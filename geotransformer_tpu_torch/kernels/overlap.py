r"""Ground-truth patch overlaps: the CUDA kernel (``csrc/overlap.cu``) and its
plain PyTorch version.

``patch_overlaps`` replaces ``geotransformer_tpu/kernels/overlap.py:
patch_overlaps``: for each ref node and each of its candidate src nodes, the
mean of the fractions of both patches' points that have a partner within the
matching radius. The kernel reads the candidate patches through the
candidate indices; the plain version gathers them a chunk of ref nodes at a
time (the chunked loop of the JAX XLA path, ``models/matching.py:195-238``).
Both take the squared distance directly as dx dx + dy dy + dz dz (the JAX
paths expand |r|^2 - 2 r.s + |s|^2). Overlaps are training targets: no
gradient.
"""

import ctypes

import torch

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.kernels.sinkhorn import device_block_bytes

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"patch_overlaps_launch": [_P] * 7 + [_I] * 6 + [_F, _P]}
_INDEX_BYTES = {torch.int64: 8, torch.int32: 4}
_WARPS = 8  # candidates a block of csrc/overlap.cu


def overlap_route(k, block_bytes):
    """The route ``csrc/overlap.cu`` takes for patches of ``k`` points, as
    ``patch_overlaps_launch`` checks it: "shared" where a block's
    ``block_bytes`` of shared memory hold the ref patch and a patch a warp
    as float4 and each warp's cover words (every shipped configuration; up
    to ~1,600 points), else "global" (a block a candidate, its warps
    walking both patches in place through L1, each point's walk ending once
    it is covered)."""
    words = -(-k // 32)
    staged = 16 * (_WARPS + 1) * k + 4 * _WARPS * words
    return "shared" if staged <= block_bytes else "global"


def _sq_dist(a, b):
    """|a - b|^2 of broadcast (..., 3) points, each product and sum rounded
    in the kernel's order."""
    d = a - b
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    return dx * dx + dy * dy + dz * dz


def patch_overlaps_plain(ref_knn_points, ref_knn_masks, src_knn_points, src_knn_masks,
                         cand_indices, cand_masks, pos_radius, chunk_size=32):
    """Plain PyTorch version of :func:`patch_overlaps`, ``chunk_size`` ref
    nodes at a time (bounds the (chunk, S, K, K) work set)."""
    m, n = ref_knn_points.shape[0], src_knn_points.shape[0]
    if n == 0:
        return torch.zeros(cand_masks.shape, dtype=torch.float32, device=cand_masks.device)
    r2 = pos_radius ** 2
    overlaps = []
    for c0 in range(0, m, chunk_size):
        r_knn, r_mask = ref_knn_points[c0:c0 + chunk_size], ref_knn_masks[c0:c0 + chunk_size]
        c_idx = cand_indices[c0:c0 + chunk_size].long()
        in_range = (c_idx >= 0) & (c_idx < n)
        c_idx = torch.where(in_range, c_idx, 0)
        s_knn, s_mask = src_knn_points[c_idx], src_knn_masks[c_idx]  # (c, S, K, 3), (c, S, K)
        d2 = _sq_dist(r_knn[:, None, :, None, :], s_knn[:, :, None, :, :])  # (c, S, K, K)
        match = (d2 < r2) & r_mask[:, None, :, None] & s_mask[:, :, None, :]
        ref_counts = match.any(dim=3).sum(dim=2).float()  # (c, S)
        src_counts = match.any(dim=2).sum(dim=2).float()
        ref_total = torch.clamp(r_mask.sum(dim=1).float(), min=1.0)
        src_total = torch.clamp(s_mask.sum(dim=2).float(), min=1.0)
        overlap = 0.5 * (ref_counts / ref_total[:, None] + src_counts / src_total)
        keep = cand_masks[c0:c0 + chunk_size] & in_range
        overlaps.append(torch.where(keep, overlap, 0.0))
    return torch.cat(overlaps, dim=0)


def patch_overlaps(ref_knn_points, ref_knn_masks, src_knn_points, src_knn_masks, cand_indices,
                   cand_masks, pos_radius, chunk_size=32, force=None):
    """Overlap of each ref node's patch with each candidate src patch.

    Args:
        ref_knn_points: (M, K, 3) ref patches; ref_knn_masks: (M, K) bool.
        src_knn_points: (N, K, 3) src patches, already under the GT
            transform; src_knn_masks: (N, K) bool.
        cand_indices: (M, S) int64 or int32 src node per candidate (the
            kernel reads either as it is); cand_masks: (M, S) bool. A
            candidate whose index lies outside [0, N) gives 0, masked or
            not, on both routes.
        pos_radius: matching radius.
        chunk_size: ref nodes per chunk of the plain version.
        force: ``ModelConfig.force_pallas`` (see :func:`cuda.use_kernel`).

    Returns:
        (M, S) float32 overlaps in [0, 1], 0 where ``cand_masks`` is off
        or the index is out of range.
    """
    if not cuda.use_kernel(ref_knn_points, force):
        return patch_overlaps_plain(ref_knn_points, ref_knn_masks, src_knn_points, src_knn_masks,
                                    cand_indices, cand_masks, pos_radius, chunk_size)
    dev = ref_knn_points.device
    m, k, _ = ref_knn_points.shape
    n = src_knn_points.shape[0]
    s = cand_indices.shape[1]
    cuda.require(ref_knn_points, "ref_knn_points", torch.float32, (m, k, 3), dev)
    cuda.require(ref_knn_masks, "ref_knn_masks", torch.bool, (m, k), dev)
    cuda.require(src_knn_points, "src_knn_points", torch.float32, (n, k, 3), dev)
    cuda.require(src_knn_masks, "src_knn_masks", torch.bool, (n, k), dev)
    cuda.require(cand_masks, "cand_masks", torch.bool, (m, s), dev)
    if cand_indices.dtype not in _INDEX_BYTES:
        raise ValueError(f"cand_indices has dtype {cand_indices.dtype}, expected int64 or int32")
    cuda.require(cand_indices, "cand_indices", cand_indices.dtype, (m, s), dev)
    out = torch.empty((m, s), dtype=torch.float32, device=dev)
    lib = cuda.library("overlap", _SIGNATURES)
    code = lib.patch_overlaps_launch(
        cuda.ptr(ref_knn_points), cuda.ptr(ref_knn_masks), cuda.ptr(src_knn_points),
        cuda.ptr(src_knn_masks), cuda.ptr(cand_indices), cuda.ptr(cand_masks), cuda.ptr(out),
        m, n, s, k, _INDEX_BYTES[cand_indices.dtype],
        int(overlap_route(k, device_block_bytes(dev)) == "shared"), float(pos_radius) ** 2,
        cuda.stream_of(ref_knn_points))
    cuda.check(lib, code, "patch_overlaps")
    cuda.launches["patch_overlaps"] += 1
    return out
