r"""KPConv forward: CUDA kernels (``csrc/kpconv.cu``) and their plain versions.

``kpconv_fused`` replaces ``geotransformer_tpu/kernels/kpconv.py:kpconv_fused``
(every conv of the backbone but the first, optionally fusing the strided
block's shortcut max-pool); ``kpconv_stream_fused`` replaces
``kpconv_stream_fused`` (the c_in == 1 input conv over the precomputed edge
stream). Each wrapper takes the plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors (:func:`cuda.use_kernel`).

Layouts are the JAX package's: stacked ``[ref | src]`` rows, sentinel
neighbor index = number of support rows, weights (K, C_in, C_out).
"""

import ctypes

import torch

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.ops.gather import gather_with_shadow

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "kpconv_fused_launch": [_P] * 11 + [_I] * 8 + [_F, _P],
    "kpconv_stream_launch": [_P] * 4 + [_I] * 4 + [_F, _P],
}


def _influence(offsets, kernel_points, sigma):
    """max(0, 1 - |off - kp_k| / sigma): (..., 3) offsets -> (..., K)."""
    dist = torch.linalg.vector_norm(offsets[..., None, :] - kernel_points, dim=-1)
    return torch.clamp(1.0 - dist / sigma, min=0.0)


def kpconv_fused_plain(s_feats, q_points, s_points, neighbor_indices,
                       kernel_points, weights, sigma, bias=None,
                       pool_feats=None, pool_cols=None, q_mask=None):
    """Plain PyTorch version of :func:`kpconv_fused` (the JAX XLA KPConv,
    ``models/kpconv.py:198-240``, with the influence distance taken
    directly)."""
    n = s_points.shape[0]
    nbr = neighbor_indices.long()
    if q_mask is not None:
        nbr = torch.where(q_mask[:, None], nbr, n)
    valid = nbr < n
    offsets = gather_with_shadow(s_points, nbr, 0.0) - q_points[:, None, :]
    influence = _influence(offsets, kernel_points, sigma) * valid[..., None]  # (M, H, K)
    neighbor_feats = gather_with_shadow(s_feats, nbr, 0.0)  # (M, H, C)
    weighted = torch.einsum("mhk,mhc->mkc", influence, neighbor_feats)
    out = torch.einsum("mkc,kcd->md", weighted, weights)
    # divisor: neighbors whose feature sum is positive, at least 1
    # (reference kpconv.py:113-116)
    posflag = (torch.sum(s_feats, dim=-1) > 0.0).to(out.dtype)
    count = torch.clamp(gather_with_shadow(posflag, nbr, 0.0).sum(dim=-1), min=1.0)
    out = out / count[:, None]
    if bias is not None:
        out = out + bias
    if pool_feats is None:
        return out
    cols = nbr if pool_cols is None else nbr[:, :pool_cols]
    pooled = gather_with_shadow(pool_feats, cols, 0.0).amax(dim=1)
    return out, pooled


def kpconv_fused(s_feats, q_points, s_points, neighbor_indices, kernel_points,
                 weights, sigma, bias=None, pool_feats=None, pool_cols=None,
                 q_mask=None, force=None):
    """Fused KPConv forward.

    Args:
        s_feats: (N, C_in) support features.
        q_points: (M, 3) query points.
        s_points: (N, 3) support points.
        neighbor_indices: (M, H) int32, sentinel N.
        kernel_points: (K, 3).
        weights: (K, C_in, C_out).
        sigma: influence radius.
        bias: optional (C_out,), added after the count division.
        pool_feats: optional (N, C_pool) features max-pooled over the first
            ``pool_cols`` columns of the same table (strided shortcut;
            shadow neighbors read 0).
        q_mask: optional (M,) bool; queries that are off write 0 (count 1,
            pool 0) — what the all-shadow neighbor rows of padding give.
        force: ``ModelConfig.force_pallas`` (see :func:`cuda.use_kernel`).

    Returns:
        (M, C_out) float32 [, (M, C_pool) pooled].
    """
    if not cuda.use_kernel(s_feats, force):
        return kpconv_fused_plain(
            s_feats, q_points, s_points, neighbor_indices, kernel_points,
            weights, sigma, bias, pool_feats, pool_cols, q_mask)

    dev = s_feats.device
    m, h = neighbor_indices.shape
    n, c_in = s_feats.shape
    k, _, c_out = weights.shape
    f32 = torch.float32
    cuda.require(s_feats, "s_feats", f32, (n, c_in), dev)
    cuda.require(q_points, "q_points", f32, (m, 3), dev)
    cuda.require(s_points, "s_points", f32, (n, 3), dev)
    cuda.require(neighbor_indices, "neighbor_indices", torch.int32, (m, h), dev)
    cuda.require(kernel_points, "kernel_points", f32, (k, 3), dev)
    cuda.require(weights, "weights", f32, (k, c_in, c_out), dev)
    if q_mask is not None:
        cuda.require(q_mask, "q_mask", torch.bool, (m,), dev)
    c_pool = 0
    if pool_feats is not None:
        c_pool = pool_feats.shape[1]
        cuda.require(pool_feats, "pool_feats", f32, (n, c_pool), dev)
    posflag = (torch.sum(s_feats, dim=-1) > 0.0).to(f32)
    out = torch.empty((m, c_out), dtype=f32, device=dev)
    pooled = torch.empty((m, c_pool), dtype=f32, device=dev) if pool_feats is not None else None
    lib = cuda.library("kpconv", _SIGNATURES)
    code = lib.kpconv_fused_launch(
        cuda.ptr(s_feats), cuda.ptr(q_points), cuda.ptr(s_points),
        cuda.ptr(neighbor_indices), cuda.ptr(posflag), cuda.ptr(kernel_points),
        cuda.ptr(weights), cuda.ptr(q_mask), cuda.ptr(pool_feats),
        cuda.ptr(out), cuda.ptr(pooled),
        m, n, h, k, c_in, c_out, c_pool, h if pool_cols is None else int(pool_cols),
        float(sigma), cuda.stream_of(s_feats))
    cuda.check(lib, code, "kpconv_fused")
    cuda.launches["kpconv_fused"] += 1
    if bias is not None:
        out = out + bias
    return out if pool_feats is None else (out, pooled)


def kpconv_stream_fused_plain(stream, kernel_points, weights, sigma, bias=None):
    """Plain PyTorch version of :func:`kpconv_stream_fused`."""
    offsets = stream[:3].permute(1, 2, 0)  # (M, H, 3)
    influence = _influence(offsets, kernel_points, sigma)  # (M, H, K)
    t1 = torch.einsum("mhk,mh->mk", influence, stream[4])
    out = t1 @ weights[:, 0, :]
    count = torch.clamp(stream[3].sum(dim=1), min=1.0)
    out = out / count[:, None]
    return out if bias is None else out + bias


def kpconv_stream_fused(stream, kernel_points, weights, sigma, bias=None,
                        force=None):
    """Gather-free input-layer KPConv (c_in == 1) from the edge stream.

    Args:
        stream: (5, M, H) float32 planes [off_x, off_y, off_z, posflag,
            feat], zeros on invalid slots (preprocess.build_input_stream).
        kernel_points: (K, 3).
        weights: (K, 1, C_out).
        sigma: influence radius.
        bias: optional (C_out,).
        force: ``ModelConfig.force_pallas``.

    Returns:
        (M, C_out) float32.
    """
    if not cuda.use_kernel(stream, force):
        return kpconv_stream_fused_plain(stream, kernel_points, weights, sigma, bias)

    dev = stream.device
    _, m, h = stream.shape
    k, _, c_out = weights.shape
    f32 = torch.float32
    cuda.require(stream, "stream", f32, (5, m, h), dev)
    cuda.require(kernel_points, "kernel_points", f32, (k, 3), dev)
    cuda.require(weights, "weights", f32, (k, 1, c_out), dev)
    out = torch.empty((m, c_out), dtype=f32, device=dev)
    lib = cuda.library("kpconv", _SIGNATURES)
    code = lib.kpconv_stream_launch(
        cuda.ptr(stream), cuda.ptr(kernel_points), cuda.ptr(weights), cuda.ptr(out),
        m, h, k, c_out, float(sigma), cuda.stream_of(stream))
    cuda.check(lib, code, "kpconv_stream_fused")
    cuda.launches["kpconv_stream_fused"] += 1
    return out if bias is None else out + bias
