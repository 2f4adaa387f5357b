r"""Geometric structure embedding: CUDA kernel (``csrc/gse.cu``) and its plain
version. Replaces ``geotransformer_tpu/kernels/gse.py:gse_embedding_full``.

The output is float32; the JAX kernel stores bfloat16 (``EMBED_DTYPE``).
"""

import ctypes
import math

import torch

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.ops.embedding import div_term, sinusoidal_embedding

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"gse_embedding_launch": [_P] * 8 + [_I] * 3 + [_F, _F, _P]}


def _angle_factor(sigma_a):
    return 180.0 / (sigma_a * math.pi)


def gse_embedding_full_plain(points, ref_vectors, w_d, b_d, w_a, b_a, sigma_d,
                             sigma_a, n_valid=None):
    """Plain PyTorch version of :func:`gse_embedding_full` (the XLA path of
    ``models/transformer.py:55-83,141-157`` from given reference vectors,
    with the pair distance taken directly)."""
    n = points.shape[0]
    hidden = w_d.shape[0]
    anchor = points[None, :, :] - points[:, None, :]  # [i, j] = p_j - p_i
    d_idx = torch.linalg.vector_norm(anchor, dim=-1) / sigma_d  # (N, N)
    ref_b = ref_vectors[:, None, :, :]  # (N, 1, k, 3)
    anc_b = anchor[:, :, None, :]  # (N, N, 1, 3)
    sin_values = torch.linalg.vector_norm(torch.linalg.cross(ref_b, anc_b, dim=-1), dim=-1)
    # + 0.0 turns a -0 sum (v = 0 on the diagonal) into +0: atan2(+0, -0)
    # would be pi, the XLA path's diagonal angle is 0
    cos_values = torch.sum(ref_b * anc_b, dim=-1) + 0.0  # (N, N, k)
    a_idx = torch.atan2(sin_values, cos_values) * _angle_factor(sigma_a)
    e_d = sinusoidal_embedding(d_idx, hidden) @ w_d + b_d
    e_a = torch.amax(sinusoidal_embedding(a_idx, hidden) @ w_a + b_a, dim=2)
    out = e_d + e_a
    if n_valid is not None:
        idx = torch.arange(n, device=points.device)
        inside = idx < n_valid.reshape(())
        out = out * (inside[:, None] & inside[None, :])[..., None].to(out.dtype)
    return out


def gse_embedding_full(points, ref_vectors, w_d, b_d, w_a, b_a, sigma_d,
                       sigma_a, n_valid=None, force=None):
    """Fused GSE of one cloud (reduction 'max').

    Args:
        points: (N, 3) superpoints.
        ref_vectors: (N, k, 3) k-NN reference vectors (knn point - point).
        w_d, w_a: (C, C) projection matrices, rows indexing the interleaved
            [sin0, cos0, sin1, ...] basis (a Dense kernel / Linear weight^T).
        b_d, b_a: (C,) biases.
        sigma_d, sigma_a: distance and angle scales.
        n_valid: optional int32 scalar tensor; pairs outside
            [0, n_valid)^2 are zero.
        force: ``ModelConfig.force_pallas``.

    Returns:
        (N, N, C) float32 embedding.
    """
    if not cuda.use_kernel(points, force):
        return gse_embedding_full_plain(points, ref_vectors, w_d, b_d, w_a, b_a,
                                        sigma_d, sigma_a, n_valid)

    dev = points.device
    n, angle_k, _ = ref_vectors.shape
    hidden = w_d.shape[0]
    f32 = torch.float32
    cuda.require(points, "points", f32, (n, 3), dev)
    cuda.require(ref_vectors, "ref_vectors", f32, (n, angle_k, 3), dev)
    cuda.require(w_d, "w_d", f32, (hidden, hidden), dev)
    cuda.require(w_a, "w_a", f32, (hidden, hidden), dev)
    if n_valid is None:
        n_valid = torch.full((), n, dtype=torch.int32, device=dev)
    cuda.require(n_valid, "n_valid", torch.int32, (), dev)
    bias = (b_d + b_a).contiguous()
    freqs = div_term(hidden, dev)
    out = torch.empty((n, n, hidden), dtype=f32, device=dev)
    lib = cuda.library("gse", _SIGNATURES)
    code = lib.gse_embedding_launch(
        cuda.ptr(points), cuda.ptr(ref_vectors), cuda.ptr(w_d), cuda.ptr(w_a),
        cuda.ptr(bias), cuda.ptr(freqs), cuda.ptr(n_valid), cuda.ptr(out),
        n, angle_k, hidden, float(sigma_d), float(_angle_factor(sigma_a)),
        cuda.stream_of(points))
    cuda.check(lib, code, "gse_embedding_full")
    cuda.launches["gse_embedding_full"] += 1
    return out
