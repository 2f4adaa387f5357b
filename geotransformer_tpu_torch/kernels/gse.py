r"""Geometric structure embedding: CUDA kernels (``csrc/gse.cu``,
``csrc/gse_bwd.cu``) and their plain versions.

``gse_embedding_full`` replaces ``geotransformer_tpu/kernels/gse.py:gse_embedding_full``;
``gse_full_bwd`` replaces ``_gse_full_bwd``, the backward of the
differentiable :func:`gse_embedding_full_diff` (projection parameters only).

The output is float32; the JAX kernel stores bfloat16 (``EMBED_DTYPE``).
Pairs outside the valid rectangle ``[0, n_valid)^2`` are zero, so they get
no gradient either.
"""

import ctypes
import functools
import math

import torch

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.ops.embedding import div_term, sinusoidal_embedding

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"gse_embedding_launch": [_P] * 9 + [_I] * 3 + [_F, _F, _P]}
_BWD_SIGNATURES = {
    "gse_bwd_launch": [_P] * 15 + [_I] * 4 + [_F, _F, _P],
    "gse_bwd_slices": [_I] * 2,
}


# the count of (pair, channel) entries whose angle argmax the last kernel
# call of gse_full_bwd settled in float64 (an int32 tensor on its device)
last_settled = None


@functools.lru_cache(maxsize=None)
def _frequencies(hidden, device):
    """The kernels' ``div_term(hidden)`` on ``device``, copied from the host
    once: a wrapper call then copies nothing from the host and can be
    captured in a CUDA graph."""
    return div_term(hidden, device)


def _angle_factor(sigma_a):
    return 180.0 / (sigma_a * math.pi)


def _pair_indices(points, ref_vectors, sigma_d, sigma_a):
    """Distance indices (N, N) and angle indices (N, N, k) of every pair,
    taken directly (the XLA path of ``models/transformer.py:55-83``). The
    angle's cross and dot products, norm and sum are written out one
    rounded operation at a time, in the order of ``pair_indices`` in
    ``csrc/gse_bwd.cu``: the kernel's angle indices are these, bit for bit,
    so the two never route a projection tie differently for want of an ulp."""
    anchor = points[None, :, :] - points[:, None, :]  # [i, j] = p_j - p_i
    d_idx = torch.linalg.vector_norm(anchor, dim=-1) / sigma_d
    u = ref_vectors[:, None, :, :].unbind(-1)  # 3 x (N, 1, k)
    v = anchor[:, :, None, :].unbind(-1)  # 3 x (N, N, 1)
    cx = u[1] * v[2] - u[2] * v[1]
    cy = u[2] * v[0] - u[0] * v[2]
    cz = u[0] * v[1] - u[1] * v[0]
    sin_values = torch.sqrt((cx * cx + cy * cy) + cz * cz)
    # + 0.0 turns a -0 sum (v = 0 on the diagonal) into +0: atan2(+0, -0)
    # would be pi, the XLA path's diagonal angle is 0
    cos_values = ((u[0] * v[0] + u[1] * v[1]) + u[2] * v[2]) + 0.0  # (N, N, k)
    return d_idx, torch.atan2(sin_values, cos_values) * _angle_factor(sigma_a)


def _valid_pairs(n, n_valid, device):
    """(N, N, 1) float mask of the valid rectangle [0, n_valid)^2."""
    inside = torch.arange(n, device=device) < n_valid.reshape(())
    return (inside[:, None] & inside[None, :])[..., None].float()


def gse_embedding_full_plain(points, ref_vectors, w_d, b_d, w_a, b_a, sigma_d,
                             sigma_a, n_valid=None):
    """Plain PyTorch version of :func:`gse_embedding_full` (the XLA path of
    ``models/transformer.py:55-83,141-157`` from given reference vectors,
    with the pair distance taken directly)."""
    hidden = w_d.shape[0]
    d_idx, a_idx = _pair_indices(points, ref_vectors, sigma_d, sigma_a)
    e_d = sinusoidal_embedding(d_idx, hidden) @ w_d + b_d
    e_a = torch.amax(sinusoidal_embedding(a_idx, hidden) @ w_a + b_a, dim=2)
    out = e_d + e_a
    if n_valid is not None:
        out = out * _valid_pairs(points.shape[0], n_valid, points.device).to(out.dtype)
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
    freqs = _frequencies(hidden, dev)
    # W_a and W_d as TF32 halves in the kernel's fragment order
    w_frag = torch.empty((4 * hidden * hidden,), dtype=torch.int32, device=dev)
    out = torch.empty((n, n, hidden), dtype=f32, device=dev)
    lib = cuda.library("gse", _SIGNATURES)
    code = lib.gse_embedding_launch(
        cuda.ptr(points), cuda.ptr(ref_vectors), cuda.ptr(w_d), cuda.ptr(w_a),
        cuda.ptr(bias), cuda.ptr(freqs), cuda.ptr(n_valid), cuda.ptr(w_frag), cuda.ptr(out),
        n, angle_k, hidden, float(sigma_d), float(_angle_factor(sigma_a)),
        cuda.stream_of(points))
    cuda.check(lib, code, "gse_embedding_full")
    cuda.launches["gse_embedding_full"] += 1
    return out


def gse_full_bwd_plain(points, ref_vectors, w_a, sigma_d, sigma_a, de, n_valid=None):
    """Plain PyTorch version of :func:`gse_full_bwd` (the math of the JAX
    ``_gse_full_bwd_kernel``, ``kernels/gse.py:290-375``: bases recomputed,
    the angle gradient routed to the first k attaining the max).

    The routing and the sums are taken in float64 and returned in ``de``'s
    dtype: the max over k of three f32 projections can be a tie within f32
    rounding, which two f32 implementations may break differently (one pair
    and channel routed to another k moves dW_a by ~|de| there), and dW, a
    sum over every valid pair, loses digits in f32 where the weight
    gradients are small. The float64 argmax is the one exact
    arithmetic takes on these f32 indices; the kernel settles its ties the
    same way (``csrc/gse_bwd.cu``)."""
    n, angle_k, _ = ref_vectors.shape
    hidden = w_a.shape[0]
    if n_valid is not None:
        de = de * _valid_pairs(n, n_valid, de.device)
    d_idx, a_idx = _pair_indices(points, ref_vectors, sigma_d, sigma_a)
    exact = torch.float64
    basis_a = _exact_bases(a_idx, hidden)  # (N, N, k, C)
    # (N, N, C): the first maximal k (reduced over a contiguous last axis,
    # which the CPU's argmax takes several times faster than dim 2)
    first = torch.argmax((basis_a @ w_a.to(exact)).movedim(2, -1).contiguous(), dim=-1)
    de64 = de.to(exact)
    dw_d = torch.einsum("ijf,ijc->fc", sinusoidal_embedding(d_idx, hidden).to(exact), de64)
    dw_a = sum(torch.einsum("ijf,ijc->fc", sinusoidal_embedding(a_idx[:, :, k], hidden).to(exact),
                            (first == k).to(exact) * de64) for k in range(angle_k))
    db = de64.sum(dim=(0, 1))
    dtype = de.dtype
    return dw_d.to(dtype), db.to(dtype), dw_a.to(dtype), db.to(dtype)


def _exact_bases(idx, hidden):
    """Interleaved sin/cos bases of ``idx`` in float64: the arguments
    idx * div_term rounded as the f32 bases' are, their sines and cosines
    exact to float64 (the kernel's tie-break takes the same)."""
    omegas = (idx[..., None] * div_term(hidden, idx.device).to(idx.dtype)).to(torch.float64)
    return torch.stack([torch.sin(omegas), torch.cos(omegas)], dim=-1).reshape(
        idx.shape + (hidden,))


def gse_full_bwd(points, ref_vectors, w_a, sigma_d, sigma_a, de, n_valid=None, force=None):
    """Projection-parameter gradients of :func:`gse_embedding_full`.

    Args:
        points, ref_vectors, w_a, sigma_d, sigma_a, n_valid: as the forward.
        de: (N, N, C) gradient of the embedding.
        force: ``ModelConfig.force_pallas``.

    Returns:
        dW_d (C, C), db_d (C,), dW_a (C, C), db_a (C,), with
        db_d = db_a = de summed over the valid rectangle.
    """
    if not cuda.use_kernel(points, force):
        return gse_full_bwd_plain(points, ref_vectors, w_a, sigma_d, sigma_a, de, n_valid)

    dev = points.device
    n, angle_k, _ = ref_vectors.shape
    hidden = w_a.shape[0]
    f32 = torch.float32
    cuda.require(points, "points", f32, (n, 3), dev)
    cuda.require(ref_vectors, "ref_vectors", f32, (n, angle_k, 3), dev)
    cuda.require(w_a, "w_a", f32, (hidden, hidden), dev)
    cuda.require(de, "de", f32, (n, n, hidden), dev)
    if n_valid is None:
        n_valid = torch.full((), n, dtype=torch.int32, device=dev)
    cuda.require(n_valid, "n_valid", torch.int32, (), dev)
    lib = cuda.library("gse_bwd", _BWD_SIGNATURES)
    slices = lib.gse_bwd_slices(n, hidden)
    pair_idx = torch.empty((n * n, angle_k + 1), dtype=f32, device=dev)
    part_d = torch.empty((slices, hidden, hidden), dtype=f32, device=dev)
    part_a = torch.empty((slices, hidden, hidden), dtype=f32, device=dev)
    part_b = torch.empty((slices, hidden), dtype=f32, device=dev)
    part_ties = torch.empty((slices, max(hidden // 32, 1)), dtype=torch.int32, device=dev)
    dw_d = torch.empty((hidden, hidden), dtype=f32, device=dev)
    dw_a = torch.empty((hidden, hidden), dtype=f32, device=dev)
    db = torch.empty((hidden,), dtype=f32, device=dev)
    settled = torch.empty((), dtype=torch.int32, device=dev)
    freqs = _frequencies(hidden, dev)
    code = lib.gse_bwd_launch(
        cuda.ptr(points), cuda.ptr(ref_vectors), cuda.ptr(w_a), cuda.ptr(freqs),
        cuda.ptr(n_valid), cuda.ptr(de), cuda.ptr(pair_idx), cuda.ptr(part_d), cuda.ptr(part_a),
        cuda.ptr(part_b), cuda.ptr(part_ties), cuda.ptr(dw_d), cuda.ptr(dw_a), cuda.ptr(db),
        cuda.ptr(settled),
        n, angle_k, hidden, slices, float(sigma_d), float(_angle_factor(sigma_a)),
        cuda.stream_of(points))
    cuda.check(lib, code, "gse_full_bwd")
    cuda.launches["gse_full_bwd"] += 1
    global last_settled
    last_settled = settled
    return dw_d, db, dw_a, db


class _GSEFull(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w_d, b_d, w_a, b_a, points, ref_vectors, sigma_d, sigma_a, n_valid,
                force):
        out = gse_embedding_full(points, ref_vectors, w_d, b_d, w_a, b_a, sigma_d, sigma_a,
                                 n_valid, force=force)
        ctx.save_for_backward(points, ref_vectors, w_a, n_valid)
        ctx.sigma_d, ctx.sigma_a, ctx.force = sigma_d, sigma_a, force
        return out

    @staticmethod
    def backward(ctx, de):
        points, ref_vectors, w_a, n_valid = ctx.saved_tensors
        dw_d, db_d, dw_a, db_a = gse_full_bwd(points, ref_vectors, w_a, ctx.sigma_d,
                                              ctx.sigma_a, de.contiguous(), n_valid,
                                              force=ctx.force)
        return (dw_d, db_d, dw_a, db_a) + (None,) * 6


def gse_embedding_full_diff(points, ref_vectors, w_d, b_d, w_a, b_a, sigma_d, sigma_a,
                            n_valid=None, force=None):
    """Differentiable :func:`gse_embedding_full` (JAX
    ``gse_embedding_full_diff``): gradients reach the projections only;
    points and reference vectors are constants (the reference computes the
    embedding indices under no_grad)."""
    return _GSEFull.apply(w_d, b_d, w_a, b_a, points, ref_vectors, sigma_d, sigma_a,
                          n_valid, force)
