r"""KPConv: CUDA kernels (``csrc/kpconv.cu``, ``csrc/kpconv_bwd.cu``), their
plain versions, and the autograd Functions of the training path.

``kpconv_fused`` replaces ``geotransformer_tpu/kernels/kpconv.py:kpconv_fused``
(every conv of the backbone but the first, optionally fusing the strided
block's shortcut max-pool); ``kpconv_stream_fused`` replaces
``kpconv_stream_fused`` (the c_in == 1 input conv over the precomputed edge
stream); ``kpconv_bwd_fused`` replaces ``kpconv_bwd_fused`` (the backward
over the inverse neighbor table). Each wrapper takes the plain PyTorch
version for CPU tensors and launches its kernel for CUDA tensors
(:func:`cuda.use_kernel`).

Training goes through :func:`kpconv_inv_fused_diff` (with the pool:
:func:`kpconv_pool_inv_fused_diff`) and :func:`kpconv_stream_input_diff`,
the counterparts of the JAX custom_vjps of the same names: the forward is
the inference kernel, which also returns the residuals the backward needs
(the count divisor, the pool's tie counts, the stream conv's t1).

Layouts are the JAX package's: stacked ``[ref | src]`` rows, sentinel
neighbor index = number of support rows, weights (K, C_in, C_out).
"""

import ctypes

import torch

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.ops.gather import gather_with_shadow

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "kpconv_fused_launch": [_P] * 13 + [_I] * 8 + [_F, _P],
    "kpconv_stream_launch": [_P] * 6 + [_I] * 4 + [_F, _P],
}
_BWD_SIGNATURES = {
    "kpconv_bwd_launch": [_P] * 15 + [_I] * 7 + [_F, _P],
    "kpconv_dw_slices": [_I] * 4,
}


def _influence(offsets, kernel_points, sigma):
    """max(0, 1 - |off - kp_k| / sigma): (..., 3) offsets -> (..., K)."""
    dist = torch.linalg.vector_norm(offsets[..., None, :] - kernel_points, dim=-1)
    return torch.clamp(1.0 - dist / sigma, min=0.0)


def kpconv_fused_plain(s_feats, q_points, s_points, neighbor_indices,
                       kernel_points, weights, sigma, bias=None,
                       pool_feats=None, pool_cols=None, q_mask=None,
                       residuals=False):
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
        return (out, count) if residuals else out
    cols = nbr if pool_cols is None else nbr[:, :pool_cols]
    pool_block = gather_with_shadow(pool_feats, cols, 0.0)  # (M, cols, P)
    pooled = pool_block.amax(dim=1)
    if not residuals:
        return out, pooled
    ties = torch.clamp((pool_block == pooled[:, None, :]).to(out.dtype).sum(dim=1), min=1.0)
    return out, pooled, count, ties


def kpconv_fused(s_feats, q_points, s_points, neighbor_indices, kernel_points,
                 weights, sigma, bias=None, pool_feats=None, pool_cols=None,
                 q_mask=None, force=None, residuals=False):
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
        residuals: also return the backward's residuals: the (M,) count
            divisor and, with the pool, the (M, C_pool) number of pooled
            columns equal to the max (shadows count, at least 1).

    Returns:
        (M, C_out) float32 [, (M, C_pool) pooled] [, count [, ties]].
    """
    if not cuda.use_kernel(s_feats, force):
        return kpconv_fused_plain(
            s_feats, q_points, s_points, neighbor_indices, kernel_points,
            weights, sigma, bias, pool_feats, pool_cols, q_mask, residuals)

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
    count = torch.empty((m,), dtype=f32, device=dev) if residuals else None
    ties = (torch.empty((m, c_pool), dtype=f32, device=dev)
            if residuals and pool_feats is not None else None)
    lib = cuda.library("kpconv", _SIGNATURES)
    code = lib.kpconv_fused_launch(
        cuda.ptr(s_feats), cuda.ptr(q_points), cuda.ptr(s_points),
        cuda.ptr(neighbor_indices), cuda.ptr(posflag), cuda.ptr(kernel_points),
        cuda.ptr(weights), cuda.ptr(q_mask), cuda.ptr(pool_feats),
        cuda.ptr(out), cuda.ptr(pooled), cuda.ptr(count), cuda.ptr(ties),
        m, n, h, k, c_in, c_out, c_pool, h if pool_cols is None else int(pool_cols),
        float(sigma), cuda.stream_of(s_feats))
    cuda.check(lib, code, "kpconv_fused")
    cuda.launches["kpconv_fused"] += 1
    if bias is not None:
        out = out + bias
    result = (out,) if pool_feats is None else (out, pooled)
    if residuals:
        result += (count,) if pool_feats is None else (count, ties)
    return result[0] if len(result) == 1 else result


def kpconv_stream_fused_plain(stream, kernel_points, weights, sigma, bias=None,
                              residuals=False):
    """Plain PyTorch version of :func:`kpconv_stream_fused`."""
    offsets = stream[:3].permute(1, 2, 0)  # (M, H, 3)
    influence = _influence(offsets, kernel_points, sigma)  # (M, H, K)
    t1 = torch.einsum("mhk,mh->mk", influence, stream[4])
    out = t1 @ weights[:, 0, :]
    count = torch.clamp(stream[3].sum(dim=1), min=1.0)
    out = out / count[:, None]
    if bias is not None:
        out = out + bias
    return (out, t1, count) if residuals else out


def kpconv_stream_fused(stream, kernel_points, weights, sigma, bias=None,
                        force=None, residuals=False):
    """Gather-free input-layer KPConv (c_in == 1) from the edge stream.

    Args:
        stream: (5, M, H) float32 planes [off_x, off_y, off_z, posflag,
            feat], zeros on invalid slots (preprocess.build_input_stream).
        kernel_points: (K, 3).
        weights: (K, 1, C_out).
        sigma: influence radius.
        bias: optional (C_out,).
        force: ``ModelConfig.force_pallas``.
        residuals: also return t1 (M, K) = sum_h infl * feat and the (M,)
            count divisor, the weight gradient's residuals.

    Returns:
        (M, C_out) float32 [, t1, count].
    """
    if not cuda.use_kernel(stream, force):
        return kpconv_stream_fused_plain(stream, kernel_points, weights, sigma, bias, residuals)

    dev = stream.device
    _, m, h = stream.shape
    k, _, c_out = weights.shape
    f32 = torch.float32
    cuda.require(stream, "stream", f32, (5, m, h), dev)
    cuda.require(kernel_points, "kernel_points", f32, (k, 3), dev)
    cuda.require(weights, "weights", f32, (k, 1, c_out), dev)
    out = torch.empty((m, c_out), dtype=f32, device=dev)
    t1 = torch.empty((m, k), dtype=f32, device=dev) if residuals else None
    count = torch.empty((m,), dtype=f32, device=dev) if residuals else None
    lib = cuda.library("kpconv", _SIGNATURES)
    code = lib.kpconv_stream_launch(
        cuda.ptr(stream), cuda.ptr(kernel_points), cuda.ptr(weights), cuda.ptr(out),
        cuda.ptr(t1), cuda.ptr(count), m, h, k, c_out, float(sigma), cuda.stream_of(stream))
    cuda.check(lib, code, "kpconv_stream_fused")
    cuda.launches["kpconv_stream_fused"] += 1
    if bias is not None:
        out = out + bias
    return (out, t1, count) if residuals else out


def kpconv_bwd_fused_plain(s_feats, s_points, q_points, gdiv, inverse_table,
                           kernel_points, weights, sigma, pool_feats=None,
                           pooled=None, dpool_over_ties=None):
    """Plain PyTorch version of :func:`kpconv_bwd_fused` (the math of the JAX
    ``_kpconv_bwd_kernel``, ``kernels/kpconv.py:651-741``)."""
    m = q_points.shape[0]
    inv = inverse_table.long()
    valid = inv < m  # (N, J)
    offsets = s_points[:, None, :] - gather_with_shadow(q_points, inv, 0.0)  # support - query
    influence = _influence(offsets, kernel_points, sigma) * valid[..., None]  # (N, J, K)
    u = torch.einsum("njk,njd->nkd", influence, gather_with_shadow(gdiv, inv, 0.0))
    d_s_feats = torch.einsum("nkd,kcd->nc", u, weights)
    d_weights = torch.einsum("nc,nkd->kcd", s_feats, u)
    if pool_feats is None:
        return d_s_feats, d_weights
    is_max = (pool_feats[:, None, :] == gather_with_shadow(pooled, inv, 0.0)) & valid[..., None]
    d_pool = torch.sum(is_max.to(gdiv.dtype) * gather_with_shadow(dpool_over_ties, inv, 0.0), dim=1)
    return d_s_feats, d_weights, d_pool


def kpconv_bwd_fused(s_feats, s_points, q_points, gdiv, inverse_table,
                     kernel_points, weights, sigma, pool_feats=None, pooled=None,
                     dpool_over_ties=None, force=None):
    """KPConv backward over the inverse neighbor table (no scatter).

    Args:
        s_feats: (N, C_in) the conv's input features (for d_weights).
        s_points: (N, 3); q_points: (M, 3).
        gdiv: (M, C_out) dout / the forward's count divisor.
        inverse_table: (N, J) int32 query rows per support row, sentinel M
            (preprocess.build_inverse_table).
        kernel_points: (K, 3); weights: (K, C_in, C_out).
        sigma: influence radius.
        pool_feats / pooled / dpool_over_ties: optional (N, C_p) / (M, C_p)
            / (M, C_p), the strided shortcut's max-pool backward. The pool
            must have covered every real edge of the table (columns beyond
            ``pool_cols`` sentinel-only), as the JAX kernel requires.
        force: ``ModelConfig.force_pallas``.

    Returns:
        d_s_feats (N, C_in), d_weights (K, C_in, C_out) [, d_pool (N, C_p)].
    """
    if not cuda.use_kernel(s_feats, force):
        return kpconv_bwd_fused_plain(s_feats, s_points, q_points, gdiv, inverse_table,
                                      kernel_points, weights, sigma, pool_feats, pooled,
                                      dpool_over_ties)

    dev = s_feats.device
    n, c_in = s_feats.shape
    m, c_out = gdiv.shape
    j = inverse_table.shape[1]
    k = weights.shape[0]
    f32 = torch.float32
    cuda.require(s_feats, "s_feats", f32, (n, c_in), dev)
    cuda.require(s_points, "s_points", f32, (n, 3), dev)
    cuda.require(q_points, "q_points", f32, (m, 3), dev)
    cuda.require(gdiv, "gdiv", f32, (m, c_out), dev)
    cuda.require(inverse_table, "inverse_table", torch.int32, (n, j), dev)
    cuda.require(kernel_points, "kernel_points", f32, (k, 3), dev)
    cuda.require(weights, "weights", f32, (k, c_in, c_out), dev)
    c_pool = 0
    if pool_feats is not None:
        c_pool = pool_feats.shape[1]
        cuda.require(pool_feats, "pool_feats", f32, (n, c_pool), dev)
        cuda.require(pooled, "pooled", f32, (m, c_pool), dev)
        cuda.require(dpool_over_ties, "dpool_over_ties", f32, (m, c_pool), dev)
    lib = cuda.library("kpconv_bwd", _BWD_SIGNATURES)
    wt = weights.transpose(1, 2).contiguous()  # (K, C_out, C_in): coalesced over C_in
    u = torch.empty((n, k, c_out), dtype=f32, device=dev)
    slices = lib.kpconv_dw_slices(n, k, c_in, c_out)
    part = torch.empty((slices, k, c_in, c_out), dtype=f32, device=dev) if slices > 1 else None
    d_s_feats = torch.empty((n, c_in), dtype=f32, device=dev)
    d_weights = torch.empty((k, c_in, c_out), dtype=f32, device=dev)
    d_pool = torch.empty((n, c_pool), dtype=f32, device=dev) if pool_feats is not None else None
    code = lib.kpconv_bwd_launch(
        cuda.ptr(s_feats), cuda.ptr(s_points), cuda.ptr(q_points), cuda.ptr(gdiv),
        cuda.ptr(inverse_table), cuda.ptr(kernel_points), cuda.ptr(wt),
        cuda.ptr(pool_feats), cuda.ptr(pooled), cuda.ptr(dpool_over_ties),
        cuda.ptr(u), cuda.ptr(part), cuda.ptr(d_s_feats), cuda.ptr(d_weights),
        cuda.ptr(d_pool), n, m, j, k, c_in, c_out, c_pool, float(sigma),
        cuda.stream_of(s_feats))
    cuda.check(lib, code, "kpconv_bwd_fused")
    cuda.launches["kpconv_bwd_fused"] += 1
    if pool_feats is None:
        return d_s_feats, d_weights
    return d_s_feats, d_weights, d_pool


class _KPConvInv(torch.autograd.Function):
    """KPConv [+ shortcut max-pool] with the inverse-table backward; the
    bias stays outside (its gradient is dout summed over queries)."""

    @staticmethod
    def forward(ctx, s_feats, weights, pool_feats, q_points, s_points, neighbor_indices,
                inverse_table, kernel_points, sigma, pool_cols, q_mask, force):
        res = kpconv_fused(s_feats, q_points, s_points, neighbor_indices, kernel_points,
                           weights, sigma, pool_feats=pool_feats, pool_cols=pool_cols,
                           q_mask=q_mask, force=force, residuals=True)
        out, pooled, count, ties = res if pool_feats is not None else (res[0], None, res[1], None)
        ctx.save_for_backward(s_feats, weights, pool_feats, q_points, s_points,
                              inverse_table, kernel_points, count, pooled, ties)
        ctx.sigma, ctx.force = sigma, force
        return out if pool_feats is None else (out, pooled)

    @staticmethod
    def backward(ctx, dout, dpool=None):
        (s_feats, weights, pool_feats, q_points, s_points, inverse_table, kernel_points,
         count, pooled, ties) = ctx.saved_tensors
        gdiv = (dout / count[:, None]).contiguous()
        if pool_feats is None:
            d_s_feats, d_weights = kpconv_bwd_fused(
                s_feats, s_points, q_points, gdiv, inverse_table, kernel_points, weights,
                ctx.sigma, force=ctx.force)
            d_pool = None
        else:
            d_s_feats, d_weights, d_pool = kpconv_bwd_fused(
                s_feats, s_points, q_points, gdiv, inverse_table, kernel_points, weights,
                ctx.sigma, pool_feats=pool_feats, pooled=pooled,
                dpool_over_ties=(dpool / ties).contiguous(), force=ctx.force)
        return (d_s_feats, d_weights, d_pool) + (None,) * 9


def kpconv_inv_fused_diff(s_feats, q_points, s_points, neighbor_indices, inverse_table,
                          kernel_points, weights, sigma, bias=None, q_mask=None,
                          force=None):
    """Differentiable KPConv (JAX ``kpconv_inv_fused_diff``): the fused
    forward, and :func:`kpconv_bwd_fused` over ``inverse_table`` (the (N, J)
    inverse of ``neighbor_indices``, sentinel M) for d_s_feats and d_weights.
    Points, tables and kernel points get no gradient."""
    out = _KPConvInv.apply(s_feats, weights, None, q_points, s_points, neighbor_indices,
                           inverse_table, kernel_points, sigma, None, q_mask, force)
    return out if bias is None else out + bias


def kpconv_pool_inv_fused_diff(s_feats, pool_feats, q_points, s_points, neighbor_indices,
                               inverse_table, kernel_points, weights, sigma, bias=None,
                               pool_cols=None, q_mask=None, force=None):
    """:func:`kpconv_inv_fused_diff` with the fused strided-shortcut max-pool
    (JAX ``kpconv_pool_inv_fused_diff``); the pool's gradient is split
    evenly over tied maxima. Returns (out, pooled)."""
    out, pooled = _KPConvInv.apply(s_feats, weights, pool_feats, q_points, s_points,
                                   neighbor_indices, inverse_table, kernel_points, sigma,
                                   pool_cols, q_mask, force)
    return (out if bias is None else out + bias), pooled


class _KPConvStreamInput(torch.autograd.Function):
    """Input conv from the edge stream: the weight gradient only (the
    stream is batch geometry and the features are the network input)."""

    @staticmethod
    def forward(ctx, weights, stream, kernel_points, sigma, force):
        out, t1, count = kpconv_stream_fused(stream, kernel_points, weights, sigma,
                                             force=force, residuals=True)
        ctx.save_for_backward(t1, count)
        return out

    @staticmethod
    def backward(ctx, dout):
        t1, count = ctx.saved_tensors
        # d_w[k, 0, d] = sum_m t1[m, k] dout[m, d] / count[m] (JAX
        # _kpconv_stream_bwd, kernels/kpconv.py:1779: XLA, no kernel)
        d_weights = (t1.t() @ (dout / count[:, None]))[:, None, :]
        return d_weights, None, None, None, None


def kpconv_stream_input_diff(stream, kernel_points, weights, sigma, bias=None, force=None):
    """Differentiable edge-stream input conv (JAX ``kpconv_stream_input_diff``):
    gradients reach ``weights`` and ``bias`` only."""
    out = _KPConvStreamInput.apply(weights, stream, kernel_points, sigma, force)
    return out if bias is None else out + bias
