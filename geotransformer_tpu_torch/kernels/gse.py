r"""Geometric structure embedding: CUDA kernels (``csrc/gse.cu``,
``csrc/gse_bwd.cu``) and their plain versions.

``gse_embedding_full`` replaces ``geotransformer_tpu/kernels/gse.py:gse_embedding_full``;
``gse_full_bwd`` replaces ``_gse_full_bwd``, the backward of the
differentiable :func:`gse_embedding_full_diff` (projection parameters only).

The forward takes its precision point as two dtypes (float32 or
bfloat16), the JAX kernel's ``BASIS_DTYPE`` and ``EMBED_DTYPE``
(``PrecisionConfig.gse_basis`` and ``gse_embed``): ``basis_dtype`` rounds
the sin/cos bases and the projection weights (the products and their sums,
the max over the angles and the bias stay float32), ``embed_dtype`` is the
stored embedding's dtype. The kernel and its plain version honour both;
at float32 the plain version computes what it always did. The backward is
float32 only: the differentiable form raises ``NotImplementedError`` at a
bfloat16 point. Pairs outside the valid rectangle ``[0, n_valid)^2`` are
zero, so they get no gradient either.

Both kernels take every shape the JAX kernels take: any even width C and
any number of angles A (:func:`gse_route` picks the instance, the launchers
check it). An odd C raises ``ValueError`` on the card, as the JAX kernels'
interleaved sin/cos bases cannot hold it either.
"""

import collections
import ctypes
import functools
import math

import torch

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.ops.embedding import div_term, sinusoidal_embedding

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"gse_embedding_launch": [_P] * 9 + [_I] * 10 + [_F, _F, _P]}
_BWD_SIGNATURES = {
    "gse_bwd_launch": [_P] * 15 + [_I] * 9 + [_F, _F, _P],
    "gse_bwd_slices": [_I] * 2,
}

_CHUNK = 32       # basis rows: the kernels' granule
_WIDEST = 256     # the widest instance (channel block, row chunk)
_TILE = 16        # the backward's pairs a tile
_FWD_GROUP = 4    # the forward's angles a group
_EXACT_WIDTHS = (32, 64, 96, 128, 256)  # gse_kernel's instances
_BWD_GROUP = 3    # the backward's angles a group

# The forward's instance (``csrc/gse.cu``): ``exact``, gse_kernel<C> (C in
# {32, 64, 96, 128, 256}, A <= 4: every shipped width), else
# gse_general_kernel; channel blocks of ``width`` channels (a multiple of 32
# up to 256), ``channel_blocks`` of them across the grid, over
# ``basis_rows`` basis rows (C rounded up to 32) in ``chunks`` of 32, the
# angles in ``angle_groups`` groups of up to 4; ``words`` of shared memory a
# block.
GSEForwardRoute = collections.namedtuple(
    "GSEForwardRoute", "exact width channel_blocks basis_rows chunks angle_groups words")
# The backward's (``csrc/gse_bwd.cu``): ``chunks`` chunks of ``rows`` basis
# rows (a multiple of 32 up to 256), the angles in ``angle_groups`` groups
# of 3, ``channel_blocks`` c-blocks of ``channels``; ``resident``: C the
# width of one chunk and A = 3, W_a's c-block and a tile's bases kept in
# shared memory throughout, each entry's chosen angle k* a byte (16 bits
# elsewhere, so any A below 65,535); ``words`` of shared memory a block.
GSEBackwardRoute = collections.namedtuple(
    "GSEBackwardRoute", "rows chunks angle_groups channels channel_blocks resident words")
GSERoute = collections.namedtuple("GSERoute", "forward backward")


def _round_up(x, m):
    return -(-x // m) * m


def gse_route(c, a):
    """The instances the GSE kernels run for width ``c`` and ``a`` angles, as
    the launchers check them. Raises ``ValueError`` for an odd or
    non-positive width or no angle."""
    if c < 2 or c % 2:
        raise ValueError(f"GSE width C = {c}: the interleaved sin/cos bases need an even "
                         "width of at least 2")
    if a < 1:
        raise ValueError(f"GSE angle count A = {a}: the kernels take A >= 1")
    rows = _round_up(c, _CHUNK)
    blocks = -(-rows // _WIDEST)
    width = _round_up(-(-rows // blocks), _CHUNK)
    pairs = 64 if width > 128 else 128
    exact = c in _EXACT_WIDTHS and a <= _FWD_GROUP
    forward = GSEForwardRoute(
        exact, width, blocks, rows, rows // _CHUNK, -(-a // _FWD_GROUP),
        2 * (2 * _CHUNK * width) + 2 * (2 * pairs * _CHUNK) + pairs * width
        + (_FWD_GROUP + 1) * pairs + 2 * pairs + (width // 2 if exact else 0))
    group = _BWD_GROUP
    channels = 64 if width % 64 == 0 else 32
    rs, bs = channels + 8, width + 4
    resident = blocks == 1 and a == group and c == width
    backward = GSEBackwardRoute(
        width, blocks, -(-a // group), channels, -(-c // channels), resident,
        width * rs + 2 * (group + 1) * _TILE * bs + 2 * _TILE * rs + (group + 1) * _TILE
        + _TILE + width // 2 + channels + _TILE * channels // 2 + 1
        + _TILE * channels // (4 if resident else 2))
    return GSERoute(forward, backward)


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
    rounded operation at a time, in the order of ``angle_index`` in
    ``csrc/gse_common.cuh``: the kernels' angle indices are these, bit for bit,
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
                             sigma_a, n_valid=None, basis_dtype=torch.float32,
                             embed_dtype=torch.float32):
    """Plain PyTorch version of :func:`gse_embedding_full` (the XLA path of
    ``models/transformer.py:55-83,141-157`` from given reference vectors,
    with the pair distance taken directly). At a bfloat16 point, the JAX
    kernel's arithmetic (``kernels/gse.py:171-186``): the bases and weights
    rounded to ``basis_dtype``, the distance projection plus the max of the
    angle projections plus b_d + b_a in float32, stored at
    ``embed_dtype``."""
    hidden = w_d.shape[0]
    d_idx, a_idx = _pair_indices(points, ref_vectors, sigma_d, sigma_a)
    if basis_dtype == torch.float32 and embed_dtype == torch.float32:
        e_d = sinusoidal_embedding(d_idx, hidden) @ w_d + b_d
        e_a = torch.amax(sinusoidal_embedding(a_idx, hidden) @ w_a + b_a, dim=2)
        out = e_d + e_a
    else:
        def rounded(x):
            return cuda.round_to(x, basis_dtype)

        e_d = rounded(sinusoidal_embedding(d_idx, hidden)) @ rounded(w_d)
        e_a = torch.amax(rounded(sinusoidal_embedding(a_idx, hidden)) @ rounded(w_a), dim=2)
        out = (e_d + e_a + (b_d + b_a)).to(embed_dtype)
    if n_valid is not None:
        out = out * _valid_pairs(points.shape[0], n_valid, points.device).to(out.dtype)
    return out


def gse_embedding_full(points, ref_vectors, w_d, b_d, w_a, b_a, sigma_d,
                       sigma_a, n_valid=None, force=None, basis_dtype=torch.float32,
                       embed_dtype=torch.float32):
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
        basis_dtype: the bases' and weights' point (float32: 3xTF32
            products; bfloat16: rounded operands, one TF32 pass, exact).
        embed_dtype: the embedding's dtype (float32 or bfloat16).

    Returns:
        (N, N, C) embedding of ``embed_dtype``.
    """
    if not cuda.use_kernel(points, force):
        return gse_embedding_full_plain(points, ref_vectors, w_d, b_d, w_a, b_a,
                                        sigma_d, sigma_a, n_valid, basis_dtype, embed_dtype)

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
    route = gse_route(hidden, angle_k).forward
    bias = (b_d + b_a).contiguous()
    freqs = _frequencies(hidden, dev)
    # W_a and W_d as TF32 halves in the kernel's fragment order, zero-padded
    # to the route's basis rows and channel blocks
    w_frag = torch.empty((4 * route.basis_rows * route.channel_blocks * route.width,),
                         dtype=torch.int32, device=dev)
    basis_bf16 = cuda.operand_dtype(basis_dtype, "gse_basis")
    embed_bf16 = cuda.operand_dtype(embed_dtype, "gse_embed")
    out = torch.empty((n, n, hidden), dtype=embed_dtype, device=dev)
    lib = cuda.library("gse", _SIGNATURES)
    code = lib.gse_embedding_launch(
        cuda.ptr(points), cuda.ptr(ref_vectors), cuda.ptr(w_d), cuda.ptr(w_a),
        cuda.ptr(bias), cuda.ptr(freqs), cuda.ptr(n_valid), cuda.ptr(w_frag), cuda.ptr(out),
        n, angle_k, hidden, int(route.exact), route.basis_rows, route.width,
        route.channel_blocks, route.words, basis_bf16, embed_bf16, float(sigma_d),
        float(_angle_factor(sigma_a)), cuda.stream_of(points))
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
    route = gse_route(hidden, angle_k).backward
    lib = cuda.library("gse_bwd", _BWD_SIGNATURES)
    slices = lib.gse_bwd_slices(n, route.channel_blocks * route.chunks)
    pair_idx = torch.empty((n * n, angle_k + 1), dtype=f32, device=dev)
    part_d = torch.empty((slices, hidden, hidden), dtype=f32, device=dev)
    part_a = torch.empty((slices, hidden, hidden), dtype=f32, device=dev)
    part_b = torch.empty((slices, hidden), dtype=f32, device=dev)
    part_ties = torch.empty((slices, route.channel_blocks), dtype=torch.int32, device=dev)
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
        n, angle_k, hidden, route.rows, route.chunks, route.channel_blocks, int(route.resident),
        slices, route.words, float(sigma_d), float(_angle_factor(sigma_a)),
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
                            n_valid=None, force=None, basis_dtype=torch.float32,
                            embed_dtype=torch.float32):
    """Differentiable :func:`gse_embedding_full` (JAX
    ``gse_embedding_full_diff``): gradients reach the projections only;
    points and reference vectors are constants (the reference computes the
    embedding indices under no_grad). Float32 only: the JAX backward at a
    bfloat16 point is another function (``kernels/gse.py:327, 344``)."""
    if basis_dtype != torch.float32 or embed_dtype != torch.float32:
        raise NotImplementedError(
            f"GSE gradients at gse_basis={basis_dtype}, gse_embed={embed_dtype} are not ported "
            "(ROADMAP.md queue 1: training at the JAX precision point)")
    return _GSEFull.apply(w_d, b_d, w_a, b_a, points, ref_vectors, sigma_d, sigma_a,
                          n_valid, force)
