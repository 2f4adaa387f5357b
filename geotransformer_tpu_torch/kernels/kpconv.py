r"""KPConv: CUDA kernels (``csrc/kpconv.cu``, ``csrc/kpconv_bwd.cu``), their
plain versions, and the autograd Functions of the training path.

``kpconv_fused`` replaces ``geotransformer_tpu/kernels/kpconv.py:kpconv_fused``
(every conv of the backbone but the first, optionally fusing the strided
block's shortcut max-pool); ``kpconv_split_fused`` replaces
``kpconv_split_fused`` (a conv over a split table: the head columns of every
query and the compacted tail of the deep queries, walked in one pass of the
same kernels);
``kpconv_stream_fused`` and ``kpconv_union_input_fused`` replace the JAX
functions of the same names (the c_in == 1 input conv over the precomputed
edge stream or over per-tile neighbor unions); ``kpconv_bwd_fused`` replaces
``kpconv_bwd_fused`` (the backward over the inverse neighbor table, whole or
split, in one pass). Each wrapper takes the plain PyTorch version for CPU
tensors and launches its kernel for CUDA tensors (:func:`cuda.use_kernel`).
A conv on the card is two kernels of ``csrc/kpconv_common.cuh``: the edge
pass (T = sum over edges of influence x gathered row, into an (M, K C)
workspace, with the count, the pool and its ties) and a 3xTF32 tensor-core
contraction with the weights; the backward runs the edge pass over the
inverse table (u), the same contraction with the transposed weights (d_s)
and a sliced tensor-core product for dW, added in a fixed order.

Training goes through :func:`kpconv_inv_fused_diff`,
:func:`kpconv_pool_inv_fused_diff`, :func:`kpconv_split_diff`,
:func:`kpconv_split_pool_diff` (the inverse-table backward), where a batch
has no inverse tables through :func:`kpconv_fused_diff`,
:func:`kpconv_pool_fused_diff`, :func:`kpconv_split_scatter_diff` and
:func:`kpconv_split_pool_scatter_diff` (the JAX XLA scatter backward, in
PyTorch operations: ``index_put_`` with accumulation, which on CUDA sorts,
so the same sums in the same order every run), and the input convs'
weight-only backward (:func:`kpconv_stream_input_diff`,
:func:`kpconv_union_input_fused_diff`, :func:`kpconv_split_input_diff`,
:func:`kpconv_input_diff`), the counterparts of the JAX custom_vjps of the
same names: the forward is the inference kernel, which also returns the
residuals the backward needs (the count divisor, the pool's tie counts, the
input conv's t1).

Layouts are the JAX package's: stacked ``[ref | src]`` rows, sentinel
neighbor index = number of support rows, weights (K, C_in, C_out).

``mxu_dtype`` (``PrecisionConfig.kpconv_mxu``) is the contraction operands'
point, float32 or bfloat16, on the kernel and the plain route alike: at
C_in > 1 the influences and the gathered features round to it before the
neighbor sum (the JAX ``_kpconv_kernel_body``, ``kernels/kpconv.py:269-273``;
the product with W stays float32), at C_in = 1 t1 and W before t1 W
(``:249-256``, ``:1123-1127``, ``:1374-1378``, ``:1667-1671``; a split
table's t1 whole, as the JAX split conv rounds it once). On the card the
edge pass rounds each staged influence and each loaded feature, and the
C_in = 1 products round t1 and W as they read them; a product of two
bfloat16 values is exact in float32, so the sums are float32 sums as before.
The backward over the inverse table (:func:`kpconv_bwd_fused`) takes
``mxu_dtype`` too: the influences and gdiv round before u, u before both
weight products, s for dW (the JAX ``_kpconv_bwd_kernel``,
``kernels/kpconv.py:699-725``; W stays float32, a mixed product promotes),
a split inverse table's head and tail each rounding its own u as the JAX
backward's two calls do (``:778-802``). The scatter backward and the input
convs' weight-only backward stay the JAX XLA rules in float32.

``table_dtype`` (``PrecisionConfig.kpconv_table``) is the storage of the
JAX gathered table (``kernels/kpconv.py:342-365``) of rows 1 and 5: at
bfloat16 each gathered feature and each pool value rounds (the pooled max
and its ties are the rounded values'), the neighbour count stays the float32
feature sums' and the coordinates stay exact (the JAX hi/mid/lo split
reproduces float32 coordinates bit for bit); the backward rounds its own
pool features for the tie equality (``:842-845``) and the scatter backward
takes dW from the rounded features (``:498-522``). The input convs over
the edge stream and the unions read no gathered table.
"""

import collections
import ctypes

import torch

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.kernels.sinkhorn import device_block_bytes
from geotransformer_tpu_torch.ops.gather import gather_with_shadow

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "kpconv_conv_launch": [_P] * 18 + [_I] * 19 + [_F, _P],
    "kpconv_conv_workspace": [_I] * 4,
    "kpconv_stream_launch": [_P] * 6 + [_I] * 7 + [_F, _P],
    "kpconv_union_launch": [_P] * 10 + [_I] * 10 + [_F, _P],
}
_BWD_SIGNATURES = {
    "kpconv_bwd_launch": [_P] * 18 + [_I] * 17 + [_F, _P],
    "kpconv_ds_workspace": [_I] * 4,
    "kpconv_dw_slices": [_I] * 4,
}


# The edge pass's shape (``csrc/kpconv_common.cuh``) for K kernel points
# and C channels: ``vector`` channels a thread (4 where C % 4 == 0),
# ``threads_per_row`` (the row's C / vector channel groups, at most 256),
# ``rows_per_block`` (256 / threads_per_row, at most 64),
# ``kernel_point_chunks`` chunks of 16 kernel points and ``channel_passes``
# passes over a row's channel groups, each walking the row's edges once.
EdgeRoute = collections.namedtuple(
    "EdgeRoute", "vector threads_per_row rows_per_block kernel_point_chunks channel_passes")

_THREADS = 256           # the edge pass's block
_KERNEL_POINT_CHUNK = 16  # its register accumulators a channel


def edge_route(k, c):
    """The edge pass's route for ``k`` kernel points over ``c`` channels, as
    ``kpconv_conv_launch`` and ``kpconv_bwd_launch`` check it: any K >= 1
    and C >= 1."""
    if k < 1 or c < 1:
        raise ValueError(f"KPConv edge pass: K = {k} kernel points, C = {c} channels")
    vector = 4 if c % 4 == 0 else 1
    groups = c // vector
    threads = min(groups, _THREADS)
    return EdgeRoute(vector, threads, min(_THREADS // threads, 64),
                     -(-k // _KERNEL_POINT_CHUNK), -(-groups // threads))


_FLOAT = 4


def _edge_chunk(rows, width):
    """Edges a chunk of the edge pass (``csrc/kpconv_common.cuh:edge_chunk``)
    for ``rows`` rows a block over a table ``width`` columns wide."""
    e = max(4, min((8192 // (_KERNEL_POINT_CHUNK * rows)) & ~3, 64))
    return max(4, min(e, (width + 3) & ~3))


def _edge_words(rows, chunk, staged_columns):
    """4-byte words of the edge pass's shared memory
    (``csrc/kpconv_common.cuh:EdgeSmem``)."""
    big = rows * max(chunk * _KERNEL_POINT_CHUNK + 4, staged_columns)
    return big + rows * chunk + 3 * _KERNEL_POINT_CHUNK + 3 * rows


def pool_route(k, c, width, pool_width, block_bytes):
    """The pooled columns the edge pass's pool phase stages at a time, as
    ``kpconv_conv_launch`` and ``kpconv_bwd_launch`` check it: all
    ``pool_width`` of them where they fit a block's ``block_bytes`` of shared
    memory beside the rest of its layout (every shipped configuration), else
    8192 / rows-a-block of them, the running max and tie count (the
    backward: the running sum) carried from one chunk to the next. ``k``
    kernel points over ``c`` channels, a table ``width`` columns wide
    (head and tail); 0 without a pool."""
    if pool_width == 0:
        return 0
    rows = edge_route(k, c).rows_per_block
    words = _edge_words(rows, _edge_chunk(rows, width), pool_width)
    if _FLOAT * words <= block_bytes:
        return pool_width
    return max(4, (8192 // rows) & ~3)


def _t1_stride(k):
    """The input convs' t1 rows in shared memory: K padded to 16."""
    return -(-k // _KERNEL_POINT_CHUNK) * _KERNEL_POINT_CHUNK


def stream_route(h, k, d, block_bytes):
    """The stream input conv's route (``csrc/kpconv.cu``, row 2) for a table
    ``h`` columns wide, ``k`` kernel points and ``d`` output channels, as
    ``kpconv_stream_launch`` checks it: "shared" where a block of 16 queries
    stages its two-stage ring of (5, 16, h) planes and W in ``block_bytes``
    of shared memory (every shipped configuration), else "global" (past
    ~350 columns at K D = 960, or K D past ~56,000: the planes and W read
    in place through L1)."""
    # csrc/kpconv.cu:stream_smem_floats at 16 queries a block
    words = 2 * 5 * 16 * h + -(-k * d // 4) * 4 + 16 * _t1_stride(k) + 16 + 4
    return "shared" if _FLOAT * words <= block_bytes else "global"


def union_route(u, h, k, d, block_bytes):
    """The union input conv's route (``csrc/kpconv.cu``, row 7) for unions
    of ``u`` rows a tile, ``h`` sel columns, ``k`` kernel points and ``d``
    output channels, as ``kpconv_union_launch`` checks it: "shared" where a
    block of 64 queries stages the union as float4, its sel rows and W in
    ``block_bytes`` of shared memory (every shipped configuration), else
    "global" (the union rows, sel and W read in place through L1)."""
    # csrc/kpconv.cu:union_smem_floats
    words = 4 * (u + 1) + 64 * (h | 1) + -(-k * d // 4) * 4 + 64 * _t1_stride(k) + 64
    return "shared" if _FLOAT * words <= block_bytes else "global"


# rows the scatter backward spreads its sentinel edges over (_scatter_rows)
_SPARE_ROWS = 1024

# entry points that return something else than an int error code
_RESTYPES = {"kpconv_conv_workspace": ctypes.c_longlong,
             "kpconv_ds_workspace": ctypes.c_longlong}


def _workspace(floats, device):
    """A split-K partial-sum workspace of ``floats`` floats, or None."""
    return torch.empty((floats,), dtype=torch.float32, device=device) if floats else None


def _influence(offsets, kernel_points, sigma):
    """max(0, 1 - |off - kp_k| / sigma): (..., 3) offsets -> (..., K)."""
    dist = torch.linalg.vector_norm(offsets[..., None, :] - kernel_points, dim=-1)
    return torch.clamp(1.0 - dist / sigma, min=0.0)


def _outputs(out, pooled, count, ties, t1, residuals, normalize, return_t1):
    """out [, pooled] [, count [, ties]] [, t1], a bare tensor when alone."""
    result = (out,) if pooled is None else (out, pooled)
    if residuals or not normalize:
        result += (count,) if pooled is None else (count, ties)
    if return_t1:
        result += (t1,)
    return result[0] if len(result) == 1 else result


def kpconv_fused_plain(s_feats, q_points, s_points, neighbor_indices,
                       kernel_points, weights, sigma, bias=None,
                       pool_feats=None, pool_cols=None, q_mask=None,
                       residuals=False, normalize=True, return_t1=False,
                       mxu_dtype=torch.float32, table_dtype=torch.float32):
    """Plain PyTorch version of :func:`kpconv_fused` (the JAX XLA KPConv,
    ``models/kpconv.py:198-240``, with the influence distance taken
    directly; its operands rounded to ``mxu_dtype`` and its gathered
    features and pool values to ``table_dtype`` where the JAX kernel
    rounds them)."""
    n = s_points.shape[0]
    nbr = neighbor_indices.long()
    if q_mask is not None:
        nbr = torch.where(q_mask[:, None], nbr, n)
    valid = nbr < n
    offsets = gather_with_shadow(s_points, nbr, 0.0) - q_points[:, None, :]
    influence = _influence(offsets, kernel_points, sigma) * valid[..., None]  # (M, H, K)
    neighbor_feats = cuda.round_to(gather_with_shadow(s_feats, nbr, 0.0), table_dtype)  # (M, H, C)
    input_layer = s_feats.shape[1] == 1
    if not input_layer:
        influence = cuda.round_to(influence, mxu_dtype)
        neighbor_feats = cuda.round_to(neighbor_feats, mxu_dtype)
    weighted = torch.einsum("mhk,mhc->mkc", influence, neighbor_feats)
    if input_layer:
        out = torch.einsum("mkc,kcd->md", cuda.round_to(weighted, mxu_dtype),
                           cuda.round_to(weights, mxu_dtype))
    else:
        out = torch.einsum("mkc,kcd->md", weighted, weights)
    # divisor: neighbors whose feature sum is positive, at least 1
    # (reference kpconv.py:113-116); the raw count unnormalized
    posflag = (torch.sum(s_feats, dim=-1) > 0.0).to(out.dtype)
    count = gather_with_shadow(posflag, nbr, 0.0).sum(dim=-1)
    if normalize:
        count = torch.clamp(count, min=1.0)
        out = out / count[:, None]
    if bias is not None:
        out = out + bias
    t1 = weighted[:, :, 0] if return_t1 else None
    pooled = ties = None
    if pool_feats is not None:
        cols = nbr if pool_cols is None else nbr[:, :pool_cols]
        pool_block = cuda.round_to(gather_with_shadow(pool_feats, cols, 0.0), table_dtype)
        pooled = pool_block.amax(dim=1)
        ties = torch.clamp((pool_block == pooled[:, None, :]).to(out.dtype).sum(dim=1), min=1.0)
    return _outputs(out, pooled, count, ties, t1, residuals, normalize, return_t1)


def kpconv_fused(s_feats, q_points, s_points, neighbor_indices, kernel_points,
                 weights, sigma, bias=None, pool_feats=None, pool_cols=None,
                 q_mask=None, force=None, residuals=False, return_t1=False,
                 mxu_dtype=torch.float32, table_dtype=torch.float32):
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
        return_t1: (C_in == 1) also return t1 (M, K) = sum_h infl * feat,
            the input conv's weight-gradient residual (unrounded).
        mxu_dtype: the contraction operands' point (see the module
            docstring).
        table_dtype: the gathered table's point (see the module
            docstring).

    Returns:
        (M, C_out) float32 [, (M, C_pool) pooled] [, count [, ties]] [, t1].
    """
    if return_t1 and weights.shape[1] != 1:
        raise ValueError("t1 is the residual of a c_in == 1 conv")
    if not cuda.use_kernel(s_feats, force):
        return kpconv_fused_plain(
            s_feats, q_points, s_points, neighbor_indices, kernel_points,
            weights, sigma, bias, pool_feats, pool_cols, q_mask, residuals,
            return_t1=return_t1, mxu_dtype=mxu_dtype, table_dtype=table_dtype)
    h = neighbor_indices.shape[1]
    out, pooled, count, ties, t1 = _conv_launch(
        "kpconv_fused", s_feats, q_points, s_points, neighbor_indices, None, None, kernel_points,
        weights, sigma, pool_feats, h if pool_cols is None else int(pool_cols), 0, q_mask,
        residuals, mxu_dtype, table_dtype)
    if bias is not None:
        out = out + bias
    return _outputs(out, pooled, count, ties, t1 if return_t1 else None, residuals, True,
                    return_t1)


def _conv_launch(name, s_feats, q_points, s_points, head, tail, tail_rank, kernel_points,
                 weights, sigma, pool_feats, pool_head, pool_tail, q_mask, with_count,
                 mxu_dtype, table_dtype):
    """One conv on the card (``kpconv_conv_launch``: the edge pass, then the
    contraction, at ``mxu_dtype`` and ``table_dtype``) over a whole table (``tail`` None) or a
    split one; counted as one launch of ``name``. Returns out, pooled,
    count, ties and the (M, K C) workspace T, which is t1 at C_in == 1
    (None where not asked)."""
    dev = s_feats.device
    m, h1 = head.shape
    n, c_in = s_feats.shape
    k, _, c_out = weights.shape
    f32 = torch.float32
    cuda.require(s_feats, "s_feats", f32, (n, c_in), dev)
    cuda.require(q_points, "q_points", f32, (m, 3), dev)
    cuda.require(s_points, "s_points", f32, (n, 3), dev)
    cuda.require(head, "neighbor_indices", torch.int32, (m, h1), dev)
    cuda.require(kernel_points, "kernel_points", f32, (k, 3), dev)
    cuda.require(weights, "weights", f32, (k, c_in, c_out), dev)
    m2 = h2 = 0
    if tail is not None:
        m2, h2 = tail.shape
        cuda.require(tail, "tail_table", torch.int32, (m2, h2), dev)
        cuda.require(tail_rank, "tail_rank", torch.int32, (m,), dev)
    if q_mask is not None:
        cuda.require(q_mask, "q_mask", torch.bool, (m,), dev)
    c_pool = 0
    if pool_feats is not None:
        c_pool = pool_feats.shape[1]
        cuda.require(pool_feats, "pool_feats", f32, (n, c_pool), dev)
    posflag = (torch.sum(s_feats, dim=-1) > 0.0).to(f32)
    t = torch.empty((m, k * c_in), dtype=f32, device=dev)
    div = torch.empty((m,), dtype=f32, device=dev)
    out = torch.empty((m, c_out), dtype=f32, device=dev)
    pooled = torch.empty((m, c_pool), dtype=f32, device=dev) if pool_feats is not None else None
    count = torch.empty((m,), dtype=f32, device=dev) if with_count else None
    ties = (torch.empty((m, c_pool), dtype=f32, device=dev)
            if with_count and pool_feats is not None else None)
    pool_width = (min(pool_head, h1) + (min(pool_tail, h2) if tail is not None else 0)
                  if pool_feats is not None else 0)
    pool_chunk = pool_route(k, c_in, h1 + h2, pool_width, device_block_bytes(dev))
    lib = cuda.library("kpconv", _SIGNATURES, _RESTYPES)
    part = _workspace(lib.kpconv_conv_workspace(m, k, c_in, c_out), dev)
    code = lib.kpconv_conv_launch(
        cuda.ptr(s_feats), cuda.ptr(q_points), cuda.ptr(s_points), cuda.ptr(head),
        cuda.ptr(tail), cuda.ptr(tail_rank), cuda.ptr(posflag), cuda.ptr(kernel_points),
        cuda.ptr(weights), cuda.ptr(q_mask), cuda.ptr(pool_feats), cuda.ptr(t), cuda.ptr(div),
        cuda.ptr(part), cuda.ptr(out), cuda.ptr(pooled), cuda.ptr(count), cuda.ptr(ties),
        m, n, h1, h2, m2, k, c_in, c_out, c_pool, int(pool_head), int(pool_tail), pool_chunk,
        cuda.operand_dtype(mxu_dtype, "kpconv_mxu"), cuda.operand_dtype(table_dtype, "kpconv_table"),
        *edge_route(k, c_in), float(sigma), cuda.stream_of(s_feats))
    cuda.check(lib, code, name)
    cuda.launches[name] += 1
    return out, pooled, count, ties, t


def kpconv_split_fused(s_feats, q_points, s_points, head_table, tail_table, tail_q, tail_rank,
                       kernel_points, weights, sigma, bias=None, pool_feats=None,
                       pool_cols=None, q_mask=None, force=None, residuals=False,
                       return_t1=False, mxu_dtype=torch.float32, table_dtype=torch.float32):
    """KPConv over a split neighbor table (JAX ``kpconv_split_fused``).

    The head (M, H1) covers the first columns of every query, the tail
    (M2, H - H1) the remaining columns of the deep queries
    (``preprocess.build_split_tables``); together they are the unsplit
    table's edges. The result is the conv over those edges: count =
    max(count_h + count_t, 1), out = (acc_h + acc_t) / count + bias,
    pooled = max(pooled_h, pooled_t) (a query without a tail row takes the
    zero shadow row), and the pool's tie counts are counted against the
    combined maximum. On the card one pass of the conv kernels walks each
    query's head columns, then its tail row through ``tail_rank``; the
    plain version runs each part unnormalized (raw sums, raw count) and
    brings the tail back through ``tail_rank`` with a zero row for the
    queries that have none; at C_in = 1 and a bfloat16 ``mxu_dtype`` it
    takes t1 W from the whole t1 rounded once (the JAX split conv's
    ``kernels/kpconv.py:1367-1378``), as the kernel does.

    Args:
        head_table: (M, H1) int32; tail_table: (M2, H - H1) int32, both
            sentinel N.
        tail_q: (M2,) int32 query row per tail row (0 on padding rows).
        tail_rank: (M,) int32 tail row per query, sentinel M2.
        pool_cols: the true width of the pool, > H1.
        (the rest as :func:`kpconv_fused`.)

    Returns:
        out [, pooled] [, count [, ties]] [, t1], as :func:`kpconv_fused`.
    """
    h1 = head_table.shape[1]
    if pool_cols is not None and h1 >= pool_cols:
        raise ValueError(f"split head width {h1} covers the pool's {pool_cols} columns")
    if return_t1 and weights.shape[1] != 1:
        raise ValueError("t1 is the residual of a c_in == 1 conv")
    if cuda.use_kernel(s_feats, force):
        h2 = tail_table.shape[1]
        out, pooled, count, ties, t1 = _conv_launch(
            "kpconv_split_fused", s_feats, q_points, s_points, head_table, tail_table, tail_rank,
            kernel_points, weights, sigma, pool_feats,
            h1 if pool_cols is None else min(pool_cols, h1),
            h2 if pool_cols is None else max(pool_cols - h1, 1), q_mask, residuals, mxu_dtype,
            table_dtype)
        if bias is not None:
            out = out + bias
        return _outputs(out, pooled, count, ties, t1 if return_t1 else None, residuals, True,
                        return_t1)
    # the input conv at a bfloat16 point rounds the whole t1, not each part's
    whole_t1 = weights.shape[1] == 1 and mxu_dtype != torch.float32
    common = dict(pool_feats=pool_feats, residuals=True, normalize=False,
                  return_t1=return_t1 or whole_t1, mxu_dtype=mxu_dtype, table_dtype=table_dtype)
    head = kpconv_fused_plain(s_feats, q_points, s_points, head_table, kernel_points, weights,
                              sigma, pool_cols=None if pool_cols is None else min(pool_cols, h1),
                              q_mask=q_mask, **common)
    rows = tail_q.long()
    tail = kpconv_fused_plain(s_feats, q_points[rows], s_points, tail_table, kernel_points,
                              weights, sigma,
                              pool_cols=None if pool_cols is None else max(pool_cols - h1, 1),
                              q_mask=None if q_mask is None else q_mask[rows], **common)
    names = ("acc",) + (("pooled",) if pool_feats is not None else ()) + ("count",) + (
        ("ties",) if pool_feats is not None else ()) + (("t1",) if common["return_t1"] else ())
    h = dict(zip(names, head))
    t = {name: v if v.dim() == 2 else v[:, None] for name, v in zip(names, tail)}
    # one rank gather of every tail quantity, a zero row for the sentinel
    packed = torch.cat(list(t.values()), dim=1)
    packed = torch.cat([packed, packed.new_zeros((1, packed.shape[1]))], dim=0)
    t = dict(zip(names, torch.split(packed[tail_rank.long()],
                                    [v.shape[1] for v in t.values()], dim=1)))
    count = torch.clamp(h["count"] + t["count"][:, 0], min=1.0)
    if whole_t1:
        acc = cuda.round_to(h["t1"] + t["t1"], mxu_dtype) @ cuda.round_to(weights[:, 0, :],
                                                                          mxu_dtype)
    else:
        acc = h["acc"] + t["acc"]
    out = acc / count[:, None]
    if bias is not None:
        out = out + bias
    pooled = ties = t1 = None
    if pool_feats is not None:
        pooled = torch.maximum(h["pooled"], t["pooled"])
        ties = torch.clamp(h["ties"] * (h["pooled"] == pooled)
                           + t["ties"] * (t["pooled"] == pooled), min=1.0)
    if return_t1:
        t1 = h["t1"] + t["t1"]
    return _outputs(out, pooled, count, ties, t1, residuals, True, return_t1)


def kpconv_split_fused_plain(*args, **kwargs):
    """Plain version of :func:`kpconv_split_fused`: the same combine over the
    two passes' plain versions."""
    return kpconv_split_fused(*args, **dict(kwargs, force=False))


def input_conv_variant(k):
    """The instance of the input convs (``csrc/kpconv.cu``, rows 2 and 7) for
    K kernel points: 0 for K = 15 (every shipped configuration), 1 for
    another K <= 16, 2 for K > 16 (the kernel points walked in chunks of 16
    register accumulators). Rows 1, 5 and 6 take any K through their edge
    pass's route (:func:`edge_route`: chunks of 16 kernel points, and passes
    of 256 channel groups past C = 1,024); ``chip_smoke.py`` phase 15 runs
    every row at K = 16, 20 and 32 and row 1 at C_in = 1,028."""
    return 0 if k == 15 else 1 if k <= 16 else 2


def kpconv_stream_fused_plain(stream, kernel_points, weights, sigma, bias=None,
                              residuals=False, mxu_dtype=torch.float32):
    """Plain PyTorch version of :func:`kpconv_stream_fused`."""
    offsets = stream[:3].permute(1, 2, 0)  # (M, H, 3)
    influence = _influence(offsets, kernel_points, sigma)  # (M, H, K)
    t1 = torch.einsum("mhk,mh->mk", influence, stream[4])
    out = cuda.round_to(t1, mxu_dtype) @ cuda.round_to(weights[:, 0, :], mxu_dtype)
    count = torch.clamp(stream[3].sum(dim=1), min=1.0)
    out = out / count[:, None]
    if bias is not None:
        out = out + bias
    return (out, t1, count) if residuals else out


def kpconv_stream_fused(stream, kernel_points, weights, sigma, bias=None,
                        force=None, residuals=False, mxu_dtype=torch.float32):
    """Gather-free input-layer KPConv (c_in == 1) from the edge stream.

    Args:
        stream: (5, M, H) float32 planes [off_x, off_y, off_z, posflag,
            feat], zeros on invalid slots (preprocess.build_input_stream).
        kernel_points: (K, 3), any K (K > 16 in chunks of 16 on the card;
            any table width and any K D, :func:`stream_route`).
        weights: (K, 1, C_out).
        sigma: influence radius.
        bias: optional (C_out,).
        force: ``ModelConfig.force_pallas``.
        residuals: also return t1 (M, K) = sum_h infl * feat and the (M,)
            count divisor, the weight gradient's residuals.
        mxu_dtype: t1 and W round to it before t1 W.

    Returns:
        (M, C_out) float32 [, t1, count].
    """
    if not cuda.use_kernel(stream, force):
        return kpconv_stream_fused_plain(stream, kernel_points, weights, sigma, bias, residuals,
                                         mxu_dtype)

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
        cuda.ptr(t1), cuda.ptr(count), m, h, k, c_out, input_conv_variant(k),
        int(stream_route(h, k, c_out, device_block_bytes(dev)) == "shared"),
        cuda.operand_dtype(mxu_dtype, "kpconv_mxu"), float(sigma), cuda.stream_of(stream))
    cuda.check(lib, code, "kpconv_stream_fused")
    cuda.launches["kpconv_stream_fused"] += 1
    if bias is not None:
        out = out + bias
    return (out, t1, count) if residuals else out


def kpconv_union_input_fused_plain(s_feats, q_points, s_points, union_rows, union_sel,
                                   kernel_points, weights, sigma, bias=None, tile=128,
                                   residuals=False, mxu_dtype=torch.float32):
    """Plain version of :func:`kpconv_union_input_fused`: the neighbor table
    rebuilt from the unions (table[q, h] = union_rows[q // tile, sel[q, h]],
    the sentinel where sel is), then the plain KPConv."""
    n = s_points.shape[0]
    u = union_rows.shape[1]
    sel = union_sel.long()
    tiles = (torch.arange(sel.shape[0], device=sel.device) // tile)[:, None]
    rows = torch.cat([union_rows.long(), torch.full_like(union_rows[:, :1], n).long()], dim=1)
    table = rows[tiles, sel.clamp(max=u)]
    out, count, t1 = kpconv_fused_plain(s_feats, q_points, s_points, table, kernel_points,
                                        weights, sigma, bias, residuals=True, return_t1=True,
                                        mxu_dtype=mxu_dtype)
    return (out, count, t1) if residuals else out


def kpconv_union_input_fused(s_feats, q_points, s_points, union_rows, union_sel, kernel_points,
                             weights, sigma, bias=None, tile=128, force=None, residuals=False,
                             mxu_dtype=torch.float32):
    """Union-gather input-layer KPConv (c_in == 1; JAX
    ``kpconv_union_input_fused``).

    Args:
        s_feats: (N, 1); q_points: (M, 3); s_points: (N, 3).
        union_rows: (ceil(M / tile), U) int32 the support rows of each tile
            of ``tile`` queries, sentinel N; union_sel: (M, H) int32 each
            edge's position in its tile's union, sentinel U
            (``preprocess.build_union_tables`` with the same tile).
        kernel_points: (K, 3), any K; weights: (K, 1, C_out);
            sigma, bias as :func:`kpconv_fused` (any union, sel width and
            K D: :func:`union_route`).
        residuals: also return the (M,) count divisor and t1 (M, K).
        mxu_dtype: t1 and W round to it before t1 W.

    Returns:
        (M, C_out) float32 [, count, t1].
    """
    m = q_points.shape[0]
    num_tiles, u = union_rows.shape
    if num_tiles != -(-m // tile):
        raise ValueError(f"union tables of {num_tiles} tiles were built for another tile than {tile}")
    if weights.shape[1] != 1:
        raise ValueError("the union conv is the c_in == 1 input conv")
    if not cuda.use_kernel(s_feats, force):
        return kpconv_union_input_fused_plain(s_feats, q_points, s_points, union_rows,
                                              union_sel, kernel_points, weights, sigma, bias,
                                              tile, residuals, mxu_dtype)
    dev = s_feats.device
    n = s_points.shape[0]
    h = union_sel.shape[1]
    k, _, c_out = weights.shape
    f32 = torch.float32
    cuda.require(s_feats, "s_feats", f32, (n, 1), dev)
    cuda.require(q_points, "q_points", f32, (m, 3), dev)
    cuda.require(s_points, "s_points", f32, (n, 3), dev)
    cuda.require(union_rows, "union_rows", torch.int32, (num_tiles, u), dev)
    cuda.require(union_sel, "union_sel", torch.int32, (m, h), dev)
    cuda.require(kernel_points, "kernel_points", f32, (k, 3), dev)
    cuda.require(weights, "weights", f32, (k, 1, c_out), dev)
    out = torch.empty((m, c_out), dtype=f32, device=dev)
    count = torch.empty((m,), dtype=f32, device=dev) if residuals else None
    t1 = torch.empty((m, k), dtype=f32, device=dev) if residuals else None
    lib = cuda.library("kpconv", _SIGNATURES)
    code = lib.kpconv_union_launch(
        cuda.ptr(s_feats), cuda.ptr(s_points), cuda.ptr(q_points), cuda.ptr(union_rows),
        cuda.ptr(union_sel), cuda.ptr(kernel_points), cuda.ptr(weights), cuda.ptr(out),
        cuda.ptr(count), cuda.ptr(t1), m, n, u, h, k, c_out, int(tile), input_conv_variant(k),
        int(union_route(u, h, k, c_out, device_block_bytes(dev)) == "shared"),
        cuda.operand_dtype(mxu_dtype, "kpconv_mxu"), float(sigma), cuda.stream_of(s_feats))
    cuda.check(lib, code, "kpconv_union_input_fused")
    cuda.launches["kpconv_union_input_fused"] += 1
    if bias is not None:
        out = out + bias
    return (out, count, t1) if residuals else out


def kpconv_bwd_fused_plain(s_feats, s_points, q_points, gdiv, inverse_table,
                           kernel_points, weights, sigma, pool_feats=None,
                           pooled=None, dpool_over_ties=None, mxu_dtype=torch.float32,
                           table_dtype=torch.float32):
    """Plain PyTorch version of :func:`kpconv_bwd_fused` (the math of the JAX
    ``_kpconv_bwd_kernel``, ``kernels/kpconv.py:651-741``)."""
    return kpconv_bwd_fused(s_feats, s_points, q_points, gdiv, inverse_table, kernel_points,
                            weights, sigma, pool_feats, pooled, dpool_over_ties, force=False,
                            mxu_dtype=mxu_dtype, table_dtype=table_dtype)


def _bwd_pass_plain(s_feats, s_points, q_points, gdiv, inverse_table, kernel_points, weights,
                    sigma, pool_feats=None, pooled=None, dpool_over_ties=None,
                    mxu_dtype=torch.float32, table_dtype=torch.float32):
    m = q_points.shape[0]
    inv = inverse_table.long()
    valid = inv < m  # (N, J)
    offsets = s_points[:, None, :] - gather_with_shadow(q_points, inv, 0.0)  # support - query
    influence = _influence(offsets, kernel_points, sigma) * valid[..., None]  # (N, J, K)
    u = torch.einsum("njk,njd->nkd", cuda.round_to(influence, mxu_dtype),
                     cuda.round_to(gather_with_shadow(gdiv, inv, 0.0), mxu_dtype))
    u = cuda.round_to(u, mxu_dtype)
    d_s_feats = torch.einsum("nkd,kcd->nc", u, weights)
    d_weights = torch.einsum("nc,nkd->kcd", cuda.round_to(s_feats, mxu_dtype), u)
    if pool_feats is None:
        return d_s_feats, d_weights
    pool_feats = cuda.round_to(pool_feats, table_dtype)
    is_max = (pool_feats[:, None, :] == gather_with_shadow(pooled, inv, 0.0)) & valid[..., None]
    d_pool = torch.sum(is_max.to(gdiv.dtype) * gather_with_shadow(dpool_over_ties, inv, 0.0), dim=1)
    return d_s_feats, d_weights, d_pool


def _bwd_launch(s_feats, s_points, q_points, gdiv, inverse_table, kernel_points, weights, sigma,
                pool_feats, pooled, dpool_over_ties, mxu_dtype, table_dtype):
    """One backward on the card (``kpconv_bwd_launch``: the u pass, d_s, dW,
    at ``mxu_dtype`` and ``table_dtype``) over a whole inverse table or a
    split 4-tuple, walked in one pass."""
    dev = s_feats.device
    n, c_in = s_feats.shape
    m, c_out = gdiv.shape
    k = weights.shape[0]
    f32 = torch.float32
    split = isinstance(inverse_table, (tuple, list))
    head, tail, _, rank = inverse_table if split else (inverse_table, None, None, None)
    j1 = head.shape[1]
    cuda.require(s_feats, "s_feats", f32, (n, c_in), dev)
    cuda.require(s_points, "s_points", f32, (n, 3), dev)
    cuda.require(q_points, "q_points", f32, (m, 3), dev)
    cuda.require(gdiv, "gdiv", f32, (m, c_out), dev)
    cuda.require(head, "inverse_table", torch.int32, (n, j1), dev)
    n2 = j2 = 0
    if split:
        n2, j2 = tail.shape
        cuda.require(tail, "inverse tail", torch.int32, (n2, j2), dev)
        cuda.require(rank, "inverse rank", torch.int32, (n,), dev)
    cuda.require(kernel_points, "kernel_points", f32, (k, 3), dev)
    cuda.require(weights, "weights", f32, (k, c_in, c_out), dev)
    c_pool = 0
    if pool_feats is not None:
        c_pool = pool_feats.shape[1]
        cuda.require(pool_feats, "pool_feats", f32, (n, c_pool), dev)
        cuda.require(pooled, "pooled", f32, (m, c_pool), dev)
        cuda.require(dpool_over_ties, "dpool_over_ties", f32, (m, c_pool), dev)
    lib = cuda.library("kpconv_bwd", _BWD_SIGNATURES, _RESTYPES)
    wt = weights.transpose(1, 2).contiguous()  # (K, C_out, C_in): d_s = u Wt
    u = torch.empty((n, k, c_out), dtype=f32, device=dev)
    part_ds = _workspace(lib.kpconv_ds_workspace(n, k, c_in, c_out), dev)
    slices = lib.kpconv_dw_slices(n, k, c_in, c_out)
    part = torch.empty((slices, k, c_in, c_out), dtype=f32, device=dev) if slices > 1 else None
    d_s_feats = torch.empty((n, c_in), dtype=f32, device=dev)
    d_weights = torch.empty((k, c_in, c_out), dtype=f32, device=dev)
    d_pool = torch.empty((n, c_pool), dtype=f32, device=dev) if pool_feats is not None else None
    code = lib.kpconv_bwd_launch(
        cuda.ptr(s_feats), cuda.ptr(s_points), cuda.ptr(q_points), cuda.ptr(gdiv),
        cuda.ptr(head), cuda.ptr(tail), cuda.ptr(rank), cuda.ptr(kernel_points), cuda.ptr(wt),
        cuda.ptr(pool_feats), cuda.ptr(pooled), cuda.ptr(dpool_over_ties),
        cuda.ptr(u), cuda.ptr(part_ds), cuda.ptr(part), cuda.ptr(d_s_feats), cuda.ptr(d_weights),
        cuda.ptr(d_pool), n, m, j1, j2, n2, k, c_in, c_out, c_pool,
        pool_route(k, c_out, j1 + j2, j1 + j2 if pool_feats is not None else 0,
                   device_block_bytes(dev)),
        cuda.operand_dtype(mxu_dtype, "kpconv_mxu"), cuda.operand_dtype(table_dtype, "kpconv_table"),
        *edge_route(k, c_out), float(sigma), cuda.stream_of(s_feats))
    cuda.check(lib, code, "kpconv_bwd_fused")
    cuda.launches["kpconv_bwd_fused"] += 1
    if pool_feats is None:
        return d_s_feats, d_weights
    return d_s_feats, d_weights, d_pool


def kpconv_bwd_fused(s_feats, s_points, q_points, gdiv, inverse_table,
                     kernel_points, weights, sigma, pool_feats=None, pooled=None,
                     dpool_over_ties=None, force=None, mxu_dtype=torch.float32,
                     table_dtype=torch.float32):
    """KPConv backward over the inverse neighbor table (no scatter).

    Args:
        s_feats: (N, C_in) the conv's input features (for d_weights).
        s_points: (N, 3); q_points: (M, 3).
        gdiv: (M, C_out) dout / the forward's count divisor.
        inverse_table: (N, J) int32 query rows per support row, sentinel M
            (preprocess.build_inverse_table), or its split 4-tuple (head
            (N, J1), tail (N2, J - J1), tail_s (N2,), rank (N,)). On the
            card one pass walks each support row's head edges, then its
            tail row through ``rank``; the plain version takes one pass over
            the head, one over the tail's support rows and brings the second
            back through ``rank`` (JAX ``kernels/kpconv.py:778-802``).
        kernel_points: (K, 3); weights: (K, C_in, C_out).
        sigma: influence radius.
        pool_feats / pooled / dpool_over_ties: optional (N, C_p) / (M, C_p)
            / (M, C_p), the strided shortcut's max-pool backward. The pool
            must have covered every real edge of the table (columns beyond
            ``pool_cols`` sentinel-only), as the JAX kernel requires.
        force: ``ModelConfig.force_pallas``.
        mxu_dtype, table_dtype: the precision point (see the module
            docstring); a split table's head and tail round their own u.

    Returns:
        d_s_feats (N, C_in), d_weights (K, C_in, C_out) [, d_pool (N, C_p)].
    """
    point = dict(mxu_dtype=mxu_dtype, table_dtype=table_dtype)
    if cuda.use_kernel(s_feats, force):
        return _bwd_launch(s_feats, s_points, q_points, gdiv, inverse_table, kernel_points,
                           weights, sigma, pool_feats, pooled, dpool_over_ties, **point)
    if not isinstance(inverse_table, (tuple, list)):
        return _bwd_pass_plain(s_feats, s_points, q_points, gdiv, inverse_table, kernel_points,
                               weights, sigma, pool_feats, pooled, dpool_over_ties, **point)
    head, tail, tail_s, rank = inverse_table
    first = _bwd_pass_plain(s_feats, s_points, q_points, gdiv, head, kernel_points, weights,
                            sigma, pool_feats, pooled, dpool_over_ties, **point)
    # the tail's padding rows (tail_s 0) hold only sentinels: exact zeros
    rows = tail_s.long()
    second = _bwd_pass_plain(s_feats[rows], s_points[rows], q_points, gdiv, tail, kernel_points,
                             weights, sigma, None if pool_feats is None else pool_feats[rows],
                             pooled, dpool_over_ties, **point)
    rank = rank.long()

    def by_rank(x):
        return torch.cat([x, x.new_zeros((1, x.shape[1]))], dim=0)[rank]

    result = (first[0] + by_rank(second[0]), first[1] + second[1])
    if pool_feats is not None:
        result += (first[2] + by_rank(second[2]),)
    return result


class _KPConvInv(torch.autograd.Function):
    """KPConv [+ shortcut max-pool] with the inverse-table backward. ``conv``
    (s_feats, weights, pool_feats) -> (out [, pooled], count [, ties]) is
    the forward with its residuals, over a whole or a split table; the bias
    stays outside (its gradient is dout summed over queries). ``point``:
    the backward's ``mxu_dtype`` and ``table_dtype``."""

    @staticmethod
    def forward(ctx, s_feats, weights, pool_feats, conv, q_points, s_points, inverse_table,
                kernel_points, sigma, force, point):
        res = conv(s_feats, weights, pool_feats)
        out, pooled, count, ties = res if pool_feats is not None else (res[0], None, res[1], None)
        ctx.save_for_backward(s_feats, weights, pool_feats, q_points, s_points, kernel_points,
                              count, pooled, ties)
        ctx.inverse_table, ctx.sigma, ctx.force, ctx.point = inverse_table, sigma, force, point
        return out if pool_feats is None else (out, pooled)

    @staticmethod
    def backward(ctx, dout, dpool=None):
        (s_feats, weights, pool_feats, q_points, s_points, kernel_points, count, pooled,
         ties) = ctx.saved_tensors
        gdiv = (dout / count[:, None]).contiguous()
        pool = {}
        if pool_feats is not None:
            pool = dict(pool_feats=pool_feats, pooled=pooled,
                        dpool_over_ties=(dpool / ties).contiguous())
        grads = kpconv_bwd_fused(s_feats, s_points, q_points, gdiv, ctx.inverse_table,
                                 kernel_points, weights, ctx.sigma, force=ctx.force, **pool,
                                 **ctx.point)
        d_pool = grads[2] if pool_feats is not None else None
        return (grads[0], grads[1], d_pool) + (None,) * 8


def _with_bias(out, bias):
    if bias is None:
        return out
    if isinstance(out, tuple):
        return (out[0] + bias,) + out[1:]
    return out + bias


def kpconv_inv_fused_diff(s_feats, q_points, s_points, neighbor_indices, inverse_table,
                          kernel_points, weights, sigma, bias=None, q_mask=None,
                          force=None, mxu_dtype=torch.float32, table_dtype=torch.float32):
    """Differentiable KPConv (JAX ``kpconv_inv_fused_diff``): the fused
    forward, and :func:`kpconv_bwd_fused` over ``inverse_table`` (the
    inverse of ``neighbor_indices``, whole or split, sentinel M) for
    d_s_feats and d_weights, both at ``mxu_dtype`` and ``table_dtype``.
    Points, tables and kernel points get no gradient."""
    point = dict(mxu_dtype=mxu_dtype, table_dtype=table_dtype)

    def conv(sf, w, _):
        return kpconv_fused(sf, q_points, s_points, neighbor_indices, kernel_points, w, sigma,
                            q_mask=q_mask, force=force, residuals=True, **point)

    return _with_bias(_KPConvInv.apply(s_feats, weights, None, conv, q_points, s_points,
                                       inverse_table, kernel_points, sigma, force, point), bias)


def kpconv_pool_inv_fused_diff(s_feats, pool_feats, q_points, s_points, neighbor_indices,
                               inverse_table, kernel_points, weights, sigma, bias=None,
                               pool_cols=None, q_mask=None, force=None,
                               mxu_dtype=torch.float32, table_dtype=torch.float32):
    """:func:`kpconv_inv_fused_diff` with the fused strided-shortcut max-pool
    (JAX ``kpconv_pool_inv_fused_diff``); the pool's gradient is split
    evenly over tied maxima. Returns (out, pooled)."""
    point = dict(mxu_dtype=mxu_dtype, table_dtype=table_dtype)

    def conv(sf, w, pf):
        return kpconv_fused(sf, q_points, s_points, neighbor_indices, kernel_points, w, sigma,
                            pool_feats=pf, pool_cols=pool_cols, q_mask=q_mask, force=force,
                            residuals=True, **point)

    return _with_bias(_KPConvInv.apply(s_feats, weights, pool_feats, conv, q_points, s_points,
                                       inverse_table, kernel_points, sigma, force, point), bias)


def kpconv_split_diff(s_feats, q_points, s_points, head_table, split_tables, inverse_table,
                      kernel_points, weights, sigma, bias=None, q_mask=None, force=None,
                      mxu_dtype=torch.float32, table_dtype=torch.float32):
    """Differentiable split-table KPConv (JAX ``kpconv_split_diff``):
    :func:`kpconv_split_fused` forward, :func:`kpconv_bwd_fused` over the
    inverse table (whole or split; it covers every edge of both parts).
    ``split_tables`` is (tail, tail_q, tail_rank)."""
    point = dict(mxu_dtype=mxu_dtype, table_dtype=table_dtype)

    def conv(sf, w, _):
        return kpconv_split_fused(sf, q_points, s_points, head_table, *split_tables,
                                  kernel_points, w, sigma, q_mask=q_mask, force=force,
                                  residuals=True, **point)

    return _with_bias(_KPConvInv.apply(s_feats, weights, None, conv, q_points, s_points,
                                       inverse_table, kernel_points, sigma, force, point), bias)


def kpconv_split_pool_diff(s_feats, pool_feats, q_points, s_points, head_table, split_tables,
                           inverse_table, kernel_points, weights, sigma, bias=None,
                           pool_cols=None, q_mask=None, force=None, mxu_dtype=torch.float32,
                           table_dtype=torch.float32):
    """:func:`kpconv_split_diff` with the fused strided-shortcut max-pool
    (JAX ``kpconv_split_pool_diff``; the tie counts are the combined max's,
    ``_split_pool_ties``). Returns (out, pooled)."""
    point = dict(mxu_dtype=mxu_dtype, table_dtype=table_dtype)

    def conv(sf, w, pf):
        return kpconv_split_fused(sf, q_points, s_points, head_table, *split_tables,
                                  kernel_points, w, sigma, pool_feats=pf, pool_cols=pool_cols,
                                  q_mask=q_mask, force=force, residuals=True, **point)

    return _with_bias(_KPConvInv.apply(s_feats, weights, pool_feats, conv, q_points, s_points,
                                       inverse_table, kernel_points, sigma, force, point), bias)


def _scatter_rows(rows, index, n):
    """(n, C): the (..., C) ``rows`` summed into the support rows ``index``
    (sentinel n dropped). On CUDA ``index_put_`` with accumulation sorts by
    index, so the sums run in one order every run (``index_add_`` there
    adds with atomics, in any order); it sums each run of equal indices in
    one warp, so the sentinel edges (padding slots, queries that are off:
    often most of a table) are spread over ``_SPARE_ROWS`` rows dropped
    with it rather than left as one long run."""
    index = index.reshape(-1)
    spare = torch.arange(index.numel(), device=index.device) % _SPARE_ROWS
    index = torch.where(index < n, index, n + spare)
    out = rows.new_zeros((n + _SPARE_ROWS, rows.shape[-1]))
    out.index_put_((index,), rows.reshape(-1, rows.shape[-1]), accumulate=True)
    return out[:n]


def _scatter_pass(s_feats, s_points, q_points, table, kernel_points, weights, sigma, gdiv,
                  table_dtype=torch.float32):
    """One neighbor table's part of the scatter backward (JAX
    ``_kpconv_diff_bwd``): the influences recomputed from the points, d_weights
    = sum_m t[m] (x) gdiv[m] with t = sum_h infl x feat (the gathered
    features at ``table_dtype``, as the JAX residual block holds them), and
    each edge's feature gradient infl . (W gdiv) scattered onto its support
    row."""
    n = s_points.shape[0]
    valid = table < n
    offsets = gather_with_shadow(s_points, table, 0.0) - q_points[:, None, :]
    influence = _influence(offsets, kernel_points, sigma) * valid[..., None]  # (M, H, K)
    t = torch.einsum("mhk,mhc->mkc", influence,
                     cuda.round_to(gather_with_shadow(s_feats, table, 0.0), table_dtype))
    d_weights = torch.einsum("mkc,md->kcd", t, gdiv)
    d_edges = torch.einsum("mhk,mkc->mhc", influence, torch.einsum("kcd,md->mkc", weights, gdiv))
    return _scatter_rows(d_edges, table, n), d_weights


def _pool_scatter(pool_feats, pooled, dpool_over_ties, cols, table_dtype=torch.float32):
    """The max-pool's gradient over the (M', cols) table ``cols``: each pooled
    value's gradient over its ties (``dpool_over_ties``), onto every column
    that attains the max (JAX ``_kpconv_pool_diff_bwd``; shadows read 0 and
    their share is dropped; the values at ``table_dtype``, as pooled)."""
    block = cuda.round_to(gather_with_shadow(pool_feats, cols, 0.0), table_dtype)
    rows = (block == pooled[:, None, :]).to(dpool_over_ties.dtype) * dpool_over_ties[:, None, :]
    return _scatter_rows(rows, cols, pool_feats.shape[0])


class _KPConvScatter(torch.autograd.Function):
    """KPConv [+ shortcut max-pool] without an inverse table: the JAX XLA
    scatter backward (``_kpconv_diff_bwd``, ``_kpconv_pool_diff_bwd``,
    ``_split_blocks_bwd``) in PyTorch operations. ``conv`` (s_feats, weights,
    pool_feats) -> (out [, pooled], count [, ties]) is the forward with its
    residuals, as :class:`_KPConvInv`'s; ``passes`` lists the tables the
    forward walked, each (table (M', H) long with the query mask applied,
    its query rows (None: all M), its pool columns): one for a whole table,
    the head and the tail of a split one. The backward recomputes the
    influences from the points (no gathered block is kept) and reads the
    features at ``table_dtype``; it rounds nothing at a bfloat16
    ``kpconv_mxu`` (the JAX XLA rules are float32)."""

    @staticmethod
    def forward(ctx, s_feats, weights, pool_feats, conv, q_points, s_points, passes,
                kernel_points, sigma, table_dtype):
        res = conv(s_feats, weights, pool_feats)
        out, pooled, count, ties = res if pool_feats is not None else (res[0], None, res[1], None)
        ctx.save_for_backward(s_feats, weights, pool_feats, q_points, s_points, kernel_points,
                              count, pooled, ties)
        ctx.passes, ctx.sigma, ctx.table_dtype = passes, sigma, table_dtype
        return out if pool_feats is None else (out, pooled)

    @staticmethod
    def backward(ctx, dout, dpool=None):
        (s_feats, weights, pool_feats, q_points, s_points, kernel_points, count, pooled,
         ties) = ctx.saved_tensors
        gdiv = dout / count[:, None]
        dpool_over_ties = None if pool_feats is None else dpool / ties
        d_s_feats = d_weights = d_pool = None
        for table, rows, cols in ctx.passes:
            def of_rows(x):
                return x if rows is None else x[rows]
            d_s, d_w = _scatter_pass(s_feats, s_points, of_rows(q_points), table, kernel_points,
                                     weights, ctx.sigma, of_rows(gdiv), ctx.table_dtype)
            d_s_feats = d_s if d_s_feats is None else d_s_feats + d_s
            d_weights = d_w if d_weights is None else d_weights + d_w
            if pool_feats is not None:
                d_p = _pool_scatter(pool_feats, of_rows(pooled), of_rows(dpool_over_ties),
                                    table[:, :cols], ctx.table_dtype)
                d_pool = d_p if d_pool is None else d_pool + d_p
        return (d_s_feats, d_weights, d_pool) + (None,) * 7


def _masked(table, n, q_mask):
    """``table`` as long, every column of a query that is off the sentinel."""
    table = table.long()
    return table if q_mask is None else torch.where(q_mask[:, None], table, n)


def kpconv_fused_diff(s_feats, q_points, s_points, neighbor_indices, kernel_points, weights,
                      sigma, bias=None, q_mask=None, force=None, mxu_dtype=torch.float32,
                      table_dtype=torch.float32):
    """Differentiable KPConv without an inverse table (JAX
    ``kpconv_fused_diff``): the fused forward, the scatter backward over
    ``neighbor_indices`` for d_s_feats and d_weights (the forward at
    ``mxu_dtype`` and ``table_dtype``, the backward the JAX XLA rules in
    float32 over the features at ``table_dtype``)."""
    point = dict(mxu_dtype=mxu_dtype, table_dtype=table_dtype)

    def conv(sf, w, _):
        return kpconv_fused(sf, q_points, s_points, neighbor_indices, kernel_points, w, sigma,
                            q_mask=q_mask, force=force, residuals=True, **point)

    passes = [(_masked(neighbor_indices, s_points.shape[0], q_mask), None, None)]
    return _with_bias(_KPConvScatter.apply(s_feats, weights, None, conv, q_points, s_points,
                                           passes, kernel_points, sigma, table_dtype), bias)


def kpconv_pool_fused_diff(s_feats, pool_feats, q_points, s_points, neighbor_indices,
                           kernel_points, weights, sigma, bias=None, pool_cols=None, q_mask=None,
                           force=None, mxu_dtype=torch.float32, table_dtype=torch.float32):
    """:func:`kpconv_fused_diff` with the fused strided-shortcut max-pool
    (JAX ``kpconv_pool_fused_diff``); the pool's gradient is split evenly
    over tied maxima. Returns (out, pooled)."""
    point = dict(mxu_dtype=mxu_dtype, table_dtype=table_dtype)

    def conv(sf, w, pf):
        return kpconv_fused(sf, q_points, s_points, neighbor_indices, kernel_points, w, sigma,
                            pool_feats=pf, pool_cols=pool_cols, q_mask=q_mask, force=force,
                            residuals=True, **point)

    cols = neighbor_indices.shape[1] if pool_cols is None else pool_cols
    passes = [(_masked(neighbor_indices, s_points.shape[0], q_mask), None, cols)]
    return _with_bias(_KPConvScatter.apply(s_feats, weights, pool_feats, conv, q_points,
                                           s_points, passes, kernel_points, sigma, table_dtype), bias)


def _split_passes(n, head_table, split_tables, pool_cols, q_mask):
    """The head and tail passes of a split table, as the forward walks them
    (the tail's queries through ``tail_q``, masked by their queries' mask;
    its padding rows hold only sentinels)."""
    tail, tail_q, _ = split_tables
    h1 = head_table.shape[1]
    rows = tail_q.long()
    cols = (None, None) if pool_cols is None else (min(pool_cols, h1), max(pool_cols - h1, 1))
    return [(_masked(head_table, n, q_mask), None, cols[0] or h1),
            (_masked(tail, n, None if q_mask is None else q_mask[rows]), rows,
             cols[1] or tail.shape[1])]


def kpconv_split_scatter_diff(s_feats, q_points, s_points, head_table, split_tables,
                              kernel_points, weights, sigma, bias=None, q_mask=None, force=None,
                              mxu_dtype=torch.float32, table_dtype=torch.float32):
    """Differentiable split-table KPConv without an inverse table (JAX
    ``kpconv_split_diff`` with ``inverse_table=None``: the two-block scatter
    backward, ``_split_blocks_bwd``). ``split_tables`` is (tail, tail_q,
    tail_rank)."""
    point = dict(mxu_dtype=mxu_dtype, table_dtype=table_dtype)

    def conv(sf, w, _):
        return kpconv_split_fused(sf, q_points, s_points, head_table, *split_tables,
                                  kernel_points, w, sigma, q_mask=q_mask, force=force,
                                  residuals=True, **point)

    passes = _split_passes(s_points.shape[0], head_table, split_tables, None, q_mask)
    return _with_bias(_KPConvScatter.apply(s_feats, weights, None, conv, q_points, s_points,
                                           passes, kernel_points, sigma, table_dtype), bias)


def kpconv_split_pool_scatter_diff(s_feats, pool_feats, q_points, s_points, head_table,
                                   split_tables, kernel_points, weights, sigma, bias=None,
                                   pool_cols=None, q_mask=None, force=None,
                                   mxu_dtype=torch.float32, table_dtype=torch.float32):
    """:func:`kpconv_split_scatter_diff` with the fused strided-shortcut
    max-pool (JAX ``kpconv_split_pool_diff`` with ``inverse_table=None``;
    the tie counts are the combined max's). Returns (out, pooled)."""
    point = dict(mxu_dtype=mxu_dtype, table_dtype=table_dtype)

    def conv(sf, w, pf):
        return kpconv_split_fused(sf, q_points, s_points, head_table, *split_tables,
                                  kernel_points, w, sigma, pool_feats=pf, pool_cols=pool_cols,
                                  q_mask=q_mask, force=force, residuals=True, **point)

    passes = _split_passes(s_points.shape[0], head_table, split_tables, pool_cols, q_mask)
    return _with_bias(_KPConvScatter.apply(s_feats, weights, pool_feats, conv, q_points,
                                           s_points, passes, kernel_points, sigma, table_dtype), bias)


class _KPConvInputT1(torch.autograd.Function):
    """An input conv (c_in == 1) with the weight gradient only: the features
    are the network input. ``conv`` (weights) -> (out, t1, count) is the
    forward with its residuals, t1 (M, K) = sum_h infl * feat."""

    @staticmethod
    def forward(ctx, weights, conv):
        out, t1, count = conv(weights)
        ctx.save_for_backward(t1, count)
        return out

    @staticmethod
    def backward(ctx, dout):
        t1, count = ctx.saved_tensors
        # d_w[k, 0, d] = sum_m t1[m, k] dout[m, d] / count[m] (the JAX input
        # convs' backward, e.g. _kpconv_stream_bwd, kernels/kpconv.py:1779: XLA,
        # no kernel)
        return (t1.t() @ (dout / count[:, None]))[:, None, :], None


def kpconv_stream_input_diff(stream, kernel_points, weights, sigma, bias=None, force=None,
                             mxu_dtype=torch.float32):
    """Differentiable edge-stream input conv (JAX ``kpconv_stream_input_diff``):
    gradients reach ``weights`` and ``bias`` only. The forward at
    ``mxu_dtype``; the weight gradient from the unrounded t1 in float32, as
    the JAX rule's."""
    def conv(w):
        return kpconv_stream_fused(stream, kernel_points, w, sigma, force=force, residuals=True,
                                   mxu_dtype=mxu_dtype)

    return _with_bias(_KPConvInputT1.apply(weights, conv), bias)


def kpconv_union_input_fused_diff(s_feats, q_points, s_points, union_rows, union_sel,
                                  kernel_points, weights, sigma, bias=None, tile=128,
                                  force=None, mxu_dtype=torch.float32):
    """Differentiable union-gather input conv (JAX
    ``kpconv_union_input_fused_diff``): gradients reach ``weights`` and
    ``bias`` only (as :func:`kpconv_stream_input_diff`)."""
    def conv(w):
        out, count, t1 = kpconv_union_input_fused(s_feats, q_points, s_points, union_rows,
                                                  union_sel, kernel_points, w, sigma, tile=tile,
                                                  force=force, residuals=True,
                                                  mxu_dtype=mxu_dtype)
        return out, t1, count

    return _with_bias(_KPConvInputT1.apply(weights, conv), bias)


def kpconv_split_input_diff(s_feats, q_points, s_points, head_table, split_tables, kernel_points,
                            weights, sigma, bias=None, q_mask=None, force=None,
                            mxu_dtype=torch.float32, table_dtype=torch.float32):
    """Differentiable split-table input conv (JAX ``kpconv_split_input_diff``,
    c_in == 1): gradients reach ``weights`` and ``bias`` only (as
    :func:`kpconv_stream_input_diff`)."""
    def conv(w):
        out, count, t1 = kpconv_split_fused(s_feats, q_points, s_points, head_table,
                                            *split_tables, kernel_points, w, sigma,
                                            q_mask=q_mask, force=force, residuals=True,
                                            return_t1=True, mxu_dtype=mxu_dtype,
                                            table_dtype=table_dtype)
        return out, t1, count

    return _with_bias(_KPConvInputT1.apply(weights, conv), bias)


def kpconv_input_diff(s_feats, q_points, s_points, neighbor_indices, kernel_points, weights,
                      sigma, bias=None, q_mask=None, force=None, mxu_dtype=torch.float32,
                      table_dtype=torch.float32):
    """Differentiable input conv over the neighbor table (JAX
    ``kpconv_input_fused_diff``, c_in == 1): gradients reach ``weights`` and
    ``bias`` only (as :func:`kpconv_stream_input_diff`)."""
    def conv(w):
        out, count, t1 = kpconv_fused(s_feats, q_points, s_points, neighbor_indices,
                                      kernel_points, w, sigma, q_mask=q_mask, force=force,
                                      residuals=True, return_t1=True, mxu_dtype=mxu_dtype,
                                      table_dtype=table_dtype)
        return out, t1, count

    return _with_bias(_KPConvInputT1.apply(weights, conv), bias)
