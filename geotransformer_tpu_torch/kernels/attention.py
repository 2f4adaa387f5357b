r"""The geometric transformer's attention: CUDA kernels (``csrc/attention.cu``)
and their plain versions.

``rpe_pair_scores`` replaces ``geotransformer_tpu/kernels/attention.py:
rpe_pair_scores``: the RPE pair-bias scores ``qw[i, h] . embed[i, j]``,
with the pair projection moved to the query side (``qw = W_p q``).
``fused_masked_attention`` replaces ``fused_masked_attention`` there: scores
``(q k^T + bias) * scale``, a softmax over the kept keys and the product
with ``v``, heads merged, without the scores reaching device memory.

Both write exact zeros outside the valid rectangle: pair scores outside
``[0, n_valid_q) x [0, n_valid_k)`` and attention rows at or past
``n_valid_q`` (the JAX kernel leaves padded rows of a partly valid tile
unzeroed). The attention kernel takes an (M,) key mask, so any mask is
honoured; ``n_valid_k`` only cuts the keys it reads (the JAX fused path
has no mask and treats a non-prefix one as all valid).

The pair scores read the embedding in its own dtype, float32 or, at the
bfloat16 embedding point (``PrecisionConfig.gse_embed``), bfloat16, widened
exactly to float32; ``qw`` and the scores stay float32, as the JAX model's
XLA einsum promotes its bfloat16 embedding. Their differentiable form
returns a bfloat16 embedding's gradient in bfloat16, taken in float32 (the
JAX ``_pair_scores_bwd``); autograd adds the "self" blocks' bfloat16
gradients in bfloat16, last block first, as JAX adds its cotangents.

Neither JAX kernel has a Pallas backward, and neither has a CUDA one here:
the ``*_diff`` forms run the kernel forward and differentiate the plain
version (the pair scores' two einsums; the attention's softmax rows
recomputed, its gradient written out), as the JAX ``custom_vjp`` rules do.
"""

import collections
import ctypes

import torch

from geotransformer_tpu_torch.kernels import cuda

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rpe_pair_scores_launch": [_P] * 5 + [_I] * 6 + [_P],
    "fused_attention_launch": [_P] * 9 + [_I] * 7 + [_F, _P],
}
_WIDTHS = (8, 16, 32, 64)  # head widths of attention_kernel's instances
_MAX_SHARED = 232448  # csrc/attention.cu's kMaxShared: a block's shared memory on sm_90
_MAX_GRID_Y = 65535  # csrc/attention.cu's kMaxGridY: rows or heads a launch
_WIDE_PARTS = 8 * 16 * (64 + 2)  # attention_wide_kernel's partials and (m, l), in floats

# The instance of fused_masked_attention: attention_kernel of head width
# ``width`` (0: attention_wide_kernel), with 16-byte copies where ``vec16``,
# the q tile in shared memory where ``q_tile``.
AttentionRoute = collections.namedtuple("AttentionRoute", "width vec16 q_tile")


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def pair_scores_route(c, h, aligned, n=1):
    """The instance ``csrc/attention.cu`` runs for rpe_pair_scores over ``n``
    query rows: "float4" (pair_scores_kernel: C a multiple of 4 up to 512,
    H <= 8, embed and qw 16-byte aligned, at most 65,535 rows: every shipped
    configuration) or "scalar" (pair_scores_any_kernel: any N, C, H and
    alignment, rows past 65,535 in further launches)."""
    float4 = c % 4 == 0 and c <= 512 and h <= 8 and aligned and n <= _MAX_GRID_Y
    return "float4" if float4 else "scalar"


def attention_route(dh, aligned, m):
    """The instance ``csrc/attention.cu`` runs for fused_masked_attention
    over ``m`` keys, as ``fused_attention_launch`` checks it:
    attention_kernel of head width ``width`` with 16-byte copies where dh is
    that width and q, k, v are 16-byte aligned (every shipped
    configuration); else the next width up to 64 with 4-byte copies, the
    columns past dh zero in shared memory; dh > 64 width 0,
    attention_wide_kernel, its block's 16 query rows staged in shared memory
    where they fit beside the partials and the key bitmap (dh up to ~3,090),
    else (``q_tile`` False) a first kernel takes q . k^T once into an
    (H, N, M) workspace that the wide kernel reads."""
    if dh > _WIDTHS[-1]:
        dhp = -(-dh // 8) * 8
        shared = 4 * (_WIDE_PARTS + 16 * (dhp + 4)) + 4 * -(-m // 32)
        return AttentionRoute(0, False, shared <= _MAX_SHARED)
    width = next(w for w in _WIDTHS if w >= dh)
    return AttentionRoute(width, width == dh and aligned, True)


def _count(n_valid, full, device):
    """``n_valid`` (None, an int or a 0-d tensor) as a 0-d int32 tensor."""
    if n_valid is None:
        n_valid = full
    return torch.as_tensor(n_valid, dtype=torch.int32, device=device).reshape(())


def _kernel_count(n_valid, device):
    """``n_valid`` as the kernels take it: None (the full extent, a null
    pointer) or a 0-d int32 tensor on ``device``. A 0-d int32 tensor passes
    through, so a call on device counts copies nothing from the host and
    can be captured in a CUDA graph."""
    return None if n_valid is None else _count(n_valid, None, device)


def _prefix(n, n_valid, device):
    """(n,) bool: index < n_valid."""
    return torch.arange(n, device=device) < _count(n_valid, n, device)


def _rectangle(n, m, n_valid_q, n_valid_k, device):
    """(N, 1, M) bool: the valid rectangle in the (N, H, M) score layout."""
    return _prefix(n, n_valid_q, device)[:, None, None] & _prefix(m, n_valid_k, device)[None, None]


def rpe_pair_scores_plain(embed, qw, n_valid_q=None, n_valid_k=None):
    """Plain PyTorch version of :func:`rpe_pair_scores` (the einsum of the
    JAX XLA path, ``models/transformer.py:272-273``, zeroed outside the
    valid rectangle; a bfloat16 embedding widened to ``qw``'s dtype)."""
    n, m, _ = embed.shape
    scores = torch.einsum("nmc,nhc->nhm", embed.to(qw.dtype), qw)
    return torch.where(_rectangle(n, m, n_valid_q, n_valid_k, embed.device), scores, 0.0)


def rpe_pair_scores(embed, qw, n_valid_q=None, n_valid_k=None, force=None):
    """Pair-bias attention scores with the valid-rectangle skip.

    Args:
        embed: (N, M, C) float32 or bfloat16 pair embedding.
        qw: (N, H, C) float32 query-side projected queries
            (``einsum('hnc,dhc->nhd', q, W_p)``).
        n_valid_q, n_valid_k: int32 scalars (0-d tensors or ints) or None;
            rows [n_valid_q, N) and columns [n_valid_k, M) are padding.
        force: ``ModelConfig.force_pallas`` (see :func:`cuda.use_kernel`).

    Returns:
        (N, H, M) float32 ``scores[i, h, j] = qw[i, h] . embed[i, j]``, zero
        outside the valid rectangle.
    """
    if not cuda.use_kernel(embed, force):
        return rpe_pair_scores_plain(embed, qw, n_valid_q, n_valid_k)
    dev = embed.device
    n, m, c = embed.shape
    h = qw.shape[1]
    f32 = torch.float32
    embed_bf16 = cuda.operand_dtype(embed.dtype, "the embedding")
    cuda.require(embed, "embed", embed.dtype, (n, m, c), dev)
    cuda.require(qw, "qw", f32, (n, h, c), dev)
    nv_q, nv_k = _kernel_count(n_valid_q, dev), _kernel_count(n_valid_k, dev)
    out = torch.empty((n, h, m), dtype=f32, device=dev)
    vec4 = pair_scores_route(c, h, _aligned(embed, qw), n) == "float4"
    lib = cuda.library("attention", _SIGNATURES)
    code = lib.rpe_pair_scores_launch(cuda.ptr(embed), cuda.ptr(qw), cuda.ptr(nv_q),
                                      cuda.ptr(nv_k), cuda.ptr(out), n, m, h, c, int(vec4),
                                      embed_bf16, cuda.stream_of(embed))
    cuda.check(lib, code, "rpe_pair_scores")
    cuda.launches["rpe_pair_scores"] += 1
    return out


class _PairScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, embed, qw, nv_q, nv_k, force):
        ctx.save_for_backward(embed, qw, nv_q, nv_k)
        return rpe_pair_scores(embed, qw, nv_q, nv_k, force=force)

    @staticmethod
    def backward(ctx, ds):
        embed, qw, nv_q, nv_k = ctx.saved_tensors
        n, m, _ = embed.shape
        ds = torch.where(_rectangle(n, m, nv_q, nv_k, ds.device), ds, 0.0)
        # a bfloat16 embedding: d_embed in float32, stored in the embedding's
        # dtype, and d_qw from the widened embedding (JAX _pair_scores_bwd,
        # kernels/attention.py:201-207, the transpose of the XLA einsum's
        # promotion alike)
        d_embed = d_qw = None
        if ctx.needs_input_grad[0]:
            d_embed = torch.einsum("nhm,nhc->nmc", ds, qw).to(embed.dtype)
        if ctx.needs_input_grad[1]:
            d_qw = torch.einsum("nhm,nmc->nhc", ds, embed.to(qw.dtype))
        return d_embed, d_qw, None, None, None


def rpe_pair_scores_diff(embed, qw, n_valid_q=None, n_valid_k=None, force=None):
    """Differentiable :func:`rpe_pair_scores` (JAX ``rpe_pair_scores_diff``):
    the kernel forward, the plain einsums' gradients (zero outside the
    valid rectangle, where the forward is zero); a bfloat16 embedding's
    gradient in bfloat16, taken in float32."""
    n, m, _ = embed.shape
    return _PairScores.apply(embed, qw, _count(n_valid_q, n, embed.device),
                             _count(n_valid_k, m, embed.device), force)


def _probabilities(q, k, bias, n_valid_k, scale, key_masks):
    """(H, N, M) softmax of ``(q k^T + bias) * scale`` over the kept keys;
    rows without a kept key are zero."""
    m = k.shape[1]
    scores = torch.einsum("hnc,hmc->hnm", q, k)
    if bias is not None:
        scores = scores + bias.transpose(0, 1)
    scores = scores * scale
    keep = _prefix(m, n_valid_k, q.device)
    if key_masks is not None:
        keep = keep & key_masks
    scores = torch.where(keep, scores, -torch.inf)
    # the max is a shift the softmax does not see: no gradient through it
    top = torch.amax(scores, dim=-1, keepdim=True).detach().clamp_min(-3.0e38)
    p = torch.exp(scores - top)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def fused_masked_attention_plain(q, k, v, bias=None, n_valid_q=None, n_valid_k=None, scale=1.0,
                                 key_masks=None):
    """Plain PyTorch version of :func:`fused_masked_attention`: the einsums
    and the masked softmax of the JAX ``_xla_attention_ref``
    (``kernels/attention.py:376-387``), rows without a kept key and padded
    rows zero."""
    h, n, dh = q.shape
    p = _probabilities(q, k, bias, n_valid_k, scale, key_masks)
    out = torch.einsum("hnm,hmc->hnc", p, v).transpose(0, 1).reshape(n, h * dh)
    return torch.where(_prefix(n, n_valid_q, q.device)[:, None], out, 0.0)


def fused_masked_attention(q, k, v, bias=None, n_valid_q=None, n_valid_k=None, scale=1.0,
                           key_masks=None, force=None):
    """Fused ``(q k^T [+ bias]) * scale`` -> key-masked softmax -> ``@ v``.

    Args:
        q: (H, N, dh) float32 queries (head-major).
        k, v: (H, M, dh) float32 keys and values.
        bias: optional (N, H, M) float32 additive pre-scale score bias (the
            :func:`rpe_pair_scores` layout).
        n_valid_q, n_valid_k: int32 scalars (0-d tensors or ints) or None:
            query rows at or past ``n_valid_q`` are zero, keys at or past
            ``n_valid_k`` are masked.
        scale: score scale, applied after the bias.
        key_masks: optional (M,) bool; False keys are masked too.
        force: ``ModelConfig.force_pallas``.

    Returns:
        (N, H * dh) float32, heads merged in layer order.
    """
    if not cuda.use_kernel(q, force):
        return fused_masked_attention_plain(q, k, v, bias, n_valid_q, n_valid_k, scale, key_masks)
    dev = q.device
    h, n, dh = q.shape
    m = k.shape[1]
    f32 = torch.float32
    cuda.require(q, "q", f32, (h, n, dh), dev)
    cuda.require(k, "k", f32, (h, m, dh), dev)
    cuda.require(v, "v", f32, (h, m, dh), dev)
    if bias is not None:
        cuda.require(bias, "bias", f32, (n, h, m), dev)
    if key_masks is not None:
        cuda.require(key_masks, "key_masks", torch.bool, (m,), dev)
    nv_q, nv_k = _kernel_count(n_valid_q, dev), _kernel_count(n_valid_k, dev)
    out = torch.empty((n, h * dh), dtype=f32, device=dev)
    width, vec16, q_tile = attention_route(dh, _aligned(q, k, v), m)
    # the two-pass route's q . k^T
    scores = None if q_tile else torch.empty((h, n, m), dtype=f32, device=dev)
    lib = cuda.library("attention", _SIGNATURES)
    code = lib.fused_attention_launch(
        cuda.ptr(q), cuda.ptr(k), cuda.ptr(v), cuda.ptr(bias), cuda.ptr(key_masks),
        cuda.ptr(nv_q), cuda.ptr(nv_k), cuda.ptr(scores), cuda.ptr(out), n, m, h, dh, width,
        int(vec16), int(q_tile), float(scale), cuda.stream_of(q))
    cuda.check(lib, code, "fused_masked_attention")
    cuda.launches["fused_masked_attention"] += 1
    return out


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, nv_q, nv_k, scale, key_masks, force):
        ctx.save_for_backward(q, k, v, bias, nv_q, nv_k, key_masks)
        ctx.scale = scale
        return fused_masked_attention(q, k, v, bias, nv_q, nv_k, scale, key_masks, force=force)

    @staticmethod
    def backward(ctx, dout):
        # the gradient of the plain version, written out: softmax rows p
        # recomputed, dS = p (dP - rowsum(dP p)) with dP = dO v^T
        q, k, v, bias, nv_q, nv_k, key_masks = ctx.saved_tensors
        h, n, dh = q.shape
        p = _probabilities(q, k, bias, nv_k, ctx.scale, key_masks)
        rows = _prefix(n, nv_q, q.device)[:, None]
        d_out = torch.where(rows, dout, 0.0).reshape(n, h, dh).transpose(0, 1)  # (H, N, dh)
        d_p = torch.bmm(d_out, v.transpose(1, 2))
        d_s = p * (d_p - (d_p * p).sum(dim=-1, keepdim=True)) * ctx.scale
        need = ctx.needs_input_grad
        d_q = torch.bmm(d_s, k) if need[0] else None
        d_k = torch.bmm(d_s.transpose(1, 2), q) if need[1] else None
        d_v = torch.bmm(p.transpose(1, 2), d_out) if need[2] else None
        d_bias = d_s.transpose(0, 1) if bias is not None and need[3] else None
        return (d_q, d_k, d_v, d_bias) + (None,) * 5


def fused_masked_attention_diff(q, k, v, bias=None, n_valid_q=None, n_valid_k=None, scale=1.0,
                                key_masks=None, force=None):
    """Differentiable :func:`fused_masked_attention` (JAX
    ``fused_masked_attention_diff``): the kernel forward, the gradient of
    the plain version (its softmax rows recomputed)."""
    n, m = q.shape[1], k.shape[1]
    return _FusedAttention.apply(q, k, v, bias, _count(n_valid_q, n, q.device),
                                 _count(n_valid_k, m, q.device), scale, key_masks, force)
