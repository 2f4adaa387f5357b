r"""Geometric self/cross attention transformer
(``geotransformer_tpu/models/transformer.py``; reference
`modules/geotransformer/geotransformer.py:9-155`,
`modules/transformer/rpe_transformer.py`, `vanilla_transformer.py`,
`conditional_transformer.py`).

The geometric structure embedding goes through
:func:`geotransformer_tpu_torch.kernels.gse.gse_embedding_full` (CUDA kernel
on the card), or its differentiable form ``gse_embedding_full_diff`` when
gradients are enabled. Attention goes through the two attention kernels of
:mod:`geotransformer_tpu_torch.kernels.attention` (``rpe_pair_scores`` for
the geometric bias, ``fused_masked_attention`` for every self and cross
layer), in their ``*_diff`` forms when gradients are enabled, on every
configuration; ``force_pallas=False`` takes the einsum path instead. The
JAX package keeps its attention kernels behind ``kernels/flags.py``, an
environment switch that guards a TPU hang of their clamped DMA index maps;
the CUDA kernels have no such mechanism, so the port has no flag: what
admits them on the card is ``chip_smoke.py`` holding each against its plain
version. Padded tokens are excluded from keys; their query outputs are
zeroed at the stack output. The embedding's precision point
(``PrecisionConfig.gse_basis``, ``gse_embed``) is the GSE module's; the RPE
attention reads the embedding in the dtype it comes in.
Module and parameter names follow the flax tree, so the state_dict keys are
the reference torch keys.
"""

import math

import torch
from torch import nn

from geotransformer_tpu_torch.kernels.attention import (
    fused_masked_attention,
    fused_masked_attention_diff,
    rpe_pair_scores,
    rpe_pair_scores_diff,
)
from geotransformer_tpu_torch.kernels.gse import (
    _pair_indices,
    gse_embedding_full,
    gse_embedding_full_diff,
)
from geotransformer_tpu_torch.ops.embedding import sinusoidal_embedding
from geotransformer_tpu_torch.ops.pairwise_distance import pairwise_distance


def prefix_valid_count(masks, num_point):
    """(B,) int32 count of valid rows when each mask is a valid prefix, else
    ``num_point`` (every pair counts as valid)."""
    is_prefix = torch.all(masks[:, :-1].int() >= masks[:, 1:].int(), dim=1)
    count = masks.int().sum(dim=1)
    return torch.where(is_prefix, count, num_point).to(torch.int32)


class GeometricStructureEmbedding(nn.Module):
    """Pairwise distance + k-NN triplet angle embedding for superpoints.

    ``reduction_a="max"`` (every shipped configuration) runs the fused GSE
    kernel. ``"mean"`` takes the einsum route on every device, the card
    included: the JAX package runs its Pallas GSE kernel only for "max" and
    computes the mean in XLA (``geotransformer_tpu/models/transformer.py:87,
    150-155``), so the mean has no kernel to port. ``force=True`` with
    "mean" raises rather than quietly taking the einsum route. Unlike the
    kernel, the mean route leaves pairs outside the valid rectangle as they
    come, as the XLA path does.

    ``basis_dtype`` and ``embed_dtype`` are the fused embedding's precision
    point (:func:`gse_embedding_full`) on the kernel and the plain route.
    The mean route ignores them, as the JAX package's XLA mean does.
    """

    def __init__(self, hidden_dim, sigma_d, sigma_a, angle_k, reduction_a="max",
                 force=None, basis_dtype=torch.float32, embed_dtype=torch.float32):
        super().__init__()
        if reduction_a not in ("max", "mean"):
            raise ValueError(f"Unsupported reduction mode: {reduction_a}")
        if reduction_a == "mean" and force:
            raise NotImplementedError(
                "reduction_a='mean' has no GSE kernel (neither has the JAX package); "
                "leave force_pallas unset")
        self.reduction_a = reduction_a
        self.sigma_d = sigma_d
        self.sigma_a = sigma_a
        self.angle_k = angle_k
        self.force = force
        self.basis_dtype, self.embed_dtype = basis_dtype, embed_dtype
        self.proj_d = nn.Linear(hidden_dim, hidden_dim)
        self.proj_a = nn.Linear(hidden_dim, hidden_dim)

    def reference_vectors(self, points, masks=None):
        """(B, N, k, 3) vectors from each point to its k nearest valid
        neighbors, self excluded (``models/transformer.py:66-74``)."""
        knn_dists = torch.sqrt(pairwise_distance(points, points))
        if masks is not None:
            knn_dists = torch.where(masks[:, None, :], knn_dists, 1e12)
        knn_indices = torch.topk(knn_dists, self.angle_k + 1, dim=-1, largest=False).indices
        knn_indices = knn_indices[:, :, 1:]  # drop self (column 0)
        knn_points = torch.stack([p[idx] for p, idx in zip(points, knn_indices)])
        return knn_points - points[:, :, None, :]

    def forward(self, points, masks=None):
        """(B, N, 3) points [, (B, N) masks] -> (B, N, N, hidden) embedding."""
        batch_size, num_point, _ = points.shape
        ref_vectors = self.reference_vectors(points, masks)
        if self.reduction_a == "mean":
            return torch.stack([self._mean_embedding(points[b].detach(), ref_vectors[b].detach())
                                for b in range(batch_size)])
        if masks is None:
            n_valid = torch.full((batch_size,), num_point, dtype=torch.int32, device=points.device)
        else:
            n_valid = prefix_valid_count(masks, num_point)
        w_d = self.proj_d.weight.t().contiguous()
        w_a = self.proj_a.weight.t().contiguous()
        embed = gse_embedding_full_diff if torch.is_grad_enabled() else gse_embedding_full
        return torch.stack([
            embed(points[b].contiguous(), ref_vectors[b].contiguous(), w_d, self.proj_d.bias,
                  w_a, self.proj_a.bias, self.sigma_d, self.sigma_a, n_valid[b],
                  force=self.force, basis_dtype=self.basis_dtype, embed_dtype=self.embed_dtype)
            for b in range(batch_size)
        ])

    def _mean_embedding(self, points, ref_vectors):
        """(N, N, C) embedding of one cloud with the angle terms averaged
        over the k reference vectors."""
        hidden = self.proj_d.out_features
        d_idx, a_idx = _pair_indices(points, ref_vectors, self.sigma_d, self.sigma_a)
        e_d = self.proj_d(sinusoidal_embedding(d_idx, hidden))
        e_a = self.proj_a(sinusoidal_embedding(a_idx, hidden)).mean(dim=2)
        return e_d + e_a


def _split_heads(x, num_heads):
    b, n, c = x.shape
    return x.reshape(b, n, num_heads, c // num_heads).permute(0, 2, 1, 3)


def _merge_heads(x):
    b, h, n, c = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * c)


def _masked_softmax(scores, key_masks):
    """Softmax over the last axis with masked keys set to the dtype minimum."""
    if key_masks is not None:
        neg = torch.finfo(scores.dtype).min
        scores = torch.where(key_masks[:, None, None, :], scores, neg)
    return torch.softmax(scores, dim=-1)


class MultiHeadAttention(nn.Module):
    """Vanilla scaled dot-product attention (keys maskable).

    Unless ``force`` is False, the whole QK^T -> masked softmax -> AV chain
    runs in :func:`fused_masked_attention` (the CUDA kernel on the card):
    ``key_masks`` masks keys, ``input_masks`` zeroes padded query rows.
    ``force=False`` takes the einsum path."""

    def __init__(self, d_model, num_heads, force=None):
        super().__init__()
        self.num_heads = num_heads
        self.force = force
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)

    def forward(self, input_q, input_k, input_v, key_masks=None, input_masks=None):
        q = _split_heads(self.proj_q(input_q), self.num_heads)
        k = _split_heads(self.proj_k(input_k), self.num_heads)
        v = _split_heads(self.proj_v(input_v), self.num_heads)
        d_head = q.shape[-1]
        if self.force is not False:
            return _fused_attention(q, k, v, None, input_masks, key_masks, d_head, self.force)
        scores = torch.einsum("bhnc,bhmc->bhnm", q, k) / math.sqrt(d_head)
        scores = _masked_softmax(scores, key_masks)
        return _merge_heads(torch.einsum("bhnm,bhmc->bhnc", scores, v))


class RPEMultiHeadAttention(nn.Module):
    """Attention with a pairwise geometric bias: score += q . proj_p(e).

    ``proj_p`` is applied on the query side (the JAX ``_PairBiasProjection``,
    ``models/transformer.py:226-275``): q . (e W + b) = e . (W q) + q . b, so
    the (B, N, M, C) embedding is never projected. Unless ``force`` is
    False, :func:`rpe_pair_scores` computes e . (W q) and feeds it as the
    bias of :func:`fused_masked_attention`; the q . b term, the same for
    every key of a row, is dropped (the softmax does not see it, so
    ``proj_p.bias`` gets a gradient of exact zeros). RPE attention is
    self-attention: the key mask is the query mask too.
    """

    def __init__(self, d_model, num_heads, force=None):
        super().__init__()
        self.num_heads = num_heads
        self.force = force
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.proj_p = nn.Linear(d_model, d_model)

    def forward(self, input_q, input_k, input_v, embed_qk, key_masks=None):
        q = _split_heads(self.proj_q(input_q), self.num_heads)
        k = _split_heads(self.proj_k(input_k), self.num_heads)
        v = _split_heads(self.proj_v(input_v), self.num_heads)
        d_model = self.proj_p.weight.shape[0]
        d_head = d_model // self.num_heads
        w = self.proj_p.weight.t().reshape(d_model, self.num_heads, d_head)
        if self.force is not False:
            # b_p joins the graph with weight 0: its gradient is an exact 0,
            # not None, so the optimizer's weight decay reaches it as in JAX
            qw = torch.einsum("bhnc,dhc->bnhd", q, w) + 0.0 * self.proj_p.bias.sum()
            return _fused_attention(q, k, v, (embed_qk, qw), key_masks, key_masks, d_head,
                                    self.force)
        qw = torch.einsum("bhnc,dhc->bhnd", q, w)
        # a bfloat16 embedding widens exactly (the JAX einsum promotes it)
        scores_p = torch.einsum("bnmd,bhnd->bhnm", embed_qk.to(qw.dtype), qw)
        qb = torch.einsum("bhnc,hc->bhn", q, self.proj_p.bias.reshape(self.num_heads, d_head))
        scores_e = torch.einsum("bhnc,bhmc->bhnm", q, k)
        scores = (scores_e + scores_p + qb[..., None]) / math.sqrt(d_head)
        scores = _masked_softmax(scores, key_masks)
        return _merge_heads(torch.einsum("bhnm,bhmc->bhnc", scores, v))


def _fused_attention(q, k, v, pair, input_masks, key_masks, d_head, force, bias=None):
    """(B, N, H * dh) attention of (B, H, N, dh) heads, one batch element at
    a time through the kernels: ``pair`` is None or (embed (B, N, M, C),
    qw (B, N, H, C)) for the RPE bias; ``bias`` is None or a (B, N, H, M)
    additive score bias taken as it is. Valid counts come from the masks
    (:func:`prefix_valid_count`); the kernel also takes the whole key mask,
    so a non-prefix mask is honoured."""
    grad = torch.is_grad_enabled()
    pair_scores = rpe_pair_scores_diff if grad else rpe_pair_scores
    attend = fused_masked_attention_diff if grad else fused_masked_attention
    batch_size, _, num_q, _ = q.shape
    num_k = k.shape[2]
    nv_k = None if key_masks is None else prefix_valid_count(key_masks, num_k)
    if input_masks is key_masks:  # self-attention: one mask, one count
        nv_q = nv_k
    else:
        nv_q = None if input_masks is None else prefix_valid_count(input_masks, num_q)
    hidden = []
    for b in range(batch_size):
        nq = None if nv_q is None else nv_q[b]
        nk = None if nv_k is None else nv_k[b]
        bias_b = None if bias is None else bias[b].contiguous()
        if pair is not None:
            embed, qw = pair
            bias_b = pair_scores(embed[b].contiguous(), qw[b].contiguous(), nq, nk, force=force)
        hidden.append(attend(q[b].contiguous(), k[b].contiguous(), v[b].contiguous(), bias_b, nq,
                             nk, float(d_head) ** -0.5,
                             None if key_masks is None else key_masks[b].contiguous(),
                             force=force))
    return torch.stack(hidden)


class AttentionOutput(nn.Module):
    """Post-LN feed-forward: expand x2 -> ReLU -> squeeze -> residual LN."""

    def __init__(self, d_model):
        super().__init__()
        self.expand = nn.Linear(d_model, 2 * d_model)
        self.squeeze = nn.Linear(2 * d_model, d_model)
        self.norm = nn.LayerNorm(d_model)

    def forward(self, input_states):
        hidden = self.squeeze(torch.relu(self.expand(input_states)))
        return self.norm(input_states + hidden)


class AttentionLayer(nn.Module):
    def __init__(self, d_model, num_heads, force=None):
        super().__init__()
        self.attention = MultiHeadAttention(d_model, num_heads, force=force)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model)

    def forward(self, input_states, memory_states, memory_masks=None, input_masks=None):
        hidden = self.attention(input_states, memory_states, memory_states,
                                key_masks=memory_masks, input_masks=input_masks)
        return self.norm(self.linear(hidden) + input_states)


class RPEAttentionLayer(nn.Module):
    def __init__(self, d_model, num_heads, force=None):
        super().__init__()
        self.attention = RPEMultiHeadAttention(d_model, num_heads, force=force)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model)

    def forward(self, input_states, memory_states, position_states, memory_masks=None):
        hidden = self.attention(input_states, memory_states, memory_states,
                                position_states, key_masks=memory_masks)
        return self.norm(self.linear(hidden) + input_states)


class TransformerLayer(nn.Module):
    def __init__(self, d_model, num_heads, force=None):
        super().__init__()
        self.attention = AttentionLayer(d_model, num_heads, force=force)
        self.output = AttentionOutput(d_model)

    def forward(self, input_states, memory_states, memory_masks=None, input_masks=None):
        return self.output(self.attention(input_states, memory_states, memory_masks,
                                          input_masks))


class RPETransformerLayer(nn.Module):
    def __init__(self, d_model, num_heads, force=None):
        super().__init__()
        self.attention = RPEAttentionLayer(d_model, num_heads, force=force)
        self.output = AttentionOutput(d_model)

    def forward(self, input_states, memory_states, position_states, memory_masks=None):
        return self.output(self.attention(input_states, memory_states, position_states,
                                          memory_masks))


class TransformerDecoderLayer(nn.Module):
    """Self-attention, cross-attention, feed-forward (reference
    vanilla_transformer.py:132-143). Keys are masked; no query row is
    zeroed, as in the JAX layer."""

    def __init__(self, d_model, num_heads, force=None):
        super().__init__()
        self.self_attention = AttentionLayer(d_model, num_heads, force=force)
        self.cross_attention = AttentionLayer(d_model, num_heads, force=force)
        self.output = AttentionOutput(d_model)

    def forward(self, input_states, memory_states, input_masks=None, memory_masks=None):
        hidden = self.self_attention(input_states, input_states, memory_masks=input_masks)
        hidden = self.cross_attention(hidden, memory_states, memory_masks=memory_masks)
        return self.output(hidden)


class TransformerEncoder(nn.Module):
    """A stack of self-attention layers (reference
    vanilla_transformer.py:146-177); ``masks`` masks the keys. The
    feed-forward activation is ReLU, the JAX default (``activation_fn``)."""

    def __init__(self, d_model, num_heads, num_layers, force=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerLayer(d_model, num_heads, force=force) for _ in range(num_layers)])

    def forward(self, feats, masks=None):
        for layer in self.layers:
            feats = layer(feats, feats, memory_masks=masks)
        return feats


class TransformerDecoder(nn.Module):
    """A stack of decoder layers (reference vanilla_transformer.py:180-201):
    ``q_feats`` attend to themselves, then to ``s_feats``."""

    def __init__(self, d_model, num_heads, num_layers, force=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [TransformerDecoderLayer(d_model, num_heads, force=force)
             for _ in range(num_layers)])

    def forward(self, q_feats, s_feats, q_masks=None, s_masks=None):
        for layer in self.layers:
            q_feats = layer(q_feats, s_feats, input_masks=q_masks, memory_masks=s_masks)
        return q_feats


class RPEConditionalTransformer(nn.Module):
    """Interleaved geometric self-attention / vanilla cross-attention stack
    (sequential cross updates: src attends to the updated ref)."""

    def __init__(self, blocks, d_model, num_heads, force=None):
        super().__init__()
        self.blocks = tuple(blocks)
        layers = []
        for block in self.blocks:
            if block == "self":
                layers.append(RPETransformerLayer(d_model, num_heads, force=force))
            elif block == "cross":
                layers.append(TransformerLayer(d_model, num_heads, force=force))
            else:
                raise ValueError(f"Unsupported block type: {block}")
        self.layers = nn.ModuleList(layers)

    def forward(self, feats0, feats1, embeddings0, embeddings1, masks0=None, masks1=None):
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                feats0 = layer(feats0, feats0, embeddings0, memory_masks=masks0)
                feats1 = layer(feats1, feats1, embeddings1, memory_masks=masks1)
            else:
                feats0 = layer(feats0, feats1, memory_masks=masks1, input_masks=masks0)
                feats1 = layer(feats1, feats0, memory_masks=masks0, input_masks=masks1)
        return feats0, feats1


class GeometricTransformer(nn.Module):
    """GSE + conditional transformer with in/out projections
    (reference geotransformer.py:75-155)."""

    def __init__(self, input_dim, output_dim, hidden_dim, num_heads, blocks, sigma_d,
                 sigma_a, angle_k, reduction_a="max", force=None, basis_dtype=torch.float32,
                 embed_dtype=torch.float32):
        super().__init__()
        self.embedding = GeometricStructureEmbedding(
            hidden_dim, sigma_d, sigma_a, angle_k, reduction_a, force=force,
            basis_dtype=basis_dtype, embed_dtype=embed_dtype)
        self.in_proj = nn.Linear(input_dim, hidden_dim)
        self.transformer = RPEConditionalTransformer(blocks, hidden_dim, num_heads, force=force)
        self.out_proj = nn.Linear(hidden_dim, output_dim)

    def forward(self, ref_points, src_points, ref_feats, src_feats, ref_masks=None,
                src_masks=None):
        ref_embeddings = self.embedding(ref_points, ref_masks)
        src_embeddings = self.embedding(src_points, src_masks)
        ref_feats, src_feats = self.transformer(
            self.in_proj(ref_feats), self.in_proj(src_feats),
            ref_embeddings, src_embeddings, masks0=ref_masks, masks1=src_masks)
        ref_feats = self.out_proj(ref_feats)
        src_feats = self.out_proj(src_feats)
        if ref_masks is not None:
            ref_feats = ref_feats * ref_masks[..., None].to(ref_feats.dtype)
        if src_masks is not None:
            src_feats = src_feats * src_masks[..., None].to(src_feats.dtype)
        return ref_feats, src_feats
