r"""Ablation transformer variants: vanilla, absolute-PE and learnable-RPE
(``geotransformer_tpu/models/transformer_variants.py``; reference
`modules/transformer/conditional_transformer.py`, `pe_transformer.py`,
`lrpe_transformer.py`). No shipped configuration uses them. The
feed-forward activation is ReLU, the JAX modules' default
(``activation_fn``; no caller sets another).

Unless ``force`` is False, every attention goes through
:func:`~geotransformer_tpu_torch.kernels.attention.fused_masked_attention`
(the CUDA kernel on the card, its plain version on the CPU):

  * the vanilla layers are the port's :class:`TransformerLayer`;
  * PE attention passes its projected ``q + P e_q`` and ``k + P e_k``;
  * LRPE attention passes the learnable scores ``q . E[idx]``, gathered by
    a PyTorch indexing op from the (B, H, N, num_embeddings) bank products,
    as the kernel's additive bias.

No query mask is given to the kernel: as in the JAX modules, padded query
rows are computed like the others, so both routes match the JAX outputs on
every row. Where the JAX modules return the attention scores, the einsum
route (``force=False``) returns them too, and the kernel route returns
None: it never writes them.

Module and parameter names follow the flax tree, so
:func:`geotransformer_tpu_torch.utils.convert.variables_to_state_dict` maps
the JAX variables onto these modules (the LRPE bank under
``embedding.embeddings``, its LayerNorm under ``embedding.norm``).
"""

import math

import torch
from torch import nn

from geotransformer_tpu_torch.models.transformer import (
    AttentionOutput,
    TransformerLayer,
    _fused_attention,
    _masked_softmax,
    _merge_heads,
    _split_heads,
)


def _attend(q, k, v, key_masks, force, bias=None):
    """(hidden (B, N, H * dh), scores or None) of (B, H, N, dh) heads, the
    pre-scale ``bias`` (B, H, N, M) added to q k^T."""
    d_head = q.shape[-1]
    if force is not False:
        kernel_bias = None if bias is None else bias.permute(0, 2, 1, 3)
        return _fused_attention(q, k, v, None, None, key_masks, d_head, force,
                                bias=kernel_bias), None
    scores = torch.einsum("bhnc,bhmc->bhnm", q, k)
    if bias is not None:
        scores = scores + bias
    scores = _masked_softmax(scores / math.sqrt(d_head), key_masks)
    return _merge_heads(torch.einsum("bhnm,bhmc->bhnc", scores, v)), scores


class PEMultiHeadAttention(nn.Module):
    """Absolute positional embeddings, projected by ``proj_p``, added to
    the projected queries and keys."""

    def __init__(self, d_model, num_heads, force=None):
        super().__init__()
        self.num_heads = num_heads
        self.force = force
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.proj_p = nn.Linear(d_model, d_model)

    def forward(self, input_q, input_k, input_v, embed_q, embed_k, key_masks=None):
        q = _split_heads(self.proj_q(input_q) + self.proj_p(embed_q), self.num_heads)
        k = _split_heads(self.proj_k(input_k) + self.proj_p(embed_k), self.num_heads)
        v = _split_heads(self.proj_v(input_v), self.num_heads)
        return _attend(q, k, v, key_masks, self.force)


class PETransformerLayer(nn.Module):
    def __init__(self, d_model, num_heads, force=None):
        super().__init__()
        self.attention = PEMultiHeadAttention(d_model, num_heads, force=force)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model)
        self.output = AttentionOutput(d_model)

    def forward(self, input_states, memory_states, embed_q, embed_k, memory_masks=None):
        hidden, scores = self.attention(input_states, memory_states, memory_states, embed_q,
                                        embed_k, key_masks=memory_masks)
        hidden = self.norm(self.linear(hidden) + input_states)
        return self.output(hidden), scores


class LearnablePositionalEmbedding(nn.Module):
    """Embedding bank + LayerNorm (reference positional_embedding.py:37-65);
    indices past the bank read its last row."""

    def __init__(self, num_embeddings, embedding_dim):
        super().__init__()
        self.embeddings = nn.Parameter(torch.randn(num_embeddings, embedding_dim))
        self.norm = nn.LayerNorm(embedding_dim)

    def forward(self, emb_indices):
        emb_indices = torch.clamp(emb_indices, max=self.embeddings.shape[0] - 1)
        return self.norm(self.embeddings[emb_indices])


class LRPEMultiHeadAttention(nn.Module):
    """Learnable relative positional scores q . E[idx], gathered by a
    discrete (B, N, M) relative index."""

    def __init__(self, d_model, num_heads, num_embeddings, force=None):
        super().__init__()
        self.num_heads = num_heads
        self.num_embeddings = num_embeddings
        self.force = force
        self.proj_q = nn.Linear(d_model, d_model)
        self.proj_k = nn.Linear(d_model, d_model)
        self.proj_v = nn.Linear(d_model, d_model)
        self.embedding = LearnablePositionalEmbedding(num_embeddings, d_model)

    def forward(self, input_q, input_k, input_v, emb_indices_qk, key_masks=None):
        q = _split_heads(self.proj_q(input_q), self.num_heads)
        k = _split_heads(self.proj_k(input_k), self.num_heads)
        v = _split_heads(self.proj_v(input_v), self.num_heads)
        batch_size, num_heads, num_q, d_head = q.shape
        bank = self.embedding(torch.arange(self.num_embeddings, device=q.device))
        bank = bank.reshape(self.num_embeddings, num_heads, d_head)
        scores_bank = torch.einsum("bhnc,phc->bhnp", q, bank)  # (B, H, N, P)
        idx = torch.clamp(emb_indices_qk, 0, self.num_embeddings - 1).long()
        idx = idx[:, None].expand(batch_size, num_heads, num_q, idx.shape[-1])
        return _attend(q, k, v, key_masks, self.force, bias=torch.gather(scores_bank, 3, idx))


class LRPETransformerLayer(nn.Module):
    def __init__(self, d_model, num_heads, num_embeddings, force=None):
        super().__init__()
        self.attention = LRPEMultiHeadAttention(d_model, num_heads, num_embeddings, force=force)
        self.linear = nn.Linear(d_model, d_model)
        self.norm = nn.LayerNorm(d_model)
        self.output = AttentionOutput(d_model)

    def forward(self, input_states, memory_states, emb_indices, memory_masks=None):
        hidden, scores = self.attention(input_states, memory_states, memory_states, emb_indices,
                                        key_masks=memory_masks)
        hidden = self.norm(self.linear(hidden) + input_states)
        return self.output(hidden), scores


def _check_blocks(blocks):
    for block in blocks:
        if block not in ("self", "cross"):
            raise ValueError(f"Unsupported block type: {block}")
    return tuple(blocks)


class VanillaConditionalTransformer(nn.Module):
    """Self and cross blocks of vanilla attention (sequential cross
    updates: feats1 attends to the updated feats0)."""

    def __init__(self, blocks, d_model, num_heads, force=None):
        super().__init__()
        self.blocks = _check_blocks(blocks)
        self.layers = nn.ModuleList(TransformerLayer(d_model, num_heads, force=force)
                                    for _ in self.blocks)

    def forward(self, feats0, feats1, masks0=None, masks1=None):
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                feats0 = layer(feats0, feats0, memory_masks=masks0)
                feats1 = layer(feats1, feats1, memory_masks=masks1)
            else:
                feats0 = layer(feats0, feats1, memory_masks=masks1)
                feats1 = layer(feats1, feats0, memory_masks=masks0)
        return feats0, feats1


class PEConditionalTransformer(nn.Module):
    """PE self blocks, vanilla cross blocks."""

    def __init__(self, blocks, d_model, num_heads, force=None):
        super().__init__()
        self.blocks = _check_blocks(blocks)
        self.layers = nn.ModuleList(
            PETransformerLayer(d_model, num_heads, force=force) if block == "self"
            else TransformerLayer(d_model, num_heads, force=force) for block in self.blocks)

    def forward(self, feats0, feats1, embeddings0, embeddings1, masks0=None, masks1=None):
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                feats0, _ = layer(feats0, feats0, embeddings0, embeddings0, memory_masks=masks0)
                feats1, _ = layer(feats1, feats1, embeddings1, embeddings1, memory_masks=masks1)
            else:
                feats0 = layer(feats0, feats1, memory_masks=masks1)
                feats1 = layer(feats1, feats0, memory_masks=masks0)
        return feats0, feats1


class LRPEConditionalTransformer(nn.Module):
    """LRPE self blocks, vanilla cross blocks."""

    def __init__(self, blocks, d_model, num_heads, num_embeddings, force=None):
        super().__init__()
        self.blocks = _check_blocks(blocks)
        self.layers = nn.ModuleList(
            LRPETransformerLayer(d_model, num_heads, num_embeddings, force=force)
            if block == "self" else TransformerLayer(d_model, num_heads, force=force)
            for block in self.blocks)

    def forward(self, feats0, feats1, emb_indices0, emb_indices1, masks0=None, masks1=None):
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                feats0, _ = layer(feats0, feats0, emb_indices0, memory_masks=masks0)
                feats1, _ = layer(feats1, feats1, emb_indices1, memory_masks=masks1)
            else:
                feats0 = layer(feats0, feats1, memory_masks=masks1)
                feats1 = layer(feats1, feats0, memory_masks=masks0)
        return feats0, feats1
