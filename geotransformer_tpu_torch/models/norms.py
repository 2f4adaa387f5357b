r"""Mask-aware GroupNorm (``geotransformer_tpu/models/norms.py``).

The reference applies ``nn.GroupNorm`` over the whole stacked point axis
(`modules/kpconv/modules.py:33-50`). With fixed-capacity padding the
statistics must exclude padded rows, so the norm takes a validity mask and
zeroes padded rows. Transformer LayerNorms are plain ``nn.LayerNorm``
(per-row, padding-safe, eps 1e-5).
"""

import torch
from torch import nn


def masked_group_norm(x, mask, num_groups, weight, bias, eps=1e-5):
    """GroupNorm of (N, C) features over (group channels x valid rows);
    padded rows (mask False) come out zero. ``mask=None``: all rows valid."""
    n, c = x.shape
    g = num_groups
    xg = x.reshape(n, g, c // g)
    if mask is None:
        count = float(n * (c // g))
        masked = xg
    else:
        m = mask[:, None, None].to(x.dtype)
        count = torch.clamp(mask.sum().to(x.dtype) * (c // g), min=1.0)
        masked = xg * m
    mean = masked.sum(dim=(0, 2)) / count  # (G,)
    centered = xg - mean[None, :, None]
    sq = centered**2
    if mask is not None:
        sq = sq * m
    var = sq.sum(dim=(0, 2)) / count
    out = centered / torch.sqrt(var[None, :, None] + eps)
    out = out.reshape(n, c) * weight[None, :] + bias[None, :]
    if mask is not None:
        out = out * mask[:, None].to(x.dtype)
    return out


class GroupNorm(nn.Module):
    """Affine GroupNorm over the stacked point axis with a padding mask.

    The affine parameters live in ``self.norm`` (an ``nn.GroupNorm``) so the
    state_dict keys are the reference wrapper's ``...norm.norm.weight``.
    """

    def __init__(self, num_groups, num_channels):
        super().__init__()
        self.num_groups = num_groups
        self.norm = nn.GroupNorm(num_groups, num_channels)

    def forward(self, x, mask=None):
        return masked_group_norm(x, mask, self.num_groups, self.norm.weight, self.norm.bias)
