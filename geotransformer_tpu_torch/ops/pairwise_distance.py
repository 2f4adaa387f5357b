r"""Pairwise squared distances (``geotransformer_tpu/ops/pairwise_distance.py``):
``d2 = |x|^2 - 2 x.y + |y|^2`` (or ``2 - 2 x.y`` for unit vectors), clamped
at zero."""

import torch


def pairwise_distance(x, y, normalized=False):
    """(*, N, C) x (*, M, C) -> (*, N, M) squared distances (>= 0)."""
    xy = torch.matmul(x, y.transpose(-1, -2))
    if normalized:
        sq_distances = 2.0 - 2.0 * xy
    else:
        x2 = torch.sum(x**2, dim=-1)[..., :, None]
        y2 = torch.sum(y**2, dim=-1)[..., None, :]
        sq_distances = x2 - 2.0 * xy + y2
    return torch.clamp(sq_distances, min=0.0)
