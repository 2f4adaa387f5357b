r"""Vector angle ops (``geotransformer_tpu/ops/vector_angle.py``; reference
`modules/ops/vector_angle.py:5-34`)."""

import math

import torch


def vector_angle(x, y):
    """Angle between vectors along the last axis, via atan2(|x×y|, x·y)."""
    cross = torch.linalg.vector_norm(torch.linalg.cross(x, y, dim=-1), dim=-1)
    dot = torch.sum(x * y, dim=-1)
    return torch.atan2(cross, dot)


def rad2deg(rad):
    return rad * (180.0 / math.pi)


def deg2rad(deg):
    return deg * (math.pi / 180.0)
