r"""Registration metrics, masked (``geotransformer_tpu/losses/metrics.py``;
reference `modules/registration/metrics.py:8-111`)."""

import math

import torch

from geotransformer_tpu_torch.ops.pairwise_distance import pairwise_distance
from geotransformer_tpu_torch.ops.se3 import (
    apply_transform,
    get_rotation_translation_from_transform,
    inverse_transform,
)


def _masked_mean(values, masks):
    if masks is None:
        return values.mean()
    m = masks.to(values.dtype)
    return torch.sum(values * m) / torch.clamp(torch.sum(m), min=1.0)


def relative_rotation_error(gt_rotations, rotations):
    """RRE in degrees: acos((trace(R^T R_gt) - 1) / 2)."""
    mat = torch.einsum("...ij,...ik->...jk", rotations, gt_rotations)
    trace = mat[..., 0, 0] + mat[..., 1, 1] + mat[..., 2, 2]
    return 180.0 / math.pi * torch.arccos(torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0))


def relative_translation_error(gt_translations, translations):
    """RTE: Euclidean distance between translations."""
    return torch.linalg.vector_norm(gt_translations - translations, dim=-1)


def isotropic_transform_error(gt_transforms, transforms):
    """(RRE deg, RTE) of (*, 4, 4) transforms."""
    gt_r, gt_t = get_rotation_translation_from_transform(gt_transforms)
    r, t = get_rotation_translation_from_transform(transforms)
    return relative_rotation_error(gt_r, r), relative_translation_error(gt_t, t)


def registration_rmse(src_points, gt_transform, est_transform, masks=None):
    """Mean realignment residual of the src points (reference Evaluator,
    `experiments/.../loss.py:140-143`)."""
    realigned = apply_transform(src_points, inverse_transform(gt_transform) @ est_transform)
    return _masked_mean(torch.linalg.vector_norm(realigned - src_points, dim=-1), masks)


def inlier_ratio(ref_corr_points, src_corr_points, gt_transform, radius, masks=None):
    """Fraction of correspondences within ``radius`` under the GT transform."""
    dists = torch.linalg.vector_norm(
        ref_corr_points - apply_transform(src_corr_points, gt_transform), dim=-1)
    return _masked_mean((dists < radius).float(), masks)


def modified_chamfer_distance(raw_points, ref_points, src_points, gt_transform, transform,
                              raw_masks=None, ref_masks=None, src_masks=None):
    """Modified Chamfer distance (reference metrics.py:8-44), masked: masked
    raw points sit at the squared distance 1e12, masked ref and src points
    leave their means. The numpy form for one unpadded pair is
    ``utils.registration.compute_modified_chamfer_distance``."""

    def masked_min(d2, col_masks):
        if col_masks is not None:
            d2 = torch.where(col_masks[None, :], d2, 1e12)
        return torch.min(d2, dim=-1).values

    aligned_src = apply_transform(src_points, transform)
    d2_pq = pairwise_distance(aligned_src, raw_points)
    chamfer_pq = _masked_mean(torch.sqrt(masked_min(d2_pq, raw_masks)), src_masks)

    composed = transform @ inverse_transform(gt_transform)
    aligned_raw = apply_transform(raw_points, composed)
    d2_qp = pairwise_distance(ref_points, aligned_raw)
    chamfer_qp = _masked_mean(torch.sqrt(masked_min(d2_qp, raw_masks)), ref_masks)
    return chamfer_pq + chamfer_qp
