r"""Weighted Procrustes (Kabsch), SVD path (``geotransformer_tpu/models/procrustes.py``;
reference `modules/registration/procrustes.py:6-73`). The quaternion Kabsch
of the JAX package is not ported yet."""

import torch

from geotransformer_tpu_torch.ops.se3 import get_transform_from_rotation_translation


def rotation_from_covariance(H):
    """Proper rotation R = V diag(1, 1, det(V U^T)) U^T from the (B, 3, 3)
    cross-covariance H = U S V^T."""
    U, _, Vh = torch.linalg.svd(H)
    V = Vh.transpose(-1, -2)
    Ut = U.transpose(-1, -2)
    det = torch.linalg.det(V @ Ut)
    sign_fix = torch.eye(3, dtype=H.dtype, device=H.device).repeat(H.shape[0], 1, 1)
    sign_fix[:, 2, 2] = torch.sign(det)
    return V @ sign_fix @ Ut


def weighted_procrustes(src_points, ref_points, weights=None, weight_thresh=0.0,
                        eps=1e-5, return_transform=False):
    """Least-squares rigid transform src -> ref under per-point weights.

    Args:
        src_points, ref_points: (B, N, 3) or (N, 3).
        weights: (B, N) or (N,) non-negative; a zero weight drops a pair.

    Returns:
        (B, 4, 4) / (4, 4) transforms, or (R, t).
    """
    squeeze_first = src_points.dim() == 2
    if squeeze_first:
        src_points = src_points[None]
        ref_points = ref_points[None]
        if weights is not None:
            weights = weights[None]
    if weights is None:
        weights = torch.ones_like(src_points[:, :, 0])
    weights = torch.where(weights < weight_thresh, 0.0, weights)
    weights = weights / (weights.sum(dim=1, keepdim=True) + eps)
    w = weights[:, :, None]

    src_centroid = (src_points * w).sum(dim=1, keepdim=True)
    ref_centroid = (ref_points * w).sum(dim=1, keepdim=True)
    src_centered = src_points - src_centroid
    ref_centered = ref_points - ref_centroid
    H = torch.einsum("bnc,bnd->bcd", src_centered, w * ref_centered)
    R = rotation_from_covariance(H)
    t = ref_centroid[:, 0, :] - torch.einsum("bcd,bd->bc", R, src_centroid[:, 0, :])

    if return_transform:
        transform = get_transform_from_rotation_translation(R, t)
        return transform[0] if squeeze_first else transform
    if squeeze_first:
        return R[0], t[0]
    return R, t
