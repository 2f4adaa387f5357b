r"""Weighted Procrustes (Kabsch) (``geotransformer_tpu/models/procrustes.py``;
reference `modules/registration/procrustes.py:6-73`): the SVD solution, and
Horn's quaternion method (``method="quat"``), which the JAX package takes on
a TPU. The port's model keeps SVD; the quaternion path is for callers who
ask for it by name."""

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


def rotation_from_covariance_quat(H, num_iterations=30):
    """Proper rotation from the (B, 3, 3) cross-covariance by Horn's
    quaternion method: the dominant eigenvector of the symmetric 4x4 matrix,
    shifted by its Gershgorin bound and squared once, by ``num_iterations``
    power iterations from the column with the largest diagonal (a fixed
    start vector is orthogonal to the answer for some 180-degree rotations).
    Branch-free, and det(R) = +1 by construction."""
    s00, s01, s02 = H[:, 0, 0], H[:, 0, 1], H[:, 0, 2]
    s10, s11, s12 = H[:, 1, 0], H[:, 1, 1], H[:, 1, 2]
    s20, s21, s22 = H[:, 2, 0], H[:, 2, 1], H[:, 2, 2]
    K = torch.stack([
        torch.stack([s00 + s11 + s22, s12 - s21, s20 - s02, s01 - s10], -1),
        torch.stack([s12 - s21, s00 - s11 - s22, s01 + s10, s20 + s02], -1),
        torch.stack([s20 - s02, s01 + s10, -s00 + s11 - s22, s12 + s21], -1),
        torch.stack([s01 - s10, s20 + s02, s12 + s21, -s00 - s11 + s22], -1),
    ], dim=-2)
    lam = K.abs().sum(dim=-1).amax(dim=-1)
    Ks = K + lam[:, None, None] * torch.eye(4, dtype=K.dtype, device=K.device)
    K2 = Ks @ Ks
    pivot = torch.diagonal(Ks, dim1=-2, dim2=-1).argmax(dim=-1)
    q = torch.take_along_dim(Ks, pivot[:, None, None], dim=-1)[:, :, 0]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-30)
    for _ in range(num_iterations):
        q = torch.einsum("bij,bj->bi", K2, q)
        q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-30)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


ROTATION_SOLVERS = {"svd": rotation_from_covariance, "quat": rotation_from_covariance_quat}


def weighted_procrustes(src_points, ref_points, weights=None, weight_thresh=0.0,
                        eps=1e-5, return_transform=False, method="svd"):
    """Least-squares rigid transform src -> ref under per-point weights.

    Args:
        src_points, ref_points: (B, N, 3) or (N, 3).
        weights: (B, N) or (N,) non-negative; a zero weight drops a pair.
        method: ``"svd"`` or ``"quat"`` (:func:`rotation_from_covariance_quat`).

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
    R = ROTATION_SOLVERS[method](H)
    t = ref_centroid[:, 0, :] - torch.einsum("bcd,bd->bc", R, src_centroid[:, 0, :])

    if return_transform:
        transform = get_transform_from_rotation_translation(R, t)
        return transform[0] if squeeze_first else transform
    if squeeze_first:
        return R[0], t[0]
    return R, t
