r"""SE(3) rigid-transform utilities (``geotransformer_tpu/ops/se3.py``,
reference `modules/ops/transformation.py`)."""

import torch


def apply_transform(points, transform):
    """Points (*, 3) with a (4, 4) transform, or (B, N, 3) with (B, 4, 4)."""
    rotation = transform[..., :3, :3]
    translation = transform[..., :3, 3]
    if transform.dim() == 2:
        return points @ rotation.T + translation
    return torch.einsum("...nc,...dc->...nd", points, rotation) + translation[..., None, :]


def apply_rotation(points, rotation):
    """Rotate points. rotation: (3, 3) or (B, 3, 3) matching points rank."""
    if rotation.dim() == 2:
        return points @ rotation.T
    return torch.einsum("...nc,...dc->...nd", points, rotation)


def get_transform_from_rotation_translation(rotation, translation):
    """Compose (.., 3, 3) rotation and (.., 3) translation into (.., 4, 4)."""
    batch_shape = rotation.shape[:-2]
    transform = torch.zeros(batch_shape + (4, 4), dtype=rotation.dtype, device=rotation.device)
    transform[..., :3, :3] = rotation
    transform[..., :3, 3] = translation
    transform[..., 3, 3] = 1.0
    return transform


def get_rotation_translation_from_transform(transform):
    """Split (.., 4, 4) transform into rotation (.., 3, 3), translation (.., 3)."""
    return transform[..., :3, :3], transform[..., :3, 3]


def inverse_transform(transform):
    """Inverse of a rigid transform: R^T, -R^T t."""
    rotation, translation = get_rotation_translation_from_transform(transform)
    inv_rotation = rotation.transpose(-1, -2)
    inv_translation = -torch.einsum("...dc,...c->...d", inv_rotation, translation)
    return get_transform_from_rotation_translation(inv_rotation, inv_translation)


def skew_symmetric_matrix(vectors):
    """Map (.., 3) vectors to (.., 3, 3) skew-symmetric cross-product matrices."""
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def rodrigues_rotation_matrix(axes, angles):
    """Rodrigues' formula: rotation matrices from (.., 3) axes and (..,) angles."""
    axes = axes / (torch.linalg.norm(axes, dim=-1, keepdim=True) + 1e-12)
    sin = torch.sin(angles)[..., None, None]
    cos = torch.cos(angles)[..., None, None]
    skew = skew_symmetric_matrix(axes)
    eye = torch.eye(3, dtype=axes.dtype, device=axes.device)
    return eye + sin * skew + (1.0 - cos) * (skew @ skew)


def rodrigues_alignment_matrix(src_vectors, ref_vectors):
    """Rotation matrices aligning each (.., 3) src vector onto the ref vector:
    the identity where they are parallel, minus the identity (a point
    reflection) where they are anti-parallel."""
    src = src_vectors / (torch.linalg.norm(src_vectors, dim=-1, keepdim=True) + 1e-12)
    ref = ref_vectors / (torch.linalg.norm(ref_vectors, dim=-1, keepdim=True) + 1e-12)
    axes = torch.linalg.cross(src, ref, dim=-1)
    sin = torch.linalg.norm(axes, dim=-1)
    cos = torch.sum(src * ref, dim=-1)
    skew = skew_symmetric_matrix(axes / (sin[..., None] + 1e-12))
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    rot = eye + sin[..., None, None] * skew + (1.0 - cos)[..., None, None] * (skew @ skew)
    parallel = sin < 1e-6
    flip = torch.where(cos[..., None, None] > 0.0, eye, -eye)
    return torch.where(parallel[..., None, None], flip, rot)
