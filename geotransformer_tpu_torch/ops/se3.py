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
