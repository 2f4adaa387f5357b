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

