r"""Numpy point-cloud geometry for the host data pipeline: the port's copy of
the part of ``geotransformer_tpu/utils/pointcloud.py`` that the ModelNet
dataset needs (SE(3) helpers, random transforms, nearest-neighbor
distances), so the same ``np.random`` state gives the same samples.
"""

import numpy as np
from scipy.spatial import cKDTree
from scipy.spatial.transform import Rotation


def get_nearest_neighbor(q_points, s_points, return_index=False):
    """Nearest support point distance (and index) for each query point."""
    tree = cKDTree(s_points)
    distances, indices = tree.query(q_points, k=1)
    if return_index:
        return distances, indices
    return distances


def apply_transform(points, transform, normals=None):
    rotation = transform[:3, :3]
    translation = transform[:3, 3]
    points = np.matmul(points, rotation.T) + translation
    if normals is not None:
        normals = np.matmul(normals, rotation.T)
        return points, normals
    return points


def get_transform_from_rotation_translation(rotation, translation):
    transform = np.eye(4)
    transform[:3, :3] = rotation
    transform[:3, 3] = translation
    return transform


def get_rotation_translation_from_transform(transform):
    return transform[:3, :3], transform[:3, 3]


def inverse_transform(transform):
    rotation, translation = get_rotation_translation_from_transform(transform)
    inv_rotation = rotation.T
    inv_translation = -np.matmul(inv_rotation, translation)
    return get_transform_from_rotation_translation(inv_rotation, inv_translation)


def random_sample_transform(rotation_magnitude, translation_magnitude):
    """Random SE(3) with Euler angles within +-``rotation_magnitude`` degrees."""
    euler = np.random.rand(3) * np.pi * rotation_magnitude / 180.0
    rotation = Rotation.from_euler("zyx", euler).as_matrix()
    translation = np.random.uniform(-translation_magnitude, translation_magnitude, 3)
    return get_transform_from_rotation_translation(rotation, translation)
