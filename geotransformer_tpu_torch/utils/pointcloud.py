r"""Numpy point-cloud geometry for the host data pipeline: the port's copy of
``geotransformer_tpu/utils/pointcloud.py`` (reference `utils/pointcloud.py`):
SE(3) helpers, random rotations and transforms for augmentation (drawing
from ``np.random`` in the same order, so the same state gives the same
samples), nearest-neighbor queries (cKDTree), normal regularization and the
keypoint samplers.
"""

from typing import List

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


def compose_transforms(transforms: List[np.ndarray]) -> np.ndarray:
    """final = T_n @ ... @ T_1 (applied first-to-last)."""
    final = transforms[0]
    for transform in transforms[1:]:
        final = np.matmul(transform, final)
    return final


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


def random_sample_rotation(rotation_factor: float = 1.0) -> np.ndarray:
    """Uniform random rotation scaled by `rotation_factor` (reference
    pointcloud.py:112-116 semantics: random axis-angle via euler sampling)."""
    euler = np.random.rand(3) * np.pi * 2 / rotation_factor
    return Rotation.from_euler("zyx", euler).as_matrix()


def random_sample_rotation_v2() -> np.ndarray:
    """Uniform random rotation from a random axis + angle."""
    axis = np.random.rand(3) - 0.5
    axis = axis / (np.linalg.norm(axis) + 1e-8)
    theta = np.pi * np.random.rand()
    return Rotation.from_rotvec(axis * theta).as_matrix()


def random_sample_transform(rotation_magnitude, translation_magnitude):
    """Random SE(3) with Euler angles within +-``rotation_magnitude`` degrees."""
    euler = np.random.rand(3) * np.pi * rotation_magnitude / 180.0
    rotation = Rotation.from_euler("zyx", euler).as_matrix()
    translation = np.random.uniform(-translation_magnitude, translation_magnitude, 3)
    return get_transform_from_rotation_translation(rotation, translation)


def regularize_normals(points, normals, positive=True):
    """Flip normals to face the origin (or away if not positive)."""
    dot_products = -(points * normals).sum(axis=1, keepdims=True)
    direction = dot_products > 0
    if positive:
        normals = normals * direction - normals * (1 - direction)
    else:
        normals = normals * (1 - direction) - normals * direction
    return normals


def random_sample_keypoints(points, feats, num_keypoints):
    num_points = points.shape[0]
    if num_points > num_keypoints:
        indices = np.random.choice(num_points, num_keypoints, replace=False)
        points = points[indices]
        feats = feats[indices]
    return points, feats


def sample_keypoints_with_scores(points, feats, scores, num_keypoints):
    num_points = points.shape[0]
    if num_points > num_keypoints:
        indices = np.argsort(-scores)[:num_keypoints]
        points = points[indices]
        feats = feats[indices]
    return points, feats


def random_sample_keypoints_with_scores(points, feats, scores, num_keypoints):
    num_points = points.shape[0]
    if num_points > num_keypoints:
        probs = scores / np.sum(scores)
        indices = np.random.choice(num_points, num_keypoints, replace=False, p=probs)
        points = points[indices]
        feats = feats[indices]
    return points, feats


def sample_keypoints_with_nms(points, feats, scores, num_keypoints, radius):
    """Greedy score-ordered NMS keypoint selection."""
    num_points = points.shape[0]
    if num_points <= num_keypoints:
        return points, feats
    radius2 = radius**2
    masks = np.ones(num_points, dtype=bool)
    sorted_indices = np.argsort(scores)[::-1]
    indices = []
    for i in sorted_indices:
        if masks[i]:
            indices.append(i)
            if len(indices) == num_keypoints:
                break
            d2 = np.sum((points - points[i]) ** 2, axis=1)
            masks[d2 < radius2] = False
    indices = np.asarray(indices)
    return points[indices], feats[indices]


def convert_depth_mat_to_points(
    depth_mat, intrinsics, scaling_factor=1000.0, distance_limit=6.0
):
    """Back-project a depth image to 3D points (reference pointcloud.py:245-273)."""
    focal_x = intrinsics[0, 0]
    focal_y = intrinsics[1, 1]
    center_x = intrinsics[0, 2]
    center_y = intrinsics[1, 2]
    height, width = depth_mat.shape
    coords = np.arange(height * width)
    u = coords % width
    v = coords // width
    depth = depth_mat.flatten().astype(np.float64) / scaling_factor
    masks = np.logical_and(depth > 0, depth < distance_limit)
    depth, u, v = depth[masks], u[masks], v[masks]
    x = (u - center_x) * depth / focal_x
    y = (v - center_y) * depth / focal_y
    return np.stack([x, y, depth], axis=1)
