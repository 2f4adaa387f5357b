r"""Numpy point-cloud augmentations of the dataset samplers: the port's copy
of the sampling, jitter, shuffle and crop functions of
``geotransformer_tpu/datasets/transforms.py`` (reference
`transforms/functional.py`), drawing from ``np.random`` in the same order.
"""

import numpy as np


def normalize_points(points):
    """Center at origin, scale to unit sphere."""
    points = points - points.mean(axis=0)
    return points / np.max(np.linalg.norm(points, axis=1))


def random_sample_points(points, num_samples, normals=None):
    """Random subset; repeats points if fewer than requested."""
    num_points = points.shape[0]
    sel = np.random.permutation(num_points)
    if num_points > num_samples:
        sel = sel[:num_samples]
    elif num_points < num_samples:
        reps = [sel] * (num_samples // num_points)
        pad = num_samples % num_points
        if pad > 0:
            reps.append(sel[:pad])
        sel = np.concatenate(reps, axis=0)
    points = points[sel]
    if normals is not None:
        return points, normals[sel]
    return points


def random_jitter_points(points, scale, noise_magnitude=0.05):
    noise = np.clip(np.random.normal(scale=scale, size=points.shape),
                    -noise_magnitude, noise_magnitude)
    return points + noise


def random_shuffle_points(points, normals=None):
    indices = np.random.permutation(points.shape[0])
    points = points[indices]
    if normals is not None:
        return points, normals[indices]
    return points


def random_sample_plane():
    """Unit normal of a random plane through the origin."""
    phi = np.random.uniform(0.0, 2 * np.pi)
    theta = np.random.uniform(0.0, np.pi)
    return np.asarray([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)])


def random_crop_point_cloud_with_plane(points, p_normal=None, keep_ratio=0.7, normals=None):
    """Keep the ``keep_ratio`` fraction on one side of a random plane."""
    num_samples = int(np.floor(points.shape[0] * keep_ratio + 0.5))
    if p_normal is None:
        p_normal = random_sample_plane()
    distances = points @ p_normal
    sel = np.argsort(-distances)[:num_samples]
    points = points[sel]
    if normals is not None:
        return points, normals[sel]
    return points


def random_sample_viewpoint(limit=500):
    return np.random.rand(3) + np.asarray([limit, limit, limit]) * np.random.choice(
        [1.0, -1.0], size=3)


def random_crop_point_cloud_with_point(points, viewpoint=None, keep_ratio=0.7, normals=None):
    """Keep the ``keep_ratio`` fraction closest to a distant random viewpoint."""
    num_samples = int(np.floor(points.shape[0] * keep_ratio + 0.5))
    if viewpoint is None:
        viewpoint = random_sample_viewpoint()
    distances = np.linalg.norm(viewpoint - points, axis=1)
    sel = np.argsort(distances)[:num_samples]
    points = points[sel]
    if normals is not None:
        return points, normals[sel]
    return points
