r"""Numpy point-cloud augmentations of the dataset samplers: the port's copy
of ``geotransformer_tpu/datasets/transforms.py`` (reference
`transforms/functional.py:7-162`): sampling, jitter, shuffle, dropout,
scale-shift, up-axis rotation, rescale and crops, drawing from
``np.random`` / ``random`` in the same order, so the same state gives the
same samples.
"""

import math
import random

import numpy as np


def normalize_points(points):
    """Center at origin, scale to unit sphere."""
    points = points - points.mean(axis=0)
    return points / np.max(np.linalg.norm(points, axis=1))


def sample_points(points, num_samples, normals=None):
    points = points[:num_samples]
    if normals is not None:
        return points, normals[:num_samples]
    return points


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


def random_dropout_points(points, max_p):
    num_points = points.shape[0]
    p = np.random.rand(num_points) * max_p
    masks = np.random.rand(num_points) < p
    points = points.copy()
    points[masks] = points[0]
    return points


def random_scale_shift_points(points, low=2.0 / 3.0, high=3.0 / 2.0, shift=0.2, normals=None):
    scale = np.random.uniform(low=low, high=high, size=(1, 3))
    bias = np.random.uniform(low=-shift, high=shift, size=(1, 3))
    points = points * scale + bias
    if normals is not None:
        normals = normals * scale
        normals = normals / np.linalg.norm(normals, axis=1, keepdims=True)
        return points, normals
    return points


def random_rotate_points_along_up_axis(points, normals=None):
    theta = np.random.rand() * 2.0 * math.pi
    rot_t = np.asarray([
        [math.cos(theta), math.sin(theta), 0.0],
        [-math.sin(theta), math.cos(theta), 0.0],
        [0.0, 0.0, 1.0],
    ])
    points = points @ rot_t
    if normals is not None:
        return points, normals @ rot_t
    return points


def random_rescale_points(points, low=0.8, high=1.2):
    return points * random.uniform(low, high)


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
