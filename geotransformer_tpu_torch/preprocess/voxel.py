r"""Voxel-grid subsampling (host side, numpy).

Same code as ``geotransformer_tpu/preprocess/voxel.py``, which cannot be
imported without JAX (its package ``__init__`` pulls in the on-device
pyramid). Sort-by-voxel-id + segment-mean: the grid origin is
``floor(min/voxel)*voxel`` per cloud and each occupied voxel emits the mean
of its points, ordered by flat voxel id.
"""

import numpy as np


def grid_subsample_single(points, voxel_size):
    """Subsample one cloud: mean of points per occupied voxel.

    Args:
        points: (N, 3) float array.
        voxel_size: float voxel edge length.

    Returns:
        (M, 3) float32 array of voxel means, ordered by flat voxel id.
    """
    points = np.asarray(points, dtype=np.float64)
    origin = np.floor(points.min(axis=0) / voxel_size) * voxel_size
    cell = np.floor((points - origin) / voxel_size).astype(np.int64)  # (N, 3)
    n_xy = cell.max(axis=0) + 1
    flat = cell[:, 0] + n_xy[0] * cell[:, 1] + n_xy[0] * n_xy[1] * cell[:, 2]
    uniq, inverse = np.unique(flat, return_inverse=True)
    sums = np.zeros((uniq.shape[0], 3), dtype=np.float64)
    np.add.at(sums, inverse, points)
    counts = np.bincount(inverse, minlength=uniq.shape[0]).astype(np.float64)
    return (sums / counts[:, None]).astype(np.float32)


def grid_subsample(points, lengths, voxel_size):
    """Stack-mode voxel subsampling over a batch of concatenated clouds.

    Args:
        points: (N, 3) stacked points.
        lengths: (B,) int array of cloud sizes.
        voxel_size: float.

    Returns:
        s_points: (M, 3) stacked subsampled points.
        s_lengths: (B,) int64 subsampled sizes.
    """
    s_clouds = []
    s_lengths = []
    start = 0
    for length in np.asarray(lengths):
        cloud = grid_subsample_single(points[start : start + length], voxel_size)
        s_clouds.append(cloud)
        s_lengths.append(cloud.shape[0])
        start += length
    return np.concatenate(s_clouds, axis=0), np.asarray(s_lengths, dtype=np.int64)
