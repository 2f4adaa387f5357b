r"""KPConv kernel-point disposition.

Read in place from the JAX package's cached disposition
(``geotransformer_tpu/models/dispositions/k_<K>_center_<D>d.npy``), so both
packages convolve with the same kernel points. Unlike the JAX
``load_kernel_points``, nothing is generated: a missing file is an error.
"""

import os

import numpy as np

import geotransformer_tpu


def disposition_path(num_points, dimension=3):
    return os.path.join(os.path.dirname(os.path.abspath(geotransformer_tpu.__file__)),
                        "models", "dispositions",
                        f"k_{num_points:03d}_center_{dimension}d.npy")


def load_kernel_points(radius, num_points, dimension=3):
    """(num_points, dimension) float32 kernel points scaled to ``radius``;
    row 0 is the center."""
    path = disposition_path(num_points, dimension)
    if not os.path.exists(path):
        raise FileNotFoundError(f"kernel-point disposition {path} is missing")
    return (np.load(path) * radius).astype(np.float32)
