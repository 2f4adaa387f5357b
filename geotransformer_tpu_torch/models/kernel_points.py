r"""KPConv kernel-point disposition.

Read from the port's own copy of the cached disposition
(``models/dispositions/k_<K>_center_<D>d.npy``, byte-identical to the JAX
package's), so both packages convolve with the same kernel points. Unlike
the JAX ``load_kernel_points``, nothing is generated: a missing file is an
error.
"""

import os

import numpy as np

DISPOSITIONS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dispositions")


def disposition_path(num_points, dimension=3):
    return os.path.join(DISPOSITIONS_DIR, f"k_{num_points:03d}_center_{dimension}d.npy")


def load_kernel_points(radius, num_points, dimension=3):
    """(num_points, dimension) float32 kernel points scaled to ``radius``;
    row 0 is the center."""
    path = disposition_path(num_points, dimension)
    if not os.path.exists(path):
        raise FileNotFoundError(f"kernel-point disposition {path} is missing")
    return (np.load(path) * radius).astype(np.float32)
