"""Shared fixtures of the port's tests that run both packages.

``numpy_pyramids``, for the tests that build batches in both packages and
compare them:

Both packages read ``GEOTRANSFORMER_TPU_NATIVE``; the port takes its native
library unless it is ``0``, the JAX package takes its own whenever it
builds and falls back to numpy silently. The two routes order neighbors
differently on exact distance ties, so a comparison pins both packages to
the numpy route: a JAX library that failed to build would otherwise put
JAX numpy tables against the port's native ones. Set in ``os.environ``, so
spawned loader workers and rank subprocesses inherit it.
"""

import os

import pytest


@pytest.fixture(autouse=True, scope="module")
def numpy_pyramids():
    saved = os.environ.get("GEOTRANSFORMER_TPU_NATIVE")
    os.environ["GEOTRANSFORMER_TPU_NATIVE"] = "0"
    yield
    if saved is None:
        os.environ.pop("GEOTRANSFORMER_TPU_NATIVE", None)
    else:
        os.environ["GEOTRANSFORMER_TPU_NATIVE"] = saved


@pytest.fixture(autouse=True, scope="module")
def jax_precision_kept():
    """The JAX kernel modules' precision globals put back as they were
    before the module ran. The port's tests hand the JAX package
    configurations pinned to the float32 point (the port's default, which
    the port honours); the JAX ``create_model`` and ``prepare_pair`` install
    a configuration's point process-wide (``apply_precision``), so without
    this a later module in the same worker would run the JAX kernels at
    float32 instead of their bfloat16 defaults."""
    from geotransformer_tpu.kernels import gse, kpconv

    saved = kpconv.TABLE_DTYPE, kpconv.MXU_DTYPE, gse.BASIS_DTYPE, gse.EMBED_DTYPE
    yield
    kpconv.TABLE_DTYPE, kpconv.MXU_DTYPE, gse.BASIS_DTYPE, gse.EMBED_DTYPE = saved
