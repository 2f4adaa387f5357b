"""A shared fixture of the port's tests that build batches in both
packages and compare them.

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
