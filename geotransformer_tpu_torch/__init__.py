r"""geotransformer_tpu_torch: the PyTorch/CUDA port of geotransformer_tpu.

The 3DMatch inference path of the JAX package — host pyramid, KPConv FPN,
geometric transformer, superpoint matching, learnable Sinkhorn and
local-to-global registration — in PyTorch, with the four Pallas kernels of
that path rewritten by hand in CUDA C++ for Hopper (``kernels/csrc``).

The layout mirrors ``geotransformer_tpu`` (``preprocess/``, ``ops/``,
``models/``, ``kernels/``, ``utils/``) so each module has an obvious JAX
counterpart; the JAX package stays the numerical reference. This package
imports ``torch`` and never ``jax`` or ``flax``.
"""

__version__ = "0.1.0"
