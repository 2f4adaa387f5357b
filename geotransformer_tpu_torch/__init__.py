r"""geotransformer_tpu_torch: the PyTorch/CUDA port of geotransformer_tpu.

The 3DMatch, KITTI and ModelNet paths of the JAX package — dataset and
loader, host pyramid, KPConv FPN, geometric transformer, superpoint
matching, learnable Sinkhorn, local-to-global registration, the training
and eval steps and the one-card trainer — in PyTorch, with every Pallas
kernel of the JAX package rewritten by hand in CUDA C++ for Hopper
(``kernels/csrc``).

The layout mirrors ``geotransformer_tpu`` (``preprocess/``, ``ops/``,
``models/``, ``kernels/``, ``datasets/``, ``engine/``, ``utils/``) so each
module has an obvious JAX counterpart; the JAX package stays the numerical reference. This package
imports ``torch`` and never ``jax`` or ``flax``.
"""

__version__ = "0.1.0"
