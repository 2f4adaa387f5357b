r"""Hand-written CUDA kernels of the main path, each beside its plain PyTorch
version (``kpconv.py``, ``gse.py``, ``sinkhorn.py``, ``overlap.py``,
``attention.py``, and ``pyramid.py`` for the on-device pyramid); build,
binding and dispatch in ``cuda.py``. Nothing here imports Triton or compiles
anything at import time."""
