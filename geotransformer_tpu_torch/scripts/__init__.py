r"""Command-line entry points of the port (``python -m
geotransformer_tpu_torch.scripts.<name>``): ``trainval``, ``test``,
``eval`` and ``synthetic_benchmark``, the counterparts of the JAX package's
``scripts/``. Each runs on the card unless given ``--device cpu``."""
