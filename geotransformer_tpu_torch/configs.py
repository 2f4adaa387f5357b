r"""Experiment configuration, shared with the JAX package.

``geotransformer_tpu.configs`` imports only ``dataclasses`` and ``typing``
(and ``geotransformer_tpu/__init__.py`` imports nothing), so the frozen
dataclasses are re-exported as they are. ``apply_precision`` is not: it
installs JAX kernel globals. ``ModelConfig.force_pallas`` selects the
port's kernels the same way it selects the Pallas kernels there (see
:func:`geotransformer_tpu_torch.kernels.cuda.use_kernel`).
"""

from geotransformer_tpu.configs import (  # noqa: F401
    BackboneConfig,
    CapsConfig,
    CoarseMatchingConfig,
    FineMatchingConfig,
    GeoTransformerConfig,
    GeoTransformerModuleConfig,
    ModelConfig,
    make_3dmatch_config,
    make_kitti_config,
    make_modelnet_config,
)
