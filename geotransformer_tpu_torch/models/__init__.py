from geotransformer_tpu_torch.models.geotransformer import (  # noqa: F401
    GeoTransformer,
    create_model,
    precompute_gt_targets,
)
