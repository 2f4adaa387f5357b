from geotransformer_tpu_torch.datasets.modelnet import (  # noqa: F401
    ASYMMETRIC_INDICES,
    ModelNetPairDataset,
    compute_overlap,
)
