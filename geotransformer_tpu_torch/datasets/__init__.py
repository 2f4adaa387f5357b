from geotransformer_tpu_torch.datasets.kitti import OdometryKittiPairDataset  # noqa: F401
from geotransformer_tpu_torch.datasets.modelnet import (  # noqa: F401
    ASYMMETRIC_INDICES,
    ModelNetPairDataset,
    compute_overlap,
)
from geotransformer_tpu_torch.datasets.synthetic import SyntheticSceneBenchmark  # noqa: F401
from geotransformer_tpu_torch.datasets.threedmatch import ThreeDMatchPairDataset  # noqa: F401
