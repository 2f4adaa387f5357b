from geotransformer_tpu_torch.losses.circle_loss import circle_loss, weighted_circle_loss  # noqa: F401
from geotransformer_tpu_torch.losses.metrics import (  # noqa: F401
    inlier_ratio,
    isotropic_transform_error,
    modified_chamfer_distance,
    registration_rmse,
    relative_rotation_error,
    relative_translation_error,
)
from geotransformer_tpu_torch.losses.overall import (  # noqa: F401
    coarse_matching_loss,
    evaluate,
    fine_matching_loss,
    overall_loss,
)
