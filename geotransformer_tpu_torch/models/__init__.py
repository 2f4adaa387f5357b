from geotransformer_tpu_torch.models.geotransformer import (  # noqa: F401
    GeoTransformer,
    create_model,
    precompute_gt_targets,
)
from geotransformer_tpu_torch.models.backbone import KPConvFPN  # noqa: F401
from geotransformer_tpu_torch.models.kpconv import (  # noqa: F401
    ConvBlock,
    KPConv,
    LastUnaryBlock,
    ResidualBlock,
    UnaryBlock,
    nearest_upsample,
)
from geotransformer_tpu_torch.models.transformer import (  # noqa: F401
    GeometricStructureEmbedding,
    GeometricTransformer,
    RPEConditionalTransformer,
)
from geotransformer_tpu_torch.models.transformer_variants import (  # noqa: F401
    LearnablePositionalEmbedding,
    LRPEConditionalTransformer,
    PEConditionalTransformer,
    VanillaConditionalTransformer,
)
from geotransformer_tpu_torch.models.point_matching import point_matching  # noqa: F401
from geotransformer_tpu_torch.models.sinkhorn import LearnableLogOptimalTransport  # noqa: F401
from geotransformer_tpu_torch.models.procrustes import weighted_procrustes  # noqa: F401
from geotransformer_tpu_torch.models.matching import (  # noqa: F401
    candidates_to_dense_overlaps,
    get_node_correspondences,
    superpoint_matching,
    superpoint_target_sample,
)
from geotransformer_tpu_torch.models.lgr import (  # noqa: F401
    compute_correspondence_matrix,
    local_to_global_registration,
    procrustes_from_pair_weights,
)
from geotransformer_tpu_torch.models.corr_utils import (  # noqa: F401
    dense_correspondences_to_node_correspondences,
    extract_correspondences_from_feats,
    extract_correspondences_from_scores,
    extract_correspondences_from_scores_threshold,
    extract_correspondences_from_scores_topk,
    get_node_occlusion_ratios,
    get_node_overlap_ratios,
    node_correspondences_to_dense_correspondences,
)
