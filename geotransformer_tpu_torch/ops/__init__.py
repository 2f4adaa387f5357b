from geotransformer_tpu_torch.ops.embedding import sinusoidal_embedding  # noqa: F401
from geotransformer_tpu_torch.ops.gather import gather_with_shadow, index_select, masked_topk  # noqa: F401
from geotransformer_tpu_torch.ops.pairwise_distance import pairwise_distance  # noqa: F401
from geotransformer_tpu_torch.ops.partition import (  # noqa: F401
    ball_query_partition,
    get_point_to_node_indices,
    knn_partition,
    point_to_node_partition,
)
from geotransformer_tpu_torch.ops.se3 import (  # noqa: F401
    apply_rotation,
    apply_transform,
    get_rotation_translation_from_transform,
    get_transform_from_rotation_translation,
    inverse_transform,
    rodrigues_alignment_matrix,
    rodrigues_rotation_matrix,
    skew_symmetric_matrix,
)
from geotransformer_tpu_torch.ops.vector_angle import deg2rad, rad2deg, vector_angle  # noqa: F401
