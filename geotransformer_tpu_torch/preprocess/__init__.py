from geotransformer_tpu_torch.preprocess.calibrate import (  # noqa: F401
    calibrate_inverse_limits,
    calibrate_neighbor_limits,
    calibrate_split_specs,
    calibrate_stage_cap_buckets,
    calibrate_stage_caps,
)
from geotransformer_tpu_torch.preprocess.pyramid import (  # noqa: F401
    PAD_COORD,
    TABLE_ALIGN,
    batch_to_torch,
    build_input_stream,
    build_inverse_table,
    build_pyramid,
    build_split_tables,
    build_union_tables,
    caps_for_pyramid,
    fit_split_for_table,
    pad_registration_batch,
    round_up,
)
