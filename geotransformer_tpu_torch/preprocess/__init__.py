from geotransformer_tpu_torch.preprocess.voxel import (  # noqa: F401
    grid_subsample,
    grid_subsample_single,
)
from geotransformer_tpu_torch.preprocess.neighbors import radius_search  # noqa: F401
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
    batch_to_float64,
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
    table_align,
)
from geotransformer_tpu_torch.preprocess.device import (  # noqa: F401
    DevicePreprocessPlan,
    build_pyramid_device,
    pad_stage0,
    prepare_raw_pair,
)
