from geotransformer_tpu_torch.eval.threedmatch_benchmark import (  # noqa: F401
    read_log_file,
    read_info_file,
    write_log_file,
    get_gt_logs_and_infos,
    get_num_fragments,
    get_scene_abbr,
    compute_transform_error,
    evaluate_registration_one_scene,
)
