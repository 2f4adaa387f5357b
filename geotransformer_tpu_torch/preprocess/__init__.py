from geotransformer_tpu_torch.preprocess.pyramid import (  # noqa: F401
    PAD_COORD,
    batch_to_torch,
    build_input_stream,
    build_inverse_table,
    build_pyramid,
    caps_for_pyramid,
    pad_registration_batch,
)
