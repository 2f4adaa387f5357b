from geotransformer_tpu_torch.parallel.mesh import (  # noqa: F401
    all_gather_object,
    barrier,
    check_pairs_per_process,
    destroy_process_group,
    init_process_group,
    is_initialized,
    rank,
    world_size,
)
from geotransformer_tpu_torch.parallel.train import (  # noqa: F401
    MultiSteps,
    apply_gradients,
    make_eval_step,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
