from geotransformer_tpu_torch.parallel.train import (  # noqa: F401
    make_eval_step,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
