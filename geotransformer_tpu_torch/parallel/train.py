r"""Training step on one card (``geotransformer_tpu/parallel/train.py``;
reference `engine/base_trainer.py:179-234`, `trainval.py:31-34`).

One step registers one pair with ``training=True, with_gt=True``, takes the
overall loss, runs the backward through the kernels' autograd Functions and
applies Adam with the config's schedule, unless a gradient is not finite:
then neither the optimizer nor the schedule steps, so the parameters, the
Adam moments and the schedule's count stay as they were (the reference
skips ``optimizer.step()``; the JAX step selects the old state). Data
parallelism (DDP) is not ported yet.
"""

import math

import torch

from geotransformer_tpu_torch.losses.overall import evaluate, overall_loss
from geotransformer_tpu_torch.preprocess.pyramid import batch_to_torch


def make_lr_schedule(cfg, steps_per_epoch):
    """Learning rate at each optimizer step: a StepLR-equivalent staircase
    (``lr_decay`` every ``lr_decay_steps`` epochs) or, with ``warmup_steps``,
    warmup then cosine (reference `utils/torch.py:143-178`; one card, so the
    reference's lr x world size is the config's lr). Returns step -> lr."""
    optim = cfg.optim
    base_lr = optim.lr
    if optim.warmup_steps > 0:
        warm, total = optim.warmup_steps, max(optim.max_iteration, 1)

        def schedule(step):
            if step < warm:
                return base_lr * (optim.eta_init + (1.0 - optim.eta_init) * step / warm)
            progress = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
            cos = 0.5 * (1.0 + math.cos(math.pi * progress))
            return base_lr * (optim.eta_min + (1.0 - optim.eta_min) * cos)

        return schedule
    period = steps_per_epoch * optim.lr_decay_steps
    return lambda step: base_lr * optim.lr_decay ** (step // period)


def make_optimizer(model, cfg, steps_per_epoch):
    """Adam with coupled weight decay (optax ``add_decayed_weights`` then
    ``scale_by_adam``: torch's ``Adam(weight_decay=...)``, eps 1e-8) and a
    ``LambdaLR`` on :func:`make_lr_schedule`. Returns (optimizer, scheduler)."""
    if cfg.optim.grad_acc_steps > 1:
        raise NotImplementedError("gradient accumulation (optim.grad_acc_steps > 1) is not ported")
    schedule = make_lr_schedule(cfg, steps_per_epoch)
    base_lr = cfg.optim.lr
    optimizer = torch.optim.Adam(model.parameters(), lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=cfg.optim.weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: schedule(step) / base_lr)
    return optimizer, scheduler


def grads_finite(parameters):
    """True iff every gradient present is finite (one device sync)."""
    flags = [torch.isfinite(p.grad).all() for p in parameters if p.grad is not None]
    return bool(torch.stack(flags).all()) if flags else True


def make_train_step(model, cfg, optimizer, scheduler, device="cuda"):
    """Build ``step(batch, generator=None) -> metrics`` for one pair.

    ``batch`` is a PairBatch (numpy or tensors; moved to ``device``) with
    the inverse tables (``pad_registration_batch(..., inverse_limits=...)``)
    and, optionally, the precomputed targets (``precompute_gt_targets``);
    ``generator`` is the CPU ``torch.Generator`` of the target sampling.
    The metrics are tensors: loss, c_loss, f_loss and grad_finite (1.0, or
    0.0 for a step the guard skipped).
    """
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch, generator=None):
        batch = batch_to_torch(batch, device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        output = model(batch, training=True, with_gt=True, generator=generator)
        loss, aux = overall_loss(cfg, output, batch["transform"])
        loss.backward()
        ok = grads_finite(params)
        if ok:
            optimizer.step()
            scheduler.step()
        metrics = {k: v.detach() for k, v in aux.items()}
        metrics["grad_finite"] = torch.tensor(float(ok))
        return metrics

    return step


def make_eval_step(model, cfg, device="cuda"):
    """Build ``step(batch) -> metrics``: the inference forward with GT
    targets (no gradient), the losses and PIR / IR / RRE / RTE / RMSE / RR."""

    def step(batch):
        batch = batch_to_torch(batch, device)
        model.eval()
        with torch.no_grad():
            output = model(batch, training=False, with_gt=True)
            _, aux = overall_loss(cfg, output, batch["transform"])
            metrics = evaluate(cfg, output, batch["transform"])
        metrics.update(aux)
        return metrics

    return step
