r"""Data-parallel training step (``geotransformer_tpu/parallel/train.py``;
reference `engine/base_trainer.py:179-234`, `trainval.py:31-34`).

One step registers this process's pair with ``training=True, with_gt=True``,
takes the overall loss and runs the backward through the kernels'
autograd Functions. In a process group (:mod:`.mesh`) the gradients are
then averaged over the ranks (``pmean``, one collective on one flat buffer),
so every rank holds the same gradients and takes the same decisions; the
metrics are averaged too. Then Adam applies them with the config's
schedule (at lr x world size), unless a gradient is not finite: then
neither the optimizer nor the schedule steps, so the parameters, the Adam
moments, the accumulated gradients and the schedule's count stay as they
were (the reference skips ``optimizer.step()``; the JAX step selects the
old state). With ``optim.grad_acc_steps`` k > 1 the optimizer is
:class:`MultiSteps` (``optax.MultiSteps``): it applies the mean of k
mini-steps' gradients every k-th step. Given a ``pyramid_spec``, a raw
batch of the device-preprocess loader is built into its pyramid on the card
inside the step; a capacity overflow on any rank (``pmax``) skips the step
on every rank before any of them runs the model.
"""

import math

import torch

from geotransformer_tpu_torch.losses.overall import evaluate, overall_loss
from geotransformer_tpu_torch.parallel import mesh
from geotransformer_tpu_torch.preprocess.device import build_pyramid_device
from geotransformer_tpu_torch.preprocess.pyramid import batch_to_torch, table_align


def make_lr_schedule(cfg, steps_per_epoch, world_size=1):
    """Learning rate at each optimizer update: a StepLR-equivalent staircase
    (``lr_decay`` every ``lr_decay_steps`` epochs) or, with ``warmup_steps``,
    warmup then cosine (reference `utils/torch.py:143-178`), from the
    config's lr x ``world_size`` (reference `base_trainer.py:189-194`).
    Returns update -> lr; with accumulation an update is every k-th step."""
    optim = cfg.optim
    base_lr = optim.lr * world_size
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


class MultiSteps:
    """Gradient accumulation with ``optax.MultiSteps(every_k_schedule=k)``
    semantics over a torch optimizer.

    Each :meth:`step` is a mini-step: the parameters' gradients go into the
    running mean ``acc + (g - acc) / (n + 1)`` of this accumulation's n
    earlier mini-steps, and every k-th mini-step the wrapped optimizer
    applies that mean and the accumulator starts again from zeros. A
    mini-step that is never taken (the step's finite guard) leaves the
    accumulator and its count as they were. ``state_dict`` holds the wrapped
    optimizer's state, the accumulator and the count, so a resume in the
    middle of an accumulation repeats the run."""

    def __init__(self, optimizer, every_k):
        self.optimizer = optimizer
        self.every_k = every_k
        self.params = [p for group in optimizer.param_groups for p in group["params"]]
        self.acc_grads = [torch.zeros_like(p) for p in self.params]
        self.mini_step = 0

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def zero_grad(self, set_to_none=True):
        self.optimizer.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self):
        """Take the gradients of one mini-step; True where the wrapped
        optimizer applied an update."""
        n = self.mini_step
        for acc, p in zip(self.acc_grads, self.params):
            acc.add_((p.grad - acc) / (n + 1))
        if n + 1 < self.every_k:
            self.mini_step = n + 1
            return False
        for acc, p in zip(self.acc_grads, self.params):
            p.grad.copy_(acc)
            acc.zero_()
        self.optimizer.step()
        self.mini_step = 0
        return True

    def state_dict(self):
        return {"optimizer": self.optimizer.state_dict(), "mini_step": self.mini_step,
                "acc_grads": [acc.clone() for acc in self.acc_grads]}

    def load_state_dict(self, state):
        self.optimizer.load_state_dict(state["optimizer"])
        self.mini_step = int(state["mini_step"])
        for acc, saved in zip(self.acc_grads, state["acc_grads"]):
            acc.copy_(saved)


def make_optimizer(model, cfg, steps_per_epoch, world_size=1):
    """Adam with coupled weight decay (optax ``add_decayed_weights`` then
    ``scale_by_adam``: torch's ``Adam(weight_decay=...)``, eps 1e-8) and a
    ``LambdaLR`` on :func:`make_lr_schedule` at ``world_size``; with
    ``optim.grad_acc_steps`` k > 1 the Adam goes inside :class:`MultiSteps`
    and the schedule counts its updates. Returns (optimizer, scheduler)."""
    schedule = make_lr_schedule(cfg, steps_per_epoch, world_size)
    base_lr = cfg.optim.lr * world_size
    adam = torch.optim.Adam(model.parameters(), lr=base_lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.optim.weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(adam, lambda step: schedule(step) / base_lr)
    k = cfg.optim.grad_acc_steps
    return (MultiSteps(adam, k) if k > 1 else adam), scheduler


def apply_gradients(optimizer, scheduler):
    """One optimizer step on the parameters' gradients, and a schedule step
    where it applied an update (every step, or every k-th under
    :class:`MultiSteps`). Returns whether it did."""
    if isinstance(optimizer, MultiSteps):
        applied = optimizer.step()
    else:
        optimizer.step()
        applied = True
    if applied:
        scheduler.step()
    return applied


def grads_finite(parameters):
    """True iff every gradient present is finite (one device sync)."""
    flags = [torch.isfinite(p.grad).all() for p in parameters if p.grad is not None]
    return bool(torch.stack(flags).all()) if flags else True


def mean_gradients(params):
    """Every parameter's gradient, a zero where autograd left none (JAX
    differentiates every parameter, and Adam's decay moves each one), then,
    in a process group, averaged over the ranks in one collective on one
    flat buffer (``pmean``)."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if not mesh.is_initialized():
        return
    grads = [p.grad for p in params]
    flat = mesh.mean_(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def mean_metrics(metrics):
    """The metrics (0-d tensors) averaged over the ranks (``pmean``), in one
    collective; as they are without a process group."""
    if not mesh.is_initialized():
        return metrics
    keys = sorted(metrics)
    flat = mesh.mean_(torch.stack([metrics[k].detach().float() for k in keys]))
    return dict(zip(keys, flat.unbind()))


def build_raw_batch(batch, pyramid_spec, precision=None):
    """A raw batch (``raw_points``, ``raw_lengths``, ``raw_feats``,
    ``transform``, on the card) built into its pyramid there, its tables
    aligned for ``precision`` (``preprocess.table_align``, as the JAX build
    follows the installed point); returns (batch, overflowed), the overflow
    vector read once to a bool, the largest over the process group's ranks
    (the reference's CPU collate, `utils/data.py:13-77`, in the step)."""
    built, overflow = build_pyramid_device(batch["raw_points"], batch["raw_lengths"],
                                           batch["raw_feats"], batch["transform"],
                                           **pyramid_spec, align=table_align(precision))
    # an overflow on any rank skips the step on every rank (pmax)
    return built, bool(mesh.max_(overflow.any().float()))


def make_train_step(model, cfg, optimizer, scheduler, device="cuda", pyramid_spec=None):
    """Build ``step(batch, generator=None) -> metrics`` for one pair.

    ``batch`` is a PairBatch (numpy or tensors; moved to ``device``),
    optionally with the inverse tables of the KPConv backward
    (``pad_registration_batch(..., inverse_limits=...)``; without them the
    convs' backward scatters) and the precomputed targets
    (``precompute_gt_targets``);
    ``generator`` is the CPU ``torch.Generator`` of the target sampling.
    The metrics are tensors: loss, c_loss, f_loss (the ranks' mean in a
    process group) and grad_finite (1.0, or 0.0 for a step the guard
    skipped). Every parameter leaves the step with a gradient (a zero
    where it took no part). With :class:`MultiSteps` a step that passes the
    guard is a mini-step; the schedule counts applied updates.

    ``cfg.precision`` is the model's: the step trains at any point (each
    kernel's backward at the point, as the JAX custom_vjps take it).

    With ``pyramid_spec`` (the keywords of ``build_pyramid_device``,
    ``DevicePreprocessPlan.spec``), a raw batch is built on the card first.
    Where a capacity overflowed, nothing runs further: neither the
    optimizer nor the scheduler steps and the generator draws nothing, so a
    retry is exact; the metrics are then ``pyramid_overflow`` 1.0 and
    ``grad_finite`` 0.0. A built batch reports ``pyramid_overflow`` 0.0.
    """
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch, generator=None):
        batch = batch_to_torch(batch, device)
        overflowed = None
        if pyramid_spec is not None and "raw_points" in batch:
            batch, overflowed = build_raw_batch(batch, pyramid_spec, cfg.precision)
            if overflowed:
                return {"pyramid_overflow": torch.tensor(1.0), "grad_finite": torch.tensor(0.0)}
        model.train()
        optimizer.zero_grad(set_to_none=True)
        output = model(batch, training=True, with_gt=True, generator=generator)
        loss, aux = overall_loss(cfg, output, batch["transform"])
        loss.backward()
        mean_gradients(params)
        ok = grads_finite(params)
        if ok:
            apply_gradients(optimizer, scheduler)
        metrics = mean_metrics({k: v.detach() for k, v in aux.items()})
        metrics["grad_finite"] = torch.tensor(float(ok))
        if overflowed is not None:
            metrics["pyramid_overflow"] = torch.tensor(0.0)
        return metrics

    return step


def make_eval_step(model, cfg, device="cuda", pyramid_spec=None):
    """Build ``step(batch) -> metrics``: the inference forward with GT
    targets (no gradient), the losses and PIR / IR / RRE / RTE / RMSE / RR,
    averaged over the process group's ranks (``pmean``). With ``pyramid_spec``, a raw batch is built on the card first, as in
    :func:`make_train_step`: an overflow returns ``pyramid_overflow`` 1.0
    alone, a built batch's metrics carry ``pyramid_overflow`` 0.0."""

    def step(batch):
        batch = batch_to_torch(batch, device)
        overflowed = None
        if pyramid_spec is not None and "raw_points" in batch:
            batch, overflowed = build_raw_batch(batch, pyramid_spec, cfg.precision)
            if overflowed:
                return {"pyramid_overflow": torch.tensor(1.0)}
        model.eval()
        with torch.no_grad():
            output = model(batch, training=False, with_gt=True)
            _, aux = overall_loss(cfg, output, batch["transform"])
            metrics = evaluate(cfg, output, batch["transform"])
        metrics.update(aux)
        metrics = mean_metrics(metrics)
        if overflowed is not None:
            metrics["pyramid_overflow"] = torch.tensor(0.0)
        return metrics

    return step
