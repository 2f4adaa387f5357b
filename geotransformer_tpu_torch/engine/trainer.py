r"""Training engine on one card (``geotransformer_tpu/engine/trainer.py``;
reference `engine/epoch_based_trainer.py`, `iter_based_trainer.py`,
`base_trainer.py`).

Epoch- or iteration-based loops over the port's ``make_train_step``, with
validation through ``make_eval_step``, checkpoints of the model, optimizer,
schedule, target-sampling generator, step and epoch, summary meters and
the prepare / process time split. One pair a step on one card: no mesh
(data parallelism is not ported), no TensorBoard writer, no profiler hook.

Per-step metrics stay on the card until a log boundary, where they are
read in one go; ``history`` then holds one dict of floats per step (its
learning rate, losses, ``grad_finite`` and process seconds).

With a ``device_plan`` (the loader's raw mode) each capacity bucket has its
own train and eval step, built lazily, which build the pyramid on the card;
a group whose pyramid overflowed its caps is handled by the plan's policy:
an error (``raise``, the default, and ``escalate`` past the last bucket), a
retry at the next bucket (``escalate``) or the host pyramid (``host``).
``overflows`` counts the overflowed tries, ``host_fallbacks`` the groups
that went to the host; every log line with a time reports both.
"""

import functools
import os
import time

import torch

from geotransformer_tpu_torch.engine.checkpoint import CheckpointManager
from geotransformer_tpu_torch.engine.logger import create_logger
from geotransformer_tpu_torch.engine.meters import SummaryBoard
from geotransformer_tpu_torch.engine.timer import Timer
from geotransformer_tpu_torch.parallel.train import (
    make_eval_step,
    make_optimizer,
    make_train_step,
)


def _pair_of(group):
    """The one pair of a loader group, without its host-only ``meta``."""
    if len(group) != 1:
        raise NotImplementedError(
            f"one card takes one pair a step; got a group of {len(group)} (data parallelism "
            "is not ported)")
    return {k: v for k, v in group[0].items() if k != "meta"}


class Trainer:
    """Epoch / iteration trainer of one model on one card."""

    def __init__(self, cfg, model, train_loader, val_loader=None, output_dir="output",
                 log_steps=10, max_checkpoints=None, device="cuda", device_plan=None):
        self.cfg = cfg
        self.model = model
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.logger = create_logger(log_file=os.path.join(output_dir, "train.log"))
        self.log_steps = log_steps
        self.device = device
        steps_per_epoch = max(len(train_loader), 1)
        self.optimizer, self.scheduler = make_optimizer(model, cfg, steps_per_epoch)
        # the steps of host-built batches (in the raw mode: the host fallback)
        self.train_step = make_train_step(model, cfg, self.optimizer, self.scheduler, device=device)
        self.eval_step = make_eval_step(model, cfg, device=device)
        self.device_plan = device_plan
        self._bucket_train_steps = {}
        self._bucket_eval_steps = {}
        self.overflows = 0
        self.host_fallbacks = 0
        self.checkpoints = CheckpointManager(os.path.join(output_dir, "checkpoints"),
                                             max_to_keep=max_checkpoints)
        # the GT target sampling draws from one CPU generator across steps
        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.step = 0
        self.epoch = 0
        self.restored = False
        self.history = []
        self.last_metrics = {}

    def initialize(self, example_batch=None):
        """Log the parameter count (the model is built with its
        parameters; ``example_batch`` is accepted for the JAX signature)."""
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"initialized model: {n_params / 1e6:.2f}M params")

    def state(self):
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "scheduler": self.scheduler.state_dict(),
                 "generator": self.generator.get_state(), "step": self.step, "epoch": self.epoch}
        pipeline = getattr(self.train_loader, "pipeline_cfg", None)
        if pipeline is not None:
            # the caps and input route the model was trained with, which the
            # test script restores with the weights
            state["pipeline"] = {"stage_caps": pipeline["stage_caps"],
                                 "input_stream": pipeline.get("input_stream", True)}
        if self.device_plan is not None:
            state["device_plan"] = {"buckets": self.device_plan.buckets}
        return state

    def save(self, step, metadata=None):
        self.checkpoints.save(step, self.state(), metadata=metadata)

    def resume(self, step=None):
        """Restore the latest checkpoint (or ``step``); False if none.
        :meth:`run` and :meth:`run_iterations` call it unless a checkpoint
        was restored already."""
        try:
            state, step = self.checkpoints.restore(step)
        except FileNotFoundError:
            return False
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.generator.set_state(state["generator"])
        self.step, self.epoch = int(state["step"]), int(state["epoch"])
        self.restored = True
        self.logger.info(f"resumed from checkpoint {step}: step {self.step}, epoch {self.epoch}")
        return True

    # ---- the raw mode: a step per bucket and the overflow policy ----

    def _bucket_of_group(self, group):
        return self.device_plan.bucket_for_cap0(group[0]["raw_points"].shape[0] // 2)

    def _train_step_for(self, bucket):
        step = self._bucket_train_steps.get(bucket)
        if step is None:
            step = make_train_step(self.model, self.cfg, self.optimizer, self.scheduler,
                                   device=self.device, pyramid_spec=self.device_plan.spec(bucket))
            self._bucket_train_steps[bucket] = step
        return step

    def _eval_step_for(self, bucket):
        step = self._bucket_eval_steps.get(bucket)
        if step is None:
            step = make_eval_step(self.model, self.cfg, device=self.device,
                                  pyramid_spec=self.device_plan.spec(bucket, with_inverse=False))
            self._bucket_eval_steps[bucket] = step
        return step

    def _run_raw(self, group, step_for, host_step):
        """A raw group through its bucket's step (``step_for(bucket)``), by
        the plan's overflow policy, or through ``host_step`` on the host
        pyramid."""
        def run_bucket(bucket, group):
            metrics = step_for(bucket)(_pair_of(group))
            return metrics, float(metrics["pyramid_overflow"]) != 0.0

        metrics, tries, host = self.device_plan.run(
            group, self._bucket_of_group(group), run_bucket,
            lambda host_group: host_step(_pair_of(host_group)), self.logger.warning)
        self.overflows += tries
        self.host_fallbacks += host
        return metrics

    def _fallback_note(self):
        """The raw mode's overflow counters, for a log line that reports a
        time (a host fallback times the host pyramid, not the kernels)."""
        if self.device_plan is None:
            return ""
        return f" | overflows {self.overflows} host_fallbacks {self.host_fallbacks}"

    def _train_on_group(self, group, timer, pending):
        lr = self.scheduler.get_last_lr()[0]
        timer.tic_process()
        if self.device_plan is None:
            metrics = self.train_step(_pair_of(group), self.generator)
        else:
            metrics = self._run_raw(
                group, lambda bucket: functools.partial(self._train_step_for(bucket),
                                                        generator=self.generator),
                functools.partial(self.train_step, generator=self.generator))
        timer.toc_process()
        self.step += 1
        pending.append((self.step, lr, metrics))

    def _flush(self, summary, pending, timer):
        """Read the pending steps' metrics off the card into ``history``."""
        if not pending:
            return
        seconds = timer.process_times()[-len(pending):]
        for (step, lr, metrics), sec in zip(pending, seconds):
            values = {k: float(v) for k, v in metrics.items()}
            summary.update_from_dict(values)
            self.history.append(dict(values, step=step, lr=lr, process_s=sec))
        pending.clear()

    def train_epoch(self):
        summary = SummaryBoard(last_n=self.log_steps)
        timer = Timer(self.device)
        self.train_loader.set_epoch(self.epoch)
        pending = []
        timer.tic_prepare()
        for it, group in enumerate(self.train_loader):
            timer.toc_prepare()
            self._train_on_group(group, timer, pending)
            if (it + 1) % self.log_steps == 0:
                self._flush(summary, pending, timer)
                self.logger.info(
                    f"epoch {self.epoch} it {it + 1}/{len(self.train_loader)}: "
                    f"{summary.tostring()} | prep {timer.get_prepare_time():.3f}s "
                    f"proc {timer.get_process_time():.3f}s{self._fallback_note()}")
            timer.tic_prepare()
        self._flush(summary, pending, timer)
        self.last_metrics = summary.summary()
        return self.last_metrics

    def validate(self):
        if self.val_loader is None:
            return {}
        summary = SummaryBoard()
        for group in self.val_loader:
            metrics = (self.eval_step(_pair_of(group)) if self.device_plan is None
                       else self._run_raw(group, self._eval_step_for, self.eval_step))
            summary.update_from_dict({k: float(v) for k, v in metrics.items()})
        result = summary.summary()
        self.logger.info(f"validation at step {self.step}: {summary.tostring()}")
        return result

    def run(self):
        """Epoch-based training (3DMatch / KITTI)."""
        if not self.restored:
            self.resume()
        while self.epoch < self.cfg.optim.max_epoch:
            self.epoch += 1
            start = time.time()
            metrics = self.train_epoch()
            self.logger.info(f"epoch {self.epoch} done in {time.time() - start:.1f}s: "
                             + ", ".join(f"{k}={v:.4f}" for k, v in metrics.items())
                             + self._fallback_note())
            self.save(self.epoch, metadata={"epoch": self.epoch})
            self.validate()
        return self.last_metrics

    def run_iterations(self, snapshot_steps=None):
        """Iteration-based training (ModelNet; reference
        `iter_based_trainer.py`) to ``cfg.optim.max_iteration`` steps, a
        checkpoint and a validation every ``snapshot_steps``."""
        if not self.restored:
            self.resume()
        snapshot_steps = snapshot_steps or self.cfg.optim.snapshot_steps or 10000
        max_iter = self.cfg.optim.max_iteration
        summary = SummaryBoard(last_n=self.log_steps)
        timer = Timer(self.device)
        pending = []
        while self.step < max_iter:
            self.train_loader.set_epoch(self.epoch)
            self.epoch += 1
            for group in self.train_loader:
                self._train_on_group(group, timer, pending)
                if self.step % self.log_steps == 0:
                    self._flush(summary, pending, timer)
                    self.logger.info(f"iter {self.step}/{max_iter}: {summary.tostring()}")
                if self.step % snapshot_steps == 0:
                    self._flush(summary, pending, timer)
                    self.save(self.step, metadata={"iteration": self.step})
                    self.validate()
                if self.step >= max_iter:
                    break
        self._flush(summary, pending, timer)
        self.last_metrics = summary.summary()
        return self.last_metrics
