r"""Training engine (``geotransformer_tpu/engine/trainer.py``; reference
`engine/epoch_based_trainer.py`, `iter_based_trainer.py`,
`base_trainer.py`).

Epoch- or iteration-based loops over the port's ``make_train_step``, with
validation through ``make_eval_step``, checkpoints of the model, optimizer
(with its accumulated gradients), schedule, target-sampling generators,
step and epoch, summary meters and the prepare / process time split. One
process owns one card and takes one pair a step; in a process group
(:mod:`geotransformer_tpu_torch.parallel.mesh`) the steps average
gradients and metrics over the ranks, the lr is the config's x the world
size, rank 0 logs and writes the checkpoints, and each rank samples its
GT targets from its own generator (seeded ``cfg.seed + rank``).

Per-step metrics stay on the card until a log boundary, where they are
read in one go; ``history`` then holds one dict of floats per step (its
learning rate, losses, ``grad_finite`` and process seconds).

Three hooks, as the JAX trainer's: ``tensorboard`` writes the train and
val scalars (``train/<key>``, ``val/<key>``) with a
``torch.utils.tensorboard.SummaryWriter`` on rank 0 under
``<output_dir>/events`` (off, and logged so, where the ``tensorboard``
package is missing); ``profile_steps=(a, b)`` records steps [a, b) with
``torch.profiler`` into ``<output_dir>/profile/trace_rank<r>.json`` and
logs a warning where the trace lost events of a hand-written kernel
(``utils.timing.lost_kernel_events``: fewer than its wrapper launched);
``debug_nans`` turns on autograd's anomaly detection for the process (the
reference's tool for it), so a backward that makes a NaN raises where it
does.

With a ``device_plan`` (the loader's raw mode) each capacity bucket has its
own train and eval step, built lazily, which build the pyramid on the card;
a group whose pyramid overflowed its caps is handled by the plan's policy:
an error (``raise``, the default, and ``escalate`` past the last bucket), a
retry at the next bucket (``escalate``) or the host pyramid (``host``).
``overflows`` counts the overflowed tries, ``host_fallbacks`` the groups
that went to the host; every log line with a time reports both.
"""

import collections
import contextlib
import functools
import itertools
import os
import time

import torch

from geotransformer_tpu_torch.engine.checkpoint import CheckpointManager
from geotransformer_tpu_torch.engine.logger import create_logger
from geotransformer_tpu_torch.engine.meters import SummaryBoard
from geotransformer_tpu_torch.engine.timer import Timer
from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.parallel import mesh
from geotransformer_tpu_torch.parallel.train import (
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from geotransformer_tpu_torch.utils.timing import lost_kernel_events


def _pair_of(group):
    """The one pair of a loader group, without its host-only ``meta``."""
    mesh.check_pairs_per_process(len(group))
    return {k: v for k, v in group[0].items() if k != "meta"}


class Trainer:
    """Epoch / iteration trainer: one model, one card a process."""

    def __init__(self, cfg, model, train_loader, val_loader=None, output_dir="output",
                 log_steps=10, max_checkpoints=None, tensorboard=True, profile_steps=None,
                 debug_nans=False, device="cuda", device_plan=None):
        if debug_nans:
            # the reference's anomaly detection (base_trainer.py:37,80-86,
            # utils/torch.py:94), process-wide as JAX's jax_debug_nans
            torch.autograd.set_detect_anomaly(True)
        self.cfg = cfg
        self.model = model
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.rank, self.world_size = mesh.rank(), mesh.world_size()
        self.logger = create_logger(log_file=os.path.join(output_dir, "train.log"),
                                    process_index=self.rank)
        self.log_steps = log_steps
        self.device = device
        # every rank takes as many steps an epoch: the fewest pairs a shard
        # holds (a shard may hold one pair more than another), so no rank
        # waits in a collective that another never reaches
        self.steps_per_epoch = min(mesh.all_gather_object(len(train_loader)))
        self.optimizer, self.scheduler = make_optimizer(model, cfg, max(self.steps_per_epoch, 1),
                                                        world_size=self.world_size)
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
        # the GT target sampling draws from one CPU generator a rank across
        # steps (JAX folds the rank into the step's key)
        self.generator = torch.Generator().manual_seed(cfg.seed + self.rank)
        self.step = 0
        self.epoch = 0
        self.restored = False
        self.history = []
        self.last_metrics = {}
        self.writer = self._summary_writer() if tensorboard and self.rank == 0 else None
        self.profile_steps = profile_steps
        self._profiler = None

    def _summary_writer(self):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as error:
            self.logger.warning(f"TensorBoard writer off: {error}")
            return None
        directory = os.path.join(self.output_dir, "events")
        self.logger.info(f"TensorBoard writer on: {directory}")
        return SummaryWriter(directory)

    def _write_scalars(self, prefix, metrics, step):
        if self.writer is not None:
            for key, value in metrics.items():
                self.writer.add_scalar(f"{prefix}/{key}", value, step)

    def _maybe_profile(self):
        """Start the profiler before step a, stop it before step b (steps
        counted from 0, as the JAX trainer's)."""
        if self.profile_steps is None:
            return
        start, stop = self.profile_steps
        if self.step == start and self._profiler is None:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profile_launches = collections.Counter(cuda.launches)
            self._profiler.__enter__()
        elif self.step >= stop:
            self._stop_profile()

    def _stop_profile(self):
        if self._profiler is None:
            return
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)
        self._profiler.__exit__(None, None, None)
        directory = os.path.join(self.output_dir, "profile")
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"trace_rank{self.rank}.json")
        self._profiler.export_chrome_trace(path)
        launched = collections.Counter(cuda.launches)
        launched.subtract(self._profile_launches)
        events = [(e.key, e.count) for e in self._profiler.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        self._profiler = None
        self.logger.info(f"profile of steps {self.profile_steps}: {path}")
        lost = lost_kernel_events(events, launched)
        if lost:
            self.logger.warning(f"the profile lost hand-written kernel events, "
                                f"{{wrapper: (launches, events)}} {lost}: profile the steps "
                                f"in a process of their own")

    def _finish(self):
        self._stop_profile()
        if self.writer is not None:
            self.writer.flush()

    def initialize(self, example_batch=None):
        """Log the parameter count (the model is built with its
        parameters; ``example_batch`` is accepted for the JAX signature)."""
        n_params = sum(p.numel() for p in self.model.parameters())
        self.logger.info(f"initialized model: {n_params / 1e6:.2f}M params")

    def state(self):
        """What a checkpoint holds; every rank's generator state, gathered
        (a collective: every rank calls it)."""
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                 "scheduler": self.scheduler.state_dict(),
                 "generators": mesh.all_gather_object(self.generator.get_state()),
                 "step": self.step, "epoch": self.epoch}
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
        """Restore the latest checkpoint (or ``step``) on every rank, each
        rank its own generator (where the checkpoint holds as many ranks' as
        this run has); False if none. :meth:`run` and
        :meth:`run_iterations` call it unless a checkpoint was restored
        already."""
        try:
            state, step = self.checkpoints.restore(step)
        except FileNotFoundError:
            return False
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        generators = state["generators"]
        if len(generators) == self.world_size:
            self.generator.set_state(generators[self.rank])
        else:
            # another world size shards the pairs otherwise too: each rank
            # keeps its generator seeded cfg.seed + rank
            self.logger.warning(f"checkpoint {step} holds the target generators of "
                                f"{len(generators)} ranks, this run has {self.world_size}: "
                                "their draws start afresh")
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
        self._maybe_profile()
        lr = self.scheduler.get_last_lr()[0]
        timer.tic_process()
        with (torch.profiler.record_function(f"train step {self.step}")
              if self._profiler is not None else contextlib.nullcontext()):
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
            self._write_scalars("train", values, step)
            self.history.append(dict(values, step=step, lr=lr, process_s=sec))
        pending.clear()

    def train_epoch(self):
        summary = SummaryBoard(last_n=self.log_steps)
        timer = Timer(self.device)
        self.train_loader.set_epoch(self.epoch)
        pending = []
        timer.tic_prepare()
        for it, group in enumerate(itertools.islice(self.train_loader, self.steps_per_epoch)):
            timer.toc_prepare()
            self._train_on_group(group, timer, pending)
            if (it + 1) % self.log_steps == 0:
                self._flush(summary, pending, timer)
                self.logger.info(
                    f"epoch {self.epoch} it {it + 1}/{self.steps_per_epoch}: "
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
        self._write_scalars("val", result, self.step)
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
        self._finish()
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
            for group in itertools.islice(self.train_loader, self.steps_per_epoch):
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
        self._finish()
        self.last_metrics = summary.summary()
        return self.last_metrics
