"""The port's data parallelism, gradient accumulation in the engine, and the
Trainer's hooks, on the CPU.

  * host sharding: ``PairLoader``'s indices and length equal the JAX
    loader's (``order[shard_index::num_shards]`` after the epoch's seeded
    shuffle) for several (n, shards, index, epoch);
  * two ranks over Gloo (``tests/torch_parallel_worker.py``, each a
    subprocess with a 240 s wall-clock limit; both are killed when one
    fails or the limit passes, a collective that waits 60 s raises): two
    steps of the tiny ModelNet configuration on their shards. The ranks'
    parameters and averaged gradients are bit-equal to each other; the
    gradients of the first step equal one process's accumulated gradient
    over the same two pairs with ``grad_acc_steps`` 2 (1e-4 of each
    tensor's norm, 1e-6 of the largest: the targets are summed in another
    order), the parameters after both steps within the two Adam updates'
    reach of it (2 x 2 x the lr: gradients that vanish follow rounding
    noise through Adam's scaling); the lr is 2x the config's; rank 0 wrote one
    checkpoint, and a resume restores each rank its own generator; a
    raw-mode pyramid overflow on rank 1's pair alone skips the step on both
    ranks, and neither hangs;
  * a resume in the middle of an accumulation (``grad_acc_steps`` 3, a
    checkpoint after 4 steps) repeats the run bit for bit;
  * the hooks: TensorBoard scalars read back from the event files; a
    ``profile_steps`` trace holding the asked steps and no other;
    ``debug_nans`` raising where a gradient hook injects a NaN, which
    without it the finite guard skips.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from geotransformer_tpu.preprocess.loader import PairLoader as JaxPairLoader

from geotransformer_tpu_torch.configs import (
    BackboneConfig,
    CapsConfig,
    CoarseMatchingConfig,
    GeoTransformerModuleConfig,
    ModelConfig,
    OptimConfig,
    make_modelnet_config,
)
from geotransformer_tpu_torch.datasets import ModelNetPairDataset
from geotransformer_tpu_torch.engine import Trainer
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.parallel import make_lr_schedule
from geotransformer_tpu_torch.preprocess import calibrate_stage_caps
from geotransformer_tpu_torch.preprocess.loader import PairLoader
from test_torch_modelnet import REFERENCE_SETTINGS, write_modelnet_pickle
from torch_routes import numpy_pyramids  # noqa: F401  (both packages on numpy)

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
RANK_LIMIT_S = 240


@pytest.mark.parametrize("n, shards, index, epoch, shuffle", [
    (7, 2, 0, 0, True), (7, 2, 1, 3, True), (10, 3, 2, 1, True), (5, 4, 3, 2, True),
    (9, 1, 0, 5, True), (8, 3, 1, 0, False)])
def test_shards_match_jax_loader(n, shards, index, epoch, shuffle):
    kw = dict(shuffle=shuffle, seed=11, num_shards=shards, shard_index=index)
    port, jax_loader = PairLoader(list(range(n)), {}, **kw), JaxPairLoader(list(range(n)), {}, **kw)
    port.set_epoch(epoch)
    jax_loader.set_epoch(epoch)
    np.testing.assert_array_equal(port._indices(), jax_loader._indices())
    assert len(port) == len(jax_loader)


def tiny_config(**optim):
    """The tiny ModelNet configuration of tests/test_modelnet_schedule.py in
    the port's classes, with every eligible GT pair trained on."""
    return dataclasses.replace(
        make_modelnet_config(),
        backbone=BackboneConfig(num_stages=3, init_voxel_size=0.05, init_dim=16, group_norm=8),
        model=ModelConfig(ground_truth_matching_radius=0.05, num_points_in_patch=16,
                          fine_level=0, num_sinkhorn_iterations=10),
        coarse_matching=CoarseMatchingConfig(num_targets=256, num_correspondences=32),
        geotransformer=GeoTransformerModuleConfig(input_dim=128, hidden_dim=32, output_dim=32,
                                                  blocks=("self", "cross"), num_heads=2),
        optim=OptimConfig(**optim),
        caps=CapsConfig(stage_caps=(768, 384, 192), neighbor_limits=(34, 34, 34),
                        gt_candidates=16, gt_chunk_size=16, correspondence_capacity=256))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = write_modelnet_pickle(tmp_path_factory.mktemp("modelnet"), seed=5, entries=4)
    dataset = ModelNetPairDataset(root, "train", deterministic=True, **REFERENCE_SETTINGS)
    cfg = tiny_config(lr=1e-4, max_iteration=2, snapshot_steps=2)
    bb = cfg.backbone
    caps = tuple(calibrate_stage_caps(
        (dataset[i] for i in range(len(dataset))), bb.num_stages, bb.init_voxel_size,
        bb.init_radius, list(cfg.caps.neighbor_limits), num_samples=len(dataset), multiple=64))
    cfg = cfg.with_caps(stage_caps=caps)
    pipeline = dict(num_stages=bb.num_stages, voxel_size=bb.init_voxel_size,
                    search_radius=bb.init_radius, neighbor_limits=cfg.caps.neighbor_limits,
                    stage_caps=cfg.caps.stage_caps, input_dim=bb.input_dim,
                    inverse_limits=cfg.caps.inverse_limits)
    return cfg, dataset, pipeline


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(setup_path, out, world=2):
    """The worker's ranks as subprocesses; every rank is killed when one
    fails or the wall-clock limit passes, and the test fails with their
    output."""
    port = free_port()
    logs = [open(os.path.join(out, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, setup_path, out], stdout=log, stderr=subprocess.STDOUT,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)))
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + RANK_LIMIT_S
    failure = None
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            failure = "a rank failed"
            break
        if time.monotonic() > deadline:
            failure = f"the ranks ran past {RANK_LIMIT_S} s"
            break
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    outputs = []
    for log in logs:
        log.seek(0)
        outputs.append(log.read()[-4000:])
        log.close()
    if failure is None and any(p.returncode != 0 for p in procs):
        failure = "a rank failed"
    if failure:
        pytest.fail(f"{failure}: exit codes {[p.returncode for p in procs]}\n"
                    + "\n".join(f"--- rank {r}\n{o}" for r, o in enumerate(outputs)))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    cfg, dataset, pipeline = setup
    out = str(tmp_path_factory.mktemp("ranks"))
    setup_path = os.path.join(out, "setup.pt")
    torch.save({"cfg": cfg, "dataset": dataset, "pipeline": pipeline}, setup_path)
    ranks = run_ranks(setup_path, out)
    # one process over the same pairs in the same order (the two shards
    # interleaved), accumulating each step's two pairs, at the 2-rank lr
    torch.set_num_threads(2)
    single_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, lr=2 * cfg.optim.lr, grad_acc_steps=2, max_iteration=4, snapshot_steps=100))
    model = create_model(single_cfg, seed=0, device="cpu")
    trainer = Trainer(single_cfg, model, PairLoader(dataset, pipeline, shuffle=True, seed=1),
                      output_dir=os.path.join(out, "single"), tensorboard=False, device="cpu")
    applied = []
    step = trainer.train_step

    def recording(batch, generator=None):
        metrics = step(batch, generator)
        applied.append({name: p.grad.clone() for name, p in model.named_parameters()})
        return metrics

    trainer.train_step = recording
    trainer.run_iterations()
    return dict(cfg=cfg, ranks=ranks, single_grads=applied[1],
                single_params=model.state_dict(), single=trainer)


def test_two_ranks_take_the_same_steps(two_ranks):
    r0, r1 = two_ranks["ranks"]
    assert [h["grad_finite"] for h in r0["history"]] == [1.0, 1.0]
    for g0, g1 in zip(r0["grads"], r1["grads"]):
        for name in g0:
            assert torch.equal(g0[name], g1[name]), name
    for name, value in r0["params"].items():
        assert torch.equal(value, r1["params"][name]), name
    # the averaged metrics too
    for h0, h1 in zip(r0["history"], r1["history"]):
        assert h0["loss"] == h1["loss"]
    # the shards: the epoch's order split in two
    assert sorted(np.concatenate([r0["shard"], r1["shard"]]).tolist()) == [0, 1, 2, 3]


def test_two_ranks_equal_one_process_accumulating(two_ranks):
    grads = two_ranks["ranks"][0]["grads"][0]
    want = two_ranks["single_grads"]
    floor = 1e-6 * max(g.norm().item() for g in want.values())
    for name, g in grads.items():
        diff = (g - want[name]).norm().item()
        assert diff <= 1e-4 * want[name].norm().item() + floor, (name, diff)
    # two updates at the 2-rank lr, in opposite directions at worst
    reach = 2 * 2 * (2 * two_ranks["cfg"].optim.lr)
    for name, value in two_ranks["ranks"][0]["params"].items():
        torch.testing.assert_close(value, two_ranks["single_params"][name], rtol=0, atol=reach)


def test_two_ranks_scale_the_lr(two_ranks):
    cfg = two_ranks["cfg"]
    schedule = make_lr_schedule(cfg, steps_per_epoch=2, world_size=2)
    for rank in two_ranks["ranks"]:
        lrs = [h["lr"] for h in rank["history"]]
        assert lrs == [pytest.approx(2 * cfg.optim.lr, rel=1e-12)] * 2
        assert lrs == [pytest.approx(schedule(i), rel=1e-12) for i in range(2)]


def test_two_ranks_checkpoint_and_resume(two_ranks):
    r0, r1 = two_ranks["ranks"]
    assert r0["checkpoints"] == r1["checkpoints"] == [2]
    for rank in (r0, r1):
        assert rank["restored_step"] == 2
        assert torch.equal(rank["restored_generator"], rank["generator"])
        for name, value in rank["params"].items():
            assert torch.equal(rank["restored_params"][name], value), name
    # each rank drew from its own generator (seeded cfg.seed + rank)
    assert not torch.equal(r0["generator"], r1["generator"])


def test_overflow_on_one_rank_skips_both(two_ranks):
    r0, r1 = two_ranks["ranks"]
    assert (r0["local_overflow"], r1["local_overflow"]) == (False, True)
    for rank in (r0, r1):
        assert rank["raw_metrics"] == {"pyramid_overflow": 1.0, "grad_finite": 0.0}
        assert rank["raw_unchanged"]


def make_trainer(cfg, dataset, pipeline, output_dir, seed=0, **hooks):
    return Trainer(cfg, create_model(cfg, seed=seed, device="cpu"),
                   PairLoader(dataset, pipeline, shuffle=True, seed=1),
                   output_dir=str(output_dir), log_steps=1, device="cpu",
                   **dict(dict(tensorboard=False), **hooks))


def test_resume_in_the_middle_of_an_accumulation(setup, tmp_path):
    """Accumulations of 3 steps, a checkpoint after the first epoch's 4
    (one update and one mini-step in): the resumed run's steps 5 and 6 end
    the accumulation as the first run's did. PyTorch's deterministic mode
    is on for the test: on the CPU the accumulating ``index_put_`` of the
    gathers' backward adds in any order otherwise (on CUDA it sorts)."""
    cfg, dataset, pipeline = setup
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, grad_acc_steps=3, max_iteration=6, snapshot_steps=4))
    torch.use_deterministic_algorithms(True)
    try:
        first = make_trainer(cfg, dataset, pipeline, tmp_path)
        first.run_iterations()
        resumed = make_trainer(cfg, dataset, pipeline, tmp_path, seed=1)
        assert resumed.resume(step=4)
        assert resumed.optimizer.mini_step == 1 and resumed.scheduler.last_epoch == 1
        assert resumed.optimizer.acc_grads[0].any()
        resumed.run_iterations()
    finally:
        torch.use_deterministic_algorithms(False)
    assert [h["step"] for h in resumed.history] == [5, 6]
    for got, want in zip(resumed.history, first.history[4:]):
        assert got["loss"] == want["loss"] and got["lr"] == want["lr"]
    assert resumed.scheduler.last_epoch == first.scheduler.last_epoch == 2
    for name, value in resumed.model.state_dict().items():
        assert torch.equal(value, first.model.state_dict()[name]), name


@pytest.fixture(scope="module")
def hooked(setup, tmp_path_factory):
    """Three steps with the TensorBoard writer on, a validation, and the
    profiler over step 1."""
    cfg, dataset, pipeline = setup
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, max_iteration=3,
                                                             snapshot_steps=3))
    out = tmp_path_factory.mktemp("hooks")
    trainer = Trainer(cfg, create_model(cfg, seed=0, device="cpu"),
                      PairLoader(dataset, pipeline, shuffle=True, seed=1),
                      val_loader=PairLoader(dataset, pipeline), output_dir=str(out),
                      log_steps=1, tensorboard=True, profile_steps=(1, 2), device="cpu")
    trainer.run_iterations()
    return trainer, out


def test_tensorboard_scalars_read_back(hooked):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    trainer, out = hooked
    events = EventAccumulator(str(out / "events"))
    events.Reload()
    loss = events.Scalars("train/loss")
    assert [e.step for e in loss] == [1, 2, 3]
    assert [e.value for e in loss] == pytest.approx([h["loss"] for h in trainer.history],
                                                    rel=1e-6)
    assert "train/grad_finite" in events.Tags()["scalars"]
    val = events.Scalars("val/loss")
    assert [e.step for e in val] == [3] and np.isfinite(val[0].value)


def test_profile_covers_the_asked_steps(hooked):
    _, out = hooked
    with open(out / "profile" / "trace_rank0.json") as f:
        names = {event.get("name") for event in json.load(f)["traceEvents"]}
    assert "train step 1" in names
    assert not {"train step 0", "train step 2"} & names
    assert any(name and name.startswith("aten::") for name in names)


@pytest.mark.parametrize("debug_nans", [False, True], ids=["guard", "debug_nans"])
def test_debug_nans(setup, tmp_path, debug_nans):
    cfg, dataset, pipeline = setup
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, max_iteration=1))
    trainer = make_trainer(cfg, dataset, pipeline, tmp_path, debug_nans=debug_nans)
    # a NaN injected into the gradient that reaches the transformer's input
    # projection's output: its backward then returns NaN gradients
    def inject(module, args, output):
        output.register_hook(lambda g: g * float("nan"))

    handle = trainer.model.transformer.in_proj.register_forward_hook(inject)
    try:
        if debug_nans:
            with pytest.raises(RuntimeError, match="nan"):
                trainer.run_iterations()
        else:
            before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
            trainer.run_iterations()
            assert trainer.history[0]["grad_finite"] == 0.0
            for name, value in trainer.model.state_dict().items():
                assert torch.equal(value, before[name]), name
    finally:
        handle.remove()
        torch.autograd.set_detect_anomaly(False)
