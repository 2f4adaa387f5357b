"""The port's input pipeline and training engine, on the CPU.

  * ``PairLoader`` over the port's ``ModelNetPairDataset`` (two spawned
    workers, GT targets precomputed in them) against the JAX loader's
    ``prepare_pair``: every pyramid table byte-identical, the targets
    compared as tests/test_torch_targets.py compares them;
  * ``Trainer.run_iterations``: 6 steps of the tiny ModelNet configuration,
    the learning rate of each step on the warmup-cosine schedule, a
    checkpoint every 3 steps; a second trainer restored from step 3 repeats
    steps 4-6 exactly;
  * checkpoints round-trip the state exactly under the retention rule;
  * meters and timer.
"""

import dataclasses
import math
import time

import numpy as np
import pytest
import torch

from geotransformer_tpu.preprocess.loader import prepare_pair as jax_prepare_pair

from geotransformer_tpu_torch.datasets import ModelNetPairDataset
from geotransformer_tpu_torch.engine import (
    AverageMeter,
    CheckpointManager,
    SummaryBoard,
    Timer,
    Trainer,
)
from geotransformer_tpu_torch.configs import PrecisionConfig
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.parallel import make_lr_schedule
from geotransformer_tpu_torch.preprocess import DevicePreprocessPlan, calibrate_stage_caps
from geotransformer_tpu_torch.preprocess.loader import PairLoader, prepare_pair
from test_modelnet_schedule import tiny_modelnet_config
from test_torch_modelnet import REFERENCE_SETTINGS, write_modelnet_pickle
from torch_routes import jax_precision_kept  # noqa: F401  (JAX precision globals restored)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = write_modelnet_pickle(tmp_path_factory.mktemp("modelnet"), seed=5, entries=3)
    dataset = ModelNetPairDataset(root, "train", deterministic=True, **REFERENCE_SETTINGS)
    # the JAX package's tiny configuration at the float32 point, the only
    # one the port trains at
    cfg = dataclasses.replace(tiny_modelnet_config(), precision=PrecisionConfig())
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


def assert_tables_identical(got, want, key):
    if isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), key
        for g, w in zip(got, want):
            assert_tables_identical(g, w, key)
    elif want is None:
        assert got is None, key
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape, key
        assert got.tobytes() == want.tobytes(), key


_TARGET_KEYS = ("ref_node_masks", "ref_node_knn_indices", "ref_node_knn_masks", "src_node_masks",
                "src_node_knn_indices", "src_node_knn_masks", "gt_cand_indices",
                "gt_cand_overlaps", "gt_cand_masks")


def split(batch, cfg, stage):
    """(ref, src) points of a stage."""
    cap = cfg.caps.stage_caps[stage]
    points = batch["points"][stage]
    rows = cap[0] if isinstance(cap, (tuple, list)) else points.shape[0] // 2
    return points[:rows], points[rows:]


def test_loader_batches_match_jax_prepare_pair(setup, monkeypatch):
    # the JAX package's numpy pyramid, not its native library
    monkeypatch.setenv("GEOTRANSFORMER_TPU_NATIVE", "0")
    cfg, dataset, pipeline = setup
    pipeline = dict(pipeline, precompute_targets=True, model_cfg=cfg)
    loader = PairLoader(dataset, pipeline, batch_size=1, shuffle=True, num_workers=2, seed=4)
    try:
        groups = list(loader)
    finally:
        loader.close()
    order = np.random.default_rng(4).permutation(len(dataset))
    assert len(groups) == len(loader) == len(dataset)
    for group, index in zip(groups, order):
        (got,) = group
        want = jax_prepare_pair(dataset[int(index)], **pipeline)
        assert got["meta"] == want["meta"] and got["meta"]["index"] == index
        tables = [k for k in want if k not in _TARGET_KEYS + ("meta",)]
        assert sorted(k for k in got if k not in _TARGET_KEYS + ("meta",)) == sorted(tables)
        for key in tables:
            assert_tables_identical(got[key], want[key], key)
        for side, points, nodes in zip(("ref", "src"), split(got, cfg, 0), split(got, cfg, -1)):
            for key in (f"{side}_node_masks", f"{side}_node_knn_masks"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            # each node's patch: the same points, but for near-ties at the
            # patch boundary (JAX expands the squared distance): the same
            # distances there
            masks = want[f"{side}_node_knn_masks"]
            g, w = got[f"{side}_node_knn_indices"], want[f"{side}_node_knn_indices"]

            def dists(indices):
                near = points[np.minimum(indices, len(points) - 1)]  # shadow rows masked below
                return np.sort(np.linalg.norm(near - nodes[:, None], axis=-1), axis=1)

            np.testing.assert_allclose(np.where(masks, dists(g), 0), np.where(masks, dists(w), 0),
                                       rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["gt_cand_masks"].sum(1), want["gt_cand_masks"].sum(1))
        for row in range(want["gt_cand_masks"].shape[0]):
            g_rows, w_rows = got["gt_cand_masks"][row], want["gt_cand_masks"][row]
            g = dict(zip(got["gt_cand_indices"][row][g_rows].tolist(),
                         got["gt_cand_overlaps"][row][g_rows].tolist()))
            w = dict(zip(want["gt_cand_indices"][row][w_rows].tolist(),
                         want["gt_cand_overlaps"][row][w_rows].tolist()))
            assert sorted(g) == sorted(w), f"ref node {row}"
            np.testing.assert_allclose([g[k] for k in sorted(g)], [w[k] for k in sorted(w)],
                                       rtol=0, atol=1e-6)


def test_prepare_pair_takes_the_smallest_bucket_that_fits(setup):
    cfg, dataset, pipeline = setup
    caps = cfg.caps.stage_caps
    small = tuple(c // 4 for c in caps)
    buckets = [small, caps, tuple(2 * c for c in caps)]
    batch = prepare_pair(dataset[0], **dict(pipeline, stage_caps=buckets))
    assert [p.shape[0] for p in batch["points"]] == [2 * c for c in caps]
    with pytest.raises(ValueError, match="bucket"):
        prepare_pair(dataset[0], **dict(pipeline, stage_caps=[small]))


def test_epoch_run_with_validation(setup, tmp_path):
    cfg, dataset, pipeline = setup
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, max_epoch=1))
    model = create_model(cfg, seed=2, device="cpu")
    train = PairLoader(dataset, pipeline, shuffle=True, seed=3)
    val = PairLoader(dataset, pipeline)
    trainer = Trainer(cfg, model, train, val_loader=val, output_dir=str(tmp_path), log_steps=2,
                      tensorboard=False, device="cpu")
    metrics = trainer.run()
    assert trainer.epoch == 1 and trainer.step == len(dataset)
    assert math.isfinite(metrics["loss"]) and metrics["grad_finite"] == 1.0
    assert trainer.checkpoints.all_steps() == [1]
    result = trainer.validate()
    for key in ("loss", "PIR", "RRE", "RMSE"):
        assert math.isfinite(result[key]), key


def test_loader_rejects_what_is_not_ported(setup):
    """The raw mode has no host pyramid to precompute GT targets on (host
    sharding, refused here before, is held against the JAX loader by
    tests/test_torch_parallel.py)."""
    cfg, dataset, pipeline = setup
    with pytest.raises(ValueError, match="precompute_targets"):
        PairLoader(dataset, dict(pipeline, precompute_targets=True, model_cfg=cfg),
                   device_plan=DevicePreprocessPlan(cfg))


def make_trainer(cfg, dataset, pipeline, output_dir, seed):
    model = create_model(cfg, seed=seed, device="cpu")
    loader = PairLoader(dataset, pipeline, batch_size=1, shuffle=True, seed=1)
    return Trainer(cfg, model, loader, output_dir=str(output_dir), log_steps=2, tensorboard=False,
                   device="cpu")


@pytest.fixture(scope="module")
def trained(setup, tmp_path_factory):
    cfg, dataset, pipeline = setup
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, warmup_steps=2, max_iteration=6, snapshot_steps=3))
    output_dir = tmp_path_factory.mktemp("run")
    trainer = make_trainer(cfg, dataset, pipeline, output_dir, seed=0)
    trainer.initialize()
    trainer.run_iterations()
    resumed = make_trainer(cfg, dataset, pipeline, output_dir, seed=1)
    assert resumed.resume(step=3)
    restored = {k: v.clone() for k, v in resumed.model.state_dict().items()}
    lr_restored = resumed.scheduler.get_last_lr()[0]
    step_restored, epoch_restored = resumed.step, resumed.epoch
    resumed.run_iterations()
    return dict(cfg=cfg, trainer=trainer, resumed=resumed, restored=restored,
                lr_restored=lr_restored, step_restored=step_restored,
                epoch_restored=epoch_restored, output_dir=output_dir)


def test_run_iterations_takes_six_scheduled_steps(trained):
    cfg, trainer = trained["cfg"], trained["trainer"]
    history = trainer.history
    assert trainer.step == 6 and trainer.epoch == 2
    assert [h["step"] for h in history] == [1, 2, 3, 4, 5, 6]
    schedule = make_lr_schedule(cfg, steps_per_epoch=3)
    for i, h in enumerate(history):
        assert h["grad_finite"] == 1.0, h
        assert math.isfinite(h["loss"]) and h["process_s"] > 0.0, h
        assert h["lr"] == pytest.approx(schedule(i), rel=1e-12), (i, h["lr"])
    # warmup: 0.1 lr, 0.55 lr, then the cosine from the full rate
    assert history[0]["lr"] < history[1]["lr"] < history[2]["lr"] == cfg.optim.lr
    assert CheckpointManager(trained["output_dir"] / "checkpoints").all_steps() == [3, 6]


def test_resumed_trainer_repeats_the_steps_after_its_checkpoint(trained):
    trainer, resumed = trained["trainer"], trained["resumed"]
    assert (trained["step_restored"], trained["epoch_restored"]) == (3, 1)
    assert trained["lr_restored"] == trainer.history[3]["lr"]
    assert [h["step"] for h in resumed.history] == [4, 5, 6]
    for got, want in zip(resumed.history, trainer.history[3:]):
        for key in ("loss", "c_loss", "f_loss", "lr"):
            assert got[key] == pytest.approx(want[key], rel=1e-6), key
    # within three Adam steps (lr 1e-4 each) of each other: biases whose
    # gradient vanishes follow rounding noise through Adam's scaling
    for name, value in resumed.model.state_dict().items():
        torch.testing.assert_close(value, trainer.model.state_dict()[name], rtol=0, atol=3e-4)
    # what was restored at step 3 is not the fresh model of seed 1
    fresh = create_model(trained["cfg"], seed=1, device="cpu").state_dict()
    assert any(not torch.equal(fresh[k], v) for k, v in trained["restored"].items())


def test_checkpoint_round_trip_and_retention(tmp_path):
    manager = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    with pytest.raises(FileNotFoundError):
        manager.restore()
    model = torch.nn.Linear(3, 2)
    optimizer = torch.optim.Adam(model.parameters(), lr=0.1)
    model(torch.ones(4, 3)).sum().backward()
    optimizer.step()
    generator = torch.Generator().manual_seed(3)
    torch.rand(5, generator=generator)
    state = {"model": model.state_dict(), "optimizer": optimizer.state_dict(),
             "generator": generator.get_state(), "step": 7, "epoch": 2}
    for step in (5, 6, 7):
        manager.save(step, state, metadata={"iteration": step})
    assert manager.all_steps() == [6, 7] and manager.latest_step() == 7
    got, step = manager.restore()
    assert step == 7 and got["step"] == 7 and got["epoch"] == 2
    for key, value in state["model"].items():
        assert torch.equal(got["model"][key], value)
    assert torch.equal(got["generator"], state["generator"])
    restored = torch.optim.Adam(torch.nn.Linear(3, 2).parameters(), lr=0.1)
    restored.load_state_dict(got["optimizer"])
    for key in ("exp_avg", "exp_avg_sq", "step"):
        assert torch.equal(restored.state_dict()["state"][0][key],
                           optimizer.state_dict()["state"][0][key])
    with pytest.raises(FileNotFoundError):
        manager.restore(step=5)


def test_meters():
    records = [3.0, 1.0, 4.0, 1.0, 5.0]
    meter = AverageMeter()
    meter.update(records[:2])
    for r in records[2:]:
        meter.update(r)
    assert meter.mean() == pytest.approx(np.mean(records))
    assert meter.std() == pytest.approx(np.std(records))
    assert (meter.min(), meter.max(), meter.median(), meter.sum()) == (1.0, 5.0, 3.0, 14.0)
    window = AverageMeter(last_n=2)
    window.update(records)
    assert window.mean() == 3.0
    board = SummaryBoard(last_n=3)
    for r in records:
        board.update_from_dict({"loss": torch.tensor(r), "x": r * 2})
    assert board.summary() == {"loss": pytest.approx(10 / 3), "x": pytest.approx(20 / 3)}
    assert board.tostring() == "loss: 3.3333, x: 6.6667"
    strict = SummaryBoard(names=["a"], adaptive=False)
    with pytest.raises(KeyError):
        strict.update("b", 1.0)


def test_timer_on_the_host():
    timer = Timer(device="cpu")
    assert not timer.cuda
    for _ in range(2):
        timer.tic_prepare()
        time.sleep(0.01)
        timer.toc_prepare()
        timer.tic_process()
        time.sleep(0.02)
        timer.toc_process()
    assert len(timer.process_times()) == 2
    assert 0.01 <= timer.get_prepare_time() < timer.get_process_time()


def test_timer_dict_matches_jax(monkeypatch):
    """The port's keyed timers against the JAX package's on one scripted
    clock."""
    from geotransformer_tpu.engine import timer as jax_timer

    from geotransformer_tpu_torch.engine import TimerDict
    from geotransformer_tpu_torch.engine import timer as port_timer

    results = []
    for module, cls in ((jax_timer, jax_timer.TimerDict), (port_timer, TimerDict)):
        clock = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.75, 3.0, 4.5])
        monkeypatch.setattr(module.time, "time", lambda: next(clock))
        timers = cls()
        for key in ("a", "b", "a", "b"):
            timers.tic(key)
            timers.toc(key)
        results.append((timers.summary(), timers.get_time("missing")))
    assert results[0] == results[1] == ({"a": 0.625, "b": 0.875}, 0.0)
