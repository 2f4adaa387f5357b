"""The raw device-preprocess mode end to end on the CPU: the loader pads raw
points, the steps build the pyramid (``preprocess/device.py``, the kernels'
plain versions here), and the Trainer, the Tester and the scripts apply the
overflow policies (tests/test_device_pipeline.py for the JAX package).

  * the raw loader yields the JAX loader's groups, arrays equal, with and
    without a worker; bucket selection;
  * the raw-mode eval step: its metrics within 1e-4 relative of the JAX
    raw-mode eval step (``make_eval_step(..., pyramid_spec=...)``) on the
    same raw batch and weights (the JAX model's, carried across), RTE
    within 1e-3;
  * one epoch of the Trainer with a device plan (finite losses, no skipped
    step, parameters that move, the plan's buckets in the checkpoint); the
    escalate, host and raise policies; the Tester's dumps;
  * ``scripts.trainval`` / ``scripts.test --device_preprocess`` on seeded
    files; ``scripts.demo``'s host and device batch builders on a seeded
    2,000-point pair, which agree (points within 1e-4, tables up to
    distance ties on at most 5 % of a table's rows, or 3 rows of a small
    one).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu import configs as jax_configs
from geotransformer_tpu.models import create_model as create_jax_model
from geotransformer_tpu.parallel.train import TrainState
from geotransformer_tpu.parallel.train import make_eval_step as jax_make_eval_step
from geotransformer_tpu.preprocess import DevicePreprocessPlan as JaxPlan
from geotransformer_tpu.preprocess.loader import PairLoader as JaxPairLoader

from geotransformer_tpu_torch import configs as port_configs
from geotransformer_tpu_torch.engine import CheckpointManager, Trainer
from geotransformer_tpu_torch.engine import Tester as PairTester  # pytest must not collect it
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.parallel import make_eval_step
from geotransformer_tpu_torch.preprocess import DevicePreprocessPlan, prepare_raw_pair
from geotransformer_tpu_torch.preprocess.loader import PairLoader
from geotransformer_tpu_torch.scripts import demo
from geotransformer_tpu_torch.scripts import test as test_script
from geotransformer_tpu_torch.scripts import trainval
from geotransformer_tpu_torch.utils.convert import variables_to_state_dict
from test_torch_device_preprocess import tie_rows
from test_torch_model import make_pair
from test_torch_scripts import narrow_config as script_config
from test_torch_scripts import write_threedmatch
from torch_routes import numpy_pyramids  # noqa: F401  (both packages on numpy)

CAPS = (512, 128, 64, 32)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def narrow(configs, stage_caps=CAPS, max_epoch=1):
    """A narrow 4-stage 3DMatch configuration of ``configs`` (the JAX or the
    port's module: the two are equal field by field)."""
    cfg = configs.make_3dmatch_config()
    return dataclasses.replace(
        cfg,
        backbone=configs.BackboneConfig(num_stages=4, init_voxel_size=0.06, init_dim=16,
                                        group_norm=8),
        model=configs.ModelConfig(num_points_in_patch=16, num_sinkhorn_iterations=10,
                                  force_pallas=False),
        coarse_matching=configs.CoarseMatchingConfig(num_targets=16, num_correspondences=32),
        geotransformer=configs.GeoTransformerModuleConfig(
            input_dim=256, hidden_dim=32, output_dim=32, blocks=("self", "cross"), num_heads=2),
        caps=configs.CapsConfig(stage_caps=stage_caps, neighbor_limits=(12, 12, 12, 12),
                                inverse_limits=(40, 40, 40, 40), gt_candidates=8,
                                gt_chunk_size=8, correspondence_capacity=256),
        optim=dataclasses.replace(cfg.optim, max_epoch=max_epoch))


class PairSet:
    """Seeded wavy-surface pairs (``make_pair``) as dataset samples."""

    def __init__(self, count, n=500, seed=40):
        self.samples = []
        for i in range(count):
            ref, src, transform = make_pair(seed + i, n=n)
            self.samples.append(dict(ref_points=ref, src_points=src, transform=transform,
                                     scene_name=f"scene{i % 2}", ref_frame=i, src_frame=i + 1))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        return self.samples[index]


def pipeline(cfg):
    bb = cfg.backbone
    return dict(num_stages=bb.num_stages, voxel_size=bb.init_voxel_size,
                search_radius=bb.init_radius, neighbor_limits=cfg.caps.neighbor_limits,
                stage_caps=cfg.caps.stage_caps, input_dim=bb.input_dim)


def test_raw_loader_yields_the_jax_loaders_groups():
    dataset = PairSet(3)
    buckets = [(384, 96, 48, 24), CAPS]
    want = list(JaxPairLoader(dataset, pipeline(narrow(jax_configs)), batch_size=1,
                              device_plan=JaxPlan(narrow(jax_configs), buckets=buckets)))
    cfg = narrow(port_configs)
    plan = DevicePreprocessPlan(cfg, buckets=buckets)
    got = list(PairLoader(dataset, pipeline(cfg), batch_size=1, device_plan=plan))
    loader = PairLoader(dataset, pipeline(cfg), batch_size=1, num_workers=1, device_plan=plan)
    try:
        from_worker = list(loader)
    finally:
        loader.close()
    assert len(got) == len(want) == len(from_worker) == 3
    for g, w, f in zip(got, want, from_worker):
        assert len(g) == len(w) == 1
        g, w, f = g[0], w[0], f[0]
        assert set(g) == set(w) == set(f) == {"raw_points", "raw_lengths", "raw_feats",
                                             "transform", "meta"}
        assert g["meta"] == w["meta"] == f["meta"]
        for key in ("raw_points", "raw_lengths", "raw_feats", "transform"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])
            np.testing.assert_array_equal(f[key], w[key])


def test_bucket_selection():
    cfg = narrow(port_configs)
    plan = DevicePreprocessPlan(cfg, buckets=[(256, 64, 32, 16), CAPS])
    # 500-point clouds exceed the first bucket's stage-0 capacity
    for group in PairLoader(PairSet(2, n=500), pipeline(cfg), device_plan=plan):
        assert group[0]["raw_points"].shape == (2 * 512, 3)
    for group in PairLoader(PairSet(2, n=250), pipeline(cfg), device_plan=plan):
        assert group[0]["raw_points"].shape == (2 * 256, 3)


def test_raw_eval_step_matches_jax():
    cfg_j, cfg_t = narrow(jax_configs), narrow(port_configs)
    sample = PairSet(1, seed=7)[0]
    raw = prepare_raw_pair(sample, CAPS[0])
    raw.pop("meta")
    plan_j = JaxPlan(cfg_j)
    example = jax.tree.map(jnp.asarray, {k: v for k, v in plan_j.host_batch(raw).items()
                                         if k != "meta"})
    model_j = create_jax_model(cfg_j)
    variables = jax.jit(lambda r, b: model_j.init(r, b, training=False, with_gt=True))(
        jax.random.PRNGKey(0), example)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       constants=variables["constants"], opt_state=())
    step_j = jax_make_eval_step(model_j, cfg_j, pyramid_spec=plan_j.spec(0, with_inverse=False))
    want = {k: float(v) for k, v in step_j(state, jax.tree.map(
        lambda x: jnp.asarray(x)[None], raw)).items()}

    model_t = create_model(cfg_t, device="cpu")
    model_t.load_state_dict(variables_to_state_dict(jax.tree.map(np.asarray, variables)))
    plan_t = DevicePreprocessPlan(cfg_t)
    got = {k: float(v) for k, v in make_eval_step(
        model_t, cfg_t, device="cpu", pyramid_spec=plan_t.spec(0, with_inverse=False))(
            raw).items()}
    assert got["pyramid_overflow"] == want["pyramid_overflow"] == 0.0
    for key in ("PIR", "IR", "RRE", "RTE", "RMSE", "RR", "loss", "c_loss", "f_loss"):
        assert np.isfinite(got[key]), key
    for key in ("PIR", "IR", "loss", "c_loss", "f_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(got["RTE"], want["RTE"], atol=1e-3)


def raw_trainer(tmp_path, cfg, plan, dataset, val=None):
    loader = PairLoader(dataset, pipeline(cfg), device_plan=plan)
    val_loader = None if val is None else PairLoader(val, pipeline(cfg), device_plan=plan)
    trainer = Trainer(cfg, create_model(cfg, device="cpu"), loader, val_loader,
                      output_dir=str(tmp_path / "out"), log_steps=1, tensorboard=False,
                      device="cpu", device_plan=plan)
    trainer.initialize()
    return trainer


def test_trainer_one_epoch_with_a_device_plan(tmp_path):
    cfg = narrow(port_configs)
    plan = DevicePreprocessPlan(cfg, with_inverse=True)
    trainer = raw_trainer(tmp_path, cfg, plan, PairSet(2), val=PairSet(1, seed=60))
    before = [p.detach().clone() for p in trainer.model.parameters()]
    trainer.run()
    assert [h["step"] for h in trainer.history] == [1, 2]
    for h in trainer.history:
        assert h["grad_finite"] == 1.0 and h["pyramid_overflow"] == 0.0
        assert np.isfinite(h["loss"])
    assert trainer.overflows == trainer.host_fallbacks == 0
    moved = [not torch.equal(a, b) for a, b in zip(before, trainer.model.parameters())]
    assert sum(moved) > len(moved) // 2
    state, _ = CheckpointManager(tmp_path / "out" / "checkpoints").restore()
    assert state["device_plan"] == {"buckets": [CAPS]}


@pytest.mark.parametrize("policy, buckets", [
    pytest.param("escalate", 2, id="escalate"),
    pytest.param("host", 1, id="host"),
    pytest.param("raise", 1, id="raise"),
    pytest.param("escalate", 1, id="escalate-past-the-last-bucket"),
    pytest.param(None, 1, id="default")])
def test_overflow_policies(tmp_path, policy, buckets):
    """A first bucket whose stage-1 cap (16) is far below the ~200 stage-1
    voxels of a pair: every group overflows on the device there. Only
    'host', asked for by name, runs the host pyramid; 'raise' is the
    default, and 'escalate' raises past the last bucket."""
    cfg = narrow(port_configs)
    buckets = [(512, 16, 8, 8), (544, 128, 64, 32)][:buckets]
    kwargs = {} if policy is None else {"overflow_policy": policy}
    plan = DevicePreprocessPlan(cfg, buckets=buckets, with_inverse=True, **kwargs)
    trainer = raw_trainer(tmp_path, cfg, plan, PairSet(1))
    if policy in ("raise", None) or len(buckets) == 1 and policy == "escalate":
        with pytest.raises(RuntimeError, match="overflow"):
            trainer.run()
        assert trainer.step == 0 and trainer.host_fallbacks == 0
        return
    trainer.run()
    (h,) = trainer.history
    assert h["grad_finite"] == 1.0 and np.isfinite(h["loss"])
    assert trainer.overflows == 1 and trainer.step == 1
    if policy == "escalate":
        assert set(trainer._bucket_train_steps) == {0, 1} and trainer.host_fallbacks == 0
        assert h["pyramid_overflow"] == 0.0
    else:
        assert trainer.host_fallbacks == 1 and "pyramid_overflow" not in h
    # every log line with a time names the host fallbacks behind it
    log = (tmp_path / "out" / "train.log").read_text()
    assert f"host_fallbacks {trainer.host_fallbacks}" in log.split("done in")[-1]


def test_tester_dumps_with_a_device_plan(tmp_path):
    cfg = narrow(port_configs)
    dataset = PairSet(2, seed=70)
    plan = DevicePreprocessPlan(cfg, buckets=[(512, 16, 8, 8), (544, 128, 64, 32)],
                                overflow_policy="escalate")
    tester = PairTester(cfg, create_model(cfg, device="cpu"),
                    PairLoader(dataset, pipeline(cfg), device_plan=plan),
                    output_dir=str(tmp_path / "out"), feature_dir=str(tmp_path / "features"),
                    device_plan=plan, device="cpu")
    summary, results = tester.run()
    assert len(results) == 2 and all(np.isfinite(v) for v in summary.values())
    assert tester.overflows == 2 and tester.host_fallbacks == 0  # each escalated once
    assert "overflows 2 host_fallbacks 0" in (tmp_path / "out" / "test.log").read_text()
    dumps = sorted((tmp_path / "features").glob("*/*.npz"))
    assert [d.name for d in dumps] == ["0_1.npz", "1_2.npz"]
    for dump in dumps:
        rot = np.load(dump)["estimated_transform"][:3, :3].astype(np.float64)
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-4)


def test_scripts_with_device_preprocess(tmp_path, monkeypatch, capsys):
    root = tmp_path / "3DMatch"
    cfg = script_config("3dmatch", write_threedmatch(root))
    monkeypatch.setattr(trainval, "make_config", lambda _: cfg)
    monkeypatch.setattr(test_script, "make_config", lambda _: cfg)
    out = tmp_path / "out"
    common = ["--dataset", "3dmatch", "--data_root", str(root), "--num_workers", "0",
              "--device", "cpu", "--device_preprocess"]
    trainer, metrics = trainval.main(common + ["--output_dir", str(out)])
    assert trainer.step == 2 and np.isfinite(metrics["loss"])
    assert all(h["grad_finite"] == 1.0 and h["pyramid_overflow"] == 0.0
               for h in trainer.history)
    assert trainer.train_loader.device_plan is trainer.device_plan
    summary = test_script.main(common + ["--benchmark", "3DMatch", "--checkpoint_dir",
                                         str(out / "checkpoints"), "--output_dir",
                                         str(out / "test")])
    assert "restored checkpoint step" in capsys.readouterr().out
    assert all(np.isfinite(v) for v in summary.values())
    dumps = sorted((out / "test" / "features" / "3DMatch").glob("*/*.npz"))
    assert len(dumps) == 2
    for dump in dumps:
        assert np.isfinite(np.load(dump)["estimated_transform"]).all()


# table -> (its rows' stage, its support's stage) of index i
STAGES = {"neighbors": lambda i: (i, i), "subsampling": lambda i: (i + 1, i),
          "upsampling": lambda i: (i, i + 1)}


def per_cloud(batch, key, index, caps_of):
    """A padded batch's valid rows of ``batch[key][index]`` as [ref rows, src
    rows]; table entries as cloud-local indices (sentinel -1)."""
    rows = batch[key][index]
    rows = rows.numpy() if isinstance(rows, torch.Tensor) else rows
    q_stage, s_stage = STAGES.get(key, lambda i: (i, i))(index)
    lengths = batch["lengths"][q_stage]
    cap_r = caps_of(q_stage)[0]
    out = [rows[:int(lengths[0])], rows[cap_r:cap_r + int(lengths[1])]]
    if key == "points":
        return out
    s_caps = caps_of(s_stage)
    local = []
    for cloud, table in enumerate(out):
        base = 0 if cloud == 0 else s_caps[0]
        valid = (table >= base) & (table < base + s_caps[cloud])
        local.append(np.where(valid, table - base, -1))
    return local


def test_demo_host_and_device_builders_agree():
    # the 3DMatch model at caps that hold the pair (the config's stage 0 of
    # 20,480 rows would only add padding rows to the CPU build)
    cfg = port_configs.make_3dmatch_config().with_caps(stage_caps=(2048, 1024, 512, 256))
    ref, src, transform = make_pair(5, n=2000)
    host, host_caps = demo.load_batch(cfg, ref, src, transform)
    dev, dev_caps, ms = demo.load_batch_device(cfg, ref, src, transform, "cpu")
    assert ms > 0 and dev_caps == tuple(cfg.caps.stage_caps)
    host_of = lambda s: host_caps[s]  # noqa: E731
    dev_of = lambda s: (dev_caps[s], dev_caps[s])  # noqa: E731
    stages = cfg.backbone.num_stages
    for s in range(stages):
        np.testing.assert_array_equal(dev["lengths"][s].numpy(), host["lengths"][s])
        for g, w in zip(per_cloud(dev, "points", s, dev_of), per_cloud(host, "points", s, host_of)):
            np.testing.assert_allclose(g, w, atol=1e-4)
    for key in STAGES:
        for i in range(stages if key == "neighbors" else stages - 1):
            q_stage, s_stage = STAGES[key](i)
            radius = cfg.backbone.init_radius * 2 ** (q_stage if key == "upsampling" else s_stage)
            radius *= 2 if key == "upsampling" else 1
            got, want = per_cloud(dev, key, i, dev_of), per_cloud(host, key, i, host_of)
            for cloud in range(2):
                q_pts = per_cloud(dev, "points", q_stage, dev_of)[cloud]
                s_pts = per_cloud(dev, "points", s_stage, dev_of)[cloud]
                rows = tie_rows(got[cloud], want[cloud], q_pts, s_pts, -1, radius)
                # at most 5 % of a table's rows, or 3 rows of a small one
                assert len(rows) <= max(0.05 * len(got[cloud]), 3), (key, i, cloud, rows)
