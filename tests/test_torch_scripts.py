"""The port's command-line scripts on the CPU (``--device cpu``).

  * ``trainval`` then ``test`` for 3DMatch, KITTI and ModelNet, each on data
    written from a seed in the dataset's layout, with ``make_config``
    patched to narrow widths and one epoch (ModelNet: two iterations), caps
    calibrated over the data with room for the augmentation: training
    writes its checkpoint, the test restores it and dumps one npz a pair,
    which ``eval`` reads;
  * ``test --torch_snapshot``: a state_dict saved with ``torch.save``
    loads straight into the model and gives the checkpoint's dumps;
    a checkpoint records the caps and input route it was trained with, and
    ``test`` restores them with the weights (caps doubled and no edge stream
    in an edited checkpoint);
  * the refusals: ``--device cuda`` without a card, ``--batch_size 2``, a
    Tester's device-preprocess plan under the ``raise`` policy on a pair
    that overflows; ``--device_preprocess`` is taken (the runs themselves:
    tests/test_torch_device_pipeline.py);
  * ``make_config`` equal to the JAX package's field by field;
  * ``calibrate`` prints the caps the JAX calibration functions give on
    the same 3DMatch files, and ``eval_dgr`` prints the JAX script's tables
    on the same dumps, for its three methods;
  * the port's scripts import with jax blocked (tests/test_torch_targets.py
    walks them with the rest of the package).
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from geotransformer_tpu import configs as jax_configs

from geotransformer_tpu_torch import configs as port_configs
from geotransformer_tpu_torch.configs import (
    BackboneConfig,
    CapsConfig,
    CoarseMatchingConfig,
    ModelConfig,
)
from geotransformer_tpu_torch.datasets import (
    ModelNetPairDataset,
    OdometryKittiPairDataset,
    ThreeDMatchPairDataset,
)
from geotransformer_tpu_torch.engine import CheckpointManager
from geotransformer_tpu_torch.engine import tester as port_tester
from geotransformer_tpu_torch.preprocess import (
    DevicePreprocessPlan,
    calibrate_stage_caps,
    prepare_raw_pair,
    round_up,
)
from geotransformer_tpu_torch.scripts import calibrate as calibrate_script
from geotransformer_tpu_torch.scripts import eval as eval_script
from geotransformer_tpu_torch.scripts import eval_dgr
from geotransformer_tpu_torch.scripts import synthetic_benchmark
from geotransformer_tpu_torch.scripts import test as test_script
from geotransformer_tpu_torch.scripts import trainval
from test_torch_kitti import lattice_pair
from test_torch_model import make_pair
from test_torch_modelnet import write_modelnet_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers, where more threads a worker only add to the total CPU time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def write_threedmatch(root, pairs=2):
    """3DMatch layout: metadata/{train,val,3DMatch}.pkl, data/*.pth."""
    (root / "metadata").mkdir(parents=True)
    (root / "data" / "scene_a").mkdir(parents=True)
    metadata = []
    for i in range(pairs):
        ref, src, transform = make_pair(30 + i)
        for name, points in ((f"cloud_{2 * i}.pth", ref), (f"cloud_{2 * i + 1}.pth", src)):
            torch.save(points, root / "data" / "scene_a" / name)
        metadata.append(dict(scene_name="scene_a", frag_id0=2 * i, frag_id1=2 * i + 1,
                             overlap=0.7, rotation=transform[:3, :3].astype(np.float64),
                             translation=transform[:3, 3].astype(np.float64),
                             pcd0=f"scene_a/cloud_{2 * i}.pth", pcd1=f"scene_a/cloud_{2 * i + 1}.pth"))
    for subset in ("train", "val", "3DMatch"):
        with open(root / "metadata" / f"{subset}.pkl", "wb") as f:
            pickle.dump(metadata, f)
    return ThreeDMatchPairDataset(str(root), "train")


def write_kitti(root, pairs=2):
    """KITTI layout: metadata/{train,val,test}.pkl, scans/*.npy."""
    (root / "metadata").mkdir(parents=True)
    (root / "scans").mkdir()
    metadata = []
    for i in range(pairs):
        ref, src, transform = lattice_pair(seed=i)
        np.save(root / "scans" / f"{i}_0.npy", ref)
        np.save(root / "scans" / f"{i}_1.npy", src)
        metadata.append(dict(seq_id=8, frame0=i, frame1=i + 1, pcd0=f"scans/{i}_0.npy",
                             pcd1=f"scans/{i}_1.npy", transform=transform.astype(np.float64)))
    for subset in ("train", "val", "test"):
        with open(root / "metadata" / f"{subset}.pkl", "wb") as f:
            pickle.dump(metadata, f)
    return OdometryKittiPairDataset(str(root), "train")


def write_modelnet(root):
    root.mkdir()
    write_modelnet_pickle(root, seed=8, entries=2)
    return ModelNetPairDataset(str(root), "train", num_points=717, noise_magnitude=0.05,
                               keep_ratio=0.7, twice_sample=True, deterministic=True)


def narrow_config(name, dataset):
    """make_config(name) at narrow widths, one epoch (two iterations), caps
    calibrated over ``dataset`` with twice the room (the augmentation
    rotates and scales the clouds)."""
    cfg = port_configs.make_config(name)
    if name == "3dmatch":
        cfg = dataclasses.replace(
            cfg, backbone=BackboneConfig(init_voxel_size=0.06, init_dim=16, group_norm=8),
            model=ModelConfig(num_points_in_patch=16, num_sinkhorn_iterations=10),
            caps=CapsConfig(neighbor_limits=(12,) * 4))
    elif name == "kitti":
        cfg = dataclasses.replace(
            cfg, backbone=BackboneConfig(num_stages=5, init_voxel_size=0.125, base_radius=4.25,
                                         init_dim=8, group_norm=4),
            model=ModelConfig(ground_truth_matching_radius=0.3, num_points_in_patch=16,
                              fine_level=1, num_sinkhorn_iterations=10),
            caps=CapsConfig(neighbor_limits=(16,) * 5, inverse_limits=(48,) * 5))
    else:
        cfg = dataclasses.replace(
            cfg, backbone=BackboneConfig(num_stages=3, init_voxel_size=0.05, init_dim=16,
                                         group_norm=8),
            model=ModelConfig(ground_truth_matching_radius=0.05, num_points_in_patch=16,
                              fine_level=0, num_sinkhorn_iterations=10),
            caps=CapsConfig(neighbor_limits=(34,) * 3))
    cfg = dataclasses.replace(
        cfg,
        optim=dataclasses.replace(cfg.optim, max_epoch=1, max_iteration=2, snapshot_steps=2,
                                  warmup_steps=1),
        geotransformer=dataclasses.replace(
            cfg.geotransformer, input_dim=cfg.backbone.init_dim * 2 ** cfg.backbone.num_stages,
            hidden_dim=32, output_dim=32, blocks=("self", "cross"), num_heads=2),
        coarse_matching=CoarseMatchingConfig(num_targets=16, num_correspondences=16))
    bb = cfg.backbone
    caps = calibrate_stage_caps((dataset[i] for i in range(len(dataset))), bb.num_stages,
                                bb.init_voxel_size, bb.init_radius,
                                list(cfg.caps.neighbor_limits), num_samples=len(dataset),
                                multiple=32)
    caps = tuple(round_up(2 * c, 64) for c in caps)
    return cfg.with_caps(stage_caps=caps, gt_candidates=8, gt_chunk_size=8,
                         correspondence_capacity=256)


WRITERS = {"3dmatch": (write_threedmatch, "3DMatch"), "kitti": (write_kitti, "Kitti"),
           "modelnet": (write_modelnet, "ModelNet")}


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_trainval_test_eval(tmp_path, monkeypatch, capsys, name):
    writer, folder = WRITERS[name]
    root = tmp_path / folder
    cfg = narrow_config(name, writer(root))
    monkeypatch.setattr(trainval, "make_config", lambda _: cfg)
    monkeypatch.setattr(test_script, "make_config", lambda _: cfg)
    out = tmp_path / "out"
    common = ["--dataset", name, "--data_root", str(root), "--num_workers", "0",
              "--device", "cpu"]
    trainer, metrics = trainval.main(common + ["--output_dir", str(out)]
                                     + (["--iters"] if name == "modelnet" else []))
    assert trainer.step == 2 and np.isfinite(metrics["loss"])
    assert all(h["grad_finite"] == 1.0 for h in trainer.history)
    assert trainer.checkpoints.all_steps() == [trainer.step if name == "modelnet" else 1]

    benchmark = ["--benchmark", "3DMatch"] if name == "3dmatch" else []
    summary = test_script.main(common + benchmark + [
        "--checkpoint_dir", str(out / "checkpoints"), "--output_dir", str(out / "test")])
    assert "restored checkpoint step" in capsys.readouterr().out
    assert all(np.isfinite(v) for v in summary.values()) and "RR" in summary
    feature_dir = out / "test" / "features" / (benchmark[1] if benchmark else "test")
    dumps = sorted(feature_dir.glob("*/*.npz"))
    assert len(dumps) == 2
    for dump in dumps:
        data = np.load(dump)
        rot = data["estimated_transform"][:3, :3].astype(np.float64)
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-4)

    # a reference-style state_dict ({"model": ...}) gives the same dumps
    state, step = trainer.checkpoints.restore()
    snapshot = tmp_path / "snapshot.pth.tar"
    torch.save({"model": state["model"]}, snapshot)
    test_script.main(common + benchmark + ["--torch_snapshot", str(snapshot),
                                           "--output_dir", str(out / "snapshot")])
    for dump in dumps:
        again = np.load(out / "snapshot" / dump.relative_to(out / "test"))
        np.testing.assert_array_equal(again["estimated_transform"],
                                      np.load(dump)["estimated_transform"])

    # the checkpoint's caps and input route: the trainer's, and in an edited
    # checkpoint doubled caps and the input conv over the neighbor table
    assert state["pipeline"] == {"stage_caps": tuple(cfg.caps.stage_caps), "input_stream": True}
    caps = tuple(2 * c for c in cfg.caps.stage_caps)
    state["pipeline"] = {"stage_caps": caps, "input_stream": False}
    CheckpointManager(tmp_path / "edited").save(step, state)
    pipelines = []
    loader = test_script.PairLoader
    monkeypatch.setattr(test_script, "PairLoader",
                        lambda dataset, pipeline, **kw: pipelines.append(pipeline)
                        or loader(dataset, pipeline, **kw))
    test_script.main(common + benchmark + ["--checkpoint_dir", str(tmp_path / "edited"),
                                           "--output_dir", str(out / "caps")])
    assert pipelines[-1]["stage_caps"] == caps and pipelines[-1]["input_stream"] is False
    for dump in dumps:
        again = np.load(out / "caps" / dump.relative_to(out / "test"))
        np.testing.assert_allclose(again["ref_points"], np.load(dump)["ref_points"])
        assert np.isfinite(again["estimated_transform"]).all()

    capsys.readouterr()
    eval_script.main(["--dataset", name, "--feature_dir", str(feature_dir), "--device", "cpu"])
    table = capsys.readouterr().out
    assert table.startswith("Overall (lgr):") and "RR: " in table


SCRIPT_ARGS = {
    "trainval": (trainval, ["--dataset", "3dmatch", "--data_root", "none"]),
    "test": (test_script, ["--dataset", "kitti", "--data_root", "none"]),
    "eval": (eval_script, ["--dataset", "modelnet", "--feature_dir", "none"]),
    "eval_dgr": (eval_dgr, ["--feature_dir", "none"]),
    "synthetic_benchmark": (synthetic_benchmark, ["--scale", "small"]),
}


@pytest.mark.parametrize("name", sorted(SCRIPT_ARGS))
def test_device_cuda_without_a_card_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, args = SCRIPT_ARGS[name]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        module.main(args)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        module.main(args + ["--device", "cuda:0"])


@pytest.mark.parametrize("extra, error, match", [
    (["--batch_size", "2"], ValueError, "one pair a step"),
    # taken now: the run goes on to read the (absent) data
    (["--device_preprocess"], FileNotFoundError, "none/metadata/train.pkl"),
], ids=["batch-size", "device-preprocess"])
def test_trainval_refusals(extra, error, match):
    with pytest.raises(error, match=match):
        trainval.main(["--dataset", "3dmatch", "--data_root", "none", "--device", "cpu"] + extra)


def test_tester_refuses_a_device_plan(tmp_path):
    """A device plan under the ``raise`` policy refuses a pair whose pyramid
    overflows its caps (before any forward: the model is None)."""
    cfg = port_configs.make_config("3dmatch")
    plan = DevicePreprocessPlan(cfg, buckets=[(256, 8, 8, 8)], overflow_policy="raise")
    tester = port_tester.Tester(cfg, None, [], output_dir=str(tmp_path), device_plan=plan,
                                device="cpu")
    ref, src, transform = make_pair(3, n=200)
    raw = prepare_raw_pair({"ref_points": ref, "src_points": src, "transform": transform}, 256)
    raw.pop("meta")
    with pytest.raises(RuntimeError, match="overflow"):
        tester._run_pair(raw)


@pytest.mark.parametrize("name", ["3dmatch", "kitti", "modelnet"])
def test_make_config_matches_jax(name):
    want = dataclasses.asdict(jax_configs.make_config(name))
    got = dataclasses.asdict(port_configs.make_config(name))
    # the one difference: the port's precision point defaults to float32
    assert got.pop("precision") == {knob: "float32" for knob in want.pop("precision")}
    assert got == want


def test_test_refuses_device_preprocess():
    """``--device_preprocess`` is taken now: the run goes on to read the
    (absent) data."""
    with pytest.raises(FileNotFoundError, match="none/metadata/3DMatch.pkl"):
        test_script.main(["--dataset", "3dmatch", "--data_root", "none", "--benchmark",
                          "3DMatch", "--device", "cpu", "--device_preprocess"])


def test_calibrate_matches_jax(tmp_path, capsys):
    from geotransformer_tpu import preprocess as jax_preprocess
    from geotransformer_tpu.datasets import ThreeDMatchPairDataset as JaxThreeDMatch

    write_threedmatch(tmp_path, pairs=3)
    got = calibrate_script.main(["--dataset", "3dmatch", "--data_root", str(tmp_path),
                                 "--num_samples", "3"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(got))

    # the body of scripts/calibrate.py on the JAX functions and dataset
    cfg, bb = jax_configs.make_config("3dmatch"), jax_configs.make_config("3dmatch").backbone
    dataset = JaxThreeDMatch(str(tmp_path), "train", point_limit=30000)

    def sample_iter():
        for i in range(len(dataset)):
            yield dataset[i]

    geometry = (bb.num_stages, bb.init_voxel_size, bb.init_radius)
    limits = jax_preprocess.calibrate_neighbor_limits(sample_iter(), *geometry)
    inverse, sub_inverse = jax_preprocess.calibrate_inverse_limits(
        sample_iter(), *geometry, limits, num_samples=3)
    splits, sub_splits = jax_preprocess.calibrate_split_specs(sample_iter(), *geometry, limits,
                                                              num_samples=3)
    want = {
        "neighbor_limits": limits,
        "stage_caps": jax_preprocess.calibrate_stage_caps(sample_iter(), *geometry, limits,
                                                          num_samples=3, quantile=1.0),
        "inverse_limits": inverse, "sub_inverse_limits": sub_inverse,
        "neighbor_splits": splits, "subsampling_splits": sub_splits,
    }
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))


def write_dgr_dumps(root, seed=0):
    """Feature dumps in the layout of scripts.test (a directory a scene, one
    npz a pair): correspondences of a known transform with outliers."""
    rng = np.random.default_rng(seed)
    for scene in ("scene_a", "scene_b"):
        (root / scene).mkdir(parents=True)
        for pair in range(2):
            ref, src, transform = make_pair(40 + 3 * pair + (scene == "scene_b"), n=300)
            src_corr = src[rng.integers(0, len(src), 60)]
            ref_corr = src_corr @ transform[:3, :3].T + transform[:3, 3]
            failing = scene == "scene_b" and pair == 1  # no method registers this pair
            outliers = 55 if failing else 20
            ref_corr[:outliers] += rng.normal(scale=1.0 if failing else 0.2,
                                              size=(outliers, 3)).astype(np.float32)
            estimated = transform.copy()
            estimated[:3, 3] += 1.0 if failing else 0.05
            nodes = rng.integers(0, 16, (12, 2))
            np.savez(root / scene / f"{pair}_{pair + 1}.npz",
                     ref_points_c=ref[:16], src_points_c=src[:16],
                     ref_node_corr_indices=nodes[:, 0], src_node_corr_indices=nodes[:, 1],
                     gt_node_corr_indices=nodes[rng.uniform(size=12) < 0.5 + 0.2 * pair],
                     ref_corr_points=ref_corr.astype(np.float32), src_corr_points=src_corr,
                     corr_scores=rng.uniform(0.1, 1.0, 60).astype(np.float32),
                     transform=transform, estimated_transform=estimated)


def _overall(text):
    section = text.split("== overall (DGR protocol) ==")[1]
    return {line.split(":")[0].strip(): float(line.split(":")[1])
            for line in section.strip().splitlines()}


@pytest.mark.parametrize("method", ["lgr", "ransac", "svd"])
def test_eval_dgr_matches_jax(tmp_path, monkeypatch, capsys, method):
    import importlib.util
    import sys

    write_dgr_dumps(tmp_path)
    spec = importlib.util.spec_from_file_location(
        "jax_eval_dgr", os.path.join(REPO, "scripts", "eval_dgr.py"))
    jax_eval_dgr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_eval_dgr)
    args = ["--feature_dir", str(tmp_path), "--method", method, "--num_corr", "50",
            "--ransac_iterations", "200"]
    monkeypatch.setattr(sys, "argv", ["eval_dgr.py"] + args)
    jax_eval_dgr.main()
    want = capsys.readouterr().out
    got = eval_dgr.main(args + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert 0 < got["RR"] < 1  # some pairs registered, some not
    if method == "svd":  # SVD of two libraries: the rotation errors agree to rounding
        w, g = _overall(want), _overall(text)
        assert sorted(w) == sorted(g)
        for key in w:
            assert abs(g[key] - w[key]) <= 2e-4, key
    else:
        assert text == want
