"""The port's timing helpers, profiling tools, drift tools and shell drivers
on the CPU, at narrow widths and small synthetic pairs:

  * ``utils.timing``: every helper raises without a CUDA device (no host
    clock stands in for the card); ``on_card`` runs the work once on the
    CPU and measures nothing;
  * each profiling tool's ``main`` with ``--device cpu`` (``profile_stages``,
    ``profile_forward`` for 3DMatch and ``--kitti``, ``profile_train``,
    ``profile_ops``, ``profile_kpconv``, ``profile_device``,
    ``profile_batch``) prints the card line first and its result line last,
    every time "not measured"; each raises with ``--device cuda`` and no
    card; ``probe_kernels`` raises without a card, and each probe's inputs
    reach its wrapper's plain version; the kernel families of
    ``profile_ops`` name the hand-written kernels;
  * ``train_smoke`` takes its steps and prints its losses;
  * ``drift`` at 2 steps on one pair: the ``kernels`` route equals the
    ``f32`` route bit for bit on the CPU (the wrappers take their plain
    versions there) and passes its gate; ``drift_attrib`` on its weights;
  * ``eval.sh`` runs ``scripts.test`` then ``scripts.eval`` on a 3DMatch
    layout written from a seed (narrow widths through ``PYTHON``, a shim
    interpreter), ``eval_all.sh`` skips epochs without a checkpoint, and
    ``bash -n`` parses both and the convergence suite;
  * ``synthetic_benchmark`` takes the restored flags: the data seed and
    test fragments pick the scenes, the learning rate, its decay, the
    model seed and the kernel route reach the configuration;
  * the package walk finds every new module (``tests/test_torch_targets.py``
    imports each with JAX blocked).
"""

import dataclasses
import json
import os
import pickle
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import geotransformer_tpu_torch
from geotransformer_tpu_torch import configs
from geotransformer_tpu_torch.configs import (
    BackboneConfig,
    CapsConfig,
    CoarseMatchingConfig,
    ModelConfig,
)
from geotransformer_tpu_torch.scripts import (
    drift,
    drift_attrib,
    pairs,
    probe_kernels,
    profile_batch,
    profile_device,
    profile_forward,
    profile_kpconv,
    profile_ops,
    profile_stages,
    profile_train,
    synthetic_benchmark,
    train_smoke,
)
from geotransformer_tpu_torch.utils import timing
from test_torch_model import make_pair
from test_torch_scripts import narrow_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "geotransformer_tpu_torch", "scripts")
TOOLS = {"profile_stages": profile_stages, "profile_forward": profile_forward,
         "profile_train": profile_train, "profile_ops": profile_ops,
         "profile_kpconv": profile_kpconv, "profile_device": profile_device,
         "profile_batch": profile_batch}


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers, where more threads a worker only add to the total CPU time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def narrow(cfg, caps=None):
    """``cfg`` at narrow widths (init_dim 8, hidden 32, 2 heads, 16-point
    patches, 10 Sinkhorn iterations)."""
    cfg = dataclasses.replace(
        cfg, backbone=dataclasses.replace(cfg.backbone, init_dim=8, group_norm=4),
        model=ModelConfig(num_points_in_patch=16, num_sinkhorn_iterations=10),
        geotransformer=dataclasses.replace(
            cfg.geotransformer, input_dim=8 * 2 ** cfg.backbone.num_stages, hidden_dim=32,
            output_dim=32, blocks=("self", "cross"), num_heads=2),
        coarse_matching=CoarseMatchingConfig(num_targets=16, num_correspondences=16))
    return cfg.with_caps(gt_candidates=8, gt_chunk_size=8, correspondence_capacity=256,
                         **({} if caps is None else dict(stage_caps=caps)))


def tiny_tool_config(kitti):
    if kitti:
        cfg = configs.make_kitti_config()
        cfg = dataclasses.replace(cfg, caps=CapsConfig(neighbor_limits=(12,) * 5,
                                                       inverse_limits=(48,) * 5))
        return narrow(cfg)
    cfg = dataclasses.replace(configs.make_3dmatch_config(),
                              backbone=BackboneConfig(init_voxel_size=0.06),
                              caps=CapsConfig(neighbor_limits=(12,) * 4, inverse_limits=(48,) * 4))
    return narrow(cfg)


@pytest.fixture()
def tiny_tools(monkeypatch):
    """The tools at narrow widths on small pairs (1,500 surface points; a
    LiDAR pair from 6,000 rays); the smoke and the drift tools narrow too,
    on one 1,200-point pair."""
    monkeypatch.setattr(pairs, "tool_config", tiny_tool_config)
    monkeypatch.setattr(pairs, "make_tool_pair", lambda kitti, seed: (
        pairs.make_kitti_pair(seed, n_rays=6000) if kitti else
        pairs.make_3dmatch_pair(seed, n_ref=1500)))
    smoke = train_smoke.smoke_config
    monkeypatch.setattr(train_smoke, "smoke_config",
                        lambda: narrow(smoke(), caps=(1280, 768, 256, 128)))
    monkeypatch.setattr(train_smoke, "PAIRS", 1)
    monkeypatch.setattr(train_smoke, "POINTS", 1200)


def result_line(out):
    lines = out.strip().splitlines()
    assert lines[0] == "device cpu: no card, times not measured"
    result = json.loads(lines[-1])
    return lines, result


# --- utils/timing.py ---------------------------------------------------------

def test_timing_helpers_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = []
    for helper, args in ((timing.graph_ms, ()), (timing.time_ms, (3,)),
                         (timing.top_device_ops, ())):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            helper(lambda: calls.append(1), *args)
    assert calls == []  # nothing ran, nothing was timed on the host
    assert timing.on_card("cpu", timing.time_ms, lambda: calls.append(1), 5) is None
    assert calls == [1]
    assert timing.fmt_ms(None) == "not measured" and timing.fmt_ms(1.23456) == "1.235 ms"
    assert timing.card("cpu") == "device cpu: no card, times not measured"


# --- the profiling tools -----------------------------------------------------

@pytest.mark.parametrize("name, extra", [
    ("profile_stages", []), ("profile_forward", []), ("profile_forward", ["--kitti"]),
    ("profile_train", []), ("profile_ops", []), ("profile_kpconv", []),
    ("profile_device", []), ("profile_batch", ["--reps", "1"])],
    ids=["stages", "forward", "forward-kitti", "train", "ops", "kpconv", "device", "batch"])
def test_tool_runs_on_the_cpu(tiny_tools, capsys, name, extra):
    returned = TOOLS[name].main(["--device", "cpu"] + extra)
    lines, result = result_line(capsys.readouterr().out)
    assert result["tool"] == name
    assert any("not measured" in line for line in lines[1:-1])
    if name == "profile_stages":
        assert set(result["stages"]) == set(returned) and len(returned) == 5
        assert all(v["graph_ms"] is None and v["events_ms"] is None for v in returned.values())
    elif name == "profile_train":
        # on the CPU the profile and the timing each run one step
        assert len(result["losses"]) == 2 and np.isfinite(result["losses"]).all()
    elif name == "profile_kpconv":
        assert result["kpconv_fused"]["max_abs_err"] == 0.0  # both calls take the plain version
    elif name == "profile_device":
        assert len(result["phases"]) == 3 + 4 + 6 + 2 and len(result["stage0"]) == 3
    elif name == "profile_batch":
        assert sorted(result["batches"]) == ["1", "2", "4", "8"]


@pytest.mark.parametrize("name", sorted(TOOLS) + ["train_smoke", "drift", "drift_attrib"])
def test_tool_cuda_without_a_card_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module = {**TOOLS, "train_smoke": train_smoke, "drift": drift,
              "drift_attrib": drift_attrib}[name]
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        module.main([])


def test_kernel_families_name_the_hand_written_kernels():
    for name in ("void kpconv::gemm_3xtf32_kernel<64, 64, 2, 4, false>(float const*)",
                 "(anonymous namespace)::grid_search_kernel(float const*, int const*)",
                 "void (anonymous namespace)::sinkhorn_bwd_train_kernel<64>(float*)"):
        assert profile_ops.family(name) == "hand-written", name
    assert profile_ops.family("sm90_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize128x128") == "gemm"
    assert profile_ops.family("void at::native::reduce_kernel<512, 1>") == "reduction / scan"
    assert profile_ops.family("void (anonymous namespace)::indexing_backward_kernel") == "indexing"


def test_probe_kernels_raise_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        probe_kernels.main(["all"])
    assert probe_kernels.main(["--list"]) == {}
    assert capsys.readouterr().out.split() == list(probe_kernels.PROBES)
    with pytest.raises(SystemExit, match="unknown probes"):
        probe_kernels.main(["no_such_kernel"])


@pytest.mark.parametrize("name", sorted(probe_kernels.PROBES))
def test_probe_inputs_reach_the_plain_version(name):
    """Each probe's inputs, built as on the card, fit its wrapper: the plain
    version (force=False) runs on them and agrees with itself."""
    for call in probe_kernels.probe_calls(name, torch.device("cpu")):
        assert probe_kernels.largest_difference(call(False), call(False)) == 0.0


@pytest.mark.parametrize("name", ["gse_embedding_full", "gse_full_bwd"])
def test_gse_probes_take_both_kernel_widths(name):
    """The GSE probes call C = 256 and C = 96, the widths of their kernels'
    two tilings."""
    calls = probe_kernels.probe_calls(name, torch.device("cpu"))
    widths = [call(False)[0].shape[-1] for call in calls]
    assert widths == [256, 96]


def test_probes_cover_every_kernel_wrapper():
    from geotransformer_tpu_torch.kernels import cuda

    wrappers = set()
    for module in ("attention", "gse", "kpconv", "overlap", "pyramid", "sinkhorn"):
        path = os.path.join(os.path.dirname(cuda.__file__), f"{module}.py")
        with open(path) as f:
            wrappers.update(line.split('cuda.launches["')[1].split('"')[0]
                            for line in f if 'cuda.launches["' in line)
    wrappers |= {"kpconv_fused", "kpconv_split_fused"}  # counted by name in _conv_launch
    assert wrappers == set(probe_kernels.PROBES)


def test_lost_kernel_events_holds_events_against_launches():
    """A profile's hand-written kernel events against the launches counted
    in it: wrappers that share a kernel are counted together, and only a
    shortfall is reported."""
    events = [("void edge_kernel<64, false, 8>(EdgeArgs, Extras)", 10),
              ("void gse_kernel<256>(...)", 2), ("void at::native::cat_kernel", 40)]
    whole = {"kpconv_fused": 7, "kpconv_split_fused": 3, "gse_embedding_full": 2}
    assert timing.lost_kernel_events(events, whole) == {}
    short = dict(whole, kpconv_stream_fused=1, gse_embedding_full=3)
    assert timing.lost_kernel_events(events, short) == {
        "kpconv_stream_fused": (1, 0), "gse_embedding_full": (3, 2)}
    assert timing.lost_kernel_events(events, dict(whole, kpconv_split_fused=4)) == {
        "kpconv_fused+kpconv_split_fused": (11, 10)}
    assert set(timing.KERNEL_SYMBOLS) == set(probe_kernels.PROBES)


# --- train_smoke, drift, drift_attrib ----------------------------------------

def test_train_smoke_takes_its_steps(tiny_tools, capsys):
    losses = train_smoke.main(["--steps", "2", "--device", "cpu", "--min_drop", "-100"])
    out = capsys.readouterr().out
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert out.strip().splitlines()[-1] == "OK"


def test_drift_kernels_route_is_the_f32_route_on_the_cpu(tiny_tools, tmp_path, capsys):
    weights = str(tmp_path / "weights.pt")
    report, outs = drift.main(["--steps", "2", "--device", "cpu", "--weights", weights])
    printed = capsys.readouterr().out
    assert "kernels route bit-equal to the f32 route: True" in printed
    assert printed.strip().splitlines()[-1] == "PASS"
    for got, want in zip(outs["kernels"], outs["f32"]):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    assert report["kernels"]["feats_c"] == report["f32"]["feats_c"] > 0.0
    assert report["f64"]["feats_c"] == 0.0
    capsys.readouterr()
    rows = drift_attrib.main(["--device", "cpu", "--weights", weights])
    assert set(rows) == {"all kernels", "kpconv plain", "gse plain", "attention plain",
                         "sinkhorn plain", "all plain (f32)"}
    assert len({row["digest"] for row in rows.values()}) == 1  # every route the plain one here
    # the precision knobs' sweep: seven bfloat16 points, each farther from
    # float64 than the float32 point (the plain versions round here too)
    points = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["points"]
    assert len(points) == 7 and "kpconv_mxu+gse_basis+gse_embed" in points
    assert all(p["feats_c"] > rows["all kernels"]["feats_c"] for p in points.values())


def test_drift_routes_check_their_launches():
    """A plain route that launches a hand-written kernel raises; on the CPU a
    kernels route launches none and does not."""
    from geotransformer_tpu_torch.kernels import cuda

    with drift.launching("cpu", True):
        pass
    with drift.launching("cpu", False):
        pass
    with pytest.raises(RuntimeError, match="a plain route launched 1"):
        with drift.launching("cpu", False):
            cuda.launches["gse_embedding_full"] += 1
    cuda.launches["gse_embedding_full"] -= 1


def test_drift_routes_the_chosen_wrappers_plain():
    """Within plain_wrappers the chosen wrappers run with force=False
    wherever the package holds them (a CPU call with force=True, which
    raises outside, takes the plain version), and are restored after."""
    from geotransformer_tpu_torch.kernels import gse

    original = gse.gse_embedding_full
    held = [name for name, module in sys.modules.items()
            if name.startswith("geotransformer_tpu_torch.")
            and getattr(module, "gse_embedding_full", None) is original]
    assert "geotransformer_tpu_torch.kernels.gse" in held
    g = torch.Generator().manual_seed(0)
    args = (torch.rand(6, 3, generator=g), torch.randn(6, 3, 3, generator=g),
            *(torch.randn(8, 8, generator=g), torch.randn(8, generator=g)) * 2, 0.2, 15.0)
    with pytest.raises(RuntimeError, match="force_pallas=True needs CUDA tensors"):
        gse.gse_embedding_full(*args, force=True)
    with drift.plain_wrappers(("gse_embedding_full",)):
        for name in held:
            assert getattr(sys.modules[name], "gse_embedding_full") is not original
        got = gse.gse_embedding_full(*args, force=True)
    np.testing.assert_array_equal(got.numpy(), original(*args, force=False).numpy())
    assert all(getattr(sys.modules[name], "gse_embedding_full") is original for name in held)
    with pytest.raises(ValueError, match="no kernel wrapper"):
        with drift.plain_wrappers(("no_such_wrapper",)):
            pass


# --- the shell drivers -------------------------------------------------------

def write_layout(root):
    """A 3DMatch layout of two pairs of one scene (fragments 0-2 and 1-3,
    not adjacent, so the protocol scores them) and its gt.log / gt.info."""
    (root / "data" / "scene_a").mkdir(parents=True)
    protocol = root / "metadata" / "benchmarks" / "3DMatch" / "scene_a"
    protocol.mkdir(parents=True)
    metadata, log, info = [], [], []
    for i, (a, b) in enumerate(((0, 2), (1, 3))):
        ref, src, transform = make_pair(40 + i)
        torch.save(ref, root / "data" / "scene_a" / f"cloud_{a}.pth")
        torch.save(src, root / "data" / "scene_a" / f"cloud_{b}.pth")
        metadata.append(dict(scene_name="scene_a", frag_id0=a, frag_id1=b, overlap=0.7,
                             rotation=transform[:3, :3].astype(np.float64),
                             translation=transform[:3, 3].astype(np.float64),
                             pcd0=f"scene_a/cloud_{a}.pth", pcd1=f"scene_a/cloud_{b}.pth"))
        log += [f"{a}\t{b}\t4\n"] + ["\t".join(f"{x:.8f}" for x in row) + "\n"
                                       for row in transform.tolist()]
        info += [f"{a}\t{b}\t4\n"] + ["\t".join(f"{x:.8f}" for x in row) + "\n"
                                        for row in (0.01 * np.eye(6)).tolist()]
    with open(root / "metadata" / "3DMatch.pkl", "wb") as f:
        pickle.dump(metadata, f)
    (protocol / "gt.log").write_text("".join(log))
    (protocol / "gt.info").write_text("".join(info))


SHIM = """import pickle, runpy, sys
from geotransformer_tpu_torch import configs
with open({path!r}, "rb") as f:
    cfg = pickle.load(f)
configs.make_config = lambda name: cfg
assert sys.argv[1] == "-m"
sys.argv = [sys.argv[2]] + sys.argv[3:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def test_eval_sh_runs_test_then_eval(tmp_path):
    from geotransformer_tpu_torch.datasets import ThreeDMatchPairDataset

    root = tmp_path / "3DMatch"
    write_layout(root)
    cfg = narrow_config("3dmatch", ThreeDMatchPairDataset(str(root), "3DMatch"))
    with open(tmp_path / "cfg.pkl", "wb") as f:
        pickle.dump(cfg, f)
    (tmp_path / "shim.py").write_text(SHIM.format(path=str(tmp_path / "cfg.pkl")))
    python = tmp_path / "python"
    python.write_text(f"#!/bin/sh\nexec {sys.executable} {tmp_path / 'shim.py'} \"$@\"\n")
    python.chmod(0o755)
    run = tmp_path / "run"
    run.mkdir()
    env = dict(os.environ, PYTHON=str(python))
    res = subprocess.run(["bash", os.path.join(SCRIPTS, "eval.sh"), "3dmatch", str(root),
                          "3DMatch", "--num_workers", "0", "--device", "cpu"], cwd=run, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert sorted(p.name for p in (run / "output" / "3dmatch" / "features" / "3DMatch"
                                   / "scene_a").glob("*.npz")) == ["0_2.npz", "1_3.npz"]
    assert "Overall (lgr):" in res.stdout and "RR: " in res.stdout


def test_eval_all_sh_skips_epochs_without_a_checkpoint(tmp_path):
    (tmp_path / "checkpoints" / "2").mkdir(parents=True)  # no state.pt: not a checkpoint
    res = subprocess.run(["bash", os.path.join(SCRIPTS, "eval_all.sh"), "3dmatch",
                          str(tmp_path), str(tmp_path / "checkpoints"), "3DMatch", "1", "3",
                          "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=60, env=dict(os.environ, PYTHON="false"))
    assert res.returncode == 0, res.stderr
    assert res.stdout.split("\n")[:3] == [f"skip epoch {n} (no checkpoint)" for n in (1, 2, 3)]


@pytest.mark.parametrize("script", ["eval.sh", "eval_all.sh", "run_convergence_suite.sh"])
def test_shell_drivers_parse(script):
    res = subprocess.run(["bash", "-n", os.path.join(SCRIPTS, script)], capture_output=True,
                         text=True, timeout=30)
    assert res.returncode == 0, res.stderr
    with open(os.path.join(SCRIPTS, script)) as f:
        text = f.read()
    # the repository root from the script's own path, the port's scripts by module
    assert 'ROOT=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)' in text
    assert "geotransformer_tpu_torch.scripts." in text


def test_convergence_suite_runs_jobs_at_once(tmp_path):
    """JOBS=4 starts the four runs before any ends; a failing run fails the
    suite either way."""
    shim = tmp_path / "python"
    shim.write_text("#!/usr/bin/env bash\nsleep 0.5\nexit ${SHIM_EXIT:-0}\n")
    shim.chmod(0o755)
    script = os.path.join(SCRIPTS, "run_convergence_suite.sh")
    for jobs, code in (("4", "0"), ("4", "1"), ("1", "1")):
        out = tmp_path / f"suite_{jobs}_{code}"
        res = subprocess.run(["bash", script, str(out), "1"], capture_output=True, text=True,
                             timeout=60, env=dict(os.environ, PYTHON=str(shim), JOBS=jobs,
                                                  SHIM_EXIT=code))
        assert res.returncode == int(code), res.stderr
        events = [line.split()[2] for line in (out / "suite.log").read_text().splitlines()
                  if line.startswith("===")]
        assert sorted(events) == ["exit"] * 4 + ["start"] * 4
        if jobs == "4":
            assert events[:4] == ["start"] * 4


# --- synthetic_benchmark's restored flags -------------------------------------

def test_synthetic_benchmark_takes_the_restored_flags(capsys):
    with pytest.raises(SystemExit):
        synthetic_benchmark.main(["--help"])
    text = capsys.readouterr().out
    for flag in ("--seed", "--model_seed", "--test_fragments", "--lr", "--lr_decay",
                 "--skip_eval_script", "--force_pallas"):
        assert flag in text, flag
    cfg, train_set, test_set = synthetic_benchmark.build_sets("small")
    _, train_again, test_again = synthetic_benchmark.build_sets("small", seed=0, test_fragments=6)
    np.testing.assert_array_equal(train_set[0]["ref_points"], train_again[0]["ref_points"])
    _, train_other, test_other = synthetic_benchmark.build_sets("small", seed=3)
    assert not np.array_equal(train_set[0]["ref_points"], train_other[0]["ref_points"])
    assert not np.array_equal(test_set[0]["ref_points"], test_other[0]["ref_points"])
    default = synthetic_benchmark.training_config(cfg, 20, len(train_set))
    assert default.optim.lr == 3e-4 and default.optim.lr_decay == cfg.optim.lr_decay
    assert default.seed == cfg.seed and default.model.force_pallas is None
    assert default.optim.max_epoch == -(-20 // len(train_set))
    tuned = synthetic_benchmark.training_config(cfg, 20, len(train_set), lr=1e-3, lr_decay=0.9,
                                                model_seed=4242, force_pallas=False)
    assert (tuned.optim.lr, tuned.optim.lr_decay, tuned.seed) == (1e-3, 0.9, 4242)
    assert tuned.model.force_pallas is False


def test_new_modules_are_walked():
    names = {m.name for m in pkgutil.walk_packages(geotransformer_tpu_torch.__path__,
                                                   "geotransformer_tpu_torch.")}
    new = {"utils.timing", "scripts.pairs", "scripts.profile_stages", "scripts.profile_forward",
           "scripts.profile_train", "scripts.profile_ops", "scripts.profile_kpconv",
           "scripts.profile_device", "scripts.profile_batch", "scripts.probe_kernels",
           "scripts.train_smoke", "scripts.drift", "scripts.drift_attrib"}
    assert {f"geotransformer_tpu_torch.{n}" for n in new} <= names
