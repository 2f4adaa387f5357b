"""The port's Tester and offline evaluator vs the JAX package's, on the CPU.

Two synthetic 3DMatch-protocol pairs (``SyntheticSceneBenchmark``, its
``gt.log`` / ``gt.info`` written), one narrow 4-stage configuration (the
widths of tests/test_torch_model.py) with caps calibrated over the pairs;
the JAX model's initial variables carried into the port with
``variables_to_state_dict``. Both testers run the pairs through their own
loader (the host pyramid, the JAX package's numpy path) and dump one npz a
pair:

  * every npz key: points and features within 1e-4, node correspondences
    and GT node pairs as masked sets (top-k ties), the GT overlaps by pair,
    the fine correspondences as sorted rows, ``estimated_transform`` within
    5e-4; the tester's summary metrics within 1e-4;
  * the port's ``scripts.eval`` and the JAX ``scripts/eval.py`` on the same
    feature directory and benchmark root: the same table character for
    character with ``--method lgr`` and ``ransac``, every number within 1e-4
    with ``svd``.
"""

import os
import re
import runpy
import sys

import jax
import numpy as np
import pytest
import torch

from geotransformer_tpu.engine.tester import Tester as JaxTester
from geotransformer_tpu.models import create_model as create_jax_model
from geotransformer_tpu.preprocess.loader import PairLoader as JaxPairLoader

from geotransformer_tpu_torch.datasets import SyntheticSceneBenchmark
from geotransformer_tpu_torch.engine import tester as port_tester
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.preprocess import calibrate_stage_caps
from geotransformer_tpu_torch.preprocess.loader import PairLoader
from geotransformer_tpu_torch.scripts import eval as port_eval
from geotransformer_tpu_torch.scripts.common import pipeline_config
from geotransformer_tpu_torch.utils.convert import variables_to_state_dict
from test_torch_model import narrow_config
from torch_routes import jax_precision_kept  # noqa: F401  (JAX precision globals restored)


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers, where more threads a worker only add to the total CPU time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = dict(num_scenes=1, fragments_per_scene=5, num_points=10000, point_limit=1500, seed=5,
              scene_prefix="synth-test-")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    os.environ["GEOTRANSFORMER_TPU_NATIVE"] = "0"  # the JAX loader's numpy path
    try:
        yield _run(tmp_path_factory.mktemp("tester"))
    finally:
        os.environ.pop("GEOTRANSFORMER_TPU_NATIVE", None)


def _run(root):
    dataset = SyntheticSceneBenchmark(**SCENES)
    assert len(dataset) >= 2
    pairs = [dataset[i] for i in range(2)]
    dataset.write_benchmark(str(root / "benchmark"))
    cfg = narrow_config()
    bb = cfg.backbone
    caps = calibrate_stage_caps(iter(pairs), bb.num_stages, bb.init_voxel_size, bb.init_radius,
                                list(cfg.caps.neighbor_limits), num_samples=2, multiple=32)
    cfg = cfg.with_caps(stage_caps=tuple(caps), gt_candidates=16, gt_chunk_size=16)
    pipeline = pipeline_config(cfg, input_stream=False)

    jax_loader = JaxPairLoader(pairs, {k: v for k, v in pipeline.items() if k != "input_stream"})
    jax_model = create_jax_model(cfg)
    example = next(iter(jax_loader))[0]
    example = jax.tree.map(np.asarray, {k: v for k, v in example.items() if k != "meta"})
    variables = jax.jit(lambda r, b: jax_model.init(r, b, training=False, with_gt=True))(
        jax.random.PRNGKey(0), example)
    jax_summary, _ = JaxTester(cfg, jax_model, jax_loader, output_dir=str(root / "jax"),
                               feature_dir=str(root / "jax" / "features")).run(variables)

    model = create_model(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(jax.tree.map(np.asarray, variables)))
    loader = PairLoader(pairs, pipeline)
    tester = port_tester.Tester(cfg, model, loader, output_dir=str(root / "port"),
                    feature_dir=str(root / "port" / "features"), device="cpu")
    summary, results = tester.run()
    rng = np.random.default_rng(1)
    for i in range(2, len(dataset)):
        _write_registered_dump(root / "port" / "features", dataset[i], rng, noise=0.004 * i)
    return dict(root=root, pairs=pairs, summary=summary, results=results,
                jax_summary=jax_summary, process_s=tester.timer.process_times())


def _write_registered_dump(feature_dir, pair, rng, noise):
    """An npz of the tester's layout for ``pair`` from its GT transform:
    correspondences of src points within ``noise`` of their GT match, 40 %
    outliers, an estimate ``noise`` off the GT, random node matches; it
    gives the evaluator's tables non-zero IR, FMR and RR."""
    transform = pair["transform"].astype(np.float64)
    src = pair["src_points"][rng.permutation(len(pair["src_points"]))[:300]]
    ref_corr = src @ transform[:3, :3].T + transform[:3, 3] + noise * rng.normal(size=src.shape)
    outliers = rng.uniform(size=len(src)) < 0.4
    ref_corr[outliers] = rng.uniform(-1.5, 1.5, (int(outliers.sum()), 3))
    angle = noise * rng.normal(size=3)
    skew = np.array([[0, -angle[2], angle[1]], [angle[2], 0, -angle[0]],
                     [-angle[1], angle[0], 0]])
    u, _, vt = np.linalg.svd(np.eye(3) + skew)
    estimated = transform.copy()
    estimated[:3, :3] = u @ vt @ transform[:3, :3]
    estimated[:3, 3] += noise * rng.normal(size=3)
    nodes = lambda points: points[rng.permutation(len(points))[:24]]  # noqa: E731
    gt_nodes = np.unique(rng.integers(0, 24, (40, 2)), axis=0)
    scene_dir = feature_dir / pair["scene_name"]
    scene_dir.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        scene_dir / f"{pair['ref_frame']}_{pair['src_frame']}.npz",
        ref_points=pair["ref_points"], src_points=pair["src_points"],
        ref_points_c=nodes(pair["ref_points"]), src_points_c=nodes(pair["src_points"]),
        ref_node_corr_indices=rng.integers(0, 24, 30), src_node_corr_indices=rng.integers(0, 24, 30),
        gt_node_corr_indices=gt_nodes, gt_node_corr_overlaps=rng.uniform(0.1, 1, len(gt_nodes)),
        ref_corr_points=ref_corr.astype(np.float32), src_corr_points=src,
        corr_scores=rng.uniform(0, 1, len(src)).astype(np.float32),
        estimated_transform=estimated.astype(np.float32), transform=pair["transform"])


def _dumps(run):
    names = [f"synth-test-0/{p['ref_frame']}_{p['src_frame']}.npz" for p in run["pairs"]]
    return [(np.load(run["root"] / "port" / "features" / n),
             np.load(run["root"] / "jax" / "features" / n)) for n in names]


DENSE_KEYS = ("ref_points", "src_points", "ref_points_c", "src_points_c", "ref_feats_c",
              "src_feats_c", "transform")


@pytest.mark.parametrize("key", DENSE_KEYS)
def test_dense_keys_within_1e4(run, key):
    for got, want in _dumps(run):
        assert got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-4, err_msg=key)


def _pairs_of(dump, ref_key, src_key):
    return set(zip(dump[ref_key].tolist(), dump[src_key].tolist()))


def test_node_correspondences_as_sets(run):
    for got, want in _dumps(run):
        pairs = _pairs_of(want, "ref_node_corr_indices", "src_node_corr_indices")
        assert pairs and _pairs_of(got, "ref_node_corr_indices", "src_node_corr_indices") == pairs


def test_gt_node_pairs_and_overlaps(run):
    for got, want in _dumps(run):
        overlaps = [dict(zip(map(tuple, d["gt_node_corr_indices"].tolist()),
                             d["gt_node_corr_overlaps"].tolist())) for d in (got, want)]
        assert overlaps[1] and sorted(overlaps[0]) == sorted(overlaps[1])
        for pair, value in overlaps[1].items():
            assert abs(overlaps[0][pair] - value) <= 1e-4, pair


def test_fine_correspondences_as_sorted_rows(run):
    for got, want in _dumps(run):
        rows = []
        for d in (got, want):
            table = np.concatenate([d["ref_corr_points"], d["src_corr_points"],
                                    d["corr_scores"][:, None]], axis=1)
            rows.append(table[np.lexsort(table[:, ::-1].T)])
        assert rows[1].shape[0] > 0 and rows[0].shape == rows[1].shape
        np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=1e-4)


def test_estimated_transform_within_5e4(run):
    for got, want in _dumps(run):
        assert np.isfinite(got["estimated_transform"]).all()
        np.testing.assert_allclose(got["estimated_transform"], want["estimated_transform"],
                                   rtol=0, atol=5e-4)


def test_summary_metrics(run):
    assert sorted(run["summary"]) == sorted(run["jax_summary"])
    for key, want in run["jax_summary"].items():
        assert abs(run["summary"][key] - want) <= 1e-4 * max(1.0, abs(want)), key
    assert [(r["scene_name"], r["ref_frame"], r["src_frame"]) for r in run["results"]] == [
        (p["scene_name"], p["ref_frame"], p["src_frame"]) for p in run["pairs"]]
    assert len(run["process_s"]) == 2 and all(t > 0 for t in run["process_s"])


def _tables(run, capsys, method):
    args = ["--dataset", "3dmatch", "--feature_dir", str(run["root"] / "port" / "features"),
            "--benchmark_root", str(run["root"] / "benchmark"), "--method", method,
            "--ransac_iterations", "200"]
    capsys.readouterr()
    port_eval.main(args + ["--registration_dir", str(run["root"] / "est" / "port"),
                           "--device", "cpu"])
    got = capsys.readouterr().out
    argv = sys.argv
    sys.argv = [os.path.join(REPO, "scripts", "eval.py"), *args,
                "--registration_dir", str(run["root"] / "est" / "jax")]
    try:
        runpy.run_path(sys.argv[0], run_name="__main__")
    finally:
        sys.argv = argv
    return got, capsys.readouterr().out


@pytest.mark.parametrize("method", ["lgr", "ransac"])
def test_eval_table_identical(run, capsys, method):
    got, want = _tables(run, capsys, method)
    assert "Overall" in want and "synth-test-0" in want
    assert got == want
    # the crafted dumps register: the table is not all zeros
    assert float(re.search(r"RR: (\d\.\d+)", got).group(1)) > 0
    assert float(re.search(r"FMR: (\d\.\d+)", got).group(1)) > 0
    for side in ("port", "jax"):
        assert (run["root"] / "est" / side / "synth-test-0" / "est.log").exists()


def test_eval_table_svd_within_1e4(run, capsys):
    got, want = _tables(run, capsys, "svd")
    number = r"-?\d+\.\d+"
    assert re.sub(number, "#", got) == re.sub(number, "#", want)
    np.testing.assert_allclose([float(x) for x in re.findall(number, got)],
                               [float(x) for x in re.findall(number, want)], rtol=0, atol=1e-4)
