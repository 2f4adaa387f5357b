"""The port's offline-evaluation modules vs the JAX package's, on inputs made
from a numpy seed:

  * ``utils/registration.py``: every metric within 1e-6 relative, the
    correspondence index sets equal;
  * ``eval/threedmatch_benchmark.py``: log/info reading and writing, the
    covariance-weighted transform error and the per-scene protocol;
  * ``utils/ransac.py``: both estimators equal under the same seed;
  * ``datasets/synthetic.py``: the same seeded ``SyntheticSceneBenchmark``
    gives the same pairs and fragments, and ``write_benchmark`` the same
    ``gt.log`` / ``gt.info`` bytes, which the port's readers read back;
  * ``calibrate_stage_caps`` of both packages over the same synthetic pairs.
"""

import os

import numpy as np
import pytest

from geotransformer_tpu.datasets.synthetic import SyntheticSceneBenchmark as JaxSynthetic
from geotransformer_tpu.eval import threedmatch_benchmark as jax_bench
from geotransformer_tpu.preprocess.calibrate import calibrate_stage_caps as jax_calibrate
from geotransformer_tpu.utils import ransac as jax_ransac
from geotransformer_tpu.utils import registration as jax_reg

from geotransformer_tpu_torch.datasets import SyntheticSceneBenchmark
from geotransformer_tpu_torch.eval import threedmatch_benchmark as port_bench
from geotransformer_tpu_torch.preprocess import calibrate_stage_caps
from geotransformer_tpu_torch.utils import ransac as port_ransac
from geotransformer_tpu_torch.utils import registration as port_reg
from torch_routes import numpy_pyramids  # noqa: F401  (both packages on numpy)

RTOL = 1e-6


def random_rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def random_transform(rng):
    transform = np.eye(4)
    transform[:3, :3] = random_rotation(rng)
    transform[:3, 3] = rng.uniform(-1, 1, 3)
    return transform


def perturbation(rng, noise):
    """A small rigid motion: rotation angles and translation of ``noise``."""
    angle = noise * rng.normal(size=3)
    skew = np.array([[0, -angle[2], angle[1]], [angle[2], 0, -angle[0]],
                     [-angle[1], angle[0], 0]])
    u, _, vt = np.linalg.svd(np.eye(3) + skew + 0.5 * skew @ skew)
    transform = np.eye(4)
    transform[:3, :3] = u @ vt
    transform[:3, 3] = noise * rng.normal(size=3)
    return transform


def case(seed):
    """Point sets, correspondences, features and transforms from ``seed``."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(0, 2, (300, 3))
    gt = random_transform(rng)
    est = random_transform(rng) if seed % 2 else perturbation(rng, 0.02) @ gt
    src = (ref[:250] - gt[:3, 3]) @ gt[:3, :3]  # gt maps src onto ref[:250]
    src = src + 0.01 * rng.normal(size=src.shape)
    feats_ref = rng.normal(size=(300, 8))
    feats_src = feats_ref[:250] + 0.3 * rng.normal(size=(250, 8))
    nodes_ref, nodes_src = rng.uniform(0, 2, (40, 3)), rng.uniform(0, 2, (30, 3))
    gt_corr = np.unique(np.stack([rng.integers(0, 40, 60), rng.integers(0, 30, 60)], 1), axis=0)
    pred_ref, pred_src = rng.integers(0, 40, 50), rng.integers(0, 30, 50)
    return dict(ref=ref, src=src, gt=gt, est=est, feats_ref=feats_ref, feats_src=feats_src,
                nodes_ref=nodes_ref, nodes_src=nodes_src, gt_corr=gt_corr, pred_ref=pred_ref,
                pred_src=pred_src, raw=ref + 0.005 * rng.normal(size=ref.shape))


REGISTRATION_CALLS = {
    "relative_rotation_error": lambda m, c: m.compute_relative_rotation_error(
        c["gt"][:3, :3], c["est"][:3, :3]),
    "relative_translation_error": lambda m, c: m.compute_relative_translation_error(
        c["gt"][:3, 3], c["est"][:3, 3]),
    "registration_error": lambda m, c: m.compute_registration_error(c["gt"], c["est"]),
    "rotation_mse_and_mae": lambda m, c: m.compute_rotation_mse_and_mae(
        c["gt"][:3, :3], c["est"][:3, :3]),
    "translation_mse_and_mae": lambda m, c: m.compute_translation_mse_and_mae(
        c["gt"][:3, 3], c["est"][:3, 3]),
    "transform_mse_and_mae": lambda m, c: m.compute_transform_mse_and_mae(c["gt"], c["est"]),
    "registration_rmse": lambda m, c: m.compute_registration_rmse(c["src"], c["gt"], c["est"]),
    "modified_chamfer_distance": lambda m, c: m.compute_modified_chamfer_distance(
        c["raw"], c["ref"], c["src"], c["gt"], c["est"]),
    "correspondence_residual": lambda m, c: m.compute_correspondence_residual(
        c["ref"][:250], c["src"], c["est"]),
    "inlier_ratio": lambda m, c: m.compute_inlier_ratio(c["ref"][:250], c["src"], c["est"], 0.1),
    "overlap": lambda m, c: m.compute_overlap(c["ref"], c["src"], c["est"], 0.1),
    "correspondences": lambda m, c: m.get_correspondences(c["ref"], c["src"], c["gt"], 0.05),
    "corr_indices": lambda m, c: m.extract_corr_indices_from_feats(c["feats_ref"], c["feats_src"]),
    "corr_indices_mutual": lambda m, c: m.extract_corr_indices_from_feats(
        c["feats_ref"], c["feats_src"], mutual=True),
    "corr_indices_bilateral": lambda m, c: m.extract_corr_indices_from_feats(
        c["feats_ref"], c["feats_src"], bilateral=True),
    "correspondences_from_feats": lambda m, c: m.extract_correspondences_from_feats(
        c["ref"], c["src"], c["feats_ref"], c["feats_src"], mutual=True, return_feat_dist=True),
    "evaluate_correspondences": lambda m, c: m.evaluate_correspondences(
        c["ref"][:250], c["src"], c["est"], 0.1),
    "evaluate_sparse_correspondences": lambda m, c: m.evaluate_sparse_correspondences(
        c["nodes_ref"], c["nodes_src"], c["pred_ref"], c["pred_src"], c["gt_corr"]),
}


def assert_same(got, want, what):
    """Equal structure; numbers within RTOL relative, integers equal."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for key in want:
            assert_same(got[key], want[key], f"{what}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{what}[{i}]")
    elif isinstance(want, str):
        assert got == want, what
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.shape == want.shape, what
        if np.issubdtype(want.dtype, np.integer) or want.dtype == bool:
            np.testing.assert_array_equal(got, want, err_msg=what)
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", sorted(REGISTRATION_CALLS))
def test_registration_matches_jax(name, seed):
    c = case(seed)
    assert_same(REGISTRATION_CALLS[name](port_reg, c), REGISTRATION_CALLS[name](jax_reg, c), name)


def _write_protocol(root, seed, num_fragments=8):
    """A gt.log / gt.info / est.log triple of non-adjacent and adjacent
    pairs, written with the JAX package's writer (est.log) and by hand."""
    rng = np.random.default_rng(seed)
    gt_logs, est_logs, infos = [], [], []
    for i in range(num_fragments):
        for j in range(i + 1, num_fragments):
            if rng.uniform() < 0.4:
                gt = random_transform(rng)
                est = perturbation(rng, 0.02 if rng.uniform() < 0.6 else 0.5) @ gt
                a = rng.normal(size=(6, 6))
                gt_logs.append(dict(test_pair=[i, j], num_fragments=num_fragments, transform=gt))
                est_logs.append(dict(test_pair=[i, j], num_fragments=num_fragments,
                                     transform=est))
                infos.append(((i, j), a @ a.T + 6 * np.eye(6)))
    jax_bench.write_log_file(os.path.join(root, "gt.log"), gt_logs)
    jax_bench.write_log_file(os.path.join(root, "est.log"), est_logs)
    with open(os.path.join(root, "gt.info"), "w") as f:
        for (i, j), cov in infos:
            f.write(f"{i}\t{j}\t{num_fragments}\n")
            for row in cov:
                f.write("\t".join(f"{x:.8f}" for x in row) + "\n")
    return gt_logs, est_logs, infos


BENCHMARK_CALLS = {
    "read_log_file": lambda m, root: m.read_log_file(os.path.join(root, "gt.log")),
    "read_info_file": lambda m, root: m.read_info_file(os.path.join(root, "gt.info")),
    "gt_logs_and_infos": lambda m, root: m.get_gt_logs_and_infos(root, 8),
    "transform_error": lambda m, root: [
        m.compute_transform_error(g["transform"], i["covariance"], e["transform"])
        for g, i, e in zip(m.read_log_file(os.path.join(root, "gt.log")),
                           m.read_info_file(os.path.join(root, "gt.info")),
                           m.read_log_file(os.path.join(root, "est.log")))],
    "quaternion": lambda m, root: [
        m.rotation_matrix_to_quaternion(g["transform"][:3, :3])
        for g in m.read_log_file(os.path.join(root, "gt.log"))],
    "one_scene": lambda m, root: m.evaluate_registration_one_scene(
        os.path.join(root, "gt.log"), os.path.join(root, "gt.info"),
        os.path.join(root, "est.log")),
    "scene_names": lambda m, root: [
        (m.get_num_fragments(s), m.get_scene_abbr(s)) for s in m.SCENE_NUM_FRAGMENTS]
        + [m.get_scene_abbr("synth-test-0")],
}


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("name", sorted(BENCHMARK_CALLS))
def test_threedmatch_benchmark_matches_jax(tmp_path, name, seed):
    _write_protocol(str(tmp_path), seed)
    assert_same(BENCHMARK_CALLS[name](port_bench, str(tmp_path)),
                BENCHMARK_CALLS[name](jax_bench, str(tmp_path)), name)


def test_write_log_file_byte_identical(tmp_path):
    _, est_logs, _ = _write_protocol(str(tmp_path / "jax"), 5)
    port_bench.write_log_file(str(tmp_path / "port" / "est.log"), est_logs)
    assert (tmp_path / "port" / "est.log").read_bytes() == (tmp_path / "jax" / "est.log").read_bytes()
    with pytest.raises(ValueError, match="Unsupported"):
        port_bench.get_num_fragments("synth-test-0")


def _ransac_case(seed, n=400, outliers=0.6):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (n, 3))
    gt = random_transform(rng)
    ref = src @ gt[:3, :3].T + gt[:3, 3] + 0.005 * rng.normal(size=(n, 3))
    bad = rng.uniform(size=n) < outliers
    ref[bad] = rng.uniform(-2, 2, (int(bad.sum()), 3))
    feats_src = rng.normal(size=(n, 16))
    feats_ref = feats_src + 0.2 * rng.normal(size=(n, 16))
    return src.astype(np.float32), ref.astype(np.float32), feats_src, feats_ref


RANSAC_CALLS = {
    "correspondences": lambda m, c, seed: m.registration_with_ransac_from_correspondences(
        c[0], c[1], distance_threshold=0.05, num_iterations=500, seed=seed),
    "correspondences_few": lambda m, c, seed: m.registration_with_ransac_from_correspondences(
        c[0][:2], c[1][:2], seed=seed),
    "featurematch": lambda m, c, seed: m.registration_with_ransac_from_featurematch(
        c[0], c[1], c[2], c[3], distance_threshold=0.05, num_iterations=2000, seed=seed),
    "featurematch_mutual": lambda m, c, seed: m.registration_with_ransac_from_featurematch(
        c[0], c[1], c[2], c[3], distance_threshold=0.05, num_iterations=2000, mutual=True,
        seed=seed),
}


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("name", sorted(RANSAC_CALLS))
def test_ransac_equal_under_same_seed(name, seed):
    c = _ransac_case(seed)
    got = RANSAC_CALLS[name](port_ransac, c, seed)
    want = RANSAC_CALLS[name](jax_ransac, c, seed)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


SYNTHETIC = dict(num_scenes=2, fragments_per_scene=5, num_points=12000, point_limit=2000)


@pytest.fixture(scope="module")
def synthetic_pair():
    kw = dict(SYNTHETIC, seed=3, scene_prefix="synth-test-")
    return SyntheticSceneBenchmark(**kw), JaxSynthetic(**kw)


def test_synthetic_benchmark_matches_jax(synthetic_pair):
    port, jax_set = synthetic_pair
    assert len(port) == len(jax_set) > 0
    for i in range(len(port)):
        got, want = port[i], jax_set[i]
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes(), key
            else:
                assert got[key] == value, key


def test_protocol_files_byte_identical_and_read_back(tmp_path, synthetic_pair):
    port, jax_set = synthetic_pair
    port.write_benchmark(str(tmp_path / "port"))
    jax_set.write_benchmark(str(tmp_path / "jax"))
    scenes = sorted(os.listdir(tmp_path / "jax"))
    assert scenes == sorted(os.listdir(tmp_path / "port")) == ["synth-test-0", "synth-test-1"]
    for scene in scenes:
        for name in ("gt.log", "gt.info"):
            want = (tmp_path / "jax" / scene / name).read_bytes()
            assert (tmp_path / "port" / scene / name).read_bytes() == want, f"{scene}/{name}"
        # the port's readers read back what was written: every pair, its
        # transform (8 decimals) and a covariance whose transform error is
        # the mean squared displacement (0 for the GT transform)
        root = str(tmp_path / "port" / scene)
        gt_logs = port_bench.read_log_file(os.path.join(root, "gt.log"))
        infos = port_bench.read_info_file(os.path.join(root, "gt.info"))
        pairs = [p for p in port.pairs if p["scene"] == scenes.index(scene)]
        assert [g["test_pair"] for g in gt_logs] == [[p["ref_frame"], p["src_frame"]]
                                                     for p in pairs]
        assert [i["test_pair"] for i in infos] == [g["test_pair"] for g in gt_logs]
        for g, info, p in zip(gt_logs, infos, pairs):
            want = port.gt_transform(p["scene"], p["ref_frame"], p["src_frame"])
            np.testing.assert_allclose(g["transform"], want, atol=1e-7)
            assert port_bench.compute_transform_error(
                g["transform"], info["covariance"], g["transform"]) == pytest.approx(0, abs=1e-12)


def test_calibrated_caps_match_jax(synthetic_pair):
    port, _ = synthetic_pair
    samples = [port[i] for i in range(len(port))]
    args = (4, 0.06, 0.15, [40, 34, 34, 38])
    for multiple in (32, 256):
        got = calibrate_stage_caps(iter(samples), *args, num_samples=len(samples),
                                   multiple=multiple)
        want = jax_calibrate(iter(samples), *args, num_samples=len(samples), multiple=multiple)
        assert [int(c) for c in got] == [int(c) for c in want]
