"""The port's training targets and its own copies of the JAX package's
configuration and kernel points, vs the JAX package; and the port's import
hygiene.

  * inverse neighbor tables: byte-identical to the JAX numpy
    ``pad_registration_batch(..., inverse_limits=...)``;
  * the point-to-node partition and the GT node overlaps
    (``precompute_gt_targets``, ``get_node_correspondences``) vs the JAX XLA
    path: partition tables equal, candidate indices equal as masked sets per
    ref node (top-k tie order is not part of the contract), overlaps to 1e-6;
  * ``candidates_to_dense_overlaps`` equal;
  * configs equal field by field (``dataclasses.asdict``) but for the one
    stated difference, the precision point's float32 defaults; the
    disposition file byte-identical;
  * no module of the port, and not ``chip_smoke.py``, imports jax, flax or
    the JAX package (the walk names the native binding, the model extras,
    the visualization helpers and every script).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geotransformer_tpu
from geotransformer_tpu import configs as jax_configs
from geotransformer_tpu.models.geotransformer import precompute_gt_targets as jax_precompute
from geotransformer_tpu.models.matching import (
    candidates_to_dense_overlaps as jax_candidates_to_dense,
)
from geotransformer_tpu.preprocess import pyramid as jax_pyramid

import geotransformer_tpu_torch
from geotransformer_tpu_torch import configs as port_configs
from geotransformer_tpu_torch.models import precompute_gt_targets
from geotransformer_tpu_torch.models.kernel_points import disposition_path
from geotransformer_tpu_torch.models.matching import candidates_to_dense_overlaps
from geotransformer_tpu_torch.preprocess import pyramid as port_pyramid
from geotransformer_tpu_torch.preprocess import batch_to_torch
from test_torch_model import make_pair, narrow_config
from torch_routes import jax_precision_kept  # noqa: F401  (JAX precision globals restored)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEIGHBOR_LIMITS = [38, 36, 36, 38]


@pytest.fixture()
def numpy_path(monkeypatch):
    # the JAX package's own numpy fallback, not its native library
    monkeypatch.setenv("GEOTRANSFORMER_TPU_NATIVE", "0")


def pyramid_case(seed, n=1200):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n, 2))
    z = 0.15 * np.sin(6 * xy[:, 0]) * np.cos(5 * xy[:, 1]) + 0.01 * rng.normal(size=n)
    ref = np.column_stack([xy, z]).astype(np.float32)
    src = ref[ref[:, 0] < 0.7] + 0.003 * rng.normal(size=(int((ref[:, 0] < 0.7).sum()), 3))
    points = np.concatenate([ref, src.astype(np.float32)], 0)
    return port_pyramid.build_pyramid(points, np.asarray([len(ref), len(src)]), 4, 0.025,
                                      0.0625, NEIGHBOR_LIMITS), points.shape[0]


def assert_identical(got, want, name):
    assert len(got) == len(want), name
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{name}[{i}]"
        assert g.tobytes() == w.tobytes(), f"{name}[{i}] differs"


@pytest.mark.parametrize("sub_inverse_limits", [None, (24, 24, 24)])
@pytest.mark.parametrize("per_cloud", [False, True], ids=["symmetric", "asymmetric"])
def test_inverse_tables_byte_identical(numpy_path, per_cloud, sub_inverse_limits):
    pyr, n = pyramid_case(3)
    caps = port_pyramid.caps_for_pyramid(pyr, multiple=64, per_cloud=per_cloud)
    args = (pyr, np.ones((n, 1), np.float32), np.eye(4, dtype=np.float32), caps)
    kw = dict(inverse_limits=(80, 80, 80, 80), sub_inverse_limits=sub_inverse_limits)
    got = port_pyramid.pad_registration_batch(*args, **kw)
    want = jax_pyramid.pad_registration_batch(*args, **kw)
    assert sorted(got) == sorted(want)
    for key in ("neighbors_inv", "subsampling_inv"):
        assert_identical(got[key], want[key], key)
    # each inverse lists exactly the (query, support) edges of its table
    table, inv = got["neighbors"][1], got["neighbors_inv"][1]
    edges = {(q, s) for q, row in enumerate(table) for s in row if s < table.shape[0]}
    assert edges == {(q, s) for s, row in enumerate(inv) for q in row if q < table.shape[0]}


def test_inverse_capacity_overflow_raises():
    table = np.zeros((20, 4), np.int32)  # support 0 has in-degree 20
    for build in (port_pyramid.build_inverse_table, jax_pyramid.build_inverse_table):
        with pytest.raises(ValueError, match="in-degree"):
            build(table, 5, 16)


@pytest.fixture(scope="module")
def targets():
    cfg = narrow_config()
    ref, src, transform = make_pair(11)
    points = np.concatenate([ref, src], 0)
    pyr = port_pyramid.build_pyramid(points, [len(ref), len(src)], cfg.backbone.num_stages,
                                     cfg.backbone.init_voxel_size, cfg.backbone.init_radius,
                                     list(cfg.caps.neighbor_limits))
    caps = tuple(port_pyramid.caps_for_pyramid(pyr, multiple=32, per_cloud=True))
    cfg = cfg.with_caps(stage_caps=caps, gt_candidates=16, gt_chunk_size=8)
    batch = port_pyramid.pad_registration_batch(
        pyr, np.ones((points.shape[0], 1), np.float32), transform, caps)
    want = jax.tree.map(np.asarray, jax_precompute(cfg, jax.tree.map(jnp.asarray, batch),
                                                   use_pallas=False))
    got = {k: v.numpy() for k, v in precompute_gt_targets(cfg, batch, device="cpu").items()}
    return cfg, batch, got, want


def test_partition_tables_equal(targets):
    _, _, got, want = targets
    for side in ("ref", "src"):
        for key in (f"{side}_node_masks", f"{side}_node_knn_masks"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        masks = want[f"{side}_node_knn_masks"]
        np.testing.assert_array_equal(got[f"{side}_node_knn_indices"][masks],
                                      want[f"{side}_node_knn_indices"][masks])


def test_gt_candidates_match_jax_xla(targets):
    _, _, got, want = targets
    assert want["gt_cand_masks"].any(), "no GT overlap in the case"
    np.testing.assert_array_equal(got["gt_cand_masks"].sum(1), want["gt_cand_masks"].sum(1))
    for row in range(want["gt_cand_masks"].shape[0]):
        g = dict(zip(got["gt_cand_indices"][row][got["gt_cand_masks"][row]].tolist(),
                     got["gt_cand_overlaps"][row][got["gt_cand_masks"][row]].tolist()))
        w = dict(zip(want["gt_cand_indices"][row][want["gt_cand_masks"][row]].tolist(),
                     want["gt_cand_overlaps"][row][want["gt_cand_masks"][row]].tolist()))
        assert sorted(g) == sorted(w), f"ref node {row}"
        np.testing.assert_allclose([g[k] for k in sorted(g)], [w[k] for k in sorted(w)],
                                   rtol=0, atol=1e-6)
    assert not got["gt_cand_overlaps"][~got["gt_cand_masks"]].any()


def test_dense_overlaps_match_jax(targets):
    cfg, _, got, _ = targets
    n_src = cfg.caps.stage_caps[-1][1]  # src coarse capacity
    args = [got[k] for k in ("gt_cand_indices", "gt_cand_overlaps", "gt_cand_masks")]
    want = np.asarray(jax_candidates_to_dense(*[jnp.asarray(a) for a in args], n_src))
    dense = candidates_to_dense_overlaps(*[torch.from_numpy(a) for a in args], n_src).numpy()
    np.testing.assert_array_equal(dense, want)


def test_targets_on_tensors_and_default_device(targets):
    cfg, batch, got, _ = targets
    again = precompute_gt_targets(cfg, batch_to_torch(batch, "cpu"), device="cpu")
    for key, value in again.items():
        np.testing.assert_array_equal(value.numpy(), got[key], err_msg=key)
    if not torch.cuda.is_available():  # the default is the card, with no CPU fallback
        with pytest.raises((RuntimeError, AssertionError)):
            precompute_gt_targets(cfg, batch)


def assert_one_stated_difference(got, want):
    """Two configurations as dicts equal but for the precision point's
    values: float32 throughout in the port, the JAX package's bfloat16
    defaults there (the same fields)."""
    got, want = dict(got), dict(want)
    port_point, jax_point = got.pop("precision"), want.pop("precision")
    assert port_point == {name: "float32" for name in jax_point}
    assert jax_point == dataclasses.asdict(port_configs.JAX_PRECISION)
    assert got == want


@pytest.mark.parametrize("factory", ["make_3dmatch_config", "make_kitti_config",
                                     "make_modelnet_config"])
def test_config_copy_matches_jax(factory):
    got = dataclasses.asdict(getattr(port_configs, factory)())
    want = dataclasses.asdict(getattr(jax_configs, factory)())
    assert_one_stated_difference(got, want)
    port_cfg = getattr(port_configs, factory)().with_caps(stage_caps=(1, 2)).with_model(
        force_pallas=False)
    jax_cfg = getattr(jax_configs, factory)().with_caps(stage_caps=(1, 2)).with_model(
        force_pallas=False)
    assert_one_stated_difference(dataclasses.asdict(port_cfg), dataclasses.asdict(jax_cfg))
    assert port_cfg.backbone.init_radius == jax_cfg.backbone.init_radius
    assert port_cfg.first_fine_stage == jax_cfg.first_fine_stage


def test_disposition_copy_is_byte_identical():
    jax_file = os.path.join(os.path.dirname(geotransformer_tpu.__file__), "models",
                            "dispositions", "k_015_center_3d.npy")
    port_file = disposition_path(15)
    assert os.path.dirname(port_file).startswith(os.path.dirname(geotransformer_tpu_torch.__file__))
    with open(jax_file, "rb") as a, open(port_file, "rb") as b:
        assert a.read() == b.read()


def test_port_imports_no_jax():
    """Every module of the port, its scripts among them, and chip_smoke.py
    import with jax, flax and the JAX package blocked, and load none of
    them."""
    script = (
        "import importlib, pkgutil, sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'optax', 'geotransformer_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import geotransformer_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(geotransformer_tpu_torch.__path__,\n"
        "                                                'geotransformer_tpu_torch.')]\n"
        "scripts = {'geotransformer_tpu_torch.scripts.' + s for s in\n"
        "           ('calibrate', 'common', 'demo', 'eval', 'eval_dgr', 'synthetic_benchmark',\n"
        "            'test', 'trainval')}\n"
        "extras = {'geotransformer_tpu_torch.' + s for s in\n"
        "          ('native', 'models.corr_utils', 'models.point_matching',\n"
        "           'models.transformer_variants', 'utils.visualization')}\n"
        "assert scripts | extras <= set(names), sorted(scripts | extras - set(names))\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "importlib.import_module('chip_smoke')\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not None\n"
        "             and m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'geotransformer_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(names), 'ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    count, word = res.stdout.split()
    assert word == "ok" and int(count) >= 25  # every module was walked
