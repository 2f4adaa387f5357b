"""The PyTorch port's whole inference slice vs the JAX package's XLA forward.

One narrow 4-stage configuration and one synthetic pair, built once with
numpy through the port's host pyramid; the JAX model's own initial
variables are carried into the port with ``variables_to_state_dict``, and
both forwards run on the CPU (JAX with ``force_pallas=False``: XLA paths,
Sinkhorn scan, SVD Procrustes; the port with its kernels' plain versions).
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

from geotransformer_tpu.configs import (
    BackboneConfig,
    CapsConfig,
    CoarseMatchingConfig,
    GeoTransformerModuleConfig,
    ModelConfig,
    PrecisionConfig,
    make_3dmatch_config,
)
from geotransformer_tpu.utils.convert import torch_state_dict_to_variables

from geotransformer_tpu_torch.models import create_model as create_torch_model
from geotransformer_tpu_torch.preprocess import (
    batch_to_torch,
    build_pyramid,
    caps_for_pyramid,
    pad_registration_batch,
)
from geotransformer_tpu_torch.utils.convert import variables_to_state_dict
from torch_routes import jax_precision_kept  # noqa: F401  (JAX precision globals restored)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def narrow_config():
    """The multichip dry-run widths (``__graft_entry__.py:105-118``) with
    four stages."""
    return dataclasses.replace(
        make_3dmatch_config(),
        backbone=BackboneConfig(num_stages=4, init_voxel_size=0.06, init_dim=16, group_norm=8),
        model=ModelConfig(num_points_in_patch=16, num_sinkhorn_iterations=10,
                          force_pallas=False),
        coarse_matching=CoarseMatchingConfig(num_targets=16, num_correspondences=32),
        geotransformer=GeoTransformerModuleConfig(
            input_dim=256, hidden_dim=32, output_dim=32, blocks=("self", "cross"), num_heads=2),
        caps=CapsConfig(stage_caps=(512, 128, 64, 32), neighbor_limits=(12, 12, 12, 12),
                        correspondence_capacity=256),
        # the float32 point: the port honours a config's precision, and the
        # JAX XLA path these tests hold it to computes in float32
        precision=F32_POINT,
    )


F32_POINT = PrecisionConfig(kpconv_mxu="float32", gse_basis="float32", gse_embed="float32")


def make_pair(seed, n=500):
    """Wavy-surface scan pair: src is the overlapping part, noisy, rotated
    and translated by a known rigid transform."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n, 2))
    z = 0.15 * np.sin(6 * xy[:, 0]) * np.cos(5 * xy[:, 1]) + 0.01 * rng.normal(size=n)
    ref = np.column_stack([xy, z]).astype(np.float32)
    keep = ref[:, 0] < 0.75
    angle = 0.3
    rot = np.array([[np.cos(angle), -np.sin(angle), 0.0],
                    [np.sin(angle), np.cos(angle), 0.0], [0.0, 0.0, 1.0]])
    trans = np.array([0.1, -0.05, 0.02])
    world = ref[keep] + 0.004 * rng.normal(size=(int(keep.sum()), 3))
    src = ((world - trans) @ rot).astype(np.float32)  # world = rot src + trans
    transform = np.eye(4, dtype=np.float32)
    transform[:3, :3], transform[:3, 3] = rot, trans
    return ref, src, transform


def make_batch(cfg, seed, per_cloud):
    ref, src, transform = make_pair(seed)
    points = np.concatenate([ref, src], 0)
    lengths = np.asarray([len(ref), len(src)])
    pyramid = build_pyramid(points, lengths, cfg.backbone.num_stages,
                            cfg.backbone.init_voxel_size, cfg.backbone.init_radius,
                            list(cfg.caps.neighbor_limits))
    caps = tuple(caps_for_pyramid(pyramid, multiple=32, per_cloud=per_cloud))
    feats = np.ones((points.shape[0], 1), np.float32)
    batch = pad_registration_batch(pyramid, feats, transform, caps)
    return cfg.with_caps(stage_caps=caps), pyramid, batch


def _jax_backbone_feats(cfg, variables, batch_j):
    from geotransformer_tpu.models.backbone import KPConvFPN

    bb = cfg.backbone
    fpn = KPConvFPN(bb.input_dim, bb.output_dim, bb.init_dim, bb.kernel_size, bb.init_radius,
                    bb.init_sigma, bb.group_norm, num_stages=bb.num_stages,
                    first_fine_stage=cfg.model.fine_level,
                    neighbor_limits=tuple(cfg.caps.neighbor_limits))
    sub = {c: variables[c]["backbone"] for c in ("params", "constants")}
    feats = jax.jit(lambda v, b: fpn.apply(v, b["features"], b))(sub, batch_j)
    return [np.asarray(f) for f in feats]


@pytest.fixture(scope="module", params=["symmetric_caps", "asymmetric_caps"])
def both(request):
    from geotransformer_tpu.models import create_model as create_jax_model

    cfg, pyramid, batch = make_batch(narrow_config(), seed=11,
                                     per_cloud=request.param == "asymmetric_caps")
    batch_j = jax.tree.map(jnp.asarray, batch)
    jax_model = create_jax_model(cfg)
    # jitted: eager flax init compiles op by op (~5x slower on the CPU)
    variables = jax.jit(lambda r, b: jax_model.init(r, b, training=False, with_gt=False))(
        jax.random.PRNGKey(0), batch_j)
    out_j = jax.tree.map(np.asarray, jax.jit(
        lambda v, b: jax_model.apply(v, b, training=False, with_gt=False))(variables, batch_j))
    variables_np = jax.tree.map(np.asarray, variables)

    port = create_torch_model(cfg, device="cpu")
    port.load_state_dict(variables_to_state_dict(variables_np), strict=True)
    batch_t = batch_to_torch(batch, "cpu")
    out_t = {k: v.numpy() for k, v in port(batch_t).items()}
    with torch.no_grad():
        feats_t = [f.numpy() for f in port.backbone(batch_t["features"], batch_t)]
    feats_j = _jax_backbone_feats(cfg, variables, batch_j)
    return dict(cfg=cfg, pyramid=pyramid, variables=variables, port=port,
                out_j=out_j, out_t=out_t, feats_j=feats_j, feats_t=feats_t)


def _valid_rows(masks):
    return np.asarray(masks, bool)


class TestTorchModelParity:
    def test_state_dict_round_trip(self, both):
        variables = both["variables"]
        back, unused = torch_state_dict_to_variables(both["port"].state_dict(), variables)
        assert unused == []
        for (path, want), (_, got) in zip(jax.tree_util.tree_leaves_with_path(variables),
                                          jax.tree_util.tree_leaves_with_path(back)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=str(path))

    def test_backbone_feats_list(self, both):
        for stage, (got, want) in enumerate(zip(both["feats_t"], both["feats_j"])):
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4,
                                       err_msg=f"feats_list[{stage}]")

    def test_coarse_features(self, both):
        out_t, out_j = both["out_t"], both["out_j"]
        for side in ("ref", "src"):
            rows = _valid_rows(out_j[f"{side}_masks_c"])
            np.testing.assert_allclose(out_t[f"{side}_feats_c"][rows],
                                       out_j[f"{side}_feats_c"][rows], rtol=1e-3, atol=1e-4)

    def test_fine_features(self, both):
        out_t, out_j = both["out_t"], both["out_j"]
        for side in ("ref", "src"):
            rows = _valid_rows(out_j[f"{side}_masks_f"])
            np.testing.assert_allclose(out_t[f"{side}_feats_f"][rows],
                                       out_j[f"{side}_feats_f"][rows], rtol=1e-3, atol=1e-4)

    def test_node_correspondences(self, both):
        out_t, out_j = both["out_t"], both["out_j"]

        def pairs(out):
            m = out["node_corr_masks"]
            return set(zip(out["ref_node_corr_indices"][m].tolist(),
                           out["src_node_corr_indices"][m].tolist()))

        assert pairs(out_j), "no valid node correspondence"
        assert pairs(out_t) == pairs(out_j)

    def test_matching_scores(self, both):
        out_t, out_j = both["out_t"], both["out_j"]
        # align patches by their (ref node, src node) pair: the top-k order
        # of equal scores is not part of the contract
        index_t = {
            pair: p for p, (pair, ok) in enumerate(zip(
                zip(out_t["ref_node_corr_indices"].tolist(),
                    out_t["src_node_corr_indices"].tolist()),
                out_t["node_corr_masks"])) if ok}
        checked = 0
        for p, ok in enumerate(out_j["node_corr_masks"]):
            if not ok:
                continue
            pair = (int(out_j["ref_node_corr_indices"][p]), int(out_j["src_node_corr_indices"][p]))
            q = index_t[pair]
            rows = np.append(out_j["ref_node_corr_knn_masks"][p], True)
            cols = np.append(out_j["src_node_corr_knn_masks"][p], True)
            np.testing.assert_array_equal(out_t["ref_node_corr_knn_masks"][q],
                                          out_j["ref_node_corr_knn_masks"][p])
            valid = rows[:, None] & cols[None, :]
            np.testing.assert_allclose(out_t["matching_scores"][q][valid],
                                       out_j["matching_scores"][p][valid], rtol=2e-2, atol=1e-4)
            checked += 1
        assert checked > 0

    def test_estimated_transform(self, both):
        got = both["out_t"]["estimated_transform"]
        assert np.all(np.isfinite(got))
        np.testing.assert_allclose(got, both["out_j"]["estimated_transform"], atol=5e-4)


def test_inference_only_and_kernel_dispatch():
    cfg, _, batch = make_batch(narrow_config(), seed=5, per_cloud=True)
    batch_t = batch_to_torch(batch, "cpu")
    model = create_torch_model(cfg, device="cpu")
    # training needs the GT targets, as in the JAX model
    with pytest.raises(ValueError, match="with_gt"):
        model(batch_t, training=True)
    # the inference forward keeps no autograd graph
    assert not model(batch_t)["ref_feats_c"].requires_grad
    # the dustbin configuration runs (held against JAX in test_torch_corr_utils.py)
    dustbin = dataclasses.replace(cfg, fine_matching=dataclasses.replace(
        cfg.fine_matching, use_dustbin=True))
    assert torch.isfinite(create_torch_model(dustbin, device="cpu")(batch_t)[
        "estimated_transform"]).all()
    # the mean angle reduction has no kernel: forcing one raises
    with pytest.raises(NotImplementedError, match="mean"):
        create_torch_model(dataclasses.replace(cfg.with_model(force_pallas=True), geotransformer=(
            dataclasses.replace(cfg.geotransformer, reduction_a="mean"))), device="cpu")
    # force_pallas=True demands the CUDA kernels, which have no CPU mode
    with pytest.raises(RuntimeError, match="CUDA"):
        create_torch_model(cfg.with_model(force_pallas=True), device="cpu")(batch_t)


def test_forward_without_jax():
    """The port imports and runs a CPU forward with jax and flax blocked."""
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import dataclasses\n"
        "import numpy as np, torch\n"
        "from geotransformer_tpu_torch.configs import BackboneConfig, make_3dmatch_config\n"
        "from geotransformer_tpu_torch.models import create_model\n"
        "from geotransformer_tpu_torch.preprocess import (\n"
        "    batch_to_torch, build_pyramid, caps_for_pyramid, pad_registration_batch)\n"
        "cfg = make_3dmatch_config()\n"
        "cfg = dataclasses.replace(cfg, backbone=BackboneConfig(init_voxel_size=0.06, init_dim=16,\n"
        "                                                       group_norm=8))\n"
        "cfg = dataclasses.replace(cfg, geotransformer=dataclasses.replace(\n"
        "    cfg.geotransformer, input_dim=256, hidden_dim=32, output_dim=32, num_heads=2))\n"
        "rng = np.random.default_rng(3)\n"
        "ref = rng.uniform(0, 1, (400, 3)).astype(np.float32) * [1, 1, 0.1]\n"
        "src = (ref[ref[:, 0] < 0.7] + 0.004 * rng.normal(size=(1, 3))).astype(np.float32)\n"
        "points = np.concatenate([ref, src])\n"
        "pyr = build_pyramid(points, [len(ref), len(src)], 4, 0.06, 0.15, [12] * 4)\n"
        "caps = tuple(caps_for_pyramid(pyr, multiple=32, per_cloud=True))\n"
        "cfg = cfg.with_caps(stage_caps=caps, neighbor_limits=(12,) * 4,\n"
        "                    correspondence_capacity=256)\n"
        "batch = pad_registration_batch(pyr, np.ones((len(points), 1), np.float32),\n"
        "                               np.eye(4, dtype=np.float32), caps)\n"
        "out = create_model(cfg, device='cpu')(batch_to_torch(batch, 'cpu'))\n"
        "assert torch.isfinite(out['estimated_transform']).all()\n"
        "loaded = [m for m in sys.modules if sys.modules[m] is not None\n"
        "          and (m.split('.')[0] in ('jax', 'flax', 'jaxlib'))]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.strip().endswith("ok")
