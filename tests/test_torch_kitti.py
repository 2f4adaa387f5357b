"""The port's KITTI-shaped (5-stage) model with split tables vs the JAX
package, on the CPU.

A narrow 5-stage configuration of ``make_kitti_config()``'s shape and one
synthetic pair on a lattice: every stage-0 point sits at the centre of its
own stage-1 voxel (1/4 m), on a 1/8 grid, and src is the ref overlap moved
by a grid translation. The fine level (stage 1) then equals stage 0
exactly, so the GT patch distances are exact in f32 under both the port's direct and the
JAX expanded form. The batch carries split neighbor and subsampling tables
fitted to the pair (``calibrate_split_specs`` over it) and split inverse
tables (``fit_split_for_table``); the JAX XLA path (``force_pallas=False``)
reads neither, so the comparison also shows each split conv equal to the
unsplit one. The JAX model's initial variables are carried into the port.
  * forward: coarse features within 1e-4, ``gt_cand_*`` equal (indices as
    masked sets per ref node), the transform within 5e-4;
  * a training step without precomputed targets (the in-step GT overlaps):
    the loss (rtol 1e-4) and every parameter gradient (1e-3 of its norm)
    against ``jax.grad`` of the JAX loss; ``num_targets`` covers every
    candidate, so both sides train on every eligible pair;
  * an eval step without precomputed targets: PIR and the losses as the
    JAX model's.
"""

import dataclasses

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
    make_kitti_config,
)
from geotransformer_tpu.losses.overall import evaluate as jax_evaluate
from geotransformer_tpu.losses.overall import overall_loss as jax_overall_loss
from geotransformer_tpu.models import create_model as create_jax_model

from geotransformer_tpu_torch.losses import overall_loss
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.parallel import make_eval_step
from geotransformer_tpu_torch.preprocess import (
    batch_to_torch,
    build_pyramid,
    caps_for_pyramid,
    calibrate_inverse_limits,
    calibrate_split_specs,
    fit_split_for_table,
    pad_registration_batch,
)
from geotransformer_tpu_torch.preprocess.voxel import grid_subsample_single
from geotransformer_tpu_torch.utils.convert import gradients_to_state_dict, variables_to_state_dict
from torch_routes import jax_precision_kept  # noqa: F401  (JAX precision globals restored)

VOXEL = 0.125  # stage 1 subsamples at 2 x VOXEL
CELL = 2 * VOXEL
GT_CANDIDATES = 8


def lattice_pair(seed=0, extent=10.0, density=0.6):
    """Terraced surface: a random 60 % of the lattice cells of CELL m over
    extent x extent m, each point at its cell's centre (x, y and z); src is
    the part with x < 7.5 m moved by -(0.5, 0.25, 0)."""
    rng = np.random.default_rng(seed)
    cells = int(extent / CELL)
    ij = np.argwhere(rng.uniform(size=(cells, cells)) < density)
    xy = (ij + 0.5) * CELL
    z = (np.round(0.8 * np.sin(0.6 * xy[:, 0]) * np.cos(0.5 * xy[:, 1]) / CELL) + 0.5) * CELL
    ref = np.column_stack([xy, z]).astype(np.float32)
    trans = np.array([0.5, 0.25, 0.0], np.float32)
    src = ref[ref[:, 0] < 7.5] - trans  # ref = src + trans
    transform = np.eye(4, dtype=np.float32)
    transform[:3, 3] = trans
    # in the voxel order stage 1 will have (one point a cell: the same points)
    return grid_subsample_single(ref, CELL), grid_subsample_single(src, CELL), transform


def kitti_narrow_config():
    return dataclasses.replace(
        make_kitti_config(),
        backbone=BackboneConfig(num_stages=5, init_voxel_size=VOXEL, base_radius=4.25,
                                init_dim=8, group_norm=4),
        model=ModelConfig(ground_truth_matching_radius=0.3, num_points_in_patch=16,
                          fine_level=1, num_sinkhorn_iterations=10, force_pallas=False),
        geotransformer=GeoTransformerModuleConfig(
            input_dim=256, hidden_dim=32, output_dim=32, blocks=("self", "cross"),
            num_heads=2, sigma_d=4.8),
        caps=CapsConfig(neighbor_limits=(16,) * 5, gt_candidates=GT_CANDIDATES,
                        gt_chunk_size=8, correspondence_capacity=256),
        # the float32 point, which the port honours and the JAX XLA path
        # computes in
        precision=PrecisionConfig(kpconv_mxu="float32", gse_basis="float32",
                                  gse_embed="float32"),
    )


def kitti_batch():
    cfg = kitti_narrow_config()
    ref, src, transform = lattice_pair()
    points = np.concatenate([ref, src], 0)
    bb = cfg.backbone
    args = (bb.num_stages, bb.init_voxel_size, bb.init_radius, list(cfg.caps.neighbor_limits))
    pyramid = build_pyramid(points, [len(ref), len(src)], *args)
    # stage 1 is stage 0: the GT patches are lattice points
    np.testing.assert_array_equal(pyramid["points"][1], pyramid["points"][0])
    caps = tuple(caps_for_pyramid(pyramid, multiple=32, per_cloud=True))
    samples = [{"ref_points": ref, "src_points": src}]
    nb_splits, sub_splits = calibrate_split_specs(iter(samples), *args, multiple=32)
    inverse_limits, sub_inverse_limits = calibrate_inverse_limits(iter(samples), *args)
    num_targets = caps[-1][0] * GT_CANDIDATES  # every candidate
    cfg = dataclasses.replace(cfg, coarse_matching=CoarseMatchingConfig(
        num_targets=num_targets, num_correspondences=32)).with_caps(
            stage_caps=caps, inverse_limits=tuple(inverse_limits))
    feats = np.ones((points.shape[0], 1), np.float32)
    kw = dict(inverse_limits=inverse_limits, sub_inverse_limits=sub_inverse_limits,
              neighbor_splits=nb_splits, subsampling_splits=sub_splits)
    plain = pad_registration_batch(pyramid, feats, transform, caps, **kw)
    rows = [nb.shape[0] for nb in plain["neighbors"]]
    kw["inverse_splits"] = [fit_split_for_table(t, rows[i], multiple=32, align=8)
                            for i, t in enumerate(plain["neighbors_inv"])]
    kw["sub_inverse_splits"] = [fit_split_for_table(t, rows[i + 1], multiple=32, align=8)
                                for i, t in enumerate(plain["subsampling_inv"])]
    batch = pad_registration_batch(pyramid, feats, transform, caps, **kw)
    return cfg, batch, kw


@pytest.fixture(scope="module")
def kitti():
    cfg, batch, specs = kitti_batch()
    batch_j = jax.tree.map(jnp.asarray, batch)
    jax_model = create_jax_model(cfg)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, b: jax_model.init(
        {"params": r, "target": jax.random.fold_in(r, 1)}, b, training=True, with_gt=True))(
            key, batch_j)

    def eval_fn(v, b):
        output = jax_model.apply(v, b, training=False, with_gt=True)
        metrics = jax_evaluate(cfg, output, b["transform"])
        metrics.update(jax_overall_loss(cfg, output, b["transform"])[1])
        return output, metrics

    out_j, metrics_j = jax.tree.map(np.asarray, jax.jit(eval_fn)(variables, batch_j))
    metrics_j = {k: float(v) for k, v in metrics_j.items()}

    def loss_fn(params, constants, b, rng):
        output = jax_model.apply({"params": params, "constants": constants}, b,
                                 training=True, with_gt=True, rngs={"target": rng})
        loss, aux = jax_overall_loss(cfg, output, b["transform"])
        return loss, (aux, jnp.sum(output["ref_node_corr_knn_masks"].any(axis=1)))

    grads_j, (aux_j, patches_j) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"], variables["constants"], batch_j, jax.random.PRNGKey(5))

    state = variables_to_state_dict(jax.tree.map(np.asarray, variables))
    port = create_model(cfg, device="cpu")
    port.load_state_dict(state)
    batch_t = batch_to_torch(batch, "cpu")
    out_t = {k: v.numpy() for k, v in port(batch_t, with_gt=True).items()}
    output = port(batch_t, training=True, with_gt=True,
                  generator=torch.Generator().manual_seed(5))
    loss, aux_t = overall_loss(cfg, output, batch_t["transform"])
    loss.backward()
    metrics_t = {k: float(v) for k, v in make_eval_step(port, cfg, device="cpu")(batch).items()}
    return dict(cfg=cfg, batch=batch, specs=specs, out_j=out_j, out_t=out_t, port=port,
                grads_j=gradients_to_state_dict(jax.tree.map(np.asarray, grads_j)),
                aux_j=aux_j, aux_t=aux_t, patches_j=int(patches_j), output=output,
                metrics_j=metrics_j, metrics_t=metrics_t)


def test_batch_has_split_and_split_inverse_tables(kitti):
    specs, batch = kitti["specs"], kitti["batch"]
    assert any(s is not None for s in specs["neighbor_splits"])
    assert any(s is not None for s in specs["subsampling_splits"])
    assert any(isinstance(t, tuple) for t in batch["neighbors_inv"] + batch["subsampling_inv"])
    assert len(batch["points"]) == 5


def test_coarse_features_match_jax(kitti):
    out_t, out_j = kitti["out_t"], kitti["out_j"]
    assert out_t["ref_points_c"].shape[0] == kitti["cfg"].caps.stage_caps[4][0]
    for side in ("ref", "src"):
        rows = out_j[f"{side}_masks_c"]
        np.testing.assert_allclose(out_t[f"{side}_feats_c"][rows], out_j[f"{side}_feats_c"][rows],
                                   rtol=1e-4, atol=1e-4)


def test_gt_candidates_equal_jax(kitti):
    out_t, out_j = kitti["out_t"], kitti["out_j"]
    gi, go, gm = (out_t[k] for k in ("gt_cand_indices", "gt_cand_overlaps", "gt_cand_masks"))
    wi, wo, wm = (out_j[k] for k in ("gt_cand_indices", "gt_cand_overlaps", "gt_cand_masks"))
    assert wm.sum() > 10, "too few GT overlaps in the case"
    np.testing.assert_array_equal(gm.sum(1), wm.sum(1))
    for row in range(wm.shape[0]):
        assert (dict(zip(gi[row][gm[row]].tolist(), go[row][gm[row]].tolist()))
                == dict(zip(wi[row][wm[row]].tolist(), wo[row][wm[row]].tolist()))), row


def test_transform_matches_jax(kitti):
    got = kitti["out_t"]["estimated_transform"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, kitti["out_j"]["estimated_transform"], atol=5e-4)


def test_training_step_matches_jax_grad(kitti):
    patches_t = int(kitti["output"]["ref_node_corr_knn_masks"].any(dim=1).sum())
    assert 0 < patches_t == kitti["patches_j"]
    for key in ("loss", "c_loss", "f_loss"):
        np.testing.assert_allclose(kitti["aux_t"][key].item(), float(kitti["aux_j"][key]),
                                   rtol=1e-4, err_msg=key)
    grads_j = kitti["grads_j"]
    named = dict(kitti["port"].named_parameters())
    assert sorted(named) == sorted(grads_j)
    # gradients that vanish in exact arithmetic (biases under a softmax row
    # shift or a one-channel GroupNorm group) are held to the noise floor
    floor = 1e-6 * max(np.linalg.norm(g.numpy()) for g in grads_j.values())
    vanishing = []
    for name, param in named.items():
        want, got = grads_j[name].numpy(), param.grad.numpy()
        norm = np.linalg.norm(want)
        if norm <= floor:
            vanishing.append(name)
            assert np.linalg.norm(got) <= floor, name
            continue
        assert np.linalg.norm(got - want) <= 1e-3 * norm, (
            f"{name}: |diff| {np.linalg.norm(got - want):.3e} vs |g| {norm:.3e}")
    assert all(n.endswith(".bias") for n in vanishing), vanishing


def test_eval_step_matches_jax(kitti):
    got, want = kitti["metrics_t"], kitti["metrics_j"]
    for key in ("PIR", "IR", "RRE", "RTE", "RMSE", "RR", "loss", "c_loss", "f_loss"):
        assert np.isfinite(got[key]), key
    for key in ("PIR", "loss", "c_loss", "f_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(got["RTE"], want["RTE"], atol=1e-3)
