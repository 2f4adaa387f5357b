"""The port's ModelNet path vs the JAX package's, on the CPU.

  * ``ModelNetPairDataset``: from the same synthetic pickle and ``np.random``
    state, every sample byte-identical to the JAX class's;
  * a narrow 3-stage ``fine_level=0`` model (the ModelNet structure of
    ``make_modelnet_config`` at test widths) on a dataset pair: the port's
    kernel route (the attention, GSE, KPConv and Sinkhorn kernels' plain
    versions on the CPU) against the JAX XLA forward (``force_pallas=False``)
    at the tolerances of tests/test_torch_model.py, and one training step's
    loss (rtol 1e-4) and every parameter gradient (1e-3 of its norm, the
    vanishing biases at the noise floor) against ``jax.grad``;
  * the same training step in float64 on the kernel route (the kernels'
    plain versions, the attention's written-out backward, ``q . b_p``
    dropped) and on the einsum route (``force_pallas=False``), on this
    ModelNet pair and on the narrow 3DMatch and KITTI pairs of
    tests/test_torch_train.py and tests/test_torch_kitti.py: every gradient
    equal to 1e-9 of its norm, so the two routes compute the same function
    and its gradient, and on the card they differ by float32 rounding
    alone;
  * the warmup-cosine learning rates against the JAX schedule (1e-12).
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.configs import CoarseMatchingConfig, PrecisionConfig, make_modelnet_config
from geotransformer_tpu.datasets.modelnet import ModelNetPairDataset as JaxModelNetPairDataset
from geotransformer_tpu.losses.overall import overall_loss as jax_overall_loss
from geotransformer_tpu.models import create_model as create_jax_model
from geotransformer_tpu.parallel.train import make_lr_schedule as jax_make_lr_schedule

from geotransformer_tpu_torch.configs import make_modelnet_config as port_modelnet_config
from geotransformer_tpu_torch.datasets import ModelNetPairDataset
from geotransformer_tpu_torch.losses import overall_loss
from geotransformer_tpu_torch.models import create_model, precompute_gt_targets
from geotransformer_tpu_torch.parallel import make_lr_schedule
from geotransformer_tpu_torch.preprocess import batch_to_torch, build_pyramid, caps_for_pyramid
from geotransformer_tpu_torch.preprocess import pad_registration_batch
from geotransformer_tpu_torch.utils.convert import gradients_to_state_dict, variables_to_state_dict
from test_modelnet_schedule import tiny_modelnet_config
from test_torch_kitti import kitti_batch
from test_torch_train import make_training_batch, train_config
from torch_routes import jax_precision_kept  # noqa: F401  (JAX precision globals restored)


def write_modelnet_pickle(root, seed=3, entries=4, num_points=1500):
    """A synthetic ModelNet pickle: points on the surfaces of random boxes,
    with normals, labels from the asymmetric classes."""
    rng = np.random.default_rng(seed)
    data = []
    for e in range(entries):
        size = rng.uniform(0.3, 1.0, 3)
        face = rng.integers(0, 3, num_points)
        side = rng.choice([-1.0, 1.0], num_points)
        points = rng.uniform(-0.5, 0.5, (num_points, 3)) * size
        points[np.arange(num_points), face] = 0.5 * side * size[face]
        normals = np.zeros((num_points, 3))
        normals[np.arange(num_points), face] = side
        data.append(dict(points=points.astype(np.float32), normals=normals.astype(np.float32),
                         label=(0, 2, 7, 8)[e % 4]))
    for subset in ("train", "val", "test"):
        with open(root / f"{subset}.pkl", "wb") as f:
            pickle.dump(data, f)
    return str(root)


@pytest.fixture(scope="module")
def modelnet_root(tmp_path_factory):
    return write_modelnet_pickle(tmp_path_factory.mktemp("modelnet"))


REFERENCE_SETTINGS = dict(num_points=717, noise_magnitude=0.05, keep_ratio=0.7, twice_sample=True)


@pytest.mark.parametrize("settings", [
    REFERENCE_SETTINGS,
    dict(REFERENCE_SETTINGS, deterministic=True),
    dict(num_points=512, crop_method="point", twice_transform=True, min_overlap=0.3,
         rotation_magnitude=30.0, asymmetric=False),
], ids=["reference", "deterministic", "point-crop-overlap-check"])
def test_dataset_samples_are_byte_identical(modelnet_root, settings):
    jax_ds = JaxModelNetPairDataset(modelnet_root, "train", **settings)
    port_ds = ModelNetPairDataset(modelnet_root, "train", **settings)
    assert len(port_ds) == len(jax_ds) > 0
    for index in range(len(port_ds)):
        np.random.seed(100 + index)
        want = jax_ds[index]
        np.random.seed(100 + index)
        got = port_ds[index]
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes(), key
            else:
                assert got[key] == value, key


def modelnet_test_config():
    """The tiny ModelNet configuration of tests/test_modelnet_schedule.py
    (3 stages, fine_level=0) with every GT pair trained on."""
    cfg = tiny_modelnet_config()
    # the float32 point, which the port honours and the JAX XLA path computes in
    cfg = dataclasses.replace(
        cfg, coarse_matching=CoarseMatchingConfig(num_targets=256, num_correspondences=32),
        precision=PrecisionConfig(kpconv_mxu="float32", gse_basis="float32", gse_embed="float32"))
    return cfg.with_model(force_pallas=False)


def modelnet_batch(cfg, root, index=1):
    dataset = ModelNetPairDataset(root, "train", deterministic=True, **REFERENCE_SETTINGS)
    sample = dataset[index]
    points = np.concatenate([sample["ref_points"], sample["src_points"]], 0)
    bb = cfg.backbone
    pyramid = build_pyramid(points, [len(sample["ref_points"]), len(sample["src_points"])],
                            bb.num_stages, bb.init_voxel_size, bb.init_radius,
                            list(cfg.caps.neighbor_limits))
    caps = tuple(caps_for_pyramid(pyramid, multiple=32, per_cloud=True))
    cfg = cfg.with_caps(stage_caps=caps)
    batch = pad_registration_batch(pyramid, np.ones((points.shape[0], 1), np.float32),
                                   sample["transform"], caps,
                                   inverse_limits=cfg.caps.inverse_limits)
    return cfg, batch


@pytest.fixture(scope="module")
def modelnet(modelnet_root):
    cfg, batch = modelnet_batch(modelnet_test_config(), modelnet_root)
    batch_j = jax.tree.map(jnp.asarray, batch)
    jax_model = create_jax_model(cfg)
    variables = jax.jit(lambda r, b: jax_model.init(
        {"params": r, "target": jax.random.fold_in(r, 1)}, b, training=True, with_gt=True))(
            jax.random.PRNGKey(0), batch_j)
    out_j = jax.tree.map(np.asarray, jax.jit(
        lambda v, b: jax_model.apply(v, b, training=False, with_gt=False))(variables, batch_j))

    def loss_fn(params, constants, b, rng):
        output = jax_model.apply({"params": params, "constants": constants}, b,
                                 training=True, with_gt=True, rngs={"target": rng})
        return jax_overall_loss(cfg, output, b["transform"])

    grads_j, aux_j = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"], variables["constants"], batch_j, jax.random.PRNGKey(5))

    # the port on its kernel route (force_pallas=None: plain versions here)
    port_cfg = cfg.with_model(force_pallas=None)
    port = create_model(port_cfg, device="cpu")
    port.load_state_dict(variables_to_state_dict(jax.tree.map(np.asarray, variables)),
                         strict=True)
    batch_t = batch_to_torch(batch, "cpu")
    out_t = {k: v.numpy() for k, v in port(batch_t).items()}
    batch_t.update(precompute_gt_targets(port_cfg, batch_t, device="cpu"))
    output = port(batch_t, training=True, with_gt=True, generator=torch.Generator().manual_seed(5))
    loss, aux_t = overall_loss(port_cfg, output, batch_t["transform"])
    loss.backward()
    eligible = int((batch_t["gt_cand_overlaps"][batch_t["gt_cand_masks"]]
                    > cfg.coarse_matching.overlap_threshold).sum())
    return dict(cfg=cfg, port=port, out_j=out_j, out_t=out_t, aux_j=aux_j, aux_t=aux_t,
                grads_j=gradients_to_state_dict(jax.tree.map(np.asarray, grads_j)),
                eligible=eligible)


def test_batch_is_modelnet_shaped(modelnet):
    cfg, out = modelnet["cfg"], modelnet["out_t"]
    assert cfg.model.fine_level == 0 and cfg.backbone.num_stages == 3
    # fine level 0: the fine features are stage 0's, decoded to output_dim
    assert out["ref_feats_f"].shape[1] == cfg.backbone.output_dim
    assert out["ref_feats_f"].shape[0] == out["ref_points_f"].shape[0]
    k = cfg.model.num_points_in_patch
    assert out["matching_scores"].shape[1:] == (k + 1, k + 1)


@pytest.mark.parametrize("key, rtol, atol", [("feats_c", 1e-3, 1e-4), ("feats_f", 1e-3, 1e-4)])
def test_forward_features_match_jax(modelnet, key, rtol, atol):
    out_t, out_j = modelnet["out_t"], modelnet["out_j"]
    for side in ("ref", "src"):
        rows = out_j[f"{side}_masks_{key[-1]}"].astype(bool)
        np.testing.assert_allclose(out_t[f"{side}_{key}"][rows], out_j[f"{side}_{key}"][rows],
                                   rtol=rtol, atol=atol, err_msg=side)


def test_forward_correspondences_and_transform_match_jax(modelnet):
    out_t, out_j = modelnet["out_t"], modelnet["out_j"]
    for key in ("ref_node_corr_indices", "src_node_corr_indices", "node_corr_masks"):
        np.testing.assert_array_equal(out_t[key], out_j[key], err_msg=key)
    np.testing.assert_allclose(out_t["estimated_transform"], out_j["estimated_transform"],
                               atol=5e-4)


def test_training_step_loss_matches_jax(modelnet):
    assert 0 < modelnet["eligible"] <= modelnet["cfg"].coarse_matching.num_targets
    for key in ("loss", "c_loss", "f_loss"):
        np.testing.assert_allclose(modelnet["aux_t"][key].item(), float(modelnet["aux_j"][key]),
                                   rtol=1e-4, err_msg=key)


def test_training_step_gradients_match_jax_grad(modelnet):
    grads_j = modelnet["grads_j"]
    named = dict(modelnet["port"].named_parameters())
    assert sorted(named) == sorted(grads_j)
    floor = 1e-6 * max(np.linalg.norm(g.numpy()) for g in grads_j.values())
    vanishing = []
    for name, param in named.items():
        # a parameter the graph does not reach (proj_p.bias) has no grad: 0
        want = grads_j[name].numpy()
        got = np.zeros_like(want) if param.grad is None else param.grad.numpy()
        norm = np.linalg.norm(want)
        if norm <= floor:
            vanishing.append(name)
            assert np.linalg.norm(got) <= floor, name
            continue
        assert np.linalg.norm(got - want) <= 1e-3 * norm, (
            f"{name}: |diff| {np.linalg.norm(got - want):.3e} vs |g| {norm:.3e}")
    # the fused route drops q . b_p: its proj_p biases get exact zeros
    for name in named:
        if name.endswith("proj_p.bias"):
            assert named[name].grad is None or not named[name].grad.any(), name
            assert name in vanishing
    assert all(n.endswith(".bias") for n in vanishing), vanishing


def _float64(value):
    if torch.is_tensor(value):
        return value.double() if value.is_floating_point() else value
    if isinstance(value, (list, tuple)):
        return type(value)(_float64(v) for v in value)
    return value


@pytest.mark.parametrize("path", ["modelnet", "3dmatch", "kitti"])
def test_kernel_and_einsum_routes_take_the_same_step_in_float64(modelnet_root, path):
    if path == "modelnet":
        cfg, batch = modelnet_batch(modelnet_test_config(), modelnet_root)
    elif path == "3dmatch":
        cfg, batch = make_training_batch(train_config())
    else:
        cfg, batch, _ = kitti_batch()
    batch = batch_to_torch(batch, "cpu")
    batch.update(precompute_gt_targets(cfg, batch, device="cpu"))
    batch = {k: _float64(v) for k, v in batch.items()}
    grads = []
    for force in (None, False):
        model = create_model(cfg.with_model(force_pallas=force), device="cpu").double()
        output = model(batch, training=True, with_gt=True,
                       generator=torch.Generator().manual_seed(5))
        overall_loss(cfg, output, batch["transform"])[0].backward()
        grads.append({name: p.grad for name, p in model.named_parameters()})
    kernel, einsum = grads
    assert all(g is not None for g in kernel.values())
    scale = max(g.norm().item() for g in einsum.values())
    for name, want in einsum.items():
        diff = (kernel[name] - want).norm().item()
        assert diff <= 1e-9 * want.norm().item() + 1e-12 * scale, f"{name}: {diff:.3e}"


def test_full_width_modelnet_config_matches_jax():
    want = dataclasses.asdict(make_modelnet_config())
    got = dataclasses.asdict(port_modelnet_config())
    # the one difference: the port's precision point defaults to float32
    assert got.pop("precision") == {knob: "float32" for knob in want.pop("precision")}
    assert got == {k: v for k, v in want.items() if k in got}
    assert got["model"]["fine_level"] == 0 and got["caps"]["stage_caps"] == (768, 384, 192)


def test_warmup_cosine_learning_rates_match_jax():
    cfg = tiny_modelnet_config()
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, warmup_steps=100, max_iteration=1000, eta_init=0.1, eta_min=0.1))
    want = jax_make_lr_schedule(cfg, steps_per_epoch=1)
    got = make_lr_schedule(cfg, steps_per_epoch=1)
    for step in (0, 1, 50, 99, 100, 101, 550, 999, 1000, 1500):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12,
                                   err_msg=str(step))


def test_converter_maps_every_parameter_of_the_full_width_model(modelnet_root):
    """``variables_to_state_dict`` over the full-width ModelNet model's
    variables (shapes from ``jax.eval_shape`` of its init, no compute):
    the same keys and shapes as the port's ``state_dict``, ``decoder2``,
    ``decoder1`` and the attention ``proj_p`` among them."""
    cfg, batch = modelnet_batch(make_modelnet_config().with_model(force_pallas=False),
                                modelnet_root)
    jax_model = create_jax_model(cfg)
    shapes = jax.eval_shape(
        lambda r, b: jax_model.init({"params": r, "target": r}, b, training=True, with_gt=True),
        jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, batch))
    mapped = variables_to_state_dict(jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes))
    port = create_model(port_modelnet_config(), device="cpu").state_dict()
    assert sorted(mapped) == sorted(port)
    for key, value in port.items():
        assert tuple(mapped[key].shape) == tuple(value.shape), key
    for part in ("backbone.decoder2.", "backbone.decoder1.", "attention.attention.proj_p."):
        assert any(part in key for key in port), part
