"""The port's model at a transformer width and angle count past the shipped
ones (``geotransformer.hidden_dim = 48``, ``angle_k = 4``) against the JAX
package, on the CPU.

The narrow 4-stage configuration and pair of tests/test_torch_train.py with
the GeoTransformer at C = 48 (which the GSE kernels pad to 64 basis rows
and channels on the card) and four reference angles (two angle groups in
the GSE backward); the JAX model's own initial variables carried into the
port, both on their plain routes (JAX ``force_pallas=False``):
  * the inference forward: the coarse and fine features on valid rows
    (rtol 1e-3, atol 1e-4) and the same superpoint correspondences, as
    tests/test_torch_model.py holds the shipped width;
  * one training step: the loss (rtol 1e-4) and every parameter gradient
    against ``jax.grad`` of the JAX loss (1e-3 of each gradient's norm, by
    name), as tests/test_torch_train.py holds the shipped width.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.losses.overall import overall_loss as jax_overall_loss
from geotransformer_tpu.models import create_model as create_jax_model

from geotransformer_tpu_torch.losses import overall_loss
from geotransformer_tpu_torch.models import create_model, precompute_gt_targets
from geotransformer_tpu_torch.preprocess import batch_to_torch
from geotransformer_tpu_torch.utils.convert import gradients_to_state_dict, variables_to_state_dict
from test_torch_train import assert_gradients_match, make_training_batch, train_config
from torch_routes import jax_precision_kept  # noqa: F401  (JAX precision globals restored)

HIDDEN_DIM, ANGLE_K = 48, 4


def widths_config():
    cfg = train_config()
    return dataclasses.replace(cfg, geotransformer=dataclasses.replace(
        cfg.geotransformer, hidden_dim=HIDDEN_DIM, angle_k=ANGLE_K))


@pytest.fixture(scope="module")
def models():
    cfg, batch = make_training_batch(widths_config())
    assert (cfg.geotransformer.hidden_dim, cfg.geotransformer.angle_k) == (HIDDEN_DIM, ANGLE_K)
    batch_j = jax.tree.map(jnp.asarray, batch)
    jax_model = create_jax_model(cfg)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, b: jax_model.init(
        {"params": r, "target": jax.random.fold_in(r, 1)}, b, training=True, with_gt=True))(
            key, batch_j)
    out_j = jax.tree.map(np.asarray, jax.jit(
        lambda v, b: jax_model.apply(v, b, training=False, with_gt=False))(variables, batch_j))

    def loss_fn(params, constants, b, rng):
        output = jax_model.apply({"params": params, "constants": constants}, b,
                                 training=True, with_gt=True, rngs={"target": rng})
        return jax_overall_loss(cfg, output, b["transform"])

    grads_j, aux_j = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"], variables["constants"], batch_j, jax.random.PRNGKey(5))

    port = create_model(cfg, device="cpu")
    port.load_state_dict(variables_to_state_dict(jax.tree.map(np.asarray, variables)))
    batch_t = batch_to_torch(batch, "cpu")
    with torch.no_grad():
        out_t = {k: v.numpy() for k, v in port(batch_t).items()}
    batch_t.update(precompute_gt_targets(cfg, batch_t, device="cpu"))
    output = port(batch_t, training=True, with_gt=True,
                  generator=torch.Generator().manual_seed(5))
    loss, aux_t = overall_loss(cfg, output, batch_t["transform"])
    loss.backward()
    return dict(port=port, out_j=out_j, out_t=out_t, aux_j=aux_j, aux_t=aux_t,
                grads_j=gradients_to_state_dict(jax.tree.map(np.asarray, grads_j)))


@pytest.mark.parametrize("level", ["c", "f"])
def test_forward_features_match_jax(models, level):
    out_t, out_j = models["out_t"], models["out_j"]
    for side in ("ref", "src"):
        rows = np.asarray(out_j[f"{side}_masks_{level}"], bool)
        assert rows.any()
        np.testing.assert_allclose(out_t[f"{side}_feats_{level}"][rows],
                                   out_j[f"{side}_feats_{level}"][rows], rtol=1e-3, atol=1e-4)


def test_forward_correspondences_match_jax(models):
    def pairs(out):
        m = np.asarray(out["node_corr_masks"], bool)
        return set(zip(out["ref_node_corr_indices"][m].tolist(),
                       out["src_node_corr_indices"][m].tolist()))

    assert pairs(models["out_j"]), "no valid node correspondence"
    assert pairs(models["out_t"]) == pairs(models["out_j"])


def test_step_loss_matches_jax(models):
    for key in ("loss", "c_loss", "f_loss"):
        np.testing.assert_allclose(models["aux_t"][key].item(), float(models["aux_j"][key]),
                                   rtol=1e-4, err_msg=key)


def test_step_gradients_match_jax_grad(models):
    grads = {name: p.grad for name, p in models["port"].named_parameters()}
    gse = [name for name in grads if ".embedding.proj_" in name]
    assert gse and all(grads[name].shape[-1] == HIDDEN_DIM for name in gse), gse
    assert_gradients_match(grads, models["grads_j"])
