"""The port's training step vs the JAX package's.

One narrow 4-stage configuration and one synthetic pair with inverse
tables, built once with numpy; the JAX model's own initial variables are
carried into the port. On the CPU:
  * the overall loss (rtol 1e-4) and every parameter gradient of one step
    (|g_port - g_jax| <= 1e-3 |g_jax| per tensor, by name) against
    ``jax.grad`` of the JAX ``loss_fn`` (``parallel/train.py:136-142``,
    ``force_pallas=False``: XLA autodiff, the Sinkhorn scan). ``num_targets``
    exceeds the eligible GT pairs, so both sides train on every one of them
    and their different random keys cannot change the loss;
  * one Adam update with the schedule against optax's ``make_optimizer``
    (1e-6);
  * the finite-gradient guard: a NaN gradient leaves the parameters, the
    Adam moments and the schedule's count as they were.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geotransformer_tpu.configs import CoarseMatchingConfig, OptimConfig
from geotransformer_tpu.losses.overall import overall_loss as jax_overall_loss
from geotransformer_tpu.models import create_model as create_jax_model
from geotransformer_tpu.parallel.train import make_optimizer as jax_make_optimizer

from geotransformer_tpu_torch.losses import overall_loss
from geotransformer_tpu_torch.models import create_model, precompute_gt_targets
from geotransformer_tpu_torch.parallel import (
    make_eval_step,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from geotransformer_tpu_torch.preprocess import (
    batch_to_torch,
    build_pyramid,
    caps_for_pyramid,
    pad_registration_batch,
)
from geotransformer_tpu_torch.utils.convert import gradients_to_state_dict, variables_to_state_dict
from test_torch_model import make_pair, narrow_config


def train_config():
    cfg = narrow_config()
    return dataclasses.replace(
        cfg, coarse_matching=CoarseMatchingConfig(num_targets=64, num_correspondences=32))


def make_training_batch(cfg, seed=11):
    ref, src, transform = make_pair(seed)
    points = np.concatenate([ref, src], 0)
    pyramid = build_pyramid(points, [len(ref), len(src)], cfg.backbone.num_stages,
                            cfg.backbone.init_voxel_size, cfg.backbone.init_radius,
                            list(cfg.caps.neighbor_limits))
    caps = tuple(caps_for_pyramid(pyramid, multiple=32, per_cloud=True))
    cfg = cfg.with_caps(stage_caps=caps, gt_candidates=16, gt_chunk_size=8)
    batch = pad_registration_batch(pyramid, np.ones((points.shape[0], 1), np.float32),
                                   transform, caps, inverse_limits=cfg.caps.inverse_limits)
    return cfg, batch


@pytest.fixture(scope="module")
def step_pair():
    cfg, batch = make_training_batch(train_config())
    batch_j = jax.tree.map(jnp.asarray, batch)
    jax_model = create_jax_model(cfg)
    key = jax.random.PRNGKey(0)
    variables = jax.jit(lambda r, b: jax_model.init(
        {"params": r, "target": jax.random.fold_in(r, 1)}, b, training=True, with_gt=True))(
            key, batch_j)

    def loss_fn(params, constants, b, rng):
        output = jax_model.apply({"params": params, "constants": constants}, b,
                                 training=True, with_gt=True, rngs={"target": rng})
        loss, aux = jax_overall_loss(cfg, output, b["transform"])
        return loss, (aux, jnp.sum(output["ref_node_corr_knn_masks"].any(axis=1)))

    grads_j, (aux_j, patches_j) = jax.jit(jax.grad(loss_fn, has_aux=True))(
        variables["params"], variables["constants"], batch_j, jax.random.PRNGKey(5))

    port = create_model(cfg, device="cpu")
    port.load_state_dict(variables_to_state_dict(jax.tree.map(np.asarray, variables)))
    batch_t = batch_to_torch(batch, "cpu")
    batch_t.update(precompute_gt_targets(cfg, batch_t, device="cpu"))
    output = port(batch_t, training=True, with_gt=True,
                  generator=torch.Generator().manual_seed(5))
    loss, aux = overall_loss(cfg, output, batch_t["transform"])
    loss.backward()
    eligible = int((batch_t["gt_cand_overlaps"][batch_t["gt_cand_masks"]]
                    > cfg.coarse_matching.overlap_threshold).sum())
    return dict(cfg=cfg, batch=batch, port=port, aux_t=aux, aux_j=aux_j, output=output,
                grads_j=gradients_to_state_dict(jax.tree.map(np.asarray, grads_j)),
                eligible=eligible, patches_j=int(patches_j), variables=variables)


def test_every_eligible_target_is_trained_on_both_sides(step_pair):
    eligible = step_pair["eligible"]
    assert 0 < eligible <= step_pair["cfg"].coarse_matching.num_targets
    patches_t = int(step_pair["output"]["ref_node_corr_knn_masks"].any(dim=1).sum())
    assert patches_t == eligible == step_pair["patches_j"]


def test_loss_matches_jax(step_pair):
    for key in ("loss", "c_loss", "f_loss"):
        np.testing.assert_allclose(step_pair["aux_t"][key].item(), float(step_pair["aux_j"][key]),
                                   rtol=1e-4, err_msg=key)


def test_parameter_gradients_match_jax_grad(step_pair):
    grads_j = step_pair["grads_j"]
    named = dict(step_pair["port"].named_parameters())
    assert sorted(named) == sorted(grads_j)
    # Some gradients vanish in exact arithmetic: biases that shift every
    # score of a softmax row alike (attention proj_k / proj_p, the GSE
    # projections) or feed a one-channel GroupNorm group. Both sides leave
    # f32 rounding noise there, which is held to the noise floor instead.
    floor = 1e-6 * max(np.linalg.norm(g.numpy()) for g in grads_j.values())
    vanishing = []
    for name, param in named.items():
        want = grads_j[name].numpy()
        got = param.grad.numpy()
        assert got.shape == want.shape, name
        norm = np.linalg.norm(want)
        if norm <= floor:
            vanishing.append(name)
            assert np.linalg.norm(got) <= floor, name
            continue
        assert np.linalg.norm(got - want) <= 1e-3 * norm, (
            f"{name}: |diff| {np.linalg.norm(got - want):.3e} vs |g| {norm:.3e}")
    assert all(n.endswith(".bias") for n in vanishing), vanishing
    assert len(vanishing) <= 12, vanishing


@pytest.mark.parametrize("schedule", ["step", "warmup_cosine"])
def test_adam_updates_match_optax(schedule):
    optim = OptimConfig(lr=1e-2, lr_decay=0.5, weight_decay=1e-2)
    if schedule == "warmup_cosine":
        optim = dataclasses.replace(optim, warmup_steps=2, max_iteration=6, eta_init=0.1,
                                    eta_min=0.1)
    cfg = dataclasses.replace(train_config(), optim=optim)
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = jax_make_optimizer(cfg, steps_per_epoch=2)
    state = tx.init(params)
    p_j = params
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    optimizer, scheduler = make_optimizer(module, cfg, steps_per_epoch=2)
    for step in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        updates, state = tx.update(grads, state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        for k, p in module.items():
            p.grad = torch.from_numpy(grads[k])
        optimizer.step()
        scheduler.step()
        for k, p in module.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_j[k]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{k} after step {step}")
    lr_schedule = make_lr_schedule(cfg, steps_per_epoch=2)
    assert optimizer.param_groups[0]["lr"] == pytest.approx(lr_schedule(5))


def test_guard_skips_a_non_finite_step():
    cfg, batch = make_training_batch(train_config())
    model = create_model(cfg, device="cpu")
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=1)
    step = make_train_step(model, cfg, optimizer, scheduler, device="cpu")
    batch = dict(batch_to_torch(batch, "cpu"))
    batch.update(precompute_gt_targets(cfg, batch, device="cpu"))
    first = step(batch, torch.Generator().manual_seed(0))
    assert first["grad_finite"].item() == 1.0 and torch.isfinite(first["loss"])
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    moments = {k: {s: v.clone() for s, v in optimizer.state[p].items()}
               for k, p in model.named_parameters()}
    count = scheduler.last_epoch
    hook = model.transformer.in_proj.weight.register_hook(lambda g: g * float("nan"))
    skipped = step(batch, torch.Generator().manual_seed(0))
    hook.remove()
    assert skipped["grad_finite"].item() == 0.0
    assert scheduler.last_epoch == count
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), params[k], rtol=0, atol=0)
        for s, v in optimizer.state[p].items():
            torch.testing.assert_close(v, moments[k][s], rtol=0, atol=0)
    # the next finite step goes on from where the skipped one left off
    after = step(batch, torch.Generator().manual_seed(0))
    assert after["grad_finite"].item() == 1.0 and scheduler.last_epoch == count + 1


def test_eval_step_and_entry_points_default_to_the_card():
    cfg, batch = make_training_batch(train_config())
    model = create_model(cfg, device="cpu")
    batch = dict(batch)
    metrics = make_eval_step(model, cfg, device="cpu")(batch)
    for key in ("PIR", "IR", "RRE", "RTE", "RMSE", "RR", "loss", "c_loss", "f_loss"):
        assert torch.isfinite(metrics[key]), key
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            create_model(cfg)
        optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=1)
        with pytest.raises((RuntimeError, AssertionError)):
            make_train_step(model, cfg, optimizer, scheduler)(batch)
