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
    Adam moments and the schedule's count as they were;
  * gradient accumulation (``optim.grad_acc_steps``): ``MultiSteps``
    against ``optax.MultiSteps`` (1e-6), and the tiny model's accumulated
    mean gradient against the JAX ``MultiStepsState.acc_grads`` (the
    gradient tolerance above);
  * a batch without inverse tables (the scatter backward) against
    ``jax.grad`` (the gradient tolerance above).
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
    MultiSteps,
    apply_gradients,
    make_eval_step,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
)
from geotransformer_tpu_torch.parallel.train import grads_finite
from geotransformer_tpu_torch.preprocess import (
    batch_to_torch,
    build_pyramid,
    caps_for_pyramid,
    pad_registration_batch,
)
from geotransformer_tpu_torch.utils.convert import gradients_to_state_dict, variables_to_state_dict
from test_torch_model import make_pair, narrow_config
from torch_routes import jax_precision_kept  # noqa: F401  (JAX precision globals restored)


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

    grad_fn = jax.jit(jax.grad(loss_fn, has_aux=True))
    grads_j, (aux_j, patches_j) = grad_fn(variables["params"], variables["constants"], batch_j,
                                          jax.random.PRNGKey(5))

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
                eligible=eligible, patches_j=int(patches_j), variables=variables,
                grad_fn=grad_fn)


def test_every_eligible_target_is_trained_on_both_sides(step_pair):
    eligible = step_pair["eligible"]
    assert 0 < eligible <= step_pair["cfg"].coarse_matching.num_targets
    patches_t = int(step_pair["output"]["ref_node_corr_knn_masks"].any(dim=1).sum())
    assert patches_t == eligible == step_pair["patches_j"]


def test_loss_matches_jax(step_pair):
    for key in ("loss", "c_loss", "f_loss"):
        np.testing.assert_allclose(step_pair["aux_t"][key].item(), float(step_pair["aux_j"][key]),
                                   rtol=1e-4, err_msg=key)


def assert_gradients_match(got_by_name, grads_j):
    """Every gradient within 1e-3 of the JAX one (relative norm), by name.
    Some gradients vanish in exact arithmetic: biases that shift every
    score of a softmax row alike (attention proj_k / proj_p, the GSE
    projections) or feed a one-channel GroupNorm group. Both sides leave f32
    rounding noise there, which is held to the noise floor instead."""
    assert sorted(got_by_name) == sorted(grads_j)
    floor = 1e-6 * max(np.linalg.norm(g.numpy()) for g in grads_j.values())
    vanishing = []
    for name, got in got_by_name.items():
        want = grads_j[name].numpy()
        got = got.numpy()
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


def test_parameter_gradients_match_jax_grad(step_pair):
    assert_gradients_match({name: p.grad for name, p in step_pair["port"].named_parameters()},
                           step_pair["grads_j"])


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


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("schedule", ["step", "warmup_cosine"])
def test_accumulated_updates_match_optax_multisteps(schedule, k):
    """``grad_acc_steps`` k: 7 mini-steps through ``MultiSteps``, against
    optax's ``make_optimizer`` (``optax.MultiSteps``); the fourth is not
    finite, and the guard leaves it out on both sides (the JAX step keeps
    the old state). Parameters, accumulator and its count after every
    mini-step (1e-6), the schedule counting updates."""
    optim = OptimConfig(lr=1e-2, lr_decay=0.5, weight_decay=1e-2, grad_acc_steps=k)
    if schedule == "warmup_cosine":
        optim = dataclasses.replace(optim, warmup_steps=2, max_iteration=6, eta_init=0.1,
                                    eta_min=0.1)
    cfg = dataclasses.replace(train_config(), optim=optim)
    rng = np.random.default_rng(1)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    tx = jax_make_optimizer(cfg, steps_per_epoch=2)
    state = tx.init(params)
    p_j = params
    module = torch.nn.ParameterDict({name: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for name, v in params.items()})
    optimizer, scheduler = make_optimizer(module, cfg, steps_per_epoch=2)
    assert isinstance(optimizer, MultiSteps)
    updates = 0
    for step in range(7):
        grads = {name: rng.normal(size=v.shape).astype(np.float32)
                 for name, v in params.items()}
        if step == 3:
            grads["b"][1] = np.nan
        else:
            u, state = tx.update(grads, state, p_j)
            p_j = optax.apply_updates(p_j, u)
        for name, p in module.items():
            p.grad = torch.from_numpy(grads[name].copy())
        if grads_finite(list(module.parameters())):
            updates += apply_gradients(optimizer, scheduler)
        assert optimizer.mini_step == int(state.mini_step), step
        for (name, p), acc in zip(module.items(), optimizer.acc_grads):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(p_j[name]), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} after mini-step {step}")
            np.testing.assert_allclose(acc.numpy(), np.asarray(state.acc_grads[name]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"acc {name} after mini-step {step}")
    assert updates == 6 // k == int(state.gradient_step) == scheduler.last_epoch
    lr_schedule = make_lr_schedule(cfg, steps_per_epoch=2)
    assert optimizer.param_groups[0]["lr"] == pytest.approx(lr_schedule(updates))


def without_inverse(batch):
    return {k: v for k, v in batch.items() if k not in ("neighbors_inv", "subsampling_inv")}


def test_training_without_inverse_tables_matches_jax_grad(step_pair):
    """A batch without inverse tables trains every conv through the scatter
    backward (``kernels/kpconv.py``, the JAX XLA rules): the same gradients
    as ``jax.grad``, to the tolerance of the inverse-table step."""
    cfg = step_pair["cfg"]
    port = create_model(cfg, device="cpu")
    port.load_state_dict(variables_to_state_dict(
        jax.tree.map(np.asarray, step_pair["variables"])))
    batch = batch_to_torch(without_inverse(step_pair["batch"]), "cpu")
    batch.update(precompute_gt_targets(cfg, batch, device="cpu"))
    output = port(batch, training=True, with_gt=True, generator=torch.Generator().manual_seed(5))
    overall_loss(cfg, output, batch["transform"])[0].backward()
    assert_gradients_match({name: p.grad for name, p in port.named_parameters()},
                           step_pair["grads_j"])


def test_accumulated_gradient_matches_jax_multisteps_state(step_pair):
    """Two mini-steps of an accumulation of 3 (the fixture's pair, then the
    same pair with its input features halved) through the port's train
    step: the accumulated mean against the JAX ``MultiStepsState.acc_grads``
    after the same mini-steps, to the tolerance of one step's gradients; no
    update yet, so the parameters and the schedule are as they were."""
    cfg = step_pair["cfg"]
    cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, grad_acc_steps=3))
    first = step_pair["batch"]
    stream = first["input_stream"].copy()
    stream[4] *= 0.5
    second = dict(first, features=first["features"] * 0.5, input_stream=stream)
    variables = step_pair["variables"]
    tx = jax_make_optimizer(cfg, steps_per_epoch=1)
    state = tx.init(variables["params"])
    update = jax.jit(tx.update)
    for batch in (first, second):
        grads, _ = step_pair["grad_fn"](variables["params"], variables["constants"],
                                        jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(5))
        _, state = update(grads, state, variables["params"])
    assert int(state.mini_step) == 2
    want = gradients_to_state_dict(jax.tree.map(np.asarray, state.acc_grads))

    port = create_model(cfg, device="cpu")
    port.load_state_dict(variables_to_state_dict(jax.tree.map(np.asarray, variables)))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    optimizer, scheduler = make_optimizer(port, cfg, steps_per_epoch=1)
    step = make_train_step(port, cfg, optimizer, scheduler, device="cpu")
    for batch in (first, second):
        batch = dict(batch_to_torch(batch, "cpu"))
        batch.update(precompute_gt_targets(cfg, batch, device="cpu"))
        assert step(batch, torch.Generator().manual_seed(5))["grad_finite"].item() == 1.0
    assert optimizer.mini_step == 2 and scheduler.last_epoch == 0
    for k, v in port.state_dict().items():
        assert torch.equal(v, before[k]), k
    names = [name for name, _ in port.named_parameters()]
    assert_gradients_match(dict(zip(names, optimizer.acc_grads)), want)


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
