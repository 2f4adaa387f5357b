"""One narrow training step at the JAX package's precision point on the
CPU: the port's plain versions at ``JAX_PRECISION`` against ``jax.grad`` of
the JAX model on its Pallas kernels (interpret mode) at its default point,
the same weights and batch (tolerances at the test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.losses.overall import overall_loss as jax_overall_loss
from geotransformer_tpu.models import create_model as create_jax_model

from geotransformer_tpu_torch import configs as port_configs
from geotransformer_tpu_torch.losses import overall_loss
from geotransformer_tpu_torch.models import create_model, precompute_gt_targets
from geotransformer_tpu_torch.parallel import make_optimizer, make_train_step
from geotransformer_tpu_torch.preprocess import (
    batch_to_torch,
    build_pyramid,
    caps_for_pyramid,
    pad_registration_batch,
)
from geotransformer_tpu_torch.utils.convert import gradients_to_state_dict, variables_to_state_dict
from test_torch_model import make_pair, narrow_config
from test_torch_precision import jax_point  # noqa: F401  (fixture)
from torch_routes import jax_precision_kept, numpy_pyramids  # noqa: F401


def jax_point_config():
    """The narrow 4-stage configuration at the JAX package's default point
    (a JAX configuration: the port reads its fields by name), the JAX model
    on its Pallas kernels (interpret mode on the CPU)."""
    from geotransformer_tpu.configs import CoarseMatchingConfig, PrecisionConfig

    cfg = dataclasses.replace(
        narrow_config(), precision=PrecisionConfig(),
        coarse_matching=CoarseMatchingConfig(num_targets=64, num_correspondences=32))
    return cfg.with_model(force_pallas=True)


def step_gradients(port, cfg, batch_t):
    port.zero_grad(set_to_none=True)
    output = port(batch_t, training=True, with_gt=True, generator=torch.Generator().manual_seed(5))
    loss, aux = overall_loss(cfg, output, batch_t["transform"])
    loss.backward()
    return {name: p.grad.clone() for name, p in port.named_parameters()}, aux


def test_training_step_at_the_jax_point_matches_jax_grad(jax_point):
    """One narrow training step with inverse tables at ``JAX_PRECISION``
    (the port's plain versions on the CPU) against ``jax.grad`` of the JAX
    model on its Pallas kernels at its default point, the same weights and
    batch: the loss within 1e-3 (relative; the run: 2.8e-4, the float32
    point 6.0e-4), the whole step's gradient (all tensors) within 5e-2 of
    the JAX one in relative norm and nearer it than half the port's float32
    step is (the run: 2.4e-2 against 9.2e-2; every tensor 2-7 % against
    5-33 %: the rounding flips of a narrow random network, which every
    later layer carries, as the forward's, PERF.md section 6, PR 19);
    ``make_train_step`` takes the step, finite."""
    cfg = jax_point_config()
    ref, src, transform = make_pair(11)
    points = np.concatenate([ref, src], 0)
    pyramid = build_pyramid(points, [len(ref), len(src)], cfg.backbone.num_stages,
                            cfg.backbone.init_voxel_size, cfg.backbone.init_radius,
                            list(cfg.caps.neighbor_limits))
    caps = tuple(caps_for_pyramid(pyramid, multiple=32, per_cloud=True))
    cfg = cfg.with_caps(stage_caps=caps, gt_candidates=16, gt_chunk_size=8)
    batch = pad_registration_batch(pyramid, np.ones((points.shape[0], 1), np.float32), transform,
                                   caps, inverse_limits=cfg.caps.inverse_limits)
    batch_j = jax.tree.map(jnp.asarray, batch)
    jax_model = create_jax_model(cfg)
    variables = jax.jit(lambda r, b: jax_model.init(
        {"params": r, "target": jax.random.fold_in(r, 1)}, b, training=True, with_gt=True))(
            jax.random.PRNGKey(0), batch_j)

    def loss_fn(params, constants, b, rng):
        output = jax_model.apply({"params": params, "constants": constants}, b,
                                 training=True, with_gt=True, rngs={"target": rng})
        return jax_overall_loss(cfg, output, b["transform"])

    with jax.default_matmul_precision("highest"):
        grads_j, aux_j = jax.jit(jax.grad(loss_fn, has_aux=True))(
            variables["params"], variables["constants"], batch_j, jax.random.PRNGKey(5))
    grads_j = gradients_to_state_dict(jax.tree.map(np.asarray, grads_j))

    state = variables_to_state_dict(jax.tree.map(np.asarray, variables))
    port_cfg = cfg.with_model(force_pallas=None)
    batch_t = batch_to_torch(batch, "cpu")
    batch_t.update(precompute_gt_targets(port_cfg, batch_t, device="cpu"))
    distances = {}
    for name, precision in (("jax", port_configs.JAX_PRECISION),
                            ("f32", port_configs.PrecisionConfig())):
        point_cfg = dataclasses.replace(port_cfg, precision=precision)
        port = create_model(point_cfg, device="cpu")
        port.load_state_dict(state)
        grads, aux = step_gradients(port, point_cfg, batch_t)
        if name == "jax":
            np.testing.assert_allclose(aux["loss"].item(), float(aux_j["loss"]), rtol=1e-3)
        diff = sum(float(np.sum((grads[k].numpy() - grads_j[k].numpy()) ** 2)) for k in grads_j)
        norm = sum(float(np.sum(grads_j[k].numpy() ** 2)) for k in grads_j)
        distances[name] = (diff / norm) ** 0.5
    assert distances["jax"] <= 5e-2 and distances["jax"] <= 0.5 * distances["f32"], distances

    point_cfg = dataclasses.replace(port_cfg, precision=port_configs.JAX_PRECISION)
    port = create_model(point_cfg, device="cpu")
    port.load_state_dict(state)
    step = make_train_step(port, point_cfg, *make_optimizer(port, point_cfg, 1), device="cpu")
    metrics = step(batch_t, generator=torch.Generator().manual_seed(5))
    assert metrics["grad_finite"].item() == 1.0 and np.isfinite(metrics["loss"].item())


def test_synthetic_benchmark_takes_the_jax_point(capsys):
    """``scripts.synthetic_benchmark --precision jax`` trains and tests at
    ``JAX_PRECISION`` (its float32 default is the port's point), so its
    ``--force_pallas true`` run prices the drift the JAX run prices."""
    from geotransformer_tpu_torch.scripts import synthetic_benchmark

    cfg = synthetic_benchmark.small_config()
    assert synthetic_benchmark.training_config(cfg, 20, 10).precision == (
        port_configs.PrecisionConfig())
    jax_run = synthetic_benchmark.training_config(cfg, 20, 10, force_pallas=True,
                                                  precision="jax")
    assert jax_run.precision == port_configs.JAX_PRECISION and jax_run.model.force_pallas
    with pytest.raises(SystemExit):
        synthetic_benchmark.main(["--help"])
    assert "--precision" in capsys.readouterr().out
