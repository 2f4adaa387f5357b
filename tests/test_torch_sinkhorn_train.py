"""The port's training Sinkhorn (plain versions of the forward and backward
kernels) vs the JAX package.

Same numpy inputs through ``sinkhorn_fwd_train`` / ``sinkhorn_bwd_train``
of the port (plain, on the CPU) and ``jax.vjp`` of the module's XLA
``"scan"`` backend and of ``sinkhorn_log_iterations_train`` (Pallas,
interpret mode), at 1e-4 on valid entries as tests/test_kernels.py:74
compares the forward, with partly and fully masked patches, whose values
must stay finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels.sinkhorn import (
    sinkhorn_log_iterations_train as jax_sinkhorn_train,
)
from geotransformer_tpu.models.sinkhorn import (
    LearnableLogOptimalTransport as JaxOptimalTransport,
)

from geotransformer_tpu_torch.kernels.sinkhorn import (
    sinkhorn_bwd_train,
    sinkhorn_fwd_train,
    sinkhorn_log_iterations,
    sinkhorn_log_iterations_train,
)
from geotransformer_tpu_torch.models.sinkhorn import LearnableLogOptimalTransport

ITERATIONS = 30


def make_patches(seed, p=6, k=12):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(p, k, k)).astype(np.float32)
    row_masks = rng.uniform(size=(p, k)) < 0.8
    col_masks = rng.uniform(size=(p, k)) < 0.8
    row_masks[0] = False  # an empty, fully masked patch
    col_masks[0] = False
    row_masks[1] = True
    col_masks[1] = True
    dout = rng.normal(size=(p, k + 1, k + 1)).astype(np.float32)
    return scores, row_masks, col_masks, dout


def valid_entries(row_masks, col_masks):
    rows = np.concatenate([row_masks, np.ones((row_masks.shape[0], 1), bool)], 1)
    cols = np.concatenate([col_masks, np.ones((col_masks.shape[0], 1), bool)], 1)
    return rows[:, :, None] & cols[:, None, :]


def close(got, want, valid=None):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.isfinite(got))
    if valid is not None:
        got, want = got[valid], want[valid]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_module_gradients_match_jax_scan(seed):
    scores, row_masks, col_masks, dout = make_patches(seed)
    valid = valid_entries(row_masks, col_masks)
    dout = np.where(valid, dout, 0.0).astype(np.float32)  # the loss masks its labels
    alpha = 0.8
    jax_module = JaxOptimalTransport(ITERATIONS, backend="scan")
    args = (jnp.asarray(row_masks), jnp.asarray(col_masks))
    want_out, vjp = jax.vjp(
        lambda a, s: jax_module.apply({"params": {"alpha": a}}, s, *args),
        jnp.float32(alpha), jnp.asarray(scores))
    want_da, want_ds = vjp(jnp.asarray(dout))

    module = LearnableLogOptimalTransport(ITERATIONS)
    with torch.no_grad():
        module.alpha.fill_(alpha)
    s = torch.from_numpy(scores).requires_grad_()
    out = module(s, torch.from_numpy(row_masks), torch.from_numpy(col_masks), training=True)
    got_ds, got_da = torch.autograd.grad((out * torch.from_numpy(dout)).sum(), (s, module.alpha))
    close(out.detach(), want_out, valid)
    close(got_ds, want_ds)
    close(got_da, want_da)


def _padded(seed, p=5, m1=13):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(p, m1, m1)).astype(np.float32)
    masked = rng.uniform(size=(p, m1, m1)) < 0.2
    masked[0] = True  # empty patch but for the dustbin corner
    masked[0, -1, -1] = False
    scores = np.where(masked, -1e12, scores).astype(np.float32)
    log_mu = np.where(masked.all(axis=2), -1e12, -np.log(2 * m1)).astype(np.float32)
    log_nu = np.where(masked.all(axis=1), -1e12, -np.log(2 * m1)).astype(np.float32)
    dout = np.where(masked, 0.0, rng.normal(size=(p, m1, m1))).astype(np.float32)
    return scores, log_mu, log_nu, dout, masked


def test_matches_jax_kernel_interpret():
    scores, log_mu, log_nu, dout, masked = _padded(2)
    args = [jnp.asarray(x) for x in (scores, log_mu, log_nu)]
    want_out, vjp = jax.vjp(lambda *a: jax_sinkhorn_train(*a, ITERATIONS), *args)
    want_ds, want_dmu, want_dnu = vjp(jnp.asarray(dout))
    t = [torch.from_numpy(x) for x in (scores, log_mu, log_nu)]
    out, v_hist = sinkhorn_fwd_train(*t, ITERATIONS)
    assert v_hist.shape == (5, ITERATIONS, 13) and not v_hist[:, 0].any()
    ds, dmu, dnu = sinkhorn_bwd_train(t[0], t[1], v_hist, torch.from_numpy(dout))
    close(out, want_out, ~masked)
    close(ds, want_ds)
    close(dmu, want_dmu)
    close(dnu, want_dnu)


def test_train_forward_equals_inference_and_function_gradients():
    scores, log_mu, log_nu, dout, _ = _padded(3)
    t = [torch.from_numpy(x) for x in (scores, log_mu, log_nu)]
    out, _ = sinkhorn_fwd_train(*t, ITERATIONS)
    np.testing.assert_array_equal(out.numpy(), sinkhorn_log_iterations(*t, ITERATIONS).numpy())
    # the Function's gradients are the backward's, and autograd through the
    # plain iterations agrees
    leaves = [x.clone().requires_grad_() for x in t]
    got = torch.autograd.grad(
        (sinkhorn_log_iterations_train(*leaves, ITERATIONS) * torch.from_numpy(dout)).sum(),
        leaves)
    leaves2 = [x.clone().requires_grad_() for x in t]
    want = torch.autograd.grad(
        (sinkhorn_log_iterations(*leaves2, ITERATIONS) * torch.from_numpy(dout)).sum(), leaves2)
    for g, w in zip(got, want):
        close(g, w)


def test_force_true_on_cpu_raises():
    scores = torch.zeros((1, 3, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        sinkhorn_fwd_train(scores, torch.zeros((1, 3)), torch.zeros((1, 3)), 2, force=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        sinkhorn_bwd_train(scores, torch.zeros((1, 3)), torch.zeros((1, 2, 3)), scores,
                           force=True)
