"""The port's learnable log-Sinkhorn (plain version of the Sinkhorn kernel) vs
the JAX package: ``sinkhorn_log_iterations`` in interpret mode and the
module's ``"scan"`` and ``"pallas"`` backends, at 1e-4 on valid entries,
including a fully masked (empty) patch, which must stay finite."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels.sinkhorn import (
    sinkhorn_log_iterations as jax_sinkhorn_iterations,
)
from geotransformer_tpu.models.sinkhorn import (
    LearnableLogOptimalTransport as JaxOptimalTransport,
)

from geotransformer_tpu_torch.kernels.sinkhorn import sinkhorn_log_iterations
from geotransformer_tpu_torch.models.sinkhorn import LearnableLogOptimalTransport

ITERATIONS = 100


def make_patches(seed, p=6, k=16):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(p, k, k)).astype(np.float32)
    row_masks = rng.uniform(size=(p, k)) < 0.8
    col_masks = rng.uniform(size=(p, k)) < 0.8
    row_masks[0] = False  # an empty, fully masked patch
    col_masks[0] = False
    row_masks[1] = True
    col_masks[1] = True
    return scores, row_masks, col_masks


def valid_entries(row_masks, col_masks):
    rows = np.concatenate([row_masks, np.ones((row_masks.shape[0], 1), bool)], 1)
    cols = np.concatenate([col_masks, np.ones((col_masks.shape[0], 1), bool)], 1)
    return rows[:, :, None] & cols[:, None, :]


def run_port(scores, row_masks, col_masks, alpha):
    module = LearnableLogOptimalTransport(ITERATIONS)
    with torch.no_grad():
        module.alpha.fill_(alpha)
        return module(torch.from_numpy(scores), torch.from_numpy(row_masks),
                      torch.from_numpy(col_masks)).numpy()


@pytest.mark.parametrize("backend", ["scan", "pallas"])
@pytest.mark.parametrize("seed", [0, 1])
def test_module_matches_jax(seed, backend):
    scores, row_masks, col_masks = make_patches(seed)
    alpha = 0.7 + 0.1 * seed
    jax_module = JaxOptimalTransport(ITERATIONS, backend=backend)
    want = np.asarray(jax_module.apply(
        {"params": {"alpha": jnp.float32(alpha)}}, jnp.asarray(scores),
        jnp.asarray(row_masks), jnp.asarray(col_masks)))
    got = run_port(scores, row_masks, col_masks, alpha)
    assert np.all(np.isfinite(got))
    valid = valid_entries(row_masks, col_masks)
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-4, atol=1e-4)


def test_iterations_match_jax_kernel_interpret():
    rng = np.random.default_rng(4)
    p, m1, n1 = 5, 17, 17
    scores = rng.normal(size=(p, m1, n1)).astype(np.float32)
    masked = rng.uniform(size=(p, m1, n1)) < 0.2
    masked[0] = True  # empty patch but for the dustbin corner
    masked[0, -1, -1] = False
    scores = np.where(masked, -1e12, scores).astype(np.float32)
    log_mu = np.where(masked.all(axis=2), -1e12, -np.log(m1 + n1)).astype(np.float32)
    log_nu = np.where(masked.all(axis=1), -1e12, -np.log(m1 + n1)).astype(np.float32)
    want = np.asarray(jax_sinkhorn_iterations(
        jnp.asarray(scores), jnp.asarray(log_mu), jnp.asarray(log_nu), ITERATIONS))
    got = sinkhorn_log_iterations(torch.from_numpy(scores), torch.from_numpy(log_mu),
                                  torch.from_numpy(log_nu), ITERATIONS).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[~masked], want[~masked], rtol=1e-4, atol=1e-4)


def test_force_true_on_cpu_raises():
    scores = torch.zeros((1, 3, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        sinkhorn_log_iterations(scores, torch.zeros((1, 3)), torch.zeros((1, 3)), 2, force=True)
