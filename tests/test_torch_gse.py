"""The port's geometric structure embedding (plain version of the GSE kernel)
vs the JAX package: the XLA ``GeometricStructureEmbedding`` at 1e-4 and the
Pallas ``gse_embedding_full`` in interpret mode at its own bar (rtol 2e-2,
atol 1e-2: bf16 bases and output, tests/test_gse_kernel.py:22), compared on
the valid rectangle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels.gse import gse_embedding_full as jax_gse_full
from geotransformer_tpu.models.transformer import (
    GeometricStructureEmbedding as JaxGSE,
)

from geotransformer_tpu_torch.kernels.gse import gse_embedding_full
from geotransformer_tpu_torch.models.transformer import GeometricStructureEmbedding

HIDDEN, SIGMA_D, SIGMA_A, ANGLE_K = 64, 0.2, 15.0, 3


def make_points(seed, n):
    # coordinates on a 1/256 grid: |x|^2 - 2 x.y + |y|^2 (the JAX distance)
    # is then exact in f32, like the port's direct |y - x|
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(0, 1, (1, n, 3)) * 256) / 256).astype(np.float32)


def jax_and_port(seed, n, n_valid=None):
    points = make_points(seed, n)
    masks = None
    if n_valid is not None:
        masks = np.zeros((1, n), bool)
        masks[:, :n_valid] = True
    jax_module = JaxGSE(HIDDEN, SIGMA_D, SIGMA_A, ANGLE_K)
    pj = jnp.asarray(points)
    mj = None if masks is None else jnp.asarray(masks)
    variables = jax_module.init(jax.random.PRNGKey(seed), pj, mj)
    rng = np.random.default_rng(seed + 100)
    params = {name: {"kernel": np.array(variables["params"][name]["kernel"]),
                     "bias": rng.normal(size=HIDDEN).astype(np.float32)}
              for name in ("proj_d", "proj_a")}
    want = np.asarray(jax_module.apply({"params": params}, pj, mj))
    port = GeometricStructureEmbedding(HIDDEN, SIGMA_D, SIGMA_A, ANGLE_K)
    with torch.no_grad():
        for name in ("proj_d", "proj_a"):
            getattr(port, name).weight.copy_(torch.from_numpy(params[name]["kernel"].T))
            getattr(port, name).bias.copy_(torch.from_numpy(params[name]["bias"]))
        got = port(torch.from_numpy(points),
                   None if masks is None else torch.from_numpy(masks)).numpy()
    return points, params, port, want, got


@pytest.mark.parametrize("seed", [0, 1])
def test_module_matches_jax_xla(seed):
    _, _, _, want, got = jax_and_port(seed, 60)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_module_with_masks_matches_on_valid_rectangle():
    n, nv = 70, 50
    _, _, _, want, got = jax_and_port(2, n, n_valid=nv)
    np.testing.assert_allclose(got[:, :nv, :nv], want[:, :nv, :nv], rtol=1e-4, atol=1e-4)
    # outside the valid rectangle the port writes zeros, as the CUDA kernel does
    assert not got[:, nv:].any() and not got[:, :, nv:].any()


@pytest.mark.parametrize("n_valid", [None, 45])
def test_plain_matches_jax_pallas_interpret(n_valid):
    n = 70
    points, params, port, _, _ = jax_and_port(3, n, n_valid=n_valid)
    masks = None
    if n_valid is not None:
        masks = torch.zeros((1, n), dtype=torch.bool)
        masks[:, :n_valid] = True
    with torch.no_grad():
        ref_vectors = port.reference_vectors(torch.from_numpy(points), masks)[0]
    nv = n if n_valid is None else n_valid
    w_d, b_d = params["proj_d"]["kernel"], params["proj_d"]["bias"]
    w_a, b_a = params["proj_a"]["kernel"], params["proj_a"]["bias"]
    want = np.asarray(jax_gse_full(
        jnp.asarray(points[0]), jnp.asarray(ref_vectors.numpy()), jnp.asarray(w_d),
        jnp.asarray(b_d), jnp.asarray(w_a), jnp.asarray(b_a), HIDDEN, SIGMA_D, SIGMA_A,
        n_valid=nv), np.float32)
    got = gse_embedding_full(
        torch.from_numpy(points[0]), ref_vectors, torch.from_numpy(w_d), torch.from_numpy(b_d),
        torch.from_numpy(w_a), torch.from_numpy(b_a), SIGMA_D, SIGMA_A,
        torch.tensor(nv, dtype=torch.int32)).numpy()
    np.testing.assert_allclose(got[:nv, :nv], want[:nv, :nv], rtol=2e-2, atol=1e-2)


def test_diagonal_angle_is_zero():
    # v = p_i - p_i = 0 with u < 0 componentwise makes u . v a signed zero;
    # atan2(+0, -0) would be pi, the XLA path's diagonal angle is 0
    points = torch.tensor([[0.0, 0.0, 0.0], [0.1, 0.0, 0.0], [0.0, 0.2, 0.0]])
    ref_vectors = -torch.ones((3, 1, 3))
    w_d = torch.zeros((2, 2))
    w_a = torch.zeros((2, 2))
    w_a[1, 1] = 1.0  # channel 1 = cos(angle index): 1 at angle 0, cos(12) at pi
    zero = torch.zeros(2)
    out = gse_embedding_full(points, ref_vectors, w_d, zero, w_a, zero, SIGMA_D, SIGMA_A)
    np.testing.assert_array_equal(torch.diagonal(out[:, :, 1]).numpy(), 1.0)


def test_force_true_on_cpu_raises():
    points = torch.rand(5, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        gse_embedding_full(points, torch.rand(5, 3, 3), torch.eye(4), torch.zeros(4),
                           torch.eye(4), torch.zeros(4), SIGMA_D, SIGMA_A, force=True)
