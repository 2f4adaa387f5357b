"""The port's GSE parameter gradients (plain version of the GSE backward
kernel) vs the JAX package.

Same numpy inputs through ``gse_full_bwd`` of the port (plain, on the CPU)
and:
  * ``jax.vjp`` of the XLA ``GeometricStructureEmbedding`` with respect to
    its projections (rtol 1e-4, atol 1e-5 x the largest gradient: f32 sums
    in another order; points on a 1/256 grid make both distances exact),
    the cotangent zero outside the valid rectangle (the port's embedding is
    zero there) and on the diagonal (where the XLA path's angle can be pi
    from a -0 dot product and the port's is 0);
  * the Pallas ``_gse_full_bwd`` in interpret mode at the JAX test's own bar
    (at most 0.5 % of the entries off by more than 5 % of the largest:
    bf16 bases, polynomial sin/cos, tests/test_gse_kernel.py:45,142), with
    ``n_valid < n`` too;
  * autograd through the port's plain forward, and the autograd Function
    (rtol 1e-5: the same bases; first-argmax and amax's even split agree);
  * a tie of two angle projections within f32 rounding, off the diagonal:
    the gradient goes to the float64 argmax's k (the kernel settles such
    ties the same way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels.gse import _gse_full_bwd as jax_gse_full_bwd
from geotransformer_tpu.models.transformer import GeometricStructureEmbedding as JaxGSE

from geotransformer_tpu_torch.kernels import gse as port_gse
from geotransformer_tpu_torch.kernels.gse import (
    gse_embedding_full_diff,
    gse_embedding_full_plain,
    gse_full_bwd,
)
from geotransformer_tpu_torch.ops.embedding import sinusoidal_embedding
from geotransformer_tpu_torch.models.transformer import GeometricStructureEmbedding

HIDDEN, SIGMA_D, SIGMA_A, ANGLE_K = 64, 0.2, 15.0, 3


def make_case(seed, n, n_valid):
    rng = np.random.default_rng(seed)
    points = (np.round(rng.uniform(0, 1, (n, 3)) * 256) / 256).astype(np.float32)
    masks = np.arange(n) < n_valid
    de = rng.normal(size=(n, n, HIDDEN)).astype(np.float32)
    de[n_valid:] = 0.0
    de[:, n_valid:] = 0.0
    w_a = (rng.normal(size=(HIDDEN, HIDDEN)) / 8).astype(np.float32)
    port = GeometricStructureEmbedding(HIDDEN, SIGMA_D, SIGMA_A, ANGLE_K)
    with torch.no_grad():
        ref_vectors = port.reference_vectors(torch.from_numpy(points)[None],
                                             torch.from_numpy(masks)[None])[0]
    return points, masks, de, w_a, ref_vectors


def port_grads(points, ref_vectors, w_a, de, n_valid):
    return gse_full_bwd(torch.from_numpy(points), ref_vectors, torch.from_numpy(w_a), SIGMA_D,
                        SIGMA_A, torch.from_numpy(de), torch.tensor(n_valid, dtype=torch.int32))


@pytest.mark.parametrize("n_valid", [50, 40])
def test_matches_jax_xla_vjp(n_valid):
    n = 50
    points, masks, de, w_a, ref_vectors = make_case(0, n, n_valid)
    de[np.arange(n), np.arange(n)] = 0.0
    module = JaxGSE(HIDDEN, SIGMA_D, SIGMA_A, ANGLE_K)
    pj, mj = jnp.asarray(points)[None], jnp.asarray(masks)[None]
    variables = module.init(jax.random.PRNGKey(0), pj, mj)
    params = {"proj_d": dict(variables["params"]["proj_d"]),
              "proj_a": {"kernel": jnp.asarray(w_a), "bias": variables["params"]["proj_a"]["bias"]}}
    _, vjp = jax.vjp(lambda p: module.apply({"params": p}, pj, mj), params)
    (want,) = vjp(jnp.asarray(de)[None])
    dw_d, db_d, dw_a, db_a = port_grads(points, ref_vectors, w_a, de, n_valid)
    for got, ref in ((dw_d, want["proj_d"]["kernel"]), (db_d, want["proj_d"]["bias"]),
                     (dw_a, want["proj_a"]["kernel"]), (db_a, want["proj_a"]["bias"])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("n_valid", [70, 45])
def test_matches_jax_pallas_interpret(n_valid):
    n = 70
    points, _, de, w_a, ref_vectors = make_case(1, n, n_valid)
    want = jax_gse_full_bwd(jnp.asarray(points), jnp.asarray(ref_vectors.numpy()),
                            jnp.asarray(w_a), HIDDEN, SIGMA_D, SIGMA_A, jnp.asarray(de),
                            interpret=True, n_valid=n_valid)
    got = port_grads(points, ref_vectors, w_a, de, n_valid)
    for g, w in zip(got, want):
        w = np.asarray(w)
        rel = np.abs(g.numpy() - w) / (np.abs(w).max() + 1e-8)
        assert (rel > 5e-2).mean() <= 0.005, f"max rel {rel.max():.3f}"


@pytest.mark.parametrize("n_valid", [30, 1])
def test_matches_autograd_and_function(n_valid):
    n = 30
    points, _, de, w_a, ref_vectors = make_case(2, n, n_valid)
    rng = np.random.default_rng(3)
    params = [torch.from_numpy((rng.normal(size=s) / 8).astype(np.float32)).requires_grad_()
              for s in ((HIDDEN, HIDDEN), (HIDDEN,), (HIDDEN, HIDDEN), (HIDDEN,))]
    with torch.no_grad():
        params[2].copy_(torch.from_numpy(w_a))
    p, nv, det = torch.from_numpy(points), torch.tensor(n_valid, dtype=torch.int32), torch.from_numpy(de)
    out = gse_embedding_full_plain(p, ref_vectors, *params, SIGMA_D, SIGMA_A, nv)
    want = torch.autograd.grad((out * det).sum(), params)
    out_f = gse_embedding_full_diff(p, ref_vectors, *params, SIGMA_D, SIGMA_A, nv)
    np.testing.assert_array_equal(out_f.detach().numpy(), out.detach().numpy())
    via_function = torch.autograd.grad((out_f * det).sum(), params)
    direct = port_grads(points, ref_vectors, w_a, de, n_valid)
    for got in (via_function, direct):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6 * float(w.abs().max()) + 1e-7)


def test_force_true_on_cpu_raises():
    points, _, de, w_a, ref_vectors = make_case(4, 10, 10)
    with pytest.raises(RuntimeError, match="CUDA"):
        gse_full_bwd(torch.from_numpy(points), ref_vectors, torch.from_numpy(w_a), SIGMA_D,
                     SIGMA_A, torch.from_numpy(de), force=True)


def test_a_tie_within_f32_rounding_routes_by_the_float64_argmax():
    n, i, j, c = 20, 2, 7, 5
    points, _, _, w_a, ref_vectors = make_case(5, n, n)
    p = torch.from_numpy(points)
    _, a_idx = port_gse._pair_indices(p, ref_vectors, SIGMA_D, SIGMA_A)
    bases = port_gse._exact_bases(a_idx[i, j], HIDDEN)  # (k, C) float64
    w = torch.from_numpy(w_a).double()
    proj = bases @ w[:, c]
    k1, k2 = proj.topk(2).indices.tolist()
    # move column c along the difference of the two best bases until their
    # projections are 1e-9 of the column's scale apart
    diff = bases[k1] - bases[k2]
    scale = w[:, c].abs().sum()
    w[:, c] -= diff * ((proj[k1] - proj[k2]) - 1e-9 * scale) / diff.dot(diff)
    w32 = w.float()
    proj = bases @ w32.double()[:, c]
    top = proj.topk(2)
    assert sorted(top.indices.tolist()) == sorted([k1, k2])
    assert top.values[0] - top.values[1] < 1e-6 * scale  # within f32 rounding of the sums
    de = torch.zeros(n, n, HIDDEN)
    de[i, j, c] = 1.0
    dw_a = gse_full_bwd(p, ref_vectors, w32, SIGMA_D, SIGMA_A, de)[2]
    want = sinusoidal_embedding(a_idx[i, j, int(proj.argmax())], HIDDEN)
    np.testing.assert_allclose(dw_a[:, c].numpy(), want.numpy(), rtol=1e-6, atol=1e-7)
    assert not dw_a[:, :c].any() and not dw_a[:, c + 1:].any()
