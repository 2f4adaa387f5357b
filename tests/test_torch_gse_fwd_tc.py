"""The arithmetic of the GSE forward kernel (``gse_kernel`` in
``csrc/gse.cu``), checked on the CPU (the kernel itself runs on the card:
``-m cuda``, chip_smoke.py).

The kernel takes each valid pair's A angle projections B_k W_a and its
distance projection B_d W_d on the tensor cores as 3xTF32 products: the
bases and the weights split once into TF32 halves (big, small), and each k8
step of 8 basis rows puts small . big, big . small and big . big into a
fresh tile, which one f32 add brings into the running sum, steps in order
(chunks of four steps, in order). The angle projections fold into a
running max, k in order; the output is (distance projection + max) +
(b_d + b_a). Each mma's sum is modelled as the tensor cores take it: the
exact products and the accumulator aligned to the largest one's exponent
and truncated there, their sum truncated to f32 (no guard bits: the worst
case of that model). Emulated here in that order at C = 64 and 256, three
seeds, weights at the model's init scale (nn.Linear: U(+-1/sqrt(C))) and
the indices of a few hundred pairs:

  * every valid (pair, channel) stands within 2^-23 of sum_f |W_d[f, c]| +
    sum_f |W_a[f, c]| of the float64 embedding (float64 bases of the same
    f32 arguments), where the same products taken straight into the
    accumulator (its truncations at its own scale, 96 a projection at
    C = 256) do not, nor one TF32 product (big . big alone);
  * the emulation stands within chip_smoke.py's tol_gse_embedding (1e-3)
    of ``gse_embedding_full_plain`` on the valid rectangle and within the
    1e-4 of tests/test_torch_gse.py of the JAX ``GeometricStructureEmbedding``,
    and pairs outside the valid rectangle are zeros, as the kernel writes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.models.transformer import (
    GeometricStructureEmbedding as JaxGSE,
)

from geotransformer_tpu_torch.kernels import gse as port_gse
from geotransformer_tpu_torch.kernels.gse import gse_embedding_full, gse_embedding_full_plain
from geotransformer_tpu_torch.models.transformer import GeometricStructureEmbedding
from geotransformer_tpu_torch.ops.embedding import sinusoidal_embedding

from test_torch_attention import tf32

SIGMA_D, SIGMA_A, ANGLE_K = 0.2, 15.0, 3
K8 = 8
BOUND = 2.0**-23


def truncate_f32(x):
    """float64 x rounded toward zero to float32."""
    r = x.float()
    over = r.double().abs() > x.abs()
    r[over] = torch.nextafter(r[over], torch.zeros_like(r[over]))
    return r


def mma(acc, a, w):
    """acc (P, N) + a (P, 8) @ w (8, N), TF32 halves, as one mma sums it:
    the exact products and acc aligned to the largest one's exponent and
    truncated there, the sum truncated to f32."""
    terms = torch.cat([acc.double()[:, None], a.double()[:, :, None] * w.double()[None]], dim=1)
    top = terms.abs().amax(dim=1)
    quantum = torch.exp2(torch.floor(torch.log2(torch.where(top > 0, top, 1.0))) - 23)
    return truncate_f32((torch.trunc(terms / quantum[:, None]) * quantum[:, None]).sum(dim=1))


def projection(a, w, mode="fresh"):
    """a (pairs, C) @ w (C, N) as the kernel sums it: k8 steps in order,
    each step's small . big, big . small and big . big into a fresh tile
    and the tile added to the f32 sum; ``into``: the three straight into the
    sum; ``single``: big . big alone, into a fresh tile."""
    a_big, w_big = tf32(a), tf32(w)
    a_small, w_small = tf32(a - a_big), tf32(w - w_big)
    out = torch.zeros(a.shape[0], w.shape[1])
    for k in range(0, a.shape[1], K8):
        step = slice(k, k + K8)
        products = [(a_big[:, step], w_big[step])]
        if mode != "single":
            products = [(a_small[:, step], w_big[step]), (a_big[:, step], w_small[step])] + products
        tile = out if mode == "into" else torch.zeros_like(out)
        for x, y in products:
            tile = mma(tile, x, y)
        out = tile if mode == "into" else out + tile
    return out


def emulated_gse(points, ref_vectors, w_d, b_d, w_a, b_a, n_valid, mode="fresh"):
    """The kernel's embedding: (N, N, C), zeros outside [0, n_valid)^2."""
    n, hidden = points.shape[0], w_d.shape[0]
    d_idx, a_idx = port_gse._pair_indices(points, ref_vectors, SIGMA_D, SIGMA_A)
    d_idx = d_idx[:n_valid, :n_valid].reshape(-1)
    a_idx = a_idx[:n_valid, :n_valid].reshape(-1, a_idx.shape[-1])
    amax = None
    for k in range(a_idx.shape[1]):
        cur = projection(sinusoidal_embedding(a_idx[:, k], hidden), w_a, mode)
        amax = cur if amax is None else torch.maximum(amax, cur)
    valid = (projection(sinusoidal_embedding(d_idx, hidden), w_d, mode) + amax) + (b_d + b_a)
    out = torch.zeros(n, n, hidden)
    out[:n_valid, :n_valid] = valid.reshape(n_valid, n_valid, hidden)
    return out


def exact_gse(points, ref_vectors, w_d, b_d, w_a, b_a, n_valid):
    """The embedding in float64 from float64 bases of the f32 arguments, on
    the valid rectangle."""
    hidden = w_d.shape[0]
    d_idx, a_idx = port_gse._pair_indices(points, ref_vectors, SIGMA_D, SIGMA_A)
    d_idx, a_idx = d_idx[:n_valid, :n_valid], a_idx[:n_valid, :n_valid]
    e_d = port_gse._exact_bases(d_idx, hidden) @ w_d.double()
    e_a = (port_gse._exact_bases(a_idx, hidden) @ w_a.double()).amax(dim=2)
    return e_d + e_a + (b_d.double() + b_a.double())


def make_case(seed, n, hidden, n_valid):
    rng = np.random.default_rng(seed)
    points = rng.uniform(0.0, 1.5, (n, 3)).astype(np.float32)
    masks = np.arange(n) < n_valid
    bound = 1.0 / np.sqrt(hidden)
    w_d, w_a = (rng.uniform(-bound, bound, (hidden, hidden)).astype(np.float32) for _ in range(2))
    b_d, b_a = (rng.uniform(-bound, bound, hidden).astype(np.float32) for _ in range(2))
    module = GeometricStructureEmbedding(hidden, SIGMA_D, SIGMA_A, ANGLE_K)
    with torch.no_grad():
        ref_vectors = module.reference_vectors(torch.from_numpy(points)[None],
                                               torch.from_numpy(masks)[None])[0]
    tensors = [torch.from_numpy(x) for x in (points,)] + [ref_vectors] + [
        torch.from_numpy(x) for x in (w_d, b_d, w_a, b_a)]
    return tensors


@pytest.mark.parametrize("hidden", [64, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_emulated_projections_stand_within_bound_of_float64(hidden, seed):
    n, nv = 23, 19
    points, ref_vectors, w_d, b_d, w_a, b_a = make_case(seed, n, hidden, nv)
    args = (points, ref_vectors, w_d, b_d, w_a, b_a)
    got = emulated_gse(*args, nv)
    exact = exact_gse(*args, nv)
    scale = w_d.abs().sum(dim=0).double() + w_a.abs().sum(dim=0).double()  # (C,)
    err = ((got[:nv, :nv].double() - exact).abs() / scale).max().item()
    assert err <= BOUND, f"3xTF32 error {err / BOUND:.3f} of 2^-23"
    for mode in ("into", "single"):
        other = emulated_gse(*args, nv, mode=mode)
        assert ((other[:nv, :nv].double() - exact).abs() / scale).max().item() > BOUND, mode
    # within tol_gse_embedding of the plain version; zeros outside
    plain = gse_embedding_full_plain(*args, SIGMA_D, SIGMA_A, torch.tensor(nv, dtype=torch.int32))
    assert (got[:nv, :nv] - plain[:nv, :nv]).abs().max().item() <= 1e-3
    assert not got[nv:].any() and not got[:, nv:].any()
    # the wrapper on the CPU is the plain version
    assert torch.equal(gse_embedding_full(*args, SIGMA_D, SIGMA_A,
                                          torch.tensor(nv, dtype=torch.int32)), plain)


def test_emulation_matches_jax_module():
    hidden, n = 64, 30
    rng = np.random.default_rng(5)
    points = (np.round(rng.uniform(0, 1, (1, n, 3)) * 256) / 256).astype(np.float32)
    jax_module = JaxGSE(hidden, SIGMA_D, SIGMA_A, ANGLE_K)
    variables = jax_module.init(jax.random.PRNGKey(5), jnp.asarray(points))
    params = {name: {"kernel": np.array(variables["params"][name]["kernel"]),
                     "bias": rng.normal(size=hidden).astype(np.float32)}
              for name in ("proj_d", "proj_a")}
    want = np.asarray(jax_module.apply({"params": params}, jnp.asarray(points)))[0]
    port = GeometricStructureEmbedding(hidden, SIGMA_D, SIGMA_A, ANGLE_K)
    with torch.no_grad():
        ref_vectors = port.reference_vectors(torch.from_numpy(points))[0]
    w = {name: torch.from_numpy(params[name]["kernel"]) for name in params}
    b = {name: torch.from_numpy(params[name]["bias"]) for name in params}
    got = emulated_gse(torch.from_numpy(points[0]), ref_vectors, w["proj_d"], b["proj_d"],
                       w["proj_a"], b["proj_a"], n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
