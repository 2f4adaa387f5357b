"""The arithmetic of the GSE backward kernel (``gse_bwd_kernel`` in
``csrc/gse_bwd.cu``), checked on the CPU (the kernel itself runs on the
card: ``-m cuda``, chip_smoke.py).

  * The projections. The kernel computes the A angle projections
    P_k = B_k W_a on the tensor cores as 3xTF32 products (big . small terms
    of TF32 halves), each k8 step's three products into a fresh tile that
    one f32 add brings into the sum, steps in order. Emulated here at
    C = 256 and at C = 512 (the widest width the kernels are run at: two
    chunks of 256 basis rows, the projection's k8 steps summed across them
    in order), with weights at the model's init scale (nn.Linear:
    U(+-1/sqrt(C))) and the indices of a few hundred pairs, they stand
    within 2^-19 of
    sum_f |W_a[f, c]| (half the kernel's tie band) of the float64
    projections in every channel, where one TF32 product does not; so every
    entry whose best two projections differ by more than the band
    (2^-18 sum_f |W_a[f, c]|) takes the float64 argmax from them, and the
    kernel settles the rest in float64.
  * The weight gradients. Emulated in the kernel's order (the valid pairs
    row-major in the wrapper's slices, 16-pair tiles, a fresh tile a k8
    step of 8 pairs, tiles in order, the slices added in order; db per pair
    slot, slots in order), with k* from the emulated projections and the
    band's entries settled in float64, they stand within rtol 1e-5 of
    ``gse_full_bwd_plain`` and within the bar of tests/test_torch_gse_bwd.py
    of the JAX ``_gse_full_bwd`` in interpret mode (bf16 bases there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels.gse import _gse_full_bwd as jax_gse_full_bwd

from geotransformer_tpu_torch.kernels import gse as port_gse
from geotransformer_tpu_torch.kernels.gse import gse_full_bwd_plain
from geotransformer_tpu_torch.models.transformer import GeometricStructureEmbedding
from geotransformer_tpu_torch.ops.embedding import sinusoidal_embedding

from test_torch_attention import tf32

SIGMA_D, SIGMA_A, ANGLE_K = 0.2, 15.0, 3
K8, TILE, SMS = 8, 16, 132
BAND = 2.0**-18


def projection_3xtf32(a, b, terms=3):
    """a (M, K) @ b (K, N) as the kernel sums a projection: k8 steps in
    order, each step's products (small . big, big . small, big . big; big .
    big alone with ``terms`` 1) into a fresh f32 tile, which one f32 add
    brings into the sum."""
    a = a.reshape(a.shape[0], -1, K8).transpose(0, 1)  # (steps, M, 8)
    b = b.reshape(-1, K8, b.shape[1])  # (steps, 8, N)
    a_big, b_big = tf32(a), tf32(b)
    products = [torch.bmm(a_big, b_big)]
    if terms == 3:
        products = [torch.bmm(tf32(a - a_big), b_big), torch.bmm(a_big, tf32(b - b_big))] + products
    out = torch.zeros(a.shape[1], b.shape[2])
    for step in range(a.shape[0]):
        tile = torch.zeros_like(out)
        for product in products:
            tile = tile + product[step]
        out = out + tile
    return out


def make_case(seed, n, hidden, n_valid=None):
    rng = np.random.default_rng(seed)
    points = rng.uniform(0.0, 1.5, (n, 3)).astype(np.float32)
    masks = np.arange(n) < (n if n_valid is None else n_valid)
    bound = 1.0 / np.sqrt(hidden)
    w_a = rng.uniform(-bound, bound, (hidden, hidden)).astype(np.float32)
    module = GeometricStructureEmbedding(hidden, SIGMA_D, SIGMA_A, ANGLE_K)
    with torch.no_grad():
        ref_vectors = module.reference_vectors(torch.from_numpy(points)[None],
                                               torch.from_numpy(masks)[None])[0]
    return torch.from_numpy(points), ref_vectors, torch.from_numpy(w_a), rng


def kernel_argmax(a_idx, w_a, hidden):
    """k* of every (pair, channel) as the kernel takes it: the first argmax
    of the emulated projections, and the float64 argmax where the best two
    lie within the band (off the diagonal: a caller passes off-diagonal
    pairs, or equal bases there make any k right). Also returns the
    emulated and float64 projections."""
    pairs = a_idx.shape[0]
    bases = sinusoidal_embedding(a_idx, hidden)  # (pairs, A, C) float32
    emulated = torch.stack([projection_3xtf32(bases[:, k], w_a)
                            for k in range(a_idx.shape[1])], dim=1)
    exact = port_gse._exact_bases(a_idx, hidden) @ w_a.double()  # (pairs, A, C)
    top = emulated.topk(2, dim=1).values
    wabs = w_a.abs().sum(dim=0)
    tie = (top[:, 0] - top[:, 1]) <= BAND * wabs
    first = torch.where(tie, exact.argmax(dim=1), emulated.argmax(dim=1))
    assert first.shape == (pairs, hidden)
    return first, emulated, exact, tie


def test_projections_stand_within_half_the_tie_band():
    projections_within_half_the_band(256)


def test_projections_stand_within_half_the_tie_band_at_the_widest_width():
    projections_within_half_the_band(512)


def projections_within_half_the_band(hidden):
    points, ref_vectors, w_a, _ = make_case(0, 24, hidden)
    _, a_idx = port_gse._pair_indices(points, ref_vectors, SIGMA_D, SIGMA_A)
    off = ~torch.eye(24, dtype=torch.bool)
    a_idx = a_idx[off]  # 552 off-diagonal pairs, (pairs, A)
    first, emulated, exact, tie = kernel_argmax(a_idx, w_a, hidden)
    wabs = w_a.abs().sum(dim=0).double()
    err = ((emulated.double() - exact).abs() / wabs).max().item()
    assert err <= 2.0**-19, f"3xTF32 projection error {err / 2**-19:.3f} of half the band"
    bases = sinusoidal_embedding(a_idx, hidden)
    single = torch.stack([projection_3xtf32(bases[:, k], w_a, terms=1) for k in range(3)], dim=1)
    assert ((single.double() - exact).abs() / wabs).max().item() > 2.0**-19
    # outside the band the emulated first argmax is the float64 one
    assert torch.equal(first[~tie], exact.argmax(dim=1)[~tie])
    assert torch.equal(first, exact.argmax(dim=1))
    assert tie.float().mean().item() < 1e-2


def slices_of(n, hidden):
    """The pair slices of ``gse_bwd_slices`` (csrc/gse_bwd.cu) over the
    route's blocks a slice (c-blocks times row chunks)."""
    route = port_gse.gse_route(hidden, ANGLE_K).backward
    blocks = route.channel_blocks * route.chunks
    return max(1, min(-(-SMS // blocks), -(-n * n // TILE)))


def emulated_bwd(points, ref_vectors, w_a, de, n_valid):
    """dW_d, db, dW_a in the kernel's order: the valid pairs row-major in the
    wrapper's slices, each slice in 16-pair tiles, each tile's products a
    fresh tile per 8 pairs; slices added in order."""
    n, hidden = points.shape[0], w_a.shape[0]
    d_idx, a_idx = port_gse._pair_indices(points, ref_vectors, SIGMA_D, SIGMA_A)
    rows = torch.arange(n_valid)
    d_idx = d_idx[:n_valid, :n_valid].reshape(-1)
    a_idx = a_idx[:n_valid, :n_valid].reshape(-1, a_idx.shape[-1])
    first, _, _, _ = kernel_argmax(a_idx, w_a, hidden)
    diagonal = (rows[:, None] == rows[None, :]).reshape(-1)
    first[diagonal] = 0  # equal bases: the kernel's first k
    de = de[:n_valid, :n_valid].reshape(-1, hidden)
    b_d = sinusoidal_embedding(d_idx, hidden)
    b_a = sinusoidal_embedding(a_idx, hidden)  # (pairs, A, C)
    total, slices = n_valid * n_valid, slices_of(n, hidden)
    dw_d, dw_a, db = (torch.zeros(hidden, hidden), torch.zeros(hidden, hidden),
                      torch.zeros(hidden))
    for s in range(slices):
        begin, end = total * s // slices, total * (s + 1) // slices
        acc_d, acc_a = torch.zeros(hidden, hidden), torch.zeros(hidden, hidden)
        slot_db = torch.zeros(TILE, hidden)
        for q0 in range(begin, end, TILE):
            q = torch.arange(q0, min(q0 + TILE, end))
            tile_de = torch.zeros(TILE, hidden)
            tile_de[:len(q)] = de[q]
            slot_db = slot_db + tile_de
            tile_d = torch.zeros(TILE, hidden)
            tile_d[:len(q)] = b_d[q]
            acc_d = acc_d + projection_3xtf32(tile_d.T.contiguous(), tile_de)
            for k in range(a_idx.shape[1]):
                tile_a = torch.zeros(TILE, hidden)
                tile_a[:len(q)] = b_a[q, k]
                masked = torch.zeros(TILE, hidden)
                masked[:len(q)] = torch.where(first[q] == k, de[q], 0.0)
                acc_a = acc_a + projection_3xtf32(tile_a.T.contiguous(), masked)
        slice_db = torch.zeros(hidden)
        for p in range(TILE):
            slice_db = slice_db + slot_db[p]
        dw_d, dw_a, db = dw_d + acc_d, dw_a + acc_a, db + slice_db
    return dw_d, db, dw_a, db


@pytest.mark.parametrize("hidden, n, n_valid", [(64, 30, 30), (64, 37, 23), (32, 20, 1)])
def test_weight_gradients_in_the_kernels_order(hidden, n, n_valid):
    points, ref_vectors, w_a, rng = make_case(1, n, hidden, n_valid)
    de = torch.from_numpy(rng.normal(size=(n, n, hidden)).astype(np.float32))
    de[n_valid:] = 0.0
    de[:, n_valid:] = 0.0
    nv = torch.tensor(n_valid, dtype=torch.int32)
    got = emulated_bwd(points, ref_vectors, w_a, de, n_valid)
    want = gse_full_bwd_plain(points, ref_vectors, w_a, SIGMA_D, SIGMA_A, de, nv)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(w.abs().max()) + 1e-7)
    jax_want = jax_gse_full_bwd(jnp.asarray(points.numpy()), jnp.asarray(ref_vectors.numpy()),
                                jnp.asarray(w_a.numpy()), hidden, SIGMA_D, SIGMA_A,
                                jnp.asarray(de.numpy()), interpret=True, n_valid=n_valid)
    for g, w in zip(got, jax_want):
        w = np.asarray(w)
        rel = np.abs(g.numpy() - w) / (np.abs(w).max() + 1e-8)
        assert (rel > 5e-2).mean() <= 0.005, f"max rel {rel.max():.3f}"
