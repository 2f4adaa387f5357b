"""The GSE rows (row 3 ``gse_embedding_full``, row 8 ``gse_full_bwd``) at
every shape the JAX kernels take: any even width C and any number of angles
A, on the CPU (the CUDA kernels run on the card: tests/test_torch_cuda.py,
chip_smoke.py phase 15).

  * The port's plain versions against the JAX Pallas kernels in interpret
    mode at C = 6, 48, 160 and 512 and A = 1, 4 and 5 (N = 36, 31 valid),
    the JAX kernels at their f32 point (``BASIS_DTYPE`` and ``EMBED_DTYPE``
    float32). What still differs is the JAX kernels' polynomial sin, cos and
    atan2 against the port's library ones: the embedding within 5e-3 (of
    values up to ~6); dW_d within 5e-3 and db within 1e-5 of the largest
    gradient; dW_a at the JAX tests' bar (at most 0.5 % of the entries off
    by more than 5 % of the largest), since an angle projection within the
    polynomials' error of another routes its gradient to the other k.
  * The padding the kernels apply as they stage their operands, emulated in
    float64: the bases over the route's basis rows with C's own frequencies
    (zeros past C / 2), W_d and W_a with zero rows and zero columns up to
    the route's channel blocks, de with zero channels; sliced to C, the
    embedding and the three gradients equal the unpadded plain versions
    within 1e-12, at widths that pad (C = 6, 48, 100, 288) and one that
    does not (C = 512).
  * ``gse_route`` for every even C from 2 to 1,024 and A from 1 to 8: the
    instances cover the shape, each block's shared memory stays within an
    H100 block's 227 KB, and an odd width raises ``ValueError``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels import gse as jax_gse

from geotransformer_tpu_torch.kernels import gse as port_gse
from geotransformer_tpu_torch.kernels.gse import (
    gse_embedding_full,
    gse_embedding_full_plain,
    gse_full_bwd,
    gse_full_bwd_plain,
    gse_route,
)
from geotransformer_tpu_torch.ops.embedding import div_term

SIGMA_D, SIGMA_A = 0.2, 15.0
N, N_VALID = 36, 31
H100_BLOCK_BYTES = 232448  # a block's opt-in shared memory on an H100 (227 KB)
WIDTHS = (32, 64, 96, 128, 160, 192, 224, 256)  # the kernels' instances


def make_case(c, a, seed=0, dtype=np.float32):
    """Points on a 1/256 grid (the JAX kernel's |x|^2 - 2 x.y + |y|^2
    distance is then exact, like the port's direct one), reference vectors,
    weights at the model's init scale and a cotangent zero outside the valid
    rectangle."""
    rng = np.random.default_rng(seed + c + 1000 * a)
    points = (np.round(rng.uniform(0, 1, (N, 3)) * 256) / 256).astype(dtype)
    ref_vectors = (rng.normal(size=(N, a, 3)) * 0.2).astype(dtype)
    bound = 1.0 / np.sqrt(c)
    w_d, w_a = (rng.uniform(-bound, bound, (c, c)).astype(dtype) for _ in range(2))
    b_d, b_a = (rng.normal(size=c).astype(dtype) for _ in range(2))
    de = rng.normal(size=(N, N, c)).astype(dtype)
    de[N_VALID:] = 0.0
    de[:, N_VALID:] = 0.0
    return points, ref_vectors, w_d, b_d, w_a, b_a, de


@pytest.fixture
def f32_bases(monkeypatch):
    monkeypatch.setattr(jax_gse, "BASIS_DTYPE", jnp.float32)
    monkeypatch.setattr(jax_gse, "EMBED_DTYPE", jnp.float32)


SHAPES = [(c, a) for c in (6, 48, 160, 512) for a in (1, 4, 5)]


@pytest.mark.parametrize("c, a", SHAPES)
def test_forward_matches_jax_at_any_width_and_angles(f32_bases, c, a):
    points, ref_vectors, w_d, b_d, w_a, b_a, _ = make_case(c, a)
    want = np.asarray(jax_gse.gse_embedding_full(
        *map(jnp.asarray, (points, ref_vectors, w_d, b_d, w_a, b_a)), c, SIGMA_D, SIGMA_A,
        interpret=True, n_valid=N_VALID))
    got = gse_embedding_full(*map(torch.from_numpy, (points, ref_vectors, w_d, b_d, w_a, b_a)),
                             SIGMA_D, SIGMA_A, torch.tensor(N_VALID, dtype=torch.int32)).numpy()
    assert got.shape == (N, N, c)
    np.testing.assert_allclose(got[:N_VALID, :N_VALID], want[:N_VALID, :N_VALID], rtol=0,
                               atol=5e-3)
    assert not got[N_VALID:].any() and not got[:, N_VALID:].any()


@pytest.mark.parametrize("c, a", SHAPES)
def test_backward_matches_jax_at_any_width_and_angles(f32_bases, c, a):
    points, ref_vectors, _, _, w_a, _, de = make_case(c, a)
    want = jax_gse._gse_full_bwd(*map(jnp.asarray, (points, ref_vectors, w_a)), c, SIGMA_D,
                                 SIGMA_A, jnp.asarray(de), interpret=True, n_valid=N_VALID)
    got = gse_full_bwd(*map(torch.from_numpy, (points, ref_vectors, w_a)), SIGMA_D, SIGMA_A,
                       torch.from_numpy(de), torch.tensor(N_VALID, dtype=torch.int32))
    (dw_d, db, dw_a, _), (want_d, want_b, want_a, _) = got, [np.asarray(w) for w in want]
    assert dw_d.shape == dw_a.shape == (c, c) and db.shape == (c,)
    np.testing.assert_allclose(dw_d.numpy(), want_d, rtol=0, atol=5e-3 * np.abs(want_d).max())
    np.testing.assert_allclose(db.numpy(), want_b, rtol=0, atol=1e-5 * np.abs(want_b).max())
    rel = np.abs(dw_a.numpy() - want_a) / np.abs(want_a).max()
    assert (rel > 5e-2).mean() <= 0.005, f"max rel {rel.max():.3f}"


# ---- the padding, emulated in float64 ---------------------------------------

def padded_bases(idx, freqs):
    """Interleaved [sin, cos] bases of ``idx`` over the given frequencies."""
    omegas = idx[..., None] * freqs
    return torch.stack([torch.sin(omegas), torch.cos(omegas)], dim=-1).reshape(
        idx.shape + (2 * freqs.shape[0],))


def padded_plain(points, ref_vectors, w_d, b_d, w_a, b_a, de, n_valid):
    """The embedding and gradients over the kernels' padded operands: the
    forward's basis rows and channel blocks (the backward's chunks and
    c-blocks cover no fewer of either), sliced back to C."""
    c = w_d.shape[0]
    route = gse_route(c, ref_vectors.shape[1])
    rows = route.forward.basis_rows
    channels = route.forward.width * route.forward.channel_blocks
    assert route.backward.rows * route.backward.chunks >= rows
    assert route.backward.channels * route.backward.channel_blocks >= c
    freqs = torch.zeros(rows // 2, dtype=torch.float64)
    freqs[:c // 2] = div_term(c, "cpu").double()

    def pad(x, shape):
        out = torch.zeros(shape, dtype=torch.float64)
        out[tuple(slice(0, s) for s in x.shape)] = x
        return out

    w_d, w_a = pad(w_d, (rows, channels)), pad(w_a, (rows, channels))
    bias = pad(b_d + b_a, (channels,))
    de = pad(de, de.shape[:2] + (channels,))
    d_idx, a_idx = port_gse._pair_indices(points, ref_vectors, SIGMA_D, SIGMA_A)
    b_dist, b_ang = padded_bases(d_idx, freqs), padded_bases(a_idx, freqs)  # (N, N[, A], rows)
    proj = b_ang @ w_a  # (N, N, A, channels)
    valid = port_gse._valid_pairs(points.shape[0], n_valid, "cpu").double()
    out = (b_dist @ w_d + proj.amax(dim=2) + bias) * valid
    de = de * valid
    first = proj.argmax(dim=2)  # (N, N, channels): the first maximal k
    dw_d = torch.einsum("ijf,ijc->fc", b_dist, de)
    dw_a = sum(torch.einsum("ijf,ijc->fc", b_ang[:, :, k], (first == k).double() * de)
               for k in range(a_idx.shape[2]))
    db = de.sum(dim=(0, 1))
    return out[..., :c], dw_d[:c, :c], db[:c], dw_a[:c, :c]


@pytest.mark.parametrize("c, a", [(6, 1), (48, 4), (100, 3), (288, 5), (512, 2)])
def test_padding_leaves_the_result_unchanged(c, a):
    points, ref_vectors, w_d, b_d, w_a, b_a, de = (
        torch.from_numpy(x).double() for x in make_case(c, a, seed=7))
    n_valid = torch.tensor(N_VALID, dtype=torch.int32)
    out, dw_d, db, dw_a = padded_plain(points, ref_vectors, w_d, b_d, w_a, b_a, de, n_valid)
    want_out = gse_embedding_full_plain(points, ref_vectors, w_d, b_d, w_a, b_a, SIGMA_D,
                                        SIGMA_A, n_valid)
    want_d, want_b, want_a, _ = gse_full_bwd_plain(points, ref_vectors, w_a, SIGMA_D, SIGMA_A,
                                                   de, n_valid)
    for got, want in ((out, want_out), (dw_d, want_d), (db, want_b), (dw_a, want_a)):
        assert got.shape == want.shape
        assert (got - want).abs().max().item() <= 1e-12 * max(want.abs().max().item(), 1.0)


# ---- the route ---------------------------------------------------------------

@pytest.mark.parametrize("a", range(1, 9))
def test_route_covers_every_even_width(a):
    for c in range(2, 1025, 2):
        fwd, bwd = gse_route(c, a)
        rows = -(-c // 32) * 32
        # the forward: C's basis rows in 32-row chunks, channel blocks of an
        # instance covering C with none empty, the angles in groups of 4
        assert fwd.width in WIDTHS and fwd.basis_rows == rows and fwd.chunks * 32 == rows
        assert (fwd.channel_blocks - 1) * fwd.width < c <= fwd.channel_blocks * fwd.width
        assert fwd.angle_groups == -(-a // 4)
        assert (c <= 256) == (fwd.channel_blocks == 1)
        assert fwd.exact == (c in (32, 64, 96, 128, 256) and a <= 4)
        # the backward: chunks of an instance's rows covering C, groups of 3
        # angles (resident: C one chunk's width, A = 3), c-blocks of 64 (32
        # where the chunk is no multiple of 64) covering C
        assert bwd.rows in WIDTHS and (bwd.chunks - 1) * bwd.rows < rows <= bwd.chunks * bwd.rows
        assert bwd.resident == (bwd.chunks == 1 and a == 3 and c == bwd.rows)
        assert bwd.angle_groups == -(-a // 3)
        assert bwd.channels == (64 if bwd.rows % 64 == 0 else 32)
        assert (bwd.channel_blocks - 1) * bwd.channels < c <= bwd.channel_blocks * bwd.channels
        for words in (fwd.words, bwd.words):
            assert 4 * words <= H100_BLOCK_BYTES, (c, a, words)


def test_route_keeps_the_shipped_instances():
    """C = 96, 128 and 256 with A = 3 run the instances they ran before:
    the forward's exact kernel and the backward's resident chunk, in the
    same shared memory."""
    for c, words_fwd, words_bwd in ((96, 41904, 18465), (128, 50112, 29393),
                                    (256, 57920, 55057)):
        fwd, bwd = gse_route(c, 3)
        assert (fwd.exact, fwd.width, fwd.channel_blocks, fwd.angle_groups) == (True, c, 1, 1)
        assert (bwd.rows, bwd.chunks, bwd.angle_groups, bwd.resident) == (c, 1, 1, True)
        assert (fwd.words, bwd.words) == (words_fwd, words_bwd)


@pytest.mark.parametrize("c", [1, 3, 47, 161, 0, -2])
def test_odd_width_raises(c):
    with pytest.raises(ValueError, match=f"C = {c}"):
        gse_route(c, 3)
