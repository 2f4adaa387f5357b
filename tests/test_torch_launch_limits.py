"""The launcher limits the port's CUDA kernels no longer share with the JAX
package: each wrapper's route as a plain function, and the plain versions
against the JAX kernels (or the JAX XLA search) at shapes past the former
limits, on the CPU.

Each route picks the instance the shipped configurations ran where its
staged layout fits a block's 232,448 bytes of shared memory on an H100, and
a general route past it whose layout fits too:
  * ``stream_route`` and ``union_route`` (rows 2 and 7): the staged ring or
    union and W, else nothing staged but t1 and the divisors;
  * ``pool_route`` (the pool phase of rows 1, 5 and 6): all pooled columns
    at once, else chunks of 8192 / rows-a-block of them;
  * ``overlap_route`` (row 11): the ref patch and a patch a warp staged,
    else both read in place;
  * ``attention_route``'s ``q_tile`` (row 13's wide kernel): the 16 query
    rows staged, else read in place;
  * ``search_route`` (the device pyramid's search): whole key lists, else
    1,024-key chunks merged into a running K best;
  * ``gse_route`` at A >= 255 (row 8): the general instance, k* 16-bit;
  * ``pair_scores_route`` past 65,535 rows (row 12): the scalar kernel, in
    launches of 65,535 rows (the grid's y dimension; row 13 likewise takes
    its heads 65,535 a launch).

The plain versions (which the card's kernels are held to) against the JAX
package on numpy inputs from a seed, each at the smallest shape that
crosses its former limit's formula (the stated shapes of the card runs take
minutes in Pallas interpret mode):
  * the stream input conv at H = 360 columns (K D = 960) and at K D = 61,440
    (K 15, D 4,096), against the Pallas stream kernel at its f32 MXU point:
    rtol 1e-4 and 1e-5 x max|ref|, as tests/test_torch_limits.py;
  * the union input conv at a 14,336-row union capacity and at K D = 61,440,
    against the Pallas union kernel, the same tolerance;
  * the fused max-pool over 1,024 columns at C = 4 against the JAX XLA
    ``maxpool``: equal (the max is exact);
  * ``patch_overlaps`` at K = 1,664 points against the Pallas kernel in
    interpret mode, on grid points whose distances are exact: equal;
  * ``fused_masked_attention`` at dh = 3,104 and at H = 65,540 heads against
    the JAX f32 XLA reference: 1e-5 x max|ref|; ``rpe_pair_scores`` at
    N = 65,540 rows against the Pallas kernel in interpret mode, the same;
  * ``gse_full_bwd`` at A = 255 and 300, C = 8 against ``jax.vjp`` of the
    JAX XLA embedding (the Pallas backward in interpret mode takes minutes
    there): rtol 1e-4, atol 1e-5 x the largest gradient, as
    tests/test_torch_gse_bwd.py holds the XLA vjp;
  * ``grid_radius_search`` at cand_cap 29,100 against the JAX XLA grid
    search bit for bit, and its brute mode over 29,184 support rows against
    the JAX brute search, equal but for distance ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels import attention as jax_attention
from geotransformer_tpu.kernels import kpconv as jax_kpconv_kernels
from geotransformer_tpu.kernels.overlap import patch_overlaps as jax_patch_overlaps
from geotransformer_tpu.models.kpconv import maxpool as jax_maxpool
from geotransformer_tpu.ops.embedding import sinusoidal_embedding as jax_sinusoidal_embedding
from geotransformer_tpu.ops.pairwise_distance import pairwise_distance as jax_pairwise_distance
from geotransformer_tpu.preprocess import device as jax_device
from geotransformer_tpu.preprocess.pyramid import build_input_stream, build_union_tables

from geotransformer_tpu_torch.kernels.attention import (
    attention_route,
    fused_masked_attention,
    pair_scores_route,
    rpe_pair_scores,
)
from geotransformer_tpu_torch.kernels.gse import gse_full_bwd, gse_route
from geotransformer_tpu_torch.kernels.kpconv import (
    edge_route,
    kpconv_fused,
    kpconv_stream_fused,
    kpconv_union_input_fused,
    pool_route,
    stream_route,
    union_route,
)
from geotransformer_tpu_torch.kernels.overlap import overlap_route, patch_overlaps_plain
from geotransformer_tpu_torch.kernels.pyramid import search_route
from geotransformer_tpu_torch.preprocess import device as port_device

H100_BLOCK_BYTES = 232448  # a block's opt-in shared memory on an H100
I32 = torch.int32


def t1_stride(k):
    return 16 if k <= 16 else -(-k // 16) * 16


def within(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.isfinite(got))
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), f"max |diff| {np.abs(got - want).max()}"


# ---- the routes ------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 15, 16, 20, 32])
def test_stream_route_fits_a_block(k):
    """The staged route exactly where a 16-query block's ring of (5, 16, H)
    planes, W, t1 and the divisors fit; the general route's t1 and divisors
    always do."""
    for h in (1, 16, 38, 65, 128, 200, 349, 350, 351, 360, 512, 4096):
        for d in (1, 64, 256, 1024, 3700, 4096):
            staged = 4 * (2 * 5 * 16 * h + -(-k * d // 4) * 4 + 16 * t1_stride(k) + 16 + 4)
            route = stream_route(h, k, d, H100_BLOCK_BYTES)
            assert route == ("shared" if staged <= H100_BLOCK_BYTES else "global"), (h, d)
            assert 4 * (16 * t1_stride(k) + 16) <= H100_BLOCK_BYTES


def test_stream_route_keeps_the_shipped_instances():
    for h in (34, 38, 40, 64, 65, 128):
        assert stream_route(h, 15, 64, H100_BLOCK_BYTES) == "shared"
    # the former refusals: past ~350 columns at K D = 960, K D past ~56,000
    assert stream_route(360, 15, 64, H100_BLOCK_BYTES) == "global"
    assert stream_route(512, 15, 64, H100_BLOCK_BYTES) == "global"
    assert stream_route(65, 15, 4096, H100_BLOCK_BYTES) == "global"


@pytest.mark.parametrize("k", [15, 16, 32])
def test_union_route_fits_a_block(k):
    for u in (1, 512, 2048, 8192, 13000, 13312, 13500, 14336, 40000):
        for h in (4, 38, 64, 850, 900):
            for d in (64, 1024, 4096):
                staged = 4 * (4 * (u + 1) + 64 * (h | 1) + -(-k * d // 4) * 4
                              + 64 * t1_stride(k) + 64)
                route = union_route(u, h, k, d, H100_BLOCK_BYTES)
                assert route == ("shared" if staged <= H100_BLOCK_BYTES else "global")
    assert union_route(3072, 38, 15, 64, H100_BLOCK_BYTES) == "shared"
    assert union_route(14000, 38, 15, 64, H100_BLOCK_BYTES) == "global"
    assert union_route(512, 38, 15, 4096, H100_BLOCK_BYTES) == "global"


def edge_words(rows, width, staged):
    """csrc/kpconv_common.cuh's EdgeSmem words at the launcher's edge chunk."""
    e = max(4, min((8192 // (16 * rows)) & ~3, 64))
    chunk = max(4, min(e, (width + 3) & ~3))
    return rows * max(chunk * 16 + 4, staged) + rows * chunk + 48 + 3 * rows


@pytest.mark.parametrize("c", [1, 3, 4, 16, 64, 256, 1028])
def test_pool_route_fits_a_block(c):
    """All pooled columns where the whole layout fits (every shipped conv),
    else chunks that fit, no wider than the pool."""
    rows = edge_route(15, c).rows_per_block
    for width in (16, 38, 40, 128, 1024, 4000):
        for pool_width in {1, 12, 38, width}:
            chunk = pool_route(15, c, width, pool_width, H100_BLOCK_BYTES)
            if 4 * edge_words(rows, width, pool_width) <= H100_BLOCK_BYTES:
                assert chunk == pool_width
            else:
                assert 4 <= chunk < pool_width and chunk % 4 == 0
                assert 4 * edge_words(rows, width, chunk) <= H100_BLOCK_BYTES
    assert pool_route(15, c, 40, 0, H100_BLOCK_BYTES) == 0


def test_pool_route_keeps_the_shipped_pools():
    for c in (1, 64, 128, 256, 512, 1024):
        for width in (34, 38, 40, 64, 65):
            assert pool_route(15, c, width, width, H100_BLOCK_BYTES) == width
    # the former refusals: ~900 columns at C <= 4 (64 rows a block)
    assert pool_route(15, 4, 1024, 1024, H100_BLOCK_BYTES) == 128
    assert pool_route(15, 64, 4000, 4000, H100_BLOCK_BYTES) == 512


def test_overlap_route_fits_a_block():
    for k in range(1, 4097, 7):
        staged = 16 * 9 * k + 4 * 8 * -(-k // 32)
        assert overlap_route(k, H100_BLOCK_BYTES) == (
            "shared" if staged <= H100_BLOCK_BYTES else "global")
    for k in (64, 128, 256, 1024):  # the patch sizes of every configuration and more
        assert overlap_route(k, H100_BLOCK_BYTES) == "shared"
    assert overlap_route(1664, H100_BLOCK_BYTES) == "global"
    assert overlap_route(2048, H100_BLOCK_BYTES) == "global"


def test_attention_route_stages_the_q_tile_where_it_fits():
    for m in (1, 256, 300, 4096, 100000):
        for dh in range(65, 5001, 13):
            route = attention_route(dh, True, m)
            assert (route.width, route.vec16) == (0, False)
            parts = 4 * 8 * 16 * 66 + 4 * -(-m // 32)
            with_q = parts + 4 * 16 * (-(-dh // 8) * 8 + 4)
            assert route.q_tile == (with_q <= H100_BLOCK_BYTES)
            assert parts <= H100_BLOCK_BYTES
        for dh in (8, 16, 24, 32, 48, 64):
            assert attention_route(dh, True, m).q_tile
    assert attention_route(3100, True, 256).q_tile is False
    assert attention_route(4096, True, 256).q_tile is False
    assert attention_route(128, True, 256).q_tile is True


def test_search_route_fits_a_block():
    for cap in (32, 64, 640, 7264, 7265, 9000, 14528, 14529, 29056, 29057, 32768, 100000):
        for brute in (False, True):
            warps, chunk = search_route(0 if brute else cap, cap, brute, H100_BLOCK_BYTES)
            if 8 * cap <= H100_BLOCK_BYTES:
                assert chunk == 0 and 8 * cap * warps <= H100_BLOCK_BYTES
                assert warps == 4 or 8 * cap * (warps + 1) > H100_BLOCK_BYTES
            else:
                assert (warps, chunk) == (4, 1024)
                assert 8 * 1024 * 4 <= H100_BLOCK_BYTES
    # the device pyramid's buckets and brute searches keep their instance
    assert search_route(640, 0, False, H100_BLOCK_BYTES) == (4, 0)
    assert search_route(0, 2048, True, H100_BLOCK_BYTES) == (4, 0)
    assert search_route(32768, 0, False, H100_BLOCK_BYTES) == (4, 1024)
    assert search_route(0, 40000, True, H100_BLOCK_BYTES) == (4, 1024)


def test_pair_scores_route_past_the_row_grid():
    """Rows past the grid's 65,535 take the scalar kernel, in launches of
    65,535 rows; every shipped shape keeps the float4 one."""
    assert pair_scores_route(256, 4, True, 768) == "float4"
    assert pair_scores_route(256, 4, True, 65535) == "float4"
    assert pair_scores_route(256, 4, True, 65536) == "scalar"


@pytest.mark.parametrize("a", [254, 255, 256, 300, 1000])
def test_gse_backward_route_takes_any_angle_count(a):
    """The general instance (k* 16-bit) from A = 255 on, in a block."""
    for c in (2, 8, 48, 96, 256, 512):
        bwd = gse_route(c, a).backward
        assert not bwd.resident
        assert bwd.angle_groups == -(-a // 3)
        assert 4 * bwd.words <= H100_BLOCK_BYTES


# ---- the plain versions against the JAX package ------------------------------

@pytest.fixture
def f32_mxu(monkeypatch):
    """The Pallas KPConv kernels at their f32 MXU point (bf16 operands would
    round t1 W by up to 2^-9)."""
    monkeypatch.setattr(jax_kpconv_kernels, "MXU_DTYPE", jnp.float32)


def input_case(seed, m, n, h, k, c_out):
    rng = np.random.default_rng(seed)
    q_points = rng.uniform(0, 0.5, (m, 3)).astype(np.float32)
    s_points = rng.uniform(0, 0.5, (n, 3)).astype(np.float32)
    d = np.linalg.norm(q_points[:, None] - s_points[None], axis=-1)
    nbrs = np.argsort(d, axis=1)[:, :h].astype(np.int32)
    nbrs[rng.uniform(size=(m, h)) < 0.2] = n
    feats = (rng.uniform(size=(n, 1)) > 0.1).astype(np.float32)
    kp = ((rng.uniform(size=(k, 3)) - 0.5) * 0.12).astype(np.float32)
    w = rng.normal(size=(k, 1, c_out)).astype(np.float32)
    bias = rng.normal(size=c_out).astype(np.float32)
    return q_points, s_points, nbrs, feats, kp, w, bias


@pytest.mark.parametrize("m, h, c_out", [(48, 360, 64), (40, 16, 4096)],
                         ids=["H360", "KD61440"])
def test_stream_conv_past_the_staged_ring_matches_jax(f32_mxu, m, h, c_out):
    points, _, nbrs, _, kp, w, bias = input_case(h, m, m, min(h, m), 15, c_out)
    if h > m:  # more columns than points: the rest are sentinels
        nbrs = np.concatenate([nbrs, np.full((m, h - m), m, np.int32)], axis=1)
    nbrs[:, 0] = np.arange(m)
    feats = (np.random.default_rng(1).uniform(size=(m, 1)) > 0.1).astype(np.float32)
    stream = build_input_stream(points, feats, nbrs)
    assert stream_route(h, 15, c_out, H100_BLOCK_BYTES) == "global"
    want = np.asarray(jax_kpconv_kernels.kpconv_stream_fused(
        jnp.asarray(stream), jnp.asarray(kp), jnp.asarray(w), 0.08, bias=jnp.asarray(bias),
        tile_m=16))
    got = kpconv_stream_fused(torch.from_numpy(stream), torch.from_numpy(kp),
                              torch.from_numpy(w), 0.08, torch.from_numpy(bias)).numpy()
    within(got, want, 1e-4, 1e-5 * np.abs(want).max())


@pytest.mark.parametrize("union_cap, c_out", [(14336, 64), (512, 4096)],
                         ids=["U14336", "KD61440"])
def test_union_conv_past_the_staged_union_matches_jax(f32_mxu, union_cap, c_out):
    m, n, h, tile = 16, 60, 6, 8
    q_points, s_points, nbrs, feats, kp, w, bias = input_case(union_cap, m, n, h, 15, c_out)
    rows, sel = build_union_tables(nbrs, n, tile=tile, union_cap=union_cap)
    assert union_route(union_cap, h, 15, c_out, H100_BLOCK_BYTES) == "global"
    args = (feats, q_points, s_points, rows, sel, kp, w)
    want = np.asarray(jax_kpconv_kernels.kpconv_union_input_fused(
        *map(jnp.asarray, args), 0.08, bias=jnp.asarray(bias), tile_m=tile))
    got = kpconv_union_input_fused(*map(torch.from_numpy, args), 0.08, torch.from_numpy(bias),
                                   tile=tile).numpy()
    within(got, want, 1e-4, 1e-5 * np.abs(want).max())


def test_pool_over_1024_columns_matches_jax():
    """The max-pool fused into a conv over a 1,024-column table at C = 4 (its
    pool phase in 128-column chunks on the card): the JAX XLA maxpool."""
    rng = np.random.default_rng(1024)
    m, n, h, c = 24, 1200, 1024, 4
    table = np.stack([rng.permutation(n)[:h] for _ in range(m)]).astype(np.int32)
    table[rng.uniform(size=(m, h)) < 0.3] = n
    table[0] = n  # a row of sentinels: its pool reads the zero shadow row
    s_feats = rng.normal(size=(n, c)).astype(np.float32)
    pool_feats = np.round(rng.normal(size=(n, c)) * 4).astype(np.float32)  # ties
    q_points, s_points = (rng.uniform(0, 1, (k, 3)).astype(np.float32) for k in (m, n))
    kp = ((rng.uniform(size=(15, 3)) - 0.5) * 0.1).astype(np.float32)
    w = rng.normal(size=(15, c, 8)).astype(np.float32)
    assert pool_route(15, c, h, h, H100_BLOCK_BYTES) < h
    _, pooled = kpconv_fused(*map(torch.from_numpy, (s_feats, q_points, s_points, table, kp, w)),
                             0.05, pool_feats=torch.from_numpy(pool_feats))
    want = np.asarray(jax_maxpool(jnp.asarray(pool_feats), jnp.asarray(table)))
    np.testing.assert_array_equal(pooled.numpy(), want)


def test_patch_overlaps_past_the_staged_patches_match_jax():
    """K = 1,664 (past ~1,600) on a 1/16 grid: every distance exact in f32
    under both packages' formulas, so the overlaps are equal."""
    rng = np.random.default_rng(1664)
    m, n, k, s = 3, 4, 1664, 2
    nodes = lambda count: np.round(rng.uniform(0, 0.75, (count, 3)) * 16) / 16  # noqa: E731
    grid = lambda count: rng.integers(-8, 8, size=(count, k, 3)) / 16.0  # noqa: E731
    ref_pts = (nodes(m)[:, None] + grid(m)).astype(np.float32)
    src_pts = (nodes(n)[:, None] + grid(n)).astype(np.float32)
    ref_masks, src_masks = rng.uniform(size=(m, k)) > 0.2, rng.uniform(size=(n, k)) > 0.2
    cand = rng.integers(0, n, size=(m, s)).astype(np.int64)
    cand_masks = np.ones((m, s), bool)
    assert overlap_route(k, H100_BLOCK_BYTES) == "global"
    want = np.asarray(jax_patch_overlaps(
        jnp.asarray(ref_pts), jnp.asarray(ref_masks), jnp.asarray(src_pts[cand]),
        jnp.asarray(src_masks[cand]), 0.1, interpret=True))
    got = patch_overlaps_plain(*map(torch.from_numpy, (ref_pts, ref_masks, src_pts, src_masks,
                                                       cand, cand_masks)), 0.1).numpy()
    assert 0.0 < got.min() and got.max() < 1.0  # partial overlaps only
    np.testing.assert_array_equal(got, want)


def test_attention_past_the_q_tile_matches_jax():
    rng = np.random.default_rng(3104)
    h, n, m, dh, nv_q, nv_k = 1, 20, 24, 3104, 18, 21
    q, k, v = (rng.normal(size=s).astype(np.float32) * 0.1
               for s in ((h, n, dh), (h, m, dh), (h, m, dh)))
    bias = rng.normal(size=(n, h, m)).astype(np.float32)
    assert attention_route(dh, True, m).q_tile is False
    scale = dh ** -0.5
    got = fused_masked_attention(*map(torch.from_numpy, (q, k, v, bias)), nv_q, nv_k,
                                 scale).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_attention._xla_attention_ref(
            *map(jnp.asarray, (q, k, v, bias)), nv_k, scale))
    assert np.abs(got[:nv_q] - want[:nv_q]).max() <= 1e-5 * np.abs(want[:nv_q]).max()
    assert not got[nv_q:].any()


def jax_gse_grads(points, ref_vectors, w_d, w_a, de, sigma_d, sigma_a):
    """dW_d and dW_a of the JAX XLA embedding by ``jax.vjp``: the index math
    of ``GeometricStructureEmbedding.get_embedding_indices`` over the given
    reference vectors, ``ops.embedding.sinusoidal_embedding``, the two
    projections and the max over the angles."""
    c = w_a.shape[0]
    p = jnp.asarray(points)
    d_idx = jnp.sqrt(jax_pairwise_distance(p[None], p[None]))[0] / sigma_d
    anc = (p[None, :, :] - p[:, None, :])[:, :, None, :]  # [i, j] = p_j - p_i
    ref = jnp.asarray(ref_vectors)[:, None, :, :]
    sin = jnp.linalg.norm(jnp.cross(ref, anc), axis=-1)
    a_idx = jnp.arctan2(sin, jnp.sum(ref * anc, axis=-1)) * (180.0 / (sigma_a * np.pi))

    def embed(w_d, w_a):
        e_a = jnp.max(jax_sinusoidal_embedding(a_idx, c) @ w_a, axis=2)
        return jax_sinusoidal_embedding(d_idx, c) @ w_d + e_a

    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(embed, jnp.asarray(w_d), jnp.asarray(w_a))
        return [np.asarray(g) for g in vjp(jnp.asarray(de))]


def test_pair_scores_past_the_row_grid_match_jax():
    """N = 65,540 query rows (the launch grid's y dimension holds 65,535):
    the Pallas kernel in interpret mode on bf16-exact inputs, 1e-5 x
    max|ref| (as tests/test_torch_limits.py), zeros outside the valid
    rectangle."""
    rng = np.random.default_rng(65540)
    n, m, c, h, nv_q = 65540, 3, 8, 2, 65537
    # bf16-exact inputs: the Pallas kernel's bf16 operands are then exact
    embed, qw = (np.array(jnp.asarray(rng.normal(size=s).astype(np.float32)).astype(
        jnp.bfloat16).astype(jnp.float32)) for s in ((n, m, c), (n, h, c)))
    want = np.asarray(jax_attention.rpe_pair_scores(
        jnp.asarray(embed), jnp.asarray(qw), jnp.int32(nv_q), jnp.int32(m), tile_i=1024,
        interpret=True))
    got = rpe_pair_scores(torch.from_numpy(embed), torch.from_numpy(qw), nv_q, m).numpy()
    assert np.abs(got[:nv_q] - want[:nv_q]).max() <= 1e-5 * np.abs(want[:nv_q]).max()
    assert not got[nv_q:].any()


def test_attention_past_the_head_grid_matches_jax():
    """H = 65,540 heads (the launch grid's y dimension holds 65,535): the
    JAX f32 XLA reference, 1e-5 x max|ref|."""
    rng = np.random.default_rng(65541)
    h, n, m, dh, nv_k = 65540, 2, 3, 8, 3
    q, k, v = (rng.normal(size=s).astype(np.float32) for s in ((h, n, dh), (h, m, dh),
                                                                (h, m, dh)))
    got = fused_masked_attention(*map(torch.from_numpy, (q, k, v)), n_valid_k=nv_k,
                                 scale=0.3).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_attention._xla_attention_ref(*map(jnp.asarray, (q, k, v)), None,
                                                           nv_k, 0.3))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("a", [255, 300])
def test_gse_backward_from_255_angles_matches_jax(a):
    """A = 255 and 300 (k* past a byte) at C = 8, against the JAX XLA
    embedding's vjp (the Pallas backward in interpret mode unrolls its angle
    loop: minutes at A = 255). The cotangent is zero outside the valid
    rectangle and on the diagonal (where every angle ties and the max's
    gradient is split, not given to the first)."""
    rng = np.random.default_rng(a)
    n, n_valid, c, sigma_d, sigma_a = 10, 9, 8, 0.2, 15.0
    points = (np.round(rng.uniform(0, 1, (n, 3)) * 256) / 256).astype(np.float32)
    ref_vectors = (rng.normal(size=(n, a, 3)) * 0.2).astype(np.float32)
    w_d, w_a = (rng.uniform(-c ** -0.5, c ** -0.5, (c, c)).astype(np.float32) for _ in range(2))
    de = rng.normal(size=(n, n, c)).astype(np.float32)
    de[n_valid:] = 0.0
    de[:, n_valid:] = 0.0
    de[np.arange(n), np.arange(n)] = 0.0
    assert not gse_route(c, a).backward.resident
    want_d, want_a = jax_gse_grads(points, ref_vectors, w_d, w_a, de, sigma_d, sigma_a)
    dw_d, db, dw_a, _ = gse_full_bwd(*map(torch.from_numpy, (points, ref_vectors, w_a)), sigma_d,
                                     sigma_a, torch.from_numpy(de),
                                     torch.tensor(n_valid, dtype=I32))
    for got, want in ((dw_d, want_d), (dw_a, want_a)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(db.numpy(), de.sum(axis=(0, 1)), rtol=1e-5, atol=1e-5)


def test_grid_search_past_the_key_lists_matches_jax():
    """cand_cap 29,100 (past the 29,056 keys a block holds) on 16 queries
    of a dense 2,000-point cloud: the JAX XLA grid search, bit for bit."""
    rng = np.random.default_rng(29100)
    q = rng.uniform(0, 0.4, (16, 3)).astype(np.float32)
    s = np.full((2048, 3), 1e6, np.float32)
    s[:2000] = rng.uniform(0, 0.4, (2000, 3))
    assert search_route(29100, 0, False, H100_BLOCK_BYTES).chunk
    got, ovf = port_device._radius_search_cloud_grid(
        torch.from_numpy(q)[None], torch.tensor([16], dtype=I32), torch.from_numpy(s)[None],
        torch.tensor([2000], dtype=I32), 0.15, 40, cand_cap=29100)
    want, ovf_j = jax_device._radius_search_cloud_grid(
        jnp.asarray(q), jnp.int32(16), jnp.asarray(s), jnp.int32(2000), 0.15, 40,
        cand_cap=29100, block=16)
    assert not bool(ovf[0]) and not bool(ovf_j)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    assert (got[0].numpy() < 2048).sum(axis=1).min() == 40  # full rows: the K best chosen


def test_brute_search_past_the_key_lists_matches_jax():
    """Brute over 29,184 support rows (past 29,056): the JAX brute search,
    rows differing only on distance ties."""
    rng = np.random.default_rng(29184)
    cs, n_s = 29184, 29000
    q = rng.uniform(0, 1, (32, 3)).astype(np.float32)
    s = np.full((cs, 3), 1e6, np.float32)
    s[:n_s] = rng.uniform(0, 1, (n_s, 3))
    assert search_route(0, cs, True, H100_BLOCK_BYTES).chunk
    got = port_device._radius_search_cloud(
        torch.from_numpy(q)[None], torch.tensor([32], dtype=I32), torch.from_numpy(s)[None],
        torch.tensor([n_s], dtype=I32), 0.1, 24)[0].numpy()
    want = np.asarray(jax_device._radius_search_cloud(
        jnp.asarray(q), jnp.int32(32), jnp.asarray(s), jnp.int32(n_s), 0.1, 24, block=32))
    differ = np.nonzero(~np.all(got == want, axis=1))[0]
    for i in differ:  # the same distances within float32 rounding: ties
        d = [np.sort(np.sum((s[row[row < cs]].astype(np.float64) - q[i]) ** 2, axis=1))
             for row in (got[i], want[i])]
        np.testing.assert_allclose(d[0], d[1], rtol=1e-5, atol=1e-9)
    assert len(differ) <= 2
    assert (got < cs).sum(axis=1).min() > 0
