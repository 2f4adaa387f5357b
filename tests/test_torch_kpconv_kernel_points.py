"""The KPConv rows 1 (``kpconv_fused``), 5 (``kpconv_split_fused``) and 6
(``kpconv_bwd_fused``) at kernel-point counts past 16, on the CPU (the CUDA
kernels walk K > 16 in chunks of 16 kernel points and rows wider than 256
channel groups in passes: tests/test_torch_cuda.py, chip_smoke.py phase 15).

  * The port's plain versions against the JAX Pallas kernels in interpret
    mode at K = 20 and 32, the JAX kernels' MXU operands at f32
    (``MXU_DTYPE``): the forward and the split forward at rtol 1e-4 and
    1e-5 x the largest output, the counts and pooled maxima exactly; the
    backward over a whole and a split inverse table at rtol 1e-3 and 1e-4 x
    the largest gradient (the JAX kernel's expanded |s - q - kp|^2 against
    the port's direct distance), as tests/test_torch_kpconv_bwd.py holds
    them at K = 15.
  * ``edge_route``: every K from 1 to 64 and C from 1 to 2,100 is covered
    by its kernel-point chunks and channel passes within a block of 256
    threads; the shipped shapes keep one chunk and one pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels import kpconv as jk

from geotransformer_tpu_torch.kernels.kpconv import (
    edge_route,
    kpconv_bwd_fused,
    kpconv_fused,
    kpconv_split_fused,
)
from geotransformer_tpu_torch.preprocess import pyramid as port_pyramid

SIGMA = 0.12
POOL_COLS = 12


@pytest.fixture()
def f32_mxu(monkeypatch):
    monkeypatch.setattr(jk, "MXU_DTYPE", jnp.float32)


def t(x):
    return torch.from_numpy(np.asarray(x))


def make_case(k, seed=0, n=200, m=150, h=16, c_in=12, c_out=24, c_pool=8):
    rng = np.random.default_rng(seed + k)
    s_points = rng.uniform(0, 0.6, (n, 3)).astype(np.float32)
    q_points = rng.uniform(0, 0.6, (m, 3)).astype(np.float32)
    d = np.linalg.norm(q_points[:, None] - s_points[None], axis=-1)
    nbrs = np.argsort(d, axis=1)[:, :h].astype(np.int32)
    nbrs[rng.uniform(size=(m, h)) < 0.25] = n
    nbrs[:, POOL_COLS:] = n  # past the pool's columns: sentinels only (the pool contract)
    return dict(
        n=n, m=m, s_points=s_points, q_points=q_points, nbrs=nbrs,
        s_feats=rng.normal(size=(n, c_in)).astype(np.float32),
        pool_feats=rng.integers(-2, 3, size=(n, c_pool)).astype(np.float32),  # tied maxima
        kp=((rng.uniform(size=(k, 3)) - 0.5) * 0.2).astype(np.float32),
        w=(rng.normal(size=(k, c_in, c_out)) * 0.2).astype(np.float32),
        bias=rng.normal(size=c_out).astype(np.float32),
        dout=rng.normal(size=(m, c_out)).astype(np.float32),
        dpool=rng.normal(size=(m, c_pool)).astype(np.float32))


def close(got, want, rtol, scale):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("k", [20, 32])
def test_forward_matches_jax(f32_mxu, k):
    c = make_case(k)
    got = kpconv_fused(*(t(c[x]) for x in ("s_feats", "q_points", "s_points", "nbrs", "kp", "w")),
                       SIGMA, t(c["bias"]), pool_feats=t(c["pool_feats"]), pool_cols=POOL_COLS,
                       residuals=True)
    want = jk.kpconv_fused(
        *(jnp.asarray(c[x]) for x in ("s_feats", "q_points", "s_points", "nbrs", "kp", "w")),
        SIGMA, bias=jnp.asarray(c["bias"]), tile_m=64, interpret=True,
        pool_feats=jnp.asarray(c["pool_feats"]), pool_cols=POOL_COLS, return_count=True)
    close(got[0].numpy(), want[0], 1e-4, 1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # pooled
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # count


@pytest.mark.parametrize("k", [20, 32])
def test_split_forward_matches_jax(f32_mxu, k):
    c = make_case(k, seed=1)
    table, n, h1 = c["nbrs"], c["n"], 8
    m2_cap = int((table[:, h1:] < n).any(1).sum()) + 8
    tail, tail_q, rank = port_pyramid.build_split_tables(table, n, h1, m2_cap)
    head = np.ascontiguousarray(table[:, :h1])
    args = [c["s_feats"], c["q_points"], c["s_points"], head, tail, tail_q, rank, c["kp"], c["w"]]
    got = kpconv_split_fused(*map(t, args), SIGMA, t(c["bias"]), pool_feats=t(c["pool_feats"]),
                             pool_cols=POOL_COLS, residuals=True)
    want = jk.kpconv_split_fused(*map(jnp.asarray, args), SIGMA, bias=jnp.asarray(c["bias"]),
                                 pool_feats=jnp.asarray(c["pool_feats"]), pool_cols=POOL_COLS,
                                 interpret=True)
    close(got[0].numpy(), want[0], 1e-4, 1e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # pooled
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[-1]))  # count


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("k", [20, 32])
def test_backward_matches_jax(f32_mxu, k, split):
    c = make_case(k, seed=2)
    n, m = c["n"], c["m"]
    out, pooled, count, ties = kpconv_fused(
        *(t(c[x]) for x in ("s_feats", "q_points", "s_points", "nbrs", "kp", "w")), SIGMA,
        pool_feats=t(c["pool_feats"]), pool_cols=POOL_COLS, residuals=True)
    gdiv = (t(c["dout"]) / count[:, None]).numpy()
    dpt = (t(c["dpool"]) / ties).numpy()
    inv = port_pyramid.build_inverse_table(c["nbrs"], n, 40)
    if split:
        h1 = 8
        tail, tail_s, rank = port_pyramid.build_split_tables(
            inv, m, h1, int((inv[:, h1:] < m).any(1).sum()) + 8)
        inv = (np.ascontiguousarray(inv[:, :h1]), tail, tail_s, rank)
    args = [c["s_feats"], c["s_points"], c["q_points"], gdiv]
    rest = [c["kp"], c["w"]]
    pool = [c["pool_feats"], pooled.numpy(), dpt]
    got = kpconv_bwd_fused(*map(t, args), tuple(map(t, inv)) if split else t(inv),
                           *map(t, rest), SIGMA, *map(t, pool))
    want = jk.kpconv_bwd_fused(*map(jnp.asarray, args),
                               tuple(map(jnp.asarray, inv)) if split else jnp.asarray(inv),
                               *map(jnp.asarray, rest), SIGMA, tile_n=64, interpret=True,
                               **dict(zip(("pool_feats", "pooled", "dpool_over_ties"),
                                          map(jnp.asarray, pool))))
    assert len(got) == len(want) == 3
    assert got[1].shape == (k,) + c["w"].shape[1:]
    for g, w in zip(got, want):
        close(g.numpy(), w, 1e-3, 1e-4)


@pytest.mark.parametrize("k", [1, 15, 16, 17, 20, 32, 33, 64])
def test_edge_route_covers_every_width(k):
    for c in range(1, 2101):
        r = edge_route(k, c)
        groups = c // r.vector
        assert r.vector == (4 if c % 4 == 0 else 1) and groups * r.vector == c
        assert r.kernel_point_chunks * 16 >= k > (r.kernel_point_chunks - 1) * 16
        assert r.threads_per_row == min(groups, 256)
        assert r.channel_passes * r.threads_per_row >= groups
        assert (r.channel_passes - 1) * r.threads_per_row < groups
        assert 1 <= r.rows_per_block <= 64
        assert r.rows_per_block * r.threads_per_row <= 256


def test_edge_route_keeps_the_shipped_shapes():
    """Every conv of the shipped configurations (K = 15, C from 1 to 1,024)
    keeps one chunk of kernel points and one pass over its channels."""
    for c in (1, 64, 128, 256, 512, 1024):
        r = edge_route(15, c)
        assert (r.kernel_point_chunks, r.channel_passes) == (1, 1)
    assert edge_route(15, 1028).channel_passes == 2
    with pytest.raises(ValueError):
        edge_route(0, 64)
