"""The port's split tables, union tables and calibration vs the JAX package,
and its split-table and union-gather convolutions (plain versions) vs the
JAX kernels in interpret mode, on the CPU.

  * byte-identical with the JAX numpy path: ``build_split_tables``,
    ``fit_split_for_table``, ``build_union_tables``, every ``calibrate_*``,
    and ``pad_registration_batch`` with every optional table (split
    neighbor and subsampling tables, split inverse 4-tuples, union tables);
  * ``kpconv_split_fused`` (out, pooled, count) vs JAX ``kpconv_split_fused``
    in interpret mode with its MXU operands at f32 (rtol 1e-4, atol 1e-5 x
    max: the JAX kernel's expanded |off - kp|^2 against the port's direct
    distance) and vs the unsplit conv, with skewed, all-deep and
    all-shallow tables; pooled values and counts exactly;
  * the split backward over an inverse 4-tuple vs JAX ``kpconv_bwd_fused``
    with a tuple (rtol 1e-3, atol 1e-4 x max, as the unsplit backward's
    test), and whole split-conv gradients (the pool's tie counts against the
    combined max) vs ``jax.grad`` of ``kpconv_split_pool_diff``;
  * the union conv (out, count, t1) vs JAX ``kpconv_union_input_fused``
    (interpret) and its weight gradient vs ``jax.grad`` of
    ``kpconv_union_input_fused_diff``; the split and the whole-table input
    convs likewise (``kpconv_split_input_diff``, ``kpconv_input_fused_diff``).
The CUDA kernels are checked on the card (``-m cuda``, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels import kpconv as jk
from geotransformer_tpu.preprocess import calibrate as jax_calibrate
from geotransformer_tpu.preprocess import pyramid as jax_pyramid

from geotransformer_tpu_torch.kernels.kpconv import (
    kpconv_bwd_fused,
    kpconv_fused_plain,
    kpconv_input_diff,
    kpconv_split_fused,
    kpconv_split_input_diff,
    kpconv_split_pool_diff,
    kpconv_union_input_fused,
    kpconv_union_input_fused_diff,
)
from geotransformer_tpu_torch.preprocess import calibrate as port_calibrate
from geotransformer_tpu_torch.preprocess import pyramid as port_pyramid

SIGMA = 0.3
NEIGHBOR_LIMITS = [20, 20, 20, 20]


@pytest.fixture()
def numpy_path(monkeypatch):
    # the JAX package's own numpy fallback, not its native library
    monkeypatch.setenv("GEOTRANSFORMER_TPU_NATIVE", "0")


@pytest.fixture()
def f32_mxu(monkeypatch):
    monkeypatch.setattr(jk, "MXU_DTYPE", jnp.float32)


def assert_same(got, want, name):
    """Equal structure, dtypes, shapes and bytes (None entries included)."""
    if want is None or got is None:
        assert got is None and want is None, name
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{name}[{i}]")
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert g.tobytes() == w.tobytes(), f"{name} differs"


def random_table(rng, m, n, h, skew=True):
    """(m, h) neighbor table, sentinel n, valid entries first, skewed
    valid counts (some rows nearly empty, some full)."""
    table = np.full((m, h), n, np.int32)
    for i in range(m):
        vc = rng.integers(0, h + 1) if skew else h
        table[i, :vc] = rng.choice(n, size=vc, replace=False)
    return table


@pytest.mark.parametrize("h1, m2_cap", [(8, 90), (16, 64)])
def test_split_tables_byte_identical(h1, m2_cap):
    table = random_table(np.random.default_rng(0), 96, 120, 24)
    assert_same(port_pyramid.build_split_tables(table, 120, h1, m2_cap),
                jax_pyramid.build_split_tables(table, 120, h1, m2_cap), "split")
    for build in (port_pyramid.build_split_tables, jax_pyramid.build_split_tables):
        with pytest.raises(ValueError, match="capacity"):
            build(table, 120, 8, 10)
        with pytest.raises(ValueError, match="head width"):
            build(table, 120, 12, 90)


@pytest.mark.parametrize("align, multiple", [(8, 128), (8, 16), (16, 32)])
def test_fit_split_matches_jax(align, multiple):
    rng = np.random.default_rng(1)
    for m, n, h in ((300, 400, 72), (200, 250, 24)):
        table = random_table(rng, m, n, h)
        table[: m // 2, h // 3:] = n  # many shallow rows: a split pays
        got = port_pyramid.fit_split_for_table(table, n, multiple=multiple, align=align)
        assert got == jax_pyramid.fit_split_for_table(table, n, multiple=multiple, align=align)
    assert got is not None


@pytest.mark.parametrize("tile, m", [(32, 96), (32, 100), (64, 100)], ids=["even", "ragged", "wide"])
def test_union_tables_byte_identical(tile, m):
    table = random_table(np.random.default_rng(2), m, 150, 16)
    assert_same(port_pyramid.build_union_tables(table, 150, tile=tile, union_cap=160),
                jax_pyramid.build_union_tables(table, 150, tile=tile, union_cap=160), "union")
    for build in (port_pyramid.build_union_tables, jax_pyramid.build_union_tables):
        with pytest.raises(ValueError, match="union"):
            build(table, 150, tile=tile, union_cap=8)


def sample(seed, n=900):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n, 2))
    z = 0.15 * np.sin(6 * xy[:, 0]) * np.cos(5 * xy[:, 1]) + 0.01 * rng.normal(size=n)
    ref = np.column_stack([xy, z]).astype(np.float32)
    src = ref[ref[:, 0] < 0.7] + 0.003 * rng.normal(size=(int((ref[:, 0] < 0.7).sum()), 3))
    return {"ref_points": ref, "src_points": src.astype(np.float32)}


SAMPLES = [sample(s) for s in range(3)]
PYRAMID_ARGS = (4, 0.025, 0.0625)


@pytest.mark.parametrize("name", ["calibrate_stage_caps", "calibrate_stage_cap_buckets",
                                  "calibrate_split_specs", "calibrate_inverse_limits"])
def test_calibration_matches_jax(numpy_path, name):
    args = PYRAMID_ARGS + (NEIGHBOR_LIMITS,)
    got = getattr(port_calibrate, name)(iter(SAMPLES), *args, num_samples=len(SAMPLES))
    want = getattr(jax_calibrate, name)(iter(SAMPLES), *args, num_samples=len(SAMPLES))
    assert got == want
    if name == "calibrate_split_specs":
        assert any(spec is not None for spec in got[0] + got[1])


def test_neighbor_limit_calibration_matches_jax(numpy_path):
    got = port_calibrate.calibrate_neighbor_limits(iter(SAMPLES), *PYRAMID_ARGS,
                                                   sample_threshold=500)
    assert got == jax_calibrate.calibrate_neighbor_limits(iter(SAMPLES), *PYRAMID_ARGS,
                                                          sample_threshold=500)


@pytest.mark.parametrize("per_cloud", [False, True], ids=["symmetric", "asymmetric"])
def test_batch_with_every_optional_table_byte_identical(numpy_path, per_cloud):
    s = SAMPLES[0]
    points = np.concatenate([s["ref_points"], s["src_points"]], 0)
    pyr = port_pyramid.build_pyramid(points, [len(s["ref_points"]), len(s["src_points"])],
                                     *PYRAMID_ARGS, NEIGHBOR_LIMITS)
    caps = port_pyramid.caps_for_pyramid(pyr, multiple=64, per_cloud=per_cloud)
    args = (pyr, np.ones((points.shape[0], 1), np.float32), np.eye(4, dtype=np.float32), caps)
    nb_splits, sub_splits = port_calibrate.calibrate_split_specs(
        iter(SAMPLES), *PYRAMID_ARGS, NEIGHBOR_LIMITS, num_samples=3, multiple=32)
    inverse_limits = (48, 48, 48, 48)
    plain = port_pyramid.pad_registration_batch(*args, inverse_limits=inverse_limits)
    rows = [nb.shape[0] for nb in plain["neighbors"]]
    inv_splits = [port_pyramid.fit_split_for_table(t, rows[i], multiple=32)
                  for i, t in enumerate(plain["neighbors_inv"])]
    sub_inv_splits = [port_pyramid.fit_split_for_table(t, rows[i + 1], multiple=32)
                      for i, t in enumerate(plain["subsampling_inv"])]
    assert any(x is not None for x in inv_splits + sub_inv_splits)
    assert any(x is None for x in nb_splits + sub_splits)  # None entries too
    kw = dict(inverse_limits=inverse_limits, neighbor_splits=nb_splits,
              subsampling_splits=sub_splits, inverse_splits=inv_splits,
              sub_inverse_splits=sub_inv_splits, union_cap=768, union_tile=64,
              input_stream=False)
    got = port_pyramid.pad_registration_batch(*args, **kw)
    want = jax_pyramid.pad_registration_batch(*args, **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        assert_same(got[key], want[key], key)
    assert any(isinstance(x, tuple) for x in got["neighbors_inv"] + got["subsampling_inv"])
    # batch_to_torch keeps the tuples and the None entries
    tb = port_pyramid.batch_to_torch(got, "cpu")
    for key in ("neighbors_split", "subsampling_split", "neighbors_inv", "subsampling_inv"):
        assert_same([None if x is None else (tuple(v.numpy() for v in x) if isinstance(x, tuple)
                                             else x.numpy()) for x in tb[key]], got[key], key)


def t(x):
    return torch.from_numpy(np.asarray(x))


def conv_case(seed, m=96, n=120, h=24, c_in=8, c_out=16, skew=True):
    rng = np.random.default_rng(seed)
    q_points = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    s_points = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    s_feats = rng.normal(size=(n, c_in)).astype(np.float32)
    kp = (rng.normal(size=(15, 3)) * 0.3).astype(np.float32)
    w = (rng.normal(size=(15, c_in, c_out)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(c_out,)).astype(np.float32)
    pool = rng.integers(-2, 3, size=(n, 6)).astype(np.float32)  # tied maxima
    return dict(q=q_points, s=s_points, f=s_feats, kp=kp, w=w, bias=bias, pool=pool,
                table=random_table(rng, m, n, h, skew), n=n, rng=rng)


def split_of(table, n, h1, m2_cap=None):
    if m2_cap is None:
        m2_cap = int((table[:, h1:] < n).any(1).sum()) + 8
    return port_pyramid.build_split_tables(table, n, h1, m2_cap)


CASES = {
    "skewed": lambda c: (c["table"], 8),
    "all_deep": lambda c: (np.where(np.arange(24) < 24, c["table"], c["n"]), 16),
    "all_shallow": lambda c: (np.where(np.arange(24) < 8, c["table"], c["n"]), 8),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("with_pool", [False, True], ids=["conv", "conv_pool"])
def test_split_fused_matches_jax_and_unsplit(f32_mxu, case, with_pool):
    c = conv_case(3, skew=case == "skewed")
    table, h1 = CASES[case](c)
    n = c["n"]
    tail, tail_q, rank = split_of(table, n, h1)
    if case == "all_shallow":
        assert (rank == tail.shape[0]).all()  # no query has a tail row
    if case == "all_deep":
        assert (rank < tail.shape[0]).all()
    head = np.ascontiguousarray(table[:, :h1])
    kw_t = dict(pool_feats=t(c["pool"]), pool_cols=20) if with_pool else {}
    got = kpconv_split_fused(t(c["f"]), t(c["q"]), t(c["s"]), t(head), t(tail), t(tail_q),
                             t(rank), t(c["kp"]), t(c["w"]), SIGMA, t(c["bias"]),
                             residuals=True, **kw_t)
    kw_j = {k: jnp.asarray(v) if k == "pool_feats" else v for k, v in kw_t.items()}
    kw_j = dict(kw_j, pool_feats=jnp.asarray(c["pool"])) if with_pool else {}
    if with_pool:
        kw_j["pool_cols"] = 20
    want = jk.kpconv_split_fused(*[jnp.asarray(x) for x in (
        c["f"], c["q"], c["s"], head, tail, tail_q, rank, c["kp"], c["w"])], SIGMA,
        bias=jnp.asarray(c["bias"]), interpret=True, **kw_j)
    unsplit = kpconv_fused_plain(t(c["f"]), t(c["q"]), t(c["s"]), t(table), t(c["kp"]),
                                 t(c["w"]), SIGMA, t(c["bias"]), residuals=True, **kw_t)
    out, count = got[0].numpy(), got[2 if with_pool else 1].numpy()
    for ref in (np.asarray(want[0]), unsplit[0].numpy()):
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(count, np.asarray(want[-1]))
    np.testing.assert_array_equal(count, unsplit[2 if with_pool else 1].numpy())
    if with_pool:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(got[1].numpy(), unsplit[1].numpy())


def split_inverse(table, n_support, m_rows, j=40, h1=16):
    """The inverse of ``table`` and its split 4-tuple (head, tail, tail_s,
    rank), as pad_registration_batch(..., inverse_splits=...) builds it."""
    inv = port_pyramid.build_inverse_table(table, n_support, j)
    tail, tail_s, rank = split_of(inv, m_rows, h1)
    return inv, (np.ascontiguousarray(inv[:, :h1]), tail, tail_s, rank)


@pytest.mark.parametrize("with_pool", [False, True], ids=["conv", "conv_pool"])
def test_split_backward_matches_jax_tuple(f32_mxu, with_pool):
    c = conv_case(4)
    m, n = c["table"].shape[0], c["n"]
    inv, inv_split = split_inverse(c["table"], n, m)
    assert (inv_split[3] < inv_split[1].shape[0]).any()  # the tail pass has rows
    rng = c["rng"]
    gdiv = rng.normal(size=(m, c["w"].shape[2])).astype(np.float32)
    kw = {}
    if with_pool:
        _, pooled, _, ties = kpconv_fused_plain(
            t(c["f"]), t(c["q"]), t(c["s"]), t(c["table"]), t(c["kp"]), t(c["w"]), SIGMA,
            pool_feats=t(c["pool"]), residuals=True)
        kw = dict(pool_feats=c["pool"], pooled=pooled.numpy(),
                  dpool_over_ties=(rng.normal(size=pooled.shape) / ties.numpy()).astype(np.float32))
    args = (c["f"], c["s"], c["q"], gdiv)
    got = kpconv_bwd_fused(*[t(a) for a in args], tuple(t(x) for x in inv_split), t(c["kp"]),
                           t(c["w"]), SIGMA, **{k: t(v) for k, v in kw.items()})
    want = jk.kpconv_bwd_fused(*[jnp.asarray(a) for a in args],
                               tuple(jnp.asarray(x) for x in inv_split), jnp.asarray(c["kp"]),
                               jnp.asarray(c["w"]), SIGMA, tile_n=64, interpret=True,
                               **{k: jnp.asarray(v) for k, v in kw.items()})
    whole = kpconv_bwd_fused(*[t(a) for a in args], t(inv), t(c["kp"]), t(c["w"]), SIGMA,
                             **{k: t(v) for k, v in kw.items()})
    assert len(got) == len(want) == len(whole)
    for g, w, u in zip(got, want, whole):
        for ref, rtol, atol in ((np.asarray(w), 1e-3, 1e-4), (u.numpy(), 1e-5, 1e-6)):
            np.testing.assert_allclose(g.numpy(), ref, rtol=rtol, atol=atol * np.abs(ref).max())


def test_split_pool_gradients_match_jax_grad(f32_mxu):
    c = conv_case(5)
    m, n = c["table"].shape[0], c["n"]
    inv, inv_split = split_inverse(c["table"], n, m)
    tail, tail_q, rank = split_of(c["table"], n, 8)
    head = np.ascontiguousarray(c["table"][:, :8])
    rng = c["rng"]
    dout = rng.normal(size=(m, c["w"].shape[2])).astype(np.float32)
    dpool = rng.normal(size=(m, c["pool"].shape[1])).astype(np.float32)

    def loss_j(sf, pf, w, b):
        out, pooled = jk.kpconv_split_pool_diff(
            sf, pf, jnp.asarray(c["q"]), jnp.asarray(c["s"]), jnp.asarray(head),
            jnp.asarray(tail), jnp.asarray(tail_q), jnp.asarray(rank),
            tuple(jnp.asarray(x) for x in inv_split), jnp.asarray(c["kp"]), w, SIGMA, b, 64, 20)
        return jnp.sum(out * dout) + jnp.sum(pooled * dpool)

    want = jax.grad(loss_j, argnums=(0, 1, 2, 3))(
        *[jnp.asarray(c[k]) for k in ("f", "pool", "w", "bias")])
    leaves = [t(c[k]).requires_grad_() for k in ("f", "pool", "w", "bias")]
    out, pooled = kpconv_split_pool_diff(
        leaves[0], leaves[1], t(c["q"]), t(c["s"]), t(head), (t(tail), t(tail_q), t(rank)),
        tuple(t(x) for x in inv_split), t(c["kp"]), leaves[2], SIGMA, leaves[3], pool_cols=20)
    got = torch.autograd.grad((out * t(dout)).sum() + (pooled * t(dpool)).sum(), leaves)
    for name, g, w in zip(("d_s_feats", "d_pool", "d_weights", "d_bias"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-3, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def union_case(seed, m=100, n=140, h=16, tile=32):
    c = conv_case(seed, m=m, n=n, h=h, c_in=1, c_out=16)
    c["f"] = (c["rng"].uniform(size=(n, 1)) > 0.2).astype(np.float32)  # some non-positive
    rows, sel = port_pyramid.build_union_tables(c["table"], n, tile=tile, union_cap=512)
    return c, rows, sel, tile


def test_union_conv_matches_jax(f32_mxu):
    c, rows, sel, tile = union_case(6)
    got = kpconv_union_input_fused(t(c["f"]), t(c["q"]), t(c["s"]), t(rows), t(sel), t(c["kp"]),
                                   t(c["w"]), SIGMA, t(c["bias"]), tile=tile, residuals=True)
    want = jk.kpconv_union_input_fused(*[jnp.asarray(x) for x in (
        c["f"], c["q"], c["s"], rows, sel, c["kp"], c["w"])], SIGMA, bias=jnp.asarray(c["bias"]),
        tile_m=tile, interpret=True, return_count=True, return_t1=True)
    for name, g, w in zip(("out", "count", "t1"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    # the same function as the plain conv over the table the unions encode
    plain = kpconv_fused_plain(t(c["f"]), t(c["q"]), t(c["s"]), t(c["table"]), t(c["kp"]),
                               t(c["w"]), SIGMA, t(c["bias"]))
    np.testing.assert_array_equal(got[0].numpy(), plain.numpy())
    with pytest.raises(ValueError, match="tile"):
        kpconv_union_input_fused(t(c["f"]), t(c["q"]), t(c["s"]), t(rows), t(sel), t(c["kp"]),
                                 t(c["w"]), SIGMA, tile=2 * tile)


def test_union_weight_gradient_matches_jax_grad(f32_mxu):
    c, rows, sel, tile = union_case(7, m=64, tile=32)
    dout = c["rng"].normal(size=(64, 16)).astype(np.float32)

    def loss_j(w, b):
        out = jk.kpconv_union_input_fused_diff(*[jnp.asarray(x) for x in (
            c["f"], c["q"], c["s"], rows, sel, c["kp"])], w, SIGMA, b, tile)
        return jnp.sum(out * dout)

    want = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(c["w"]), jnp.asarray(c["bias"]))
    w, b = t(c["w"]).requires_grad_(), t(c["bias"]).requires_grad_()
    out = kpconv_union_input_fused_diff(t(c["f"]), t(c["q"]), t(c["s"]), t(rows), t(sel),
                                        t(c["kp"]), w, SIGMA, b, tile=tile)
    got = torch.autograd.grad((out * t(dout)).sum(), (w, b))
    for g, wv in zip(got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-4, atol=1e-5 * np.abs(wv).max())


@pytest.mark.parametrize("table", ["split", "whole"])
def test_input_conv_matches_jax_grad(f32_mxu, table):
    """The c_in == 1 input conv over a split table or the whole table: out
    and the weight and bias gradients vs jax.grad of the JAX
    kpconv_split_input_diff / kpconv_input_fused_diff."""
    c = conv_case(8, c_in=1)
    c["f"] = np.abs(c["f"])
    n, m = c["n"], c["table"].shape[0]
    tail, tail_q, rank = split_of(c["table"], n, 8)
    head = np.ascontiguousarray(c["table"][:, :8])
    dout = c["rng"].normal(size=(m, 16)).astype(np.float32)
    fixed = (c["f"], c["q"], c["s"])

    def loss_j(w, b):
        if table == "split":
            out = jk.kpconv_split_input_diff(*[jnp.asarray(x) for x in fixed + (
                head, tail, tail_q, rank, c["kp"])], w, SIGMA, b, 64)
        else:
            out = jk.kpconv_input_fused_diff(*[jnp.asarray(x) for x in fixed + (
                c["table"], c["kp"])], w, SIGMA, b, 64)
        return jnp.sum(out * dout), out

    (_, out_j), want = jax.value_and_grad(loss_j, argnums=(0, 1), has_aux=True)(
        jnp.asarray(c["w"]), jnp.asarray(c["bias"]))
    w, b = t(c["w"]).requires_grad_(), t(c["bias"]).requires_grad_()
    if table == "split":
        out = kpconv_split_input_diff(*[t(x) for x in fixed], t(head),
                                      (t(tail), t(tail_q), t(rank)), t(c["kp"]), w, SIGMA, b)
    else:
        out = kpconv_input_diff(*[t(x) for x in fixed], t(c["table"]), t(c["kp"]), w, SIGMA, b)
    got = torch.autograd.grad((out * t(dout)).sum(), (w, b))
    out_j = np.asarray(out_j)
    np.testing.assert_allclose(out.detach().numpy(), out_j, rtol=1e-4,
                               atol=1e-5 * np.abs(out_j).max())
    for g, wv in zip(got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-4, atol=1e-5 * np.abs(wv).max())
