"""Training at the JAX package's precision point, on the CPU: the port's
plain versions of the backward kernels (row 6, the KPConv backward over the
inverse table; row 8, the GSE backward; row 12's backward on a bfloat16
embedding) against the JAX Pallas backward kernels (interpret mode) and
``jax.vjp`` at the same point. The bfloat16 gathered table:
``tests/test_torch_precision_table.py``; one narrow training step against
``jax.grad``: ``tests/test_torch_precision_step.py``.

The JAX globals are set with ``monkeypatch`` (the fixtures of
``tests/test_torch_precision.py``), never with ``apply_precision``; the
module restores them (``jax_precision_kept``). As there, points, kernel
points and reference vectors sit on binary grids, so both sides compute the
same influences and angles, and the GSE comparisons take exact sin, cos and
atan2 on the JAX side: both round the same float32 values to bfloat16 and
multiply exact products. What is left is the order of float32 sums, which
can move a sum across a bfloat16 rounding boundary before it is rounded
again (row 6's u, the GSE argmax): each output then lies within 2^-7 S of
the JAX one, S the sum over its terms of |a||b| on the unrounded operands
(row 6: S of d_s sums |u| |W| with |u| the sum of |infl| |gdiv|; of dW
|s| |u|), and at least 99 % of the outputs within 1e-5 S
(``assert_flip_bars``). Where nothing is rounded the float32 tolerance
holds (the pool gradients, db: 1e-5 of the largest entry).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels import attention as jax_attention
from geotransformer_tpu.kernels import gse as jax_gse
from geotransformer_tpu.kernels import kpconv as jax_kpconv

from geotransformer_tpu_torch.kernels import attention as port_attention
from geotransformer_tpu_torch.kernels import gse as port_gse
from geotransformer_tpu_torch.kernels import kpconv as port_kpconv
from geotransformer_tpu_torch.ops.embedding import sinusoidal_embedding
from geotransformer_tpu_torch.preprocess import build_inverse_table, build_split_tables
from test_torch_precision import (  # noqa: F401  (fixtures)
    BF16,
    GSE_VALID,
    SIGMA,
    assert_flip_bars,
    conv_case,
    exact_trig,
    gse_case,
    jax_point,
    t,
)
from torch_routes import jax_precision_kept  # noqa: F401  (JAX precision globals restored)

F32 = torch.float32


@pytest.fixture
def jax_table_point(jax_point, monkeypatch):
    """The JAX point with bfloat16 gathered tables as well (all four knobs)."""
    monkeypatch.setattr(jax_kpconv, "TABLE_DTYPE", jnp.bfloat16)


# ---- row 6: the KPConv backward over the inverse table ---------------------

def bwd_case(seed, c_in=16, c_out=24, m=96, n=120, h=24, j=40, c_pool=0):
    """A conv's backward on grid points: the forward table, its inverse, a
    dout / count, and (with ``c_pool``) normal pool features."""
    c = conv_case(seed, c_in, c_out=c_out, m=m, n=n, h=h)
    rng = np.random.default_rng(seed + 100)
    c["inv"] = build_inverse_table(c["table"], n, j)
    c["gdiv"] = rng.normal(size=(m, c_out)).astype(np.float32)
    if c_pool:
        c["pool"] = rng.normal(size=(n, c_pool)).astype(np.float32)
    return c


def split_inverse(inv, m, h1):
    m2 = int((inv[:, h1:] < m).any(axis=1).sum())
    tail, tail_s, rank = build_split_tables(inv, m, h1, m2 + 4)
    return (np.ascontiguousarray(inv[:, :h1]), tail, tail_s, rank)


def bwd_scales(c):
    """S of d_s (sum_{k, d} |u| |W|) and of dW (sum_n |s| |u|), |u| the sum
    of |infl| |gdiv| over the inverse edges."""
    return port_kpconv.kpconv_bwd_fused_plain(
        t(np.abs(c["f"])), t(c["s"]), t(c["q"]), t(np.abs(c["gdiv"])), t(c["inv"]), t(c["kp"]),
        t(np.abs(c["w"])), SIGMA)


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split_inverse"])
def test_row6_kpconv_bwd_at_bf16_matches_jax(jax_point, split):
    """Row 6 at kpconv_mxu="bfloat16": the influences and gdiv rounded
    before u, u before both weight products, s for dW (W stays float32); a
    split inverse table's head and tail each round their own u, as the JAX
    backward's two calls do (``kernels/kpconv.py:778-802``)."""
    c = bwd_case(21)
    inv = split_inverse(c["inv"], 96, 8) if split else c["inv"]
    args = (c["f"], c["s"], c["q"], c["gdiv"])
    want = jax_kpconv.kpconv_bwd_fused(
        *map(jnp.asarray, args), jax.tree.map(jnp.asarray, inv), jnp.asarray(c["kp"]),
        jnp.asarray(c["w"]), SIGMA, interpret=True)
    got = port_kpconv.kpconv_bwd_fused_plain(
        *map(t, args), jax.tree.map(t, inv), t(c["kp"]), t(c["w"]), SIGMA, mxu_dtype=BF16)
    s_ds, s_dw = bwd_scales(c)
    assert_flip_bars(got[0].numpy(), want[0], s_ds.numpy(), "row 6 d_s")
    assert_flip_bars(got[1].numpy(), want[1], s_dw.numpy(), "row 6 dW")
    # the rounding shows: the float32 point is farther from the JAX one
    f32 = port_kpconv.kpconv_bwd_fused_plain(*map(t, args), jax.tree.map(t, inv), t(c["kp"]),
                                             t(c["w"]), SIGMA)
    assert np.abs(f32[1].numpy() - want[1]).max() > 10 * np.abs(got[1].numpy() - want[1]).max()


def test_row6_split_rounds_head_and_tail_apart(jax_point):
    """The split route is not the whole table's arithmetic at bfloat16 (the
    head's and the tail's u round apart); the port takes the JAX split
    route's."""
    c = bwd_case(22)
    args = list(map(t, (c["f"], c["s"], c["q"], c["gdiv"])))
    split = jax.tree.map(t, split_inverse(c["inv"], 96, 8))
    point = dict(mxu_dtype=BF16)
    whole = port_kpconv.kpconv_bwd_fused_plain(*args, t(c["inv"]), t(c["kp"]), t(c["w"]), SIGMA,
                                               **point)
    parts = port_kpconv.kpconv_bwd_fused_plain(*args, split, t(c["kp"]), t(c["w"]), SIGMA,
                                               **point)
    assert not torch.equal(whole[1], parts[1])
    f32 = [port_kpconv.kpconv_bwd_fused_plain(*args, inv, t(c["kp"]), t(c["w"]), SIGMA)
           for inv in (t(c["inv"]), split)]
    torch.testing.assert_close(f32[0][1], f32[1][1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_row6_pool_gradient_at_the_table_point_matches_jax(jax_table_point, monkeypatch, mxu):
    """Row 6's pool gradient at kpconv_table="bfloat16": its own pool
    features rounded for the tie equality with the pooled rounded values
    (``kernels/kpconv.py:842-845``), at either kpconv_mxu; whole and split
    inverse tables."""
    if mxu == "float32":
        monkeypatch.setattr(jax_kpconv, "MXU_DTYPE", jnp.float32)
    point = dict(mxu_dtype=torch.float32 if mxu == "float32" else BF16, table_dtype=BF16)
    c = bwd_case(23, c_pool=12)
    rng = np.random.default_rng(5)
    _, pooled, _, ties = port_kpconv.kpconv_fused_plain(
        t(c["f"]), t(c["q"]), t(c["s"]), t(c["table"]), t(c["kp"]), t(c["w"]), SIGMA,
        pool_feats=t(c["pool"]), residuals=True, table_dtype=BF16)
    dpt = (rng.normal(size=pooled.shape) / ties.numpy()).astype(np.float32)
    for inv in (c["inv"], split_inverse(c["inv"], 96, 8)):
        args = (c["f"], c["s"], c["q"], c["gdiv"])
        pool = (c["pool"], pooled.numpy(), dpt)
        want = jax_kpconv.kpconv_bwd_fused(
            *map(jnp.asarray, args), jax.tree.map(jnp.asarray, inv), jnp.asarray(c["kp"]),
            jnp.asarray(c["w"]), SIGMA, interpret=True,
            **dict(zip(("pool_feats", "pooled", "dpool_over_ties"), map(jnp.asarray, pool))))
        got = port_kpconv.kpconv_bwd_fused_plain(
            *map(t, args), jax.tree.map(t, inv), t(c["kp"]), t(c["w"]), SIGMA,
            *map(t, pool), **point)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                                   atol=1e-5 * np.abs(want[2]).max())
        unrounded = port_kpconv.kpconv_bwd_fused_plain(
            *map(t, args), jax.tree.map(t, inv), t(c["kp"]), t(c["w"]), SIGMA, *map(t, pool),
            mxu_dtype=point["mxu_dtype"])
        assert not torch.equal(unrounded[2], got[2])  # the rounding decides the ties here


# ---- row 8: the GSE backward -----------------------------------------------

def gse_bwd_scales(points, ref_vectors, de, n_valid):
    """S of dW_d (sum over valid pairs of |B_d| |de|) and of dW_a (the same
    over every angle's bases)."""
    hidden = de.shape[-1]
    d_idx, a_idx = port_gse._pair_indices(t(points), t(ref_vectors), 0.2, 15.0)
    mask = np.zeros(de.shape[:2], np.float32)
    mask[:n_valid, :n_valid] = 1.0
    de_abs = torch.from_numpy(np.abs(de) * mask[..., None])
    s_d = torch.einsum("ijf,ijc->fc", sinusoidal_embedding(d_idx, hidden).abs(), de_abs)
    s_a = torch.einsum("ijkf,ijc->fc", sinusoidal_embedding(a_idx, hidden).abs(), de_abs)
    return s_d.numpy(), s_a.numpy()


@pytest.mark.parametrize("c, a", [(32, 3), (48, 5)], ids=["C32", "C48-A5"])
def test_row8_gse_bwd_at_bf16_matches_jax(jax_point, exact_trig, c, a):
    """Row 8 at gse_basis="bfloat16" on a bfloat16 embedding's cotangent:
    the bases and W_a rounded, the first argmax over the rounded
    projections, de rounded before both weight gradients, db from de as it
    comes (``kernels/gse.py:322-372, 386-387``). The cotangent is zero
    outside the valid rectangle, as the pair scores' backward leaves it (the
    JAX kernel skips whole tiles only)."""
    points, ref_vectors, _, _, w_a, _ = gse_case(c, a, seed=3)
    rng = np.random.default_rng(c + a)
    de = rng.normal(size=(points.shape[0],) * 2 + (c,)).astype(np.float32)
    de[GSE_VALID:] = 0.0
    de[:, GSE_VALID:] = 0.0
    de = torch.from_numpy(de).to(BF16)
    de_np = de.float().numpy()
    want = jax_gse._gse_full_bwd(
        *map(jnp.asarray, (points, ref_vectors, w_a)), c, 0.2, 15.0,
        jnp.asarray(de_np).astype(jnp.bfloat16), interpret=True, n_valid=GSE_VALID)
    got = port_gse.gse_full_bwd_plain(
        *map(t, (points, ref_vectors, w_a)), 0.2, 15.0, de,
        torch.tensor(GSE_VALID, dtype=torch.int32), basis_dtype=BF16)
    assert all(g.dtype == F32 for g in got)
    s_d, s_a = gse_bwd_scales(points, ref_vectors, de_np, GSE_VALID)
    assert_flip_bars(got[0].numpy(), want[0], s_d, f"row 8 dW_d, C = {c}")
    assert_flip_bars(got[2].numpy(), want[2], s_a, f"row 8 dW_a, C = {c}")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=1e-5 * np.abs(want[1]).max())
    f32 = port_gse.gse_full_bwd_plain(*map(t, (points, ref_vectors, w_a)), 0.2, 15.0, de,
                                      torch.tensor(GSE_VALID, dtype=torch.int32))
    assert np.abs(f32[2].numpy() - want[2]).max() > 10 * np.abs(got[2].numpy() - want[2]).max()


# ---- row 12's backward on a bfloat16 embedding -------------------------------

def test_row12_backward_on_a_bf16_embedding_matches_jax_vjp(monkeypatch):
    """The pair scores' backward on a bfloat16 embedding against ``jax.vjp``
    of the JAX ``rpe_pair_scores_diff``: d_embed in float32, stored in
    bfloat16 (within 2^-7 of its terms' sum plus a bfloat16 ulp of
    itself), d_qw from the widened embedding (1e-5 of the largest). The
    score cotangent is zero outside the valid rectangle, as the masked
    softmax leaves it (the JAX backward does not mask it again)."""
    monkeypatch.setattr(jax_attention, "MXU_DTYPE", jnp.float32)
    rng = np.random.default_rng(12)
    n, h, c, nv = 40, 4, 64, 33
    embed = torch.from_numpy(rng.normal(size=(n, n, c)).astype(np.float32)).to(BF16)
    qw = rng.normal(size=(n, h, c)).astype(np.float32)
    ds = rng.normal(size=(n, h, n)).astype(np.float32)
    ds[nv:] = 0.0
    ds[:, :, nv:] = 0.0
    e_jax = jnp.asarray(embed.float().numpy()).astype(jnp.bfloat16)
    _, vjp = jax.vjp(lambda e, q: jax_attention.rpe_pair_scores_diff(e, q, nv, nv), e_jax,
                     jnp.asarray(qw))
    d_embed_j, d_qw_j = vjp(jnp.asarray(ds))
    assert d_embed_j.dtype == jnp.bfloat16
    e_t = embed.clone().requires_grad_()
    q_t = t(qw).requires_grad_()
    port_attention.rpe_pair_scores_diff(e_t, q_t, nv, nv).backward(t(ds))
    assert e_t.grad.dtype == BF16 and q_t.grad.dtype == F32
    scale = np.einsum("nhm,nhc->nmc", np.abs(ds), np.abs(qw))
    want = np.asarray(d_embed_j.astype(jnp.float32))
    assert_flip_bars(e_t.grad.float().numpy(), want, scale + np.abs(want), "d_embed")
    np.testing.assert_allclose(q_t.grad.numpy(), np.asarray(d_qw_j), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(d_qw_j)).max())


def test_bf16_embedding_cotangents_add_in_jax_order(monkeypatch):
    """The embedding feeds every "self" block; its cotangents add in
    bfloat16. Autograd adds them as JAX does: the last block's first, then
    each earlier one, each sum rounded to bfloat16 (checked bit for bit on
    each side against its own per-block cotangents, three blocks)."""
    monkeypatch.setattr(jax_attention, "MXU_DTYPE", jnp.float32)
    rng = np.random.default_rng(13)
    n, h, c, nv = 24, 2, 32, 21
    embed = torch.from_numpy(rng.normal(size=(n, n, c)).astype(np.float32)).to(BF16)
    qws = [rng.normal(size=(n, h, c)).astype(np.float32) * 10.0 ** i for i in range(3)]
    dss = [rng.normal(size=(n, h, n)).astype(np.float32) for _ in range(3)]

    def ordered(parts):  # ((ct_3 + ct_2) + ct_1), rounded at each add
        total = parts[2]
        for p in (parts[1], parts[0]):
            total = (total + p).to(BF16) if isinstance(total, torch.Tensor) else (
                (total + p).astype(jnp.bfloat16))
        return total

    e_t = embed.clone().requires_grad_()
    outs = [port_attention.rpe_pair_scores_diff(e_t, t(q), nv, nv) for q in qws]
    sum((o * t(ds)).sum() for o, ds in zip(outs, dss)).backward()
    parts = []
    for q, ds in zip(qws, dss):
        e1 = embed.clone().requires_grad_()
        port_attention.rpe_pair_scores_diff(e1, t(q), nv, nv).backward(t(ds))
        parts.append(e1.grad)
    assert torch.equal(e_t.grad, ordered(parts))

    e_j = jnp.asarray(embed.float().numpy()).astype(jnp.bfloat16)

    def total(e):
        return sum(jnp.sum(jax_attention.rpe_pair_scores_diff(e, jnp.asarray(q), nv, nv)
                           * jnp.asarray(ds)) for q, ds in zip(qws, dss))

    grad_j = jax.grad(total)(e_j)
    parts_j = [jax.grad(lambda e, q=q, ds=ds: jnp.sum(jax_attention.rpe_pair_scores_diff(
        e, jnp.asarray(q), nv, nv) * jnp.asarray(ds)))(e_j) for q, ds in zip(qws, dss)]
    assert np.array_equal(np.asarray(grad_j.astype(jnp.float32)),
                          np.asarray(ordered(parts_j).astype(jnp.float32)))
