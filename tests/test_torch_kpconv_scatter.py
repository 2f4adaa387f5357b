"""The port's KPConv backward without an inverse table vs the JAX package's.

A batch without inverse tables trains through the scatter backward: the
port's ``kpconv_fused_diff``, ``kpconv_pool_fused_diff``,
``kpconv_split_scatter_diff`` and ``kpconv_split_pool_scatter_diff`` (the
forward through the plain version on the CPU), against ``jax.vjp`` of the
JAX custom_vjps whose backward is XLA scatter code: ``kpconv_fused_diff``
(``_kpconv_diff_bwd``), ``kpconv_pool_fused_diff``
(``_kpconv_pool_diff_bwd``) and ``kpconv_split_diff`` /
``kpconv_split_pool_diff`` with ``inverse_table=None``
(``_split_blocks_bwd``); their Pallas forwards run in interpret mode with
the MXU operands at f32. Every gradient (features, pool features, weights,
bias) within rtol 1e-4 and atol 1e-5 x the largest gradient, the tolerance
of ``tests/test_torch_kpconv_bwd.py`` (f32 sums in another order, the
port's direct |s - q - kp| against JAX's expanded square). The pool cases
run with distinct features and with few distinct values, whose maxima tie
among real neighbors and with the zero shadow row (the gradient split
evenly over the ties, as the forward's tie counts say). On the card the
scatter sorts, so a repeat is bit for bit (``chip_smoke.py`` phase 18).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels import kpconv as jax_kpconv

from geotransformer_tpu_torch.kernels.kpconv import (
    kpconv_fused_diff,
    kpconv_pool_fused_diff,
    kpconv_split_pool_scatter_diff,
    kpconv_split_scatter_diff,
)
from geotransformer_tpu_torch.preprocess.pyramid import build_split_tables

SIGMA = 0.3
POOL_COLS = 20
H1 = 8


def make_case(seed, tied=False, n=120, m=96, h=24, c_in=8, c_out=16, c_pool=6, k=5):
    """A conv whose queries have anywhere from 0 to h neighbors (sentinel n),
    its split at H1 columns, the pool over the first POOL_COLS columns."""
    rng = np.random.default_rng(seed)
    table = np.full((m, h), n, np.int32)
    for i in range(m):
        count = rng.integers(0, POOL_COLS + 1)
        table[i, :count] = rng.choice(n, size=count, replace=False)
    m2_cap = int((table[:, H1:] < n).any(axis=1).sum()) + 8
    pool = (rng.integers(-2, 2, size=(n, c_pool)) if tied
            else rng.normal(size=(n, c_pool)))
    return dict(
        s_feats=rng.normal(size=(n, c_in)).astype(np.float32),
        pool_feats=pool.astype(np.float32),
        q_points=rng.uniform(0, 1, (m, 3)).astype(np.float32),
        s_points=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        table=table, split=build_split_tables(table, n, H1, m2_cap),
        kp=(rng.normal(size=(k, 3)) * 0.3).astype(np.float32),
        w=(rng.normal(size=(k, c_in, c_out)) * 0.2).astype(np.float32),
        bias=rng.normal(size=(c_out,)).astype(np.float32),
        dout=rng.normal(size=(m, c_out)).astype(np.float32),
        dpool=rng.normal(size=(m, c_pool)).astype(np.float32))


def jax_grads(c, kind, pool):
    """jax.vjp of the JAX differentiable conv: (d_feats[, d_pool], d_w, d_b)."""
    q, s, kp = (jnp.asarray(c[k]) for k in ("q_points", "s_points", "kp"))
    table = jnp.asarray(c["table"])
    tail, tail_q, rank = (jnp.asarray(x) for x in c["split"])

    def conv(sf, pf, w, b):
        if kind == "whole" and pool:
            return jax_kpconv.kpconv_pool_fused_diff(sf, pf, q, s, table, kp, w, SIGMA, b, 64,
                                                     POOL_COLS)
        if kind == "whole":
            return jax_kpconv.kpconv_fused_diff(sf, q, s, table, kp, w, SIGMA, b, 64)
        head = table[:, :H1]
        if pool:
            return jax_kpconv.kpconv_split_pool_diff(sf, pf, q, s, head, tail, tail_q, rank,
                                                     None, kp, w, SIGMA, b, 64, POOL_COLS)
        return jax_kpconv.kpconv_split_diff(sf, q, s, head, tail, tail_q, rank, None, kp, w,
                                            SIGMA, b, 64)

    args = [jnp.asarray(c[k]) for k in ("s_feats", "pool_feats", "w", "bias")]
    _, vjp = jax.vjp(conv, *args)
    cot = (jnp.asarray(c["dout"]), jnp.asarray(c["dpool"])) if pool else jnp.asarray(c["dout"])
    grads = vjp(cot)
    return grads if pool else (grads[0], grads[2], grads[3])


def port_grads(c, kind, pool):
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in c.items() if k != "split"}
    sf, pf, w, b = (t[k].clone().requires_grad_() for k in ("s_feats", "pool_feats", "w", "bias"))
    tables = tuple(torch.from_numpy(x) for x in c["split"])
    head = t["table"][:, :H1].contiguous()
    common = (t["q_points"], t["s_points"])
    if kind == "whole" and pool:
        out = kpconv_pool_fused_diff(sf, pf, *common, t["table"], t["kp"], w, SIGMA, b,
                                     pool_cols=POOL_COLS)
    elif kind == "whole":
        out = kpconv_fused_diff(sf, *common, t["table"], t["kp"], w, SIGMA, b)
    elif pool:
        out = kpconv_split_pool_scatter_diff(sf, pf, *common, head, tables, t["kp"], w, SIGMA,
                                             b, pool_cols=POOL_COLS)
    else:
        out = kpconv_split_scatter_diff(sf, *common, head, tables, t["kp"], w, SIGMA, b)
    if pool:
        loss = (out[0] * t["dout"]).sum() + (out[1] * t["dpool"]).sum()
        return torch.autograd.grad(loss, (sf, pf, w, b))
    return torch.autograd.grad((out * t["dout"]).sum(), (sf, w, b))


CASES = [("whole", False, False), ("whole", True, False), ("whole", True, True),
         ("split", False, False), ("split", True, False), ("split", True, True)]


@pytest.mark.parametrize("kind, pool, tied", CASES,
                         ids=["whole", "whole-pool", "whole-pool-tied", "split", "split-pool",
                              "split-pool-tied"])
def test_scatter_backward_matches_jax_vjp(kind, pool, tied, monkeypatch):
    monkeypatch.setattr(jax_kpconv, "MXU_DTYPE", jnp.float32)
    c = make_case(3, tied=tied)
    want = jax_grads(c, kind, pool)
    got = port_grads(c, kind, pool)
    names = ("s_feats", "pool_feats", "weights", "bias") if pool else ("s_feats", "weights",
                                                                        "bias")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
