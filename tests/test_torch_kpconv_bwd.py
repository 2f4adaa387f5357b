"""The port's KPConv backward (plain version of the inverse-table kernel) vs
the JAX package and vs autograd.

Same numpy inputs through ``kpconv_bwd_fused`` of the port (the plain
version, on the CPU) and:
  (a) ``jax.vjp`` of the JAX XLA ``KPConv`` and ``maxpool`` (rtol 1e-4,
      atol 1e-5 x the largest gradient: f32 sums in another order);
  (b) the JAX Pallas ``kpconv_bwd_fused`` in interpret mode with its MXU
      operands at f32 (rtol 1e-3, atol 1e-4 x the largest gradient: the
      kernel's expanded |s - q - kp|^2 against the port's direct distance);
  (c) autograd through the port's own plain forward, also through the
      autograd Functions of the training path, with pool maxima tied among
      real neighbors and with the zero shadow row (rtol 1e-5, atol 1e-6).
The CUDA kernel itself is checked on the card (``-m cuda``, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels import kpconv as jax_kpconv_kernels
from geotransformer_tpu.kernels.kpconv import kpconv_bwd_fused as jax_kpconv_bwd
from geotransformer_tpu.models.kpconv import KPConv as JaxKPConv
from geotransformer_tpu.models.kpconv import maxpool as jax_maxpool

from geotransformer_tpu_torch.kernels.kpconv import (
    kpconv_bwd_fused,
    kpconv_fused,
    kpconv_fused_plain,
    kpconv_inv_fused_diff,
    kpconv_pool_inv_fused_diff,
    kpconv_stream_fused_plain,
    kpconv_stream_input_diff,
)
from geotransformer_tpu_torch.preprocess.pyramid import build_input_stream, build_inverse_table

SIGMA = 0.08
POOL_COLS = 12


def make_case(seed, n=300, m=200, h=16, cin=16, cout=32, cpool=24, tied=False):
    rng = np.random.default_rng(seed)
    s_points = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    q_points = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    d = np.linalg.norm(q_points[:, None] - s_points[None], axis=-1)
    nbrs = np.argsort(d, axis=1)[:, :h].astype(np.int32)
    nbrs[rng.uniform(size=(m, h)) < 0.3] = n
    nbrs[:, POOL_COLS:] = n  # alignment columns: sentinel only (the pool contract)
    s_feats = rng.normal(size=(n, cin)).astype(np.float32)
    if tied:
        # few distinct values: the pooled max ties among real neighbors and,
        # at 0, with the zero shadow row
        pool_feats = rng.integers(-2, 2, size=(n, cpool)).astype(np.float32)
    else:
        pool_feats = rng.normal(size=(n, cpool)).astype(np.float32)
    conv = JaxKPConv(cin, cout, 15, 0.1, SIGMA, use_bias=True)
    variables = conv.init(jax.random.PRNGKey(seed), jnp.asarray(s_feats), jnp.asarray(q_points),
                          jnp.asarray(s_points), jnp.asarray(nbrs))
    return dict(
        s_points=s_points, q_points=q_points, nbrs=nbrs, s_feats=s_feats, pool_feats=pool_feats,
        inv=build_inverse_table(nbrs, n, 40), conv=conv, variables=variables,
        kp=np.array(variables["constants"]["kernel_points"]),
        w=np.array(variables["params"]["weights"]),
        dout=rng.normal(size=(m, cout)).astype(np.float32),
        dpool=rng.normal(size=(m, cpool)).astype(np.float32))


def t(x):
    return torch.from_numpy(np.asarray(x))


def port_forward(c, pool=False):
    """The plain forward with the backward's residuals."""
    kw = dict(pool_feats=t(c["pool_feats"]), pool_cols=POOL_COLS) if pool else {}
    return kpconv_fused(t(c["s_feats"]), t(c["q_points"]), t(c["s_points"]), t(c["nbrs"]),
                        t(c["kp"]), t(c["w"]), SIGMA, residuals=True, **kw)


def port_backward(c, pool=False):
    res = port_forward(c, pool)
    gdiv = t(c["dout"]) / res[-1 if not pool else 2][:, None]
    kw = {}
    if pool:
        _, pooled, _, ties = res
        kw = dict(pool_feats=t(c["pool_feats"]), pooled=pooled,
                  dpool_over_ties=t(c["dpool"]) / ties)
    return kpconv_bwd_fused(t(c["s_feats"]), t(c["s_points"]), t(c["q_points"]), gdiv,
                            t(c["inv"]), t(c["kp"]), t(c["w"]), SIGMA, **kw)


def assert_grad_close(got, want, rtol, atol_frac):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_xla_vjp(seed):
    c = make_case(seed)
    params = c["variables"]["params"]

    def conv(s_feats, weights):
        variables = {"constants": c["variables"]["constants"],
                     "params": {"weights": weights, "bias": params["bias"]}}
        return c["conv"].apply(variables, s_feats, jnp.asarray(c["q_points"]),
                               jnp.asarray(c["s_points"]), jnp.asarray(c["nbrs"]))

    _, vjp = jax.vjp(conv, jnp.asarray(c["s_feats"]), jnp.asarray(c["w"]))
    want_ds, want_dw = vjp(jnp.asarray(c["dout"]))
    got_ds, got_dw = port_backward(c)
    assert_grad_close(got_ds, want_ds, 1e-4, 1e-5)
    assert_grad_close(got_dw, want_dw, 1e-4, 1e-5)


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
def test_pool_matches_jax_xla_maxpool_vjp(tied):
    c = make_case(2, tied=tied)
    _, vjp = jax.vjp(lambda f: jax_maxpool(f, jnp.asarray(c["nbrs"]), valid_cols=POOL_COLS),
                     jnp.asarray(c["pool_feats"]))
    (want,) = vjp(jnp.asarray(c["dpool"]))
    got_ds, got_dw, got_dpool = port_backward(c, pool=True)
    assert_grad_close(got_dpool, want, 1e-4, 1e-5)
    # the pool leaves the conv's gradients as they were
    want_ds, want_dw = port_backward(c)
    np.testing.assert_array_equal(got_ds.numpy(), want_ds.numpy())
    np.testing.assert_array_equal(got_dw.numpy(), want_dw.numpy())


@pytest.mark.parametrize("pool", [False, True], ids=["conv", "conv_pool"])
def test_matches_jax_pallas_interpret(pool, monkeypatch):
    monkeypatch.setattr(jax_kpconv_kernels, "MXU_DTYPE", jnp.float32)
    c = make_case(3)
    res = port_forward(c, pool)
    count = res[1] if not pool else res[2]
    gdiv = (t(c["dout"]) / count[:, None]).numpy()
    kw = {}
    if pool:
        kw = dict(pool_feats=jnp.asarray(c["pool_feats"]), pooled=jnp.asarray(res[1].numpy()),
                  dpool_over_ties=jnp.asarray((t(c["dpool"]) / res[3]).numpy()))
    want = jax_kpconv_bwd(
        jnp.asarray(c["s_feats"]), jnp.asarray(c["s_points"]), jnp.asarray(c["q_points"]),
        jnp.asarray(gdiv), jnp.asarray(c["inv"]), jnp.asarray(c["kp"]), jnp.asarray(c["w"]),
        SIGMA, tile_n=64, interpret=True, **kw)
    got = port_backward(c, pool)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_grad_close(g, w, 1e-3, 1e-4)


def _autograd_reference(c, pool):
    """Gradients of sum(out * dout [+ pooled * dpool]) by autograd through
    the plain forward (amax splits tied maxima evenly)."""
    s_feats, w = t(c["s_feats"]).requires_grad_(), t(c["w"]).requires_grad_()
    pool_feats = t(c["pool_feats"]).requires_grad_() if pool else None
    out = kpconv_fused_plain(s_feats, t(c["q_points"]), t(c["s_points"]), t(c["nbrs"]),
                             t(c["kp"]), w, SIGMA, pool_feats=pool_feats,
                             pool_cols=POOL_COLS if pool else None)
    if pool:
        loss = (out[0] * t(c["dout"])).sum() + (out[1] * t(c["dpool"])).sum()
        return torch.autograd.grad(loss, (s_feats, w, pool_feats))
    return torch.autograd.grad((out * t(c["dout"])).sum(), (s_feats, w))


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("pool", [False, True], ids=["conv", "conv_pool"])
def test_matches_autograd_of_plain_forward(pool, tied):
    c = make_case(4, tied=tied)
    want = _autograd_reference(c, pool)
    for got in (port_backward(c, pool), _function_grads(c, pool)):
        for g, w in zip(got, want):
            assert_grad_close(g, w, 1e-5, 1e-6)


def _function_grads(c, pool):
    """The same gradients through the training path's autograd Functions."""
    s_feats, w = t(c["s_feats"]).requires_grad_(), t(c["w"]).requires_grad_()
    bias = torch.zeros(w.shape[2], requires_grad=True)
    args = (t(c["q_points"]), t(c["s_points"]), t(c["nbrs"]), t(c["inv"]), t(c["kp"]), w, SIGMA)
    if not pool:
        out = kpconv_inv_fused_diff(s_feats, *args, bias)
        grads = torch.autograd.grad((out * t(c["dout"])).sum(), (s_feats, w, bias))
    else:
        pool_feats = t(c["pool_feats"]).requires_grad_()
        out, pooled = kpconv_pool_inv_fused_diff(s_feats, pool_feats, *args, bias,
                                                 pool_cols=POOL_COLS)
        loss = (out * t(c["dout"])).sum() + (pooled * t(c["dpool"])).sum()
        grads = torch.autograd.grad(loss, (s_feats, w, pool_feats, bias))
    # the bias gradient is dout summed over the queries
    np.testing.assert_allclose(grads[-1].numpy(), c["dout"].sum(0), rtol=1e-5, atol=1e-5)
    return grads[:-1]


def test_sentinel_rows_and_padding_queries_contribute_nothing():
    m, n = 60, 80
    c = make_case(5, m=m, n=n)
    c["nbrs"][40:] = n  # padding queries: all-sentinel neighbor rows
    c["inv"] = build_inverse_table(c["nbrs"], n, 40)
    assert (c["inv"][c["inv"] < m] < 40).all()  # the inverse lists real queries only
    ds, dw = port_backward(c)
    # their output gradient reaches nothing
    c["dout"][40:] = 1e3
    ds2, dw2 = port_backward(c)
    np.testing.assert_array_equal(ds2.numpy(), ds.numpy())
    np.testing.assert_array_equal(dw2.numpy(), dw.numpy())
    # support rows whose inverse rows hold only the sentinel get zero
    c["inv"][10:20] = m
    assert not port_backward(c)[0][10:20].any()


def test_stream_function_weight_gradient():
    rng = np.random.default_rng(6)
    m, h, cout = 120, 16, 32
    points = rng.uniform(0, 0.4, (m, 3)).astype(np.float32)
    d = np.linalg.norm(points[:, None] - points[None], axis=-1)
    nbrs = np.argsort(d, axis=1)[:, :h].astype(np.int32)
    nbrs[rng.uniform(size=(m, h)) < 0.2] = m
    feats = (rng.uniform(size=(m, 1)) > 0.1).astype(np.float32)
    stream = t(build_input_stream(points, feats, nbrs))
    kp = t(make_case(0)["kp"])
    dout = t(rng.normal(size=(m, cout)).astype(np.float32))
    w_ref = t(rng.normal(size=(15, 1, cout)).astype(np.float32)).requires_grad_()
    (want,) = torch.autograd.grad((kpconv_stream_fused_plain(stream, kp, w_ref, SIGMA) * dout).sum(),
                                  (w_ref,))
    w = w_ref.detach().clone().requires_grad_()
    bias = torch.zeros(cout, requires_grad=True)
    got_w, got_b = torch.autograd.grad(
        (kpconv_stream_input_diff(stream, kp, w, SIGMA, bias) * dout).sum(), (w, bias))
    assert_grad_close(got_w, want, 1e-5, 1e-6)
    np.testing.assert_allclose(got_b.numpy(), dout.sum(0).numpy(), rtol=1e-5, atol=1e-5)


def test_force_true_on_cpu_raises():
    c = make_case(7, n=40, m=20)
    res = port_forward(c)
    with pytest.raises(RuntimeError, match="CUDA"):
        kpconv_bwd_fused(t(c["s_feats"]), t(c["s_points"]), t(c["q_points"]),
                         t(c["dout"]) / res[1][:, None], t(c["inv"]), t(c["kp"]), t(c["w"]),
                         SIGMA, force=True)
