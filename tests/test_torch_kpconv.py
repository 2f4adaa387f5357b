"""The port's KPConv kernels' plain versions vs the JAX package.

Same numpy inputs through ``kpconv_fused`` (with and without the fused
shortcut pool) and ``kpconv_stream_fused`` of the port, the JAX XLA
``KPConv``/``maxpool`` (rtol 1e-3, atol 1e-4), and the JAX Pallas kernels in
interpret mode at the JAX tests' own bars (fused: rtol 3e-2, atol 1e-2 —
bf16 MXU operands, tests/test_kpconv_kernel.py:49; stream: rtol 1e-3,
atol 1e-4, tests/test_kpconv_kernel.py:484, with the stream kernel at its f32
MXU precision point). The CUDA kernels themselves are checked on the card
(``-m cuda``, and chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels import kpconv as jax_kpconv_kernels
from geotransformer_tpu.kernels.kpconv import kpconv_fused as jax_kpconv_fused
from geotransformer_tpu.kernels.kpconv import kpconv_stream_fused as jax_kpconv_stream
from geotransformer_tpu.models.kpconv import KPConv as JaxKPConv
from geotransformer_tpu.models.kpconv import maxpool as jax_maxpool
from geotransformer_tpu.preprocess.pyramid import build_input_stream

from geotransformer_tpu_torch.kernels.kpconv import kpconv_fused, kpconv_stream_fused
from geotransformer_tpu_torch.models.kpconv import KPConv
from torch_routes import numpy_pyramids  # noqa: F401  (both packages on numpy)

SIGMA = 0.08


def make_case(seed, n=300, m=200, h=16, cin=16, cout=32, cpool=24):
    rng = np.random.default_rng(seed)
    s_points = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    q_points = rng.uniform(0, 1, (m, 3)).astype(np.float32)
    # neighbors close to their query, like a radius search, with shadows
    d = np.linalg.norm(q_points[:, None] - s_points[None], axis=-1)
    nbrs = np.argsort(d, axis=1)[:, :h].astype(np.int32)
    nbrs[rng.uniform(size=(m, h)) < 0.3] = n
    s_feats = rng.normal(size=(n, cin)).astype(np.float32)
    pool_feats = rng.normal(size=(n, cpool)).astype(np.float32)
    conv = JaxKPConv(cin, cout, 15, 0.1, SIGMA, use_bias=True)
    variables = conv.init(jax.random.PRNGKey(seed), jnp.asarray(s_feats), jnp.asarray(q_points),
                          jnp.asarray(s_points), jnp.asarray(nbrs))
    kp = np.array(variables["constants"]["kernel_points"])
    w = np.array(variables["params"]["weights"])
    bias = rng.normal(size=cout).astype(np.float32)
    variables = {"constants": variables["constants"],
                 "params": {"weights": jnp.asarray(w), "bias": jnp.asarray(bias)}}
    return dict(s_points=s_points, q_points=q_points, nbrs=nbrs, s_feats=s_feats,
                pool_feats=pool_feats, kp=kp, w=w, bias=bias, conv=conv, variables=variables)


def port_fused(c, **kw):
    t = torch.from_numpy
    return kpconv_fused(t(c["s_feats"]), t(c["q_points"]), t(c["s_points"]), t(c["nbrs"]),
                        t(c["kp"]), t(c["w"]), SIGMA, t(c["bias"]), **kw)


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_matches_jax_xla_kpconv(seed):
    c = make_case(seed)
    want = np.asarray(c["conv"].apply(
        c["variables"], jnp.asarray(c["s_feats"]), jnp.asarray(c["q_points"]),
        jnp.asarray(c["s_points"]), jnp.asarray(c["nbrs"])))
    got = port_fused(c).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("pool_cols", [None, 12])
def test_fused_pool_matches_jax_xla_maxpool(pool_cols):
    c = make_case(2)
    got_out, got_pool = port_fused(c, pool_feats=torch.from_numpy(c["pool_feats"]),
                                   pool_cols=pool_cols)
    want_pool = np.asarray(jax_maxpool(jnp.asarray(c["pool_feats"]), jnp.asarray(c["nbrs"]),
                                       valid_cols=pool_cols))
    np.testing.assert_array_equal(got_pool.numpy(), want_pool)  # max is exact
    np.testing.assert_allclose(got_out.numpy(), port_fused(c).numpy(), rtol=0, atol=0)


@pytest.mark.parametrize("with_pool", [False, True], ids=["conv", "conv_pool"])
def test_fused_matches_jax_pallas_interpret(with_pool):
    c = make_case(3)
    kw = {}
    if with_pool:
        kw = dict(pool_feats=c["pool_feats"], pool_cols=12)
    want = jax_kpconv_fused(
        jnp.asarray(c["s_feats"]), jnp.asarray(c["q_points"]), jnp.asarray(c["s_points"]),
        jnp.asarray(c["nbrs"]), jnp.asarray(c["kp"]), jnp.asarray(c["w"]), SIGMA,
        bias=jnp.asarray(c["bias"]), tile_m=64,
        **{k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()})
    got = port_fused(c, **{k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
                           for k, v in kw.items()})
    if with_pool:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=3e-2, atol=1e-2)
        got, want = got[0], want[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-2, atol=1e-2)


def test_fused_q_mask_zeroes_padding_queries():
    c = make_case(4)
    q_mask = np.ones(c["q_points"].shape[0], bool)
    q_mask[150:] = False
    got, pooled = port_fused(c, pool_feats=torch.from_numpy(c["pool_feats"]), pool_cols=12,
                             q_mask=torch.from_numpy(q_mask))
    full, full_pooled = port_fused(c, pool_feats=torch.from_numpy(c["pool_feats"]), pool_cols=12)
    np.testing.assert_array_equal(got[:150].numpy(), full[:150].numpy())
    np.testing.assert_array_equal(got[150:].numpy(), np.broadcast_to(c["bias"], (50, 32)))
    np.testing.assert_array_equal(pooled[150:].numpy(), 0.0)
    np.testing.assert_array_equal(pooled[:150].numpy(), full_pooled[:150].numpy())


def make_stream_case(seed, m=240, h=16, cout=64):
    rng = np.random.default_rng(seed)
    points = rng.uniform(0, 0.5, (m, 3)).astype(np.float32)
    d = np.linalg.norm(points[:, None] - points[None], axis=-1)
    nbrs = np.argsort(d, axis=1)[:, :h].astype(np.int32)
    nbrs[rng.uniform(size=(m, h)) < 0.2] = m
    nbrs[:, 0] = np.arange(m)
    feats = (rng.uniform(size=(m, 1)) > 0.1).astype(np.float32)
    stream = build_input_stream(points, feats, nbrs)
    conv = JaxKPConv(1, cout, 15, 0.1, SIGMA, use_bias=True)
    variables = conv.init(jax.random.PRNGKey(seed), jnp.asarray(feats), jnp.asarray(points),
                          jnp.asarray(points), jnp.asarray(nbrs))
    bias = rng.normal(size=cout).astype(np.float32)
    return dict(points=points, nbrs=nbrs, feats=feats, stream=stream, conv=conv,
                kp=np.array(variables["constants"]["kernel_points"]),
                w=np.array(variables["params"]["weights"]), bias=bias,
                variables={"constants": variables["constants"],
                           "params": {"weights": variables["params"]["weights"],
                                      "bias": jnp.asarray(bias)}})


@pytest.mark.parametrize("seed", [0, 1])
def test_stream_matches_jax(seed, monkeypatch):
    # The Pallas stream kernel at its f32 MXU precision point
    # (PrecisionConfig(kpconv_mxu="float32")): the default bf16 operands round
    # t1 @ W by up to 2^-9, beyond this bar when the other side is f32.
    monkeypatch.setattr(jax_kpconv_kernels, "MXU_DTYPE", jnp.float32)
    c = make_stream_case(seed)
    got = kpconv_stream_fused(torch.from_numpy(c["stream"]), torch.from_numpy(c["kp"]),
                              torch.from_numpy(c["w"]), SIGMA, torch.from_numpy(c["bias"]))
    want_xla = np.asarray(c["conv"].apply(
        c["variables"], jnp.asarray(c["feats"]), jnp.asarray(c["points"]),
        jnp.asarray(c["points"]), jnp.asarray(c["nbrs"])))
    np.testing.assert_allclose(got.numpy(), want_xla, rtol=1e-3, atol=1e-4)
    want_pallas = np.asarray(jax_kpconv_stream(
        jnp.asarray(c["stream"]), jnp.asarray(c["kp"]), jnp.asarray(c["w"]), SIGMA,
        bias=jnp.asarray(c["bias"]), tile_m=64))
    np.testing.assert_allclose(got.numpy(), want_pallas, rtol=1e-3, atol=1e-4)


def test_module_state_dict_and_stream_dispatch():
    c = make_stream_case(2, cout=32)
    conv = KPConv(1, 32, 15, 0.1, SIGMA, bias=True)
    assert sorted(conv.state_dict()) == ["bias", "kernel_points", "weights"]
    np.testing.assert_array_equal(conv.kernel_points.numpy(), c["kp"])
    with torch.no_grad():
        conv.weights.copy_(torch.from_numpy(c["w"][:, :, :32]))
        via_stream = conv(None, None, None, None, stream=torch.from_numpy(c["stream"]))
        via_table = conv(torch.from_numpy(c["feats"]), torch.from_numpy(c["points"]),
                         torch.from_numpy(c["points"]), torch.from_numpy(c["nbrs"]))
    np.testing.assert_allclose(via_stream.numpy(), via_table.numpy(), rtol=1e-5, atol=1e-6)


def test_force_true_on_cpu_raises():
    c = make_case(5, n=40, m=20)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_fused(c, force=True)
    # force=False is the plain version everywhere
    np.testing.assert_array_equal(port_fused(c, force=False).numpy(), port_fused(c).numpy())
