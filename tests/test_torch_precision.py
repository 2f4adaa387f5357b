"""The port's precision point (``PrecisionConfig``) against the JAX package's
at its default bfloat16 point, on the CPU.

The JAX kernels round to bfloat16 where ``kpconv_mxu``, ``gse_basis`` and
``gse_embed`` say (``geotransformer_tpu/kernels/kpconv.py:249-256,
269-273``, ``gse.py:171-172, 201-219, 283``); the port's plain versions round
at the same points (the CUDA kernels are held to them on the card:
``tests/test_torch_cuda.py``, ``chip_smoke.py``'s precision path). The JAX
globals are set with ``monkeypatch`` (never ``apply_precision``, which is
process-wide), and the JAX kernels run in interpret mode.

Tolerance (the per-kernel tests). Both sides round the same float32 values
to bfloat16 where their operands are computed the same way: points, kernel
points and reference vectors on binary grids make the JAX kernels' expanded
|a|^2 - 2 a.b + |b|^2 distances exact, like the port's direct ones, and the
GSE comparisons swap the JAX kernel's polynomial sin, cos and atan2 for
exact ones. What is left is the order of float32 sums, which can move a
value across a bfloat16 rounding boundary: then one operand of a term
differs by one bfloat16 ulp (at most 2^-7 of it). So each output lies
within 2^-7 S of the JAX one, S the sum over its terms of |a||b| on the
unrounded operands (plus the output's own value where the output is
stored in bfloat16), and at least 99 % of the outputs within 1e-5 S (the
rounding happens at the same points). The modules (a KPConv, the GSE, the
RPE attention) and the whole small-config forward at the JAX point against
the JAX modules and model with ``use_pallas`` / ``force_pallas=True``: the
bars stated at each test, from the runs. And: the float32 point computes
what the default arguments compute, bit for bit; gradients and the
training step refuse a bfloat16 point and ``kpconv_table="bfloat16"``;
``PrecisionConfig`` has the JAX fields and value names.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from geotransformer_tpu import configs as jax_configs
from geotransformer_tpu.kernels import attention as jax_attention
from geotransformer_tpu.kernels import gse as jax_gse
from geotransformer_tpu.kernels import kpconv as jax_kpconv
from geotransformer_tpu.models import create_model as create_jax_model
from geotransformer_tpu.models.kpconv import KPConv as JaxKPConv
from geotransformer_tpu.models.transformer import (
    GeometricStructureEmbedding as JaxGSE,
    RPEMultiHeadAttention as JaxRPEAttention,
)
from geotransformer_tpu.utils.convert import torch_state_dict_to_variables

from geotransformer_tpu_torch import configs as port_configs
from geotransformer_tpu_torch.kernels import attention as port_attention
from geotransformer_tpu_torch.kernels import gse as port_gse
from geotransformer_tpu_torch.kernels import kpconv as port_kpconv
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.models.kpconv import KPConv
from geotransformer_tpu_torch.models.transformer import (
    GeometricStructureEmbedding,
    RPEMultiHeadAttention,
)
from geotransformer_tpu_torch.parallel import make_optimizer, make_train_step
from geotransformer_tpu_torch.preprocess import (
    batch_to_torch,
    build_pyramid,
    build_split_tables,
    build_union_tables,
    pad_registration_batch,
)
from torch_routes import numpy_pyramids  # noqa: F401  (both packages on numpy)

BF16 = torch.bfloat16
SIGMA = 0.3
H100_BLOCK_BYTES = 232448  # a block's opt-in shared memory on an H100 (227 KB)


@pytest.fixture
def jax_point(monkeypatch):
    """The JAX kernels at their default point (bfloat16 operands, bases and
    embedding), set for this test only; the pair-score and fused-attention
    kernels off, as ``kernels/flags.py`` keeps them outside the tests (the
    tests' conftest turns them on): the RPE attention is then the XLA
    einsum, which promotes the bfloat16 embedding."""
    monkeypatch.setenv("GT_TPU_DISABLE_KERNELS", "pair_scores,fused_attention")
    monkeypatch.setattr(jax_kpconv, "MXU_DTYPE", jnp.bfloat16)
    monkeypatch.setattr(jax_kpconv, "TABLE_DTYPE", jnp.float32)
    monkeypatch.setattr(jax_gse, "BASIS_DTYPE", jnp.bfloat16)
    monkeypatch.setattr(jax_gse, "EMBED_DTYPE", jnp.bfloat16)


@pytest.fixture
def exact_trig(monkeypatch):
    """The JAX GSE kernel's polynomial sin, cos and atan2 (about 5e-3 and
    1e-7 from exact) swapped for exact ones, like the port's."""
    monkeypatch.setattr(jax_gse, "_fast_sincos", lambda x: (jnp.sin(x), jnp.cos(x)))
    monkeypatch.setattr(jax_gse, "_fast_atan2_nonneg", jnp.arctan2)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_flip_bars(got, want, scale, what):
    """Every output within 2^-7 ``scale`` (one bfloat16 ulp of one operand of
    a term, ``scale`` the output's sum of |a||b| over its terms), at least
    99 % within 1e-5 ``scale``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.broadcast_to(np.asarray(scale, np.float64), want.shape)
    diff = np.abs(got - want)
    assert got.shape == want.shape, what
    assert (diff <= 2.0**-7 * scale + 1e-30).all(), (
        f"{what}: max |diff| / scale {(diff / np.maximum(scale, 1e-30)).max():.3e}")
    close = (diff <= 1e-5 * scale + 1e-30).mean()
    assert close >= 0.99, f"{what}: {close:.4f} of the outputs within 1e-5 of their scale"


# ---- KPConv rows 1, 2, 5 and 7 -------------------------------------------

def grid(rng, shape, low, high, step=1 / 64):
    """Uniform values on a binary grid: distances between them, expanded or
    direct, are exact in float32."""
    return (np.round(rng.uniform(low, high, shape) / step) * step).astype(np.float32)


def random_table(rng, m, n, h):
    """(m, h) neighbor table, sentinel n, skewed valid counts."""
    table = np.full((m, h), n, np.int32)
    for i in range(m):
        count = rng.integers(0, h + 1)
        table[i, :count] = rng.choice(n, size=count, replace=False)
    return table


def conv_case(seed, c_in, c_out=24, m=96, n=120, h=24, k=15):
    rng = np.random.default_rng(seed)
    case = dict(
        q=grid(rng, (m, 3), 0, 1), s=grid(rng, (n, 3), 0, 1), kp=grid(rng, (k, 3), -0.3, 0.3),
        w=(rng.normal(size=(k, c_in, c_out)) * 0.2).astype(np.float32),
        bias=rng.normal(size=c_out).astype(np.float32),
        pool=rng.normal(size=(n, 6)).astype(np.float32), table=random_table(rng, m, n, h), n=n)
    if c_in == 1:  # the input features: 0 or 1, as the network input
        case["f"] = (rng.uniform(size=(n, 1)) > 0.2).astype(np.float32)
    else:
        case["f"] = rng.normal(size=(n, c_in)).astype(np.float32)
    return case


def conv_scale(c, table=None):
    """S of each output of the conv over ``table``: sum_{h, k, c}
    infl |f| |W| / count, on the unrounded operands."""
    table = c["table"] if table is None else table
    raw, count = port_kpconv.kpconv_fused_plain(
        t(np.abs(c["f"])), t(c["q"]), t(c["s"]), t(table), t(c["kp"]), t(np.abs(c["w"])), SIGMA,
        residuals=True, normalize=False)
    posflag = torch.from_numpy(c["f"]).sum(dim=1) > 0
    tab = torch.from_numpy(table).long()
    count = torch.where(tab < c["n"], posflag.float()[tab.clamp(max=c["n"] - 1)], 0.0).sum(1)
    return (raw / torch.clamp(count, min=1.0)[:, None]).numpy()


@pytest.mark.parametrize("c_in", [1, 32], ids=["c_in_1", "c_in_32"])
def test_row1_kpconv_fused_at_bf16_matches_jax(jax_point, c_in):
    c = conv_case(1, c_in)
    pool = dict(pool_feats=c["pool"], pool_cols=20)
    want = jax_kpconv.kpconv_fused(
        *map(jnp.asarray, (c["f"], c["q"], c["s"], c["table"], c["kp"], c["w"])), SIGMA,
        bias=jnp.asarray(c["bias"]), tile_m=32, interpret=True, pool_feats=jnp.asarray(c["pool"]),
        pool_cols=20)
    got = port_kpconv.kpconv_fused_plain(
        *map(t, (c["f"], c["q"], c["s"], c["table"], c["kp"], c["w"])), SIGMA, t(c["bias"]),
        pool_feats=t(pool["pool_feats"]), pool_cols=20, mxu_dtype=BF16)
    assert_flip_bars(got[0].numpy(), want[0], conv_scale(c), "row 1 out")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))  # the pool: exact
    # the rounding shows: the float32 point is farther from the JAX bfloat16 one
    f32 = port_kpconv.kpconv_fused_plain(
        *map(t, (c["f"], c["q"], c["s"], c["table"], c["kp"], c["w"])), SIGMA, t(c["bias"]))
    assert np.abs(f32.numpy() - np.asarray(want[0])).max() > 10 * np.abs(
        got[0].numpy() - np.asarray(want[0])).max()


@pytest.mark.parametrize("c_in", [1, 32], ids=["c_in_1", "c_in_32"])
def test_row5_kpconv_split_fused_at_bf16_matches_jax(jax_point, c_in):
    c = conv_case(2, c_in)
    h1 = 8
    m2_cap = int((c["table"][:, h1:] < c["n"]).any(1).sum()) + 8
    tail, tail_q, rank = build_split_tables(c["table"], c["n"], h1, m2_cap)
    head = np.ascontiguousarray(c["table"][:, :h1])
    # return_t1: at C_in = 1 the JAX split conv then rounds the whole t1 once,
    # as its input conv (kpconv_split_input_diff) always asks
    want = jax_kpconv.kpconv_split_fused(
        *map(jnp.asarray, (c["f"], c["q"], c["s"], head, tail, tail_q, rank, c["kp"], c["w"])),
        SIGMA, bias=jnp.asarray(c["bias"]), tile_m=32, interpret=True, return_t1=c_in == 1)[0]
    got = port_kpconv.kpconv_split_fused_plain(
        *map(t, (c["f"], c["q"], c["s"], head, tail, tail_q, rank, c["kp"], c["w"])), SIGMA,
        t(c["bias"]), mxu_dtype=BF16)
    assert_flip_bars(got.numpy(), want, conv_scale(c), "row 5 out")


def stream_case(seed, k, m=200, h=16, c_out=32):
    rng = np.random.default_rng(seed)
    stream = np.zeros((5, m, h), np.float32)
    valid = rng.uniform(size=(m, h)) < 0.8
    stream[:3] = np.where(valid, grid(rng, (3, m, h), -0.4, 0.4), 0.0)
    stream[4] = np.where(valid, (rng.uniform(size=(m, h)) > 0.2).astype(np.float32), 0.0)
    stream[3] = (stream[4] > 0).astype(np.float32)
    kp = grid(rng, (k, 3), -0.3, 0.3)
    w = (rng.normal(size=(k, 1, c_out)) * 0.3).astype(np.float32)
    return stream, kp, w, rng.normal(size=c_out).astype(np.float32)


@pytest.mark.parametrize("k", [15, 20], ids=["K15", "K20_chunked"])
def test_row2_kpconv_stream_fused_at_bf16_matches_jax(jax_point, k):
    stream, kp, w, bias = stream_case(3, k)
    want = jax_kpconv.kpconv_stream_fused(jnp.asarray(stream), jnp.asarray(kp), jnp.asarray(w),
                                          SIGMA, bias=jnp.asarray(bias), tile_m=64,
                                          interpret=True)
    got, t1, count = port_kpconv.kpconv_stream_fused_plain(t(stream), t(kp), t(w), SIGMA,
                                                           t(bias), residuals=True, mxu_dtype=BF16)
    scale = (t1.abs() @ t(np.abs(w[:, 0]))).numpy() / count.numpy()[:, None]
    assert_flip_bars(got.numpy(), want, scale, f"row 2 out, K = {k}")


@pytest.mark.parametrize("c_out", [24, 3712], ids=["shared_route", "global_route"])
def test_row7_kpconv_union_input_fused_at_bf16_matches_jax(jax_point, c_out):
    c = conv_case(4, 1, c_out=c_out, m=128, n=150, h=16)
    tile = 64
    rows, sel = build_union_tables(c["table"], c["n"], tile=tile, union_cap=512)
    route = port_kpconv.union_route(rows.shape[1], sel.shape[1], 15, c_out, H100_BLOCK_BYTES)
    assert route == ("global" if c_out > 1000 else "shared")
    want = jax_kpconv.kpconv_union_input_fused(
        *map(jnp.asarray, (c["f"], c["q"], c["s"], rows, sel, c["kp"], c["w"])), SIGMA,
        bias=jnp.asarray(c["bias"]), tile_m=tile, interpret=True)
    got = port_kpconv.kpconv_union_input_fused_plain(
        *map(t, (c["f"], c["q"], c["s"], rows, sel, c["kp"], c["w"])), SIGMA, t(c["bias"]),
        tile=tile, mxu_dtype=BF16)
    assert_flip_bars(got.numpy(), want, conv_scale(c), f"row 7 out, D = {c_out}")


# ---- GSE row 3 and pair scores row 12 --------------------------------------

GSE_N, GSE_VALID = 36, 31


def gse_case(c, a, seed=0):
    rng = np.random.default_rng(seed + c + 100 * a)
    points = grid(rng, (GSE_N, 3), 0, 1, step=1 / 256)
    ref_vectors = grid(rng, (GSE_N, a, 3), -0.3, 0.3, step=1 / 256)
    bound = 1.0 / np.sqrt(c)
    w_d, w_a = (rng.uniform(-bound, bound, (c, c)).astype(np.float32) for _ in range(2))
    b_d, b_a = (rng.normal(size=c).astype(np.float32) for _ in range(2))
    return points, ref_vectors, w_d, b_d, w_a, b_a


def gse_scale(points, ref_vectors, w_d, b_d, w_a, b_a, out):
    """S of each embedding entry: the |basis| |W| sums of the distance and
    of every angle projection, |b_d + b_a|, and |out| itself (the bfloat16
    store's own rounding)."""
    tp = list(map(t, (points, ref_vectors, w_d, b_d, w_a, b_a)))
    hidden = w_d.shape[0]
    d_idx, a_idx = port_gse._pair_indices(tp[0], tp[1], 0.2, 15.0)
    from geotransformer_tpu_torch.ops.embedding import sinusoidal_embedding
    s = sinusoidal_embedding(d_idx, hidden).abs() @ tp[2].abs()
    s = s + (sinusoidal_embedding(a_idx, hidden).abs() @ tp[4].abs()).sum(dim=2)
    return s.numpy() + np.abs(b_d + b_a) + np.abs(np.asarray(out, np.float32))


@pytest.mark.parametrize("c, a", [(32, 3), (48, 5), (256, 3)])
def test_row3_gse_at_bf16_matches_jax(jax_point, exact_trig, c, a):
    case = gse_case(c, a)
    want = jax_gse.gse_embedding_full(*map(jnp.asarray, case), c, 0.2, 15.0, interpret=True,
                                      n_valid=GSE_VALID)
    assert want.dtype == jnp.bfloat16
    got = port_gse.gse_embedding_full_plain(*map(t, case), 0.2, 15.0,
                                            torch.tensor(GSE_VALID, dtype=torch.int32),
                                            basis_dtype=BF16, embed_dtype=BF16)
    assert got.dtype == BF16
    v = GSE_VALID
    got, want = got.float().numpy(), np.asarray(want.astype(jnp.float32))
    assert_flip_bars(got[:v, :v], want[:v, :v], gse_scale(*case, want)[:v, :v],
                     f"row 3, C = {c}, A = {a}")
    assert not got[v:].any() and not got[:, v:].any()


def test_row3_gse_at_bf16_with_the_jax_polynomials(jax_point):
    """The JAX kernel as it is (polynomial sin, cos, atan2): within the
    5e-3 of tests/test_torch_gse_widths.py, plus a bfloat16 ulp of the
    output (2^-8 of values up to ~6)."""
    case = gse_case(64, 3, seed=1)
    want = np.asarray(jax_gse.gse_embedding_full(*map(jnp.asarray, case), 64, 0.2, 15.0,
                                                 interpret=True, n_valid=GSE_VALID)
                      .astype(jnp.float32))
    got = port_gse.gse_embedding_full_plain(*map(t, case), 0.2, 15.0,
                                            torch.tensor(GSE_VALID, dtype=torch.int32),
                                            basis_dtype=BF16, embed_dtype=BF16).float().numpy()
    v = GSE_VALID
    np.testing.assert_allclose(got[:v, :v], want[:v, :v], rtol=2.0**-7, atol=5e-3)
    assert not got[v:].any() and not got[:, v:].any()


def test_row12_pair_scores_on_a_bf16_embedding_matches_jax(monkeypatch):
    """The pair scores read the bfloat16 embedding widened and qw in
    float32, as the JAX model's XLA einsum (its pair-score kernel is off,
    ``kernels/flags.py``) and the JAX Pallas kernel with its operand dtype
    at float32 do."""
    monkeypatch.setattr(jax_attention, "MXU_DTYPE", jnp.float32)
    rng = np.random.default_rng(12)
    n, h, c, nv = 40, 4, 64, 33
    embed = torch.from_numpy(rng.normal(size=(n, n, c)).astype(np.float32)).to(BF16)
    qw = rng.normal(size=(n, h, c)).astype(np.float32)
    got = port_attention.rpe_pair_scores_plain(embed, t(qw), nv, nv).numpy()
    e32 = embed.float().numpy()
    want = np.asarray(jax_attention.rpe_pair_scores(jnp.asarray(e32).astype(jnp.bfloat16),
                                                    jnp.asarray(qw), jnp.int32(nv),
                                                    jnp.int32(nv), interpret=True))
    einsum = np.asarray(jnp.einsum("nmc,nhc->nhm", jnp.asarray(e32).astype(jnp.bfloat16),
                                   jnp.asarray(qw)))
    scale = np.einsum("nmc,nhc->nhm", np.abs(e32), np.abs(qw))[:nv, :, :nv]
    # on the valid rectangle: past it the JAX kernel zeroes whole tiles only
    assert_flip_bars(got[:nv, :, :nv], want[:nv, :, :nv], scale, "row 12 vs the Pallas kernel")
    assert_flip_bars(got[:nv, :, :nv], einsum[:nv, :, :nv], scale, "row 12 vs the XLA einsum")
    assert not got[nv:].any() and not got[:, :, nv:].any()


# ---- the float32 point is the default, bit for bit -------------------------

def test_float32_point_is_the_default_bit_for_bit():
    c = conv_case(5, 16)
    args = list(map(t, (c["f"], c["q"], c["s"], c["table"], c["kp"], c["w"])))
    f32 = torch.float32
    for got, want in (
            (port_kpconv.kpconv_fused_plain(*args, SIGMA, mxu_dtype=f32),
             port_kpconv.kpconv_fused_plain(*args, SIGMA)),
            (port_kpconv.kpconv_fused(*args, SIGMA, mxu_dtype=f32),
             port_kpconv.kpconv_fused(*args, SIGMA))):
        assert torch.equal(got, want)
    stream, kp, w, bias = stream_case(6, 15)
    assert torch.equal(
        port_kpconv.kpconv_stream_fused(t(stream), t(kp), t(w), SIGMA, t(bias), mxu_dtype=f32),
        port_kpconv.kpconv_stream_fused(t(stream), t(kp), t(w), SIGMA, t(bias)))
    case = list(map(t, gse_case(32, 3)))
    nv = torch.tensor(GSE_VALID, dtype=torch.int32)
    got = port_gse.gse_embedding_full(*case, 0.2, 15.0, nv, basis_dtype=f32, embed_dtype=f32)
    assert got.dtype == f32 and torch.equal(got, port_gse.gse_embedding_full(*case, 0.2, 15.0, nv))
    # the rounding helper is the identity at float32
    x = torch.randn(5)
    assert port_kpconv.cuda.round_to(x, f32) is x


# ---- the modules -----------------------------------------------------------

def test_kpconv_module_at_bf16_matches_jax_pallas_module(jax_point):
    """A ResidualBlock-width KPConv (C_in 32 -> 32) as modules: the JAX
    ``KPConv(use_pallas=True)`` against the port's ``KPConv`` at
    ``kpconv_mxu="bfloat16"``, the same weights and grid kernel points:
    the flip bars."""
    c = conv_case(7, 32, c_out=32)
    jax_conv = JaxKPConv(32, 32, 15, 0.3, SIGMA, use_bias=True, use_pallas=True)
    variables = {"constants": {"kernel_points": jnp.asarray(c["kp"])},
                 "params": {"weights": jnp.asarray(c["w"]), "bias": jnp.asarray(c["bias"])}}
    want = jax_conv.apply(variables, *map(jnp.asarray, (c["f"], c["q"], c["s"], c["table"])))
    port = KPConv(32, 32, 15, 0.3, SIGMA, bias=True, mxu_dtype=BF16)
    with torch.no_grad():
        port.weights.copy_(t(c["w"]))
        port.bias.copy_(t(c["bias"]))
        port.kernel_points.copy_(t(c["kp"]))
        got = port(*map(t, (c["f"], c["q"], c["s"], c["table"])))
    assert_flip_bars(got.numpy(), want, conv_scale(c), "KPConv module")


def test_gse_module_at_bf16_matches_jax_pallas_module(jax_point, exact_trig):
    """The GSE modules (k-NN reference vectors in each, then the fused
    kernel): the JAX ``GeometricStructureEmbedding(use_pallas=True)`` against
    the port's at the bfloat16 basis and embedding point, on the valid
    rectangle: the flip bars over the terms of each entry."""
    rng = np.random.default_rng(8)
    c, k, n, nv = 32, 3, 40, 34
    points = grid(rng, (1, n, 3), 0, 1, step=1 / 256)
    masks = np.arange(n)[None] < nv
    params = {name: {"kernel": (rng.normal(size=(c, c)) / np.sqrt(c)).astype(np.float32),
                     "bias": rng.normal(size=c).astype(np.float32)}
              for name in ("proj_d", "proj_a")}
    jax_module = JaxGSE(c, 0.2, 15.0, k, use_pallas=True)
    want = np.asarray(jax_module.apply({"params": params}, jnp.asarray(points),
                                       jnp.asarray(masks)).astype(jnp.float32))
    port = GeometricStructureEmbedding(c, 0.2, 15.0, k, basis_dtype=BF16, embed_dtype=BF16)
    with torch.no_grad():
        for name in ("proj_d", "proj_a"):
            getattr(port, name).weight.copy_(t(params[name]["kernel"].T))
            getattr(port, name).bias.copy_(t(params[name]["bias"]))
        got = port(t(points), t(masks))
        ref_vectors = port.reference_vectors(t(points), t(masks))[0].numpy()
    assert got.dtype == BF16
    scale = gse_scale(points[0], ref_vectors, params["proj_d"]["kernel"], params["proj_d"]["bias"],
                      params["proj_a"]["kernel"], params["proj_a"]["bias"], want[0])
    assert_flip_bars(got.float().numpy()[0, :nv, :nv], want[0, :nv, :nv], scale[:nv, :nv],
                     "GSE module")


def test_rpe_attention_module_on_a_bf16_embedding_matches_jax(jax_point):
    """The RPE attention on a bfloat16 embedding: the JAX
    ``RPEMultiHeadAttention(use_pallas=True)`` (its fused kernels are off by
    ``kernels/flags.py``: the XLA einsum, which promotes the embedding)
    against the port's on the CPU (the plain versions of its kernel route),
    on the valid rows: within 1e-5 of the largest output (float32 sums in
    another order, the q . b_p shift the port drops)."""
    rng = np.random.default_rng(9)
    d, heads, n, nv = 32, 2, 24, 20
    feats = rng.normal(size=(1, n, d)).astype(np.float32)
    embed = torch.from_numpy(rng.normal(size=(1, n, n, d)).astype(np.float32)).to(BF16)
    masks = np.arange(n)[None] < nv
    names = ("proj_q", "proj_k", "proj_v", "proj_p")
    params = {name: {"kernel": (rng.normal(size=(d, d)) / np.sqrt(d)).astype(np.float32),
                     "bias": rng.normal(size=d).astype(np.float32)} for name in names}
    jax_module = JaxRPEAttention(d, heads, use_pallas=True)
    e_jax = jnp.asarray(embed.float().numpy()).astype(jnp.bfloat16)
    with jax.default_matmul_precision("highest"):  # the XLA einsums in float32
        want, _ = jax_module.apply({"params": params}, *[jnp.asarray(feats)] * 3, e_jax,
                                   key_masks=jnp.asarray(masks))
    port = RPEMultiHeadAttention(d, heads)
    with torch.no_grad():
        for name in names:
            getattr(port, name).weight.copy_(t(params[name]["kernel"].T))
            getattr(port, name).bias.copy_(t(params[name]["bias"]))
        got = port(*[t(feats)] * 3, embed, key_masks=t(masks))
    want = np.asarray(want)[0, :nv]
    np.testing.assert_allclose(got.numpy()[0, :nv], want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---- the whole slice -------------------------------------------------------

def small_pair(seed=11, n=600):
    """The JAX Pallas model test's pair generator (tests/test_pallas_model_consistency.py)
    at 600 points."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    z = 0.15 * np.sin(6 * xy[:, 0]) * np.cos(5 * xy[:, 1])
    ref = np.column_stack([xy, z]).astype(np.float32)
    src = ref[ref[:, 0] < 0.75] + 0.003 * rng.normal(size=(np.sum(ref[:, 0] < 0.75), 3))
    return np.concatenate([ref, src.astype(np.float32)], 0), np.asarray([len(ref), len(src)])


def test_small_config_forward_at_the_jax_point_matches_jax_pallas_model(jax_point):
    """The port's model at the JAX point (``port_configs.JAX_PRECISION``) on
    the CPU against the JAX model with ``force_pallas=True`` in interpret
    mode at its default point, at ``__graft_entry__._small_config`` (full
    widths, caps (2048, 640, 192, 64); a 600-point cloud and its 75 %
    overlap), the port's seeded weights in both: the coarse and the fine
    features within 2e-3 of their largest magnitude (the run: 4.2e-4 to
    1.1e-3; the roundings that flip on float32 noise, through four stages
    and the attention blocks) and within half the distance of the port's
    float32 point from the JAX one (the run: 1.5e-3 to 6.5e-3), so the
    rounding points agree."""
    jax_cfg = __graft_entry__._small_config()
    port_cfg = dataclasses.replace(
        port_configs.make_3dmatch_config().with_caps(
            stage_caps=jax_cfg.caps.stage_caps, correspondence_capacity=2048, gt_candidates=32),
        precision=port_configs.JAX_PRECISION)
    points, lengths = small_pair()
    bb = port_cfg.backbone
    pyramid = build_pyramid(points, lengths, bb.num_stages, bb.init_voxel_size, bb.init_radius,
                            list(port_cfg.caps.neighbor_limits))
    batch = pad_registration_batch(pyramid, np.ones((points.shape[0], 1), np.float32),
                                   np.eye(4, dtype=np.float32), port_cfg.caps.stage_caps)
    batch_j = jax.tree.map(jnp.asarray, batch)
    port = create_model(port_cfg, device="cpu")
    jax_model = create_jax_model(jax_cfg.with_model(force_pallas=True))
    shapes = jax.eval_shape(lambda r, b: jax_model.init(r, b, training=False, with_gt=False),
                            jax.random.PRNGKey(0), batch_j)
    variables, unused = torch_state_dict_to_variables(
        port.state_dict(), jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), shapes))
    assert not unused
    with jax.default_matmul_precision("highest"):  # XLA's float32 products in float32
        # jitted: the interpret-mode kernels run op by op otherwise
        out_j = jax.jit(lambda v, b: jax_model.apply(v, b, training=False, with_gt=False))(
            variables, batch_j)
    batch_t = batch_to_torch(batch, "cpu")
    out_t = port(batch_t)
    f32_port = create_model(dataclasses.replace(port_cfg, precision=port_configs.PrecisionConfig()),
                            device="cpu")
    f32_port.load_state_dict(port.state_dict())
    out_f32 = f32_port(batch_t)
    for key, mask in (("ref_feats_c", "ref_masks_c"), ("src_feats_c", "src_masks_c"),
                      ("ref_feats_f", "ref_masks_f"), ("src_feats_f", "src_masks_f")):
        rows = out_t[mask].numpy()
        want = np.asarray(out_j[key])[rows]
        rel = np.abs(out_t[key].numpy()[rows] - want).max() / np.abs(want).max()
        rel_f32 = np.abs(out_f32[key].numpy()[rows] - want).max() / np.abs(want).max()
        assert rel <= 2e-3 and rel <= rel_f32 / 2, f"{key}: {rel:.3e} (float32 {rel_f32:.3e})"
    assert torch.isfinite(out_t["estimated_transform"]).all()


# ---- what is refused -------------------------------------------------------

def test_gradients_and_the_training_step_refuse_a_bf16_point():
    c = conv_case(10, 8)
    tables = list(map(t, (c["q"], c["s"], c["table"])))
    stream, _, _, _ = stream_case(11, 15)
    # a KPConv at a bfloat16 point refuses a gradient-enabled forward on
    # every table it reads (the *_diff forms it would take compute float32)
    for c_in, kw in ((8, {}), (1, {}), (1, dict(stream=t(stream)))):
        conv = KPConv(c_in, 24, 15, 1.0, SIGMA, mxu_dtype=BF16)
        feats = t(c["f"])[:, :c_in]
        with pytest.raises(NotImplementedError, match="kpconv_mxu"):
            conv(feats, *tables, **kw)
        with torch.no_grad():
            assert torch.isfinite(conv(feats, *tables, **kw)).all()
    case = list(map(t, gse_case(32, 3)))
    with pytest.raises(NotImplementedError, match="gse_basis"):
        port_gse.gse_embedding_full_diff(*case, 0.2, 15.0, embed_dtype=BF16)
    with pytest.raises(NotImplementedError, match="bfloat16 embedding"):
        port_attention.rpe_pair_scores_diff(torch.zeros(4, 4, 8, dtype=BF16), torch.zeros(4, 2, 8))
    # a model at the JAX point refuses a gradient-enabled forward and the step
    cfg = dataclasses.replace(port_configs.make_3dmatch_config(),
                              precision=port_configs.JAX_PRECISION)
    model = create_model(cfg, device="cpu")
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=1)
    with pytest.raises(NotImplementedError, match="training at"):
        make_train_step(model, cfg, optimizer, scheduler, device="cpu")
    conv = model.backbone.encoder1_2.KPConv
    x = torch.zeros(c["n"], conv.weights.shape[1])
    with pytest.raises(NotImplementedError, match="kpconv_mxu"):
        conv(x, t(c["q"]), t(c["s"]), t(c["table"]))  # gradients are on


def test_bf16_tables_are_refused():
    cfg = dataclasses.replace(port_configs.make_3dmatch_config(),
                              precision=port_configs.PrecisionConfig(kpconv_table="bfloat16"))
    with pytest.raises(NotImplementedError, match="kpconv_table"):
        create_model(cfg, device="cpu")
    with pytest.raises(ValueError, match="float16"):
        port_configs.PrecisionConfig(gse_embed="float16")


def test_precision_config_has_the_jax_fields_and_value_names():
    port_fields = [f.name for f in dataclasses.fields(port_configs.PrecisionConfig)]
    jax_fields = [f.name for f in dataclasses.fields(jax_configs.PrecisionConfig)]
    assert port_fields == jax_fields == list(port_configs.PRECISION_KNOBS)
    # the JAX defaults are the port's JAX_PRECISION, and every value name
    # apply_precision takes is one the port takes
    assert dataclasses.asdict(jax_configs.PrecisionConfig()) == dataclasses.asdict(
        port_configs.JAX_PRECISION)
    for name in port_configs.DTYPE_NAMES:
        jax_configs.PrecisionConfig(**{f: name for f in jax_fields})  # constructs
        point = port_configs.PrecisionConfig(**{f: name for f in port_fields})
        assert {port_configs.knob_dtype(point, f) for f in port_fields} == {
            {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]}
    # the port's one stated difference: float32 throughout by default
    assert port_configs.is_float32_point(port_configs.PrecisionConfig())
    assert port_configs.make_3dmatch_config().precision == port_configs.PrecisionConfig()
