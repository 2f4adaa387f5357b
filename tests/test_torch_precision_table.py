"""The bfloat16 gathered table (``PrecisionConfig.kpconv_table``) on the
CPU against the JAX package at ``TABLE_DTYPE`` bfloat16: the coordinate
split is exact; rows 1 and 5 round each gathered feature and pool value
(the output by the flip bars of ``tests/test_torch_precision.py``, the
pooled max, its ties and the count bit for bit); the scatter backward
reads the rounded features (1e-5 of each gradient's largest entry); a
batch padded at the table point equals the JAX batch. Row 6's pool
gradient at this point: ``tests/test_torch_precision_train.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels import kpconv as jax_kpconv
from geotransformer_tpu.preprocess import calibrate as jax_calibrate
from geotransformer_tpu.preprocess import pyramid as jax_pyramid

from geotransformer_tpu_torch import configs as port_configs
from geotransformer_tpu_torch.kernels import kpconv as port_kpconv
from geotransformer_tpu_torch.preprocess import (
    build_pyramid,
    build_split_tables,
    calibrate_split_specs,
    caps_for_pyramid,
    pad_registration_batch,
    table_align,
)
from test_torch_model import make_pair, narrow_config
from test_torch_precision import (  # noqa: F401  (fixtures)
    BF16,
    SIGMA,
    assert_flip_bars,
    conv_case,
    jax_point,
    t,
)
from torch_routes import jax_precision_kept, numpy_pyramids  # noqa: F401

F32 = torch.float32
TABLE_POINT = port_configs.PrecisionConfig(kpconv_table="bfloat16")


@pytest.fixture
def jax_table_point(jax_point, monkeypatch):
    """The JAX point with bfloat16 gathered tables as well (all four knobs)."""
    monkeypatch.setattr(jax_kpconv, "TABLE_DTYPE", jnp.bfloat16)


def test_the_table_coordinate_split_is_exact():
    """The JAX bfloat16 table stores each coordinate as hi + mid + lo, each
    a bfloat16 value (``kernels/kpconv.py:349-353``), and the kernel adds
    them in float32 (:196-199): the sum is the float32 coordinate bit for
    bit, for random float32 values of magnitude 2^-100 to 2^127 (below it
    the residuals are subnormal, which XLA flushes to zero; above it hi
    rounds to infinity; no coordinate of a scan but 0 lies outside) and
    coordinates in
    [-100, 100], so the port's table point keeps reading float32
    coordinates."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2**32, size=1_000_000, dtype=np.uint64).astype(np.uint32)
    values = bits.view(np.float32)
    values = values[(np.abs(values) >= 2.0**-100) & (np.abs(values) <= 2.0**127)]
    values = np.concatenate([values, np.zeros(1, np.float32)])
    coords = rng.uniform(-100, 100, size=600_000).astype(np.float32)
    for x in (values, coords):
        xj = jnp.asarray(x)
        hi = xj.astype(jnp.bfloat16).astype(jnp.float32)
        mid = (xj - hi).astype(jnp.bfloat16).astype(jnp.float32)
        lo = (xj - hi - mid).astype(jnp.bfloat16).astype(jnp.float32)
        assert np.array_equal(np.asarray((hi + mid) + lo), x)


def table_case(seed, c_in=16, c_out=24, c_pool=12):
    """A conv whose features and pool features round: normal values."""
    c = conv_case(seed, c_in, c_out=c_out)
    c["pool"] = np.random.default_rng(seed + 7).normal(size=(c["n"], c_pool)).astype(np.float32)
    return c


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
def test_table_point_forward_matches_jax(jax_table_point, monkeypatch, mxu):
    """Rows 1 and 5 at kpconv_table="bfloat16": each gathered feature and
    pool value rounded, the count from the float32 feature sums; the
    output by the flip bars, the pooled max, its tie counts and the count
    bit for bit with the JAX kernel's (``_kpconv_pool_inv_fwd``,
    ``_split_pool_ties``); a table whose features are bfloat16 values
    gives the float32 table's output (the coordinates stay exact)."""
    if mxu == "float32":
        monkeypatch.setattr(jax_kpconv, "MXU_DTYPE", jnp.float32)
    point = dict(mxu_dtype=F32 if mxu == "float32" else BF16, table_dtype=BF16)
    c = table_case(31)
    j = lambda *xs: list(map(jnp.asarray, xs))  # noqa: E731
    (out_j, pooled_j), res = jax_kpconv._kpconv_pool_inv_fwd(
        *j(c["f"], c["pool"], c["q"], c["s"], c["table"]), None, *j(c["kp"], c["w"]), SIGMA,
        jnp.asarray(c["bias"]), 32, 20)
    count_j, ties_j = res[4], res[10]
    got = port_kpconv.kpconv_fused_plain(
        *map(t, (c["f"], c["q"], c["s"], c["table"], c["kp"], c["w"])), SIGMA, t(c["bias"]),
        pool_feats=t(c["pool"]), pool_cols=20, residuals=True, **point)
    scale = np.abs(port_kpconv.kpconv_fused_plain(
        *map(t, (np.abs(c["f"]), c["q"], c["s"], c["table"], c["kp"], np.abs(c["w"]))), SIGMA,
        normalize=False)[0].numpy()) / np.maximum(got[2].numpy(), 1.0)[:, None]
    assert_flip_bars(got[0].numpy() - c["bias"], np.asarray(out_j) - c["bias"], scale,
                     "table point out")
    for name, a, b in (("pooled", got[1], pooled_j), ("count", got[2], count_j),
                       ("ties", got[3], ties_j)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)

    # row 5 over the split table
    h1 = 8
    m2_cap = int((c["table"][:, h1:] < c["n"]).any(1).sum()) + 8
    tail, tail_q, rank = build_split_tables(c["table"], c["n"], h1, m2_cap)
    head = np.ascontiguousarray(c["table"][:, :h1])
    (out_sj, pooled_sj), res_s = jax_kpconv._kpconv_split_pool_fwd(
        *j(c["f"], c["pool"], c["q"], c["s"], head, tail, tail_q, rank), None,
        *j(c["kp"], c["w"]), SIGMA, jnp.asarray(c["bias"]), 32, 20)
    got_s = port_kpconv.kpconv_split_fused_plain(
        *map(t, (c["f"], c["q"], c["s"], head, tail, tail_q, rank, c["kp"], c["w"])), SIGMA,
        t(c["bias"]), pool_feats=t(c["pool"]), pool_cols=20, residuals=True, **point)
    assert_flip_bars(got_s[0].numpy() - c["bias"], np.asarray(out_sj) - c["bias"], scale,
                     "table point split out")
    for name, a, b in (("pooled", got_s[1], pooled_sj), ("count", got_s[2], res_s[4]),
                       ("ties", got_s[3], res_s[12])):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)

    # bfloat16-valued features: the table point's output is the float32 table's
    fb = torch.from_numpy(c["f"]).to(BF16).float().numpy()
    at_bf16 = jax_kpconv.kpconv_fused(*j(fb, c["q"], c["s"], c["table"], c["kp"], c["w"]), SIGMA,
                                      tile_m=32, interpret=True)
    monkeypatch.setattr(jax_kpconv, "TABLE_DTYPE", jnp.float32)
    at_f32 = jax_kpconv.kpconv_fused(*j(fb, c["q"], c["s"], c["table"], c["kp"], c["w"]), SIGMA,
                                     tile_m=32, interpret=True)
    np.testing.assert_array_equal(np.asarray(at_bf16), np.asarray(at_f32))


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
def test_table_point_scatter_backward_matches_jax(jax_table_point, monkeypatch, split):
    """The backward without inverse tables at kpconv_table="bfloat16" (the
    JAX XLA rules in float32 over the gathered block: dW from the rounded
    features, the pool gradient over the rounded pool values' ties) against
    ``jax.vjp`` of ``kpconv_pool_fused_diff`` / ``kpconv_split_pool_diff``:
    1e-5 of each gradient's largest entry. The forward at kpconv_mxu
    float32, so nothing else rounds."""
    monkeypatch.setattr(jax_kpconv, "MXU_DTYPE", jnp.float32)
    c = table_case(32)
    rng = np.random.default_rng(33)
    dout = rng.normal(size=(96, 24)).astype(np.float32)
    dpool = rng.normal(size=(96, 12)).astype(np.float32)
    h1 = 8
    if split:
        m2_cap = int((c["table"][:, h1:] < c["n"]).any(1).sum()) + 8
        tail, tail_q, rank = build_split_tables(c["table"], c["n"], h1, m2_cap)
        head = np.ascontiguousarray(c["table"][:, :h1])

        def fwd_j(f, p, w):
            return jax_kpconv.kpconv_split_pool_diff(
                f, p, *map(jnp.asarray, (c["q"], c["s"], head, tail, tail_q, rank)), None,
                jnp.asarray(c["kp"]), w, SIGMA, None, 32, 20)

        def fwd_t(f, p, w):
            return port_kpconv.kpconv_split_pool_scatter_diff(
                f, p, t(c["q"]), t(c["s"]), t(head), tuple(map(t, (tail, tail_q, rank))),
                t(c["kp"]), w, SIGMA, pool_cols=20, table_dtype=BF16)
    else:
        def fwd_j(f, p, w):
            return jax_kpconv.kpconv_pool_fused_diff(
                f, p, *map(jnp.asarray, (c["q"], c["s"], c["table"], c["kp"])), w, SIGMA, None,
                32, 20)

        def fwd_t(f, p, w):
            return port_kpconv.kpconv_pool_fused_diff(
                f, p, t(c["q"]), t(c["s"]), t(c["table"]), t(c["kp"]), w, SIGMA, pool_cols=20,
                table_dtype=BF16)
    inputs = (c["f"], c["pool"], c["w"])
    _, vjp = jax.vjp(fwd_j, *map(jnp.asarray, inputs))
    want = vjp((jnp.asarray(dout), jnp.asarray(dpool)))
    leaves = [t(x).requires_grad_() for x in inputs]
    out, pooled = fwd_t(*leaves)
    torch.autograd.backward((out, pooled), (t(dout), t(dpool)))
    for name, leaf, w in zip(("d_s", "d_pool", "dW"), leaves, want):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_table_point_batch_equals_the_jax_batch(monkeypatch):
    """A batch the port pads at kpconv_table="bfloat16" (``table_align``:
    16 columns) equals the JAX batch built at that point (its
    ``table_align`` follows ``TABLE_DTYPE``), key by key, shape and content,
    with inverse, split and split-inverse tables; the split specs
    calibrated at that alignment equal the JAX calibration's."""
    monkeypatch.setattr(jax_kpconv, "TABLE_DTYPE", jnp.bfloat16)
    assert table_align(TABLE_POINT) == jax_pyramid.table_align() == 16
    assert table_align(port_configs.PrecisionConfig()) == 8
    cfg = narrow_config()
    ref, src, transform = make_pair(17)
    points = np.concatenate([ref, src], 0)
    lengths = np.asarray([len(ref), len(src)])
    bb = cfg.backbone
    limits = list(cfg.caps.neighbor_limits)
    pyramid = build_pyramid(points, lengths, bb.num_stages, bb.init_voxel_size, bb.init_radius,
                            limits)
    caps = tuple(caps_for_pyramid(pyramid, multiple=32, per_cloud=True))
    sample = [{"ref_points": ref, "src_points": src}]
    args = (bb.num_stages, bb.init_voxel_size, bb.init_radius, limits)
    specs = calibrate_split_specs(iter(sample), *args, num_samples=1, multiple=32,
                                  align=table_align(TABLE_POINT))
    specs_j = jax_calibrate.calibrate_split_specs(iter(sample), *args, num_samples=1, multiple=32)
    assert specs == tuple(map(list, specs_j)) or list(specs) == list(specs_j)
    rows = sum(caps[0])
    kw = dict(inverse_limits=(24, 24, 24, 24), neighbor_splits=[(8, rows)] + [None] * 3,
              subsampling_splits=[(8, sum(caps[1]))] + [None] * 2,
              inverse_splits=[(8, rows)] + [None] * 3)
    feats = np.ones((points.shape[0], 1), np.float32)
    port = pad_registration_batch(pyramid, feats, transform, caps, align=16, **kw)
    jax_batch = jax_pyramid.pad_registration_batch(pyramid, feats, transform, caps, **kw)
    assert port["neighbors"][0].shape[1] % 16 == 0 and port["neighbors"][0].shape[1] > 12
    flat_p, tree_p = jax.tree.flatten(port, is_leaf=lambda x: x is None)
    flat_j, tree_j = jax.tree.flatten(jax.tree.map(np.asarray, jax_batch),
                                      is_leaf=lambda x: x is None)
    assert sorted(port) == sorted(jax_batch)
    assert len(flat_p) == len(flat_j)
    for a, b in zip(flat_p, flat_j):
        if a is None or b is None:
            assert a is None and b is None
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
