"""The port's plain versions against the JAX kernels at shapes past the card
kernels' register and vector instances, on the CPU, and each wrapper's
choice of instance as a plain function.

The JAX kernels size their blocks from the shapes; the port's CUDA kernels
compute at the same shapes (general instances, held to these plain
versions on the card by tests/test_torch_cuda.py). Same numpy inputs, from
a seed, through both packages:
  * the Sinkhorn forward, training forward and backward at 300 x 260 patches
    (past the forward's 256 and the backward's 160), P = 2, 4 iterations,
    against the Pallas kernels in interpret mode: 1e-4 + 1e-4 |ref| on valid
    entries, as chip_smoke.py holds the kernels to their plain versions;
  * rpe_pair_scores at C = 130 and 640 with H = 12, against the Pallas kernel
    in interpret mode on bf16-exact inputs (its bf16 operands are then
    exact, only the f32 sums' order differs): 1e-5 x max|ref|;
  * fused_masked_attention at dh = 48 against the JAX f32 XLA reference
    (``_xla_attention_ref``) at 1e-5 x max|ref|, and against the Pallas
    kernel in interpret mode at the JAX tests' 2e-2 (its bf16 probabilities);
  * the stream input conv at K = 20 kernel points against the Pallas stream
    kernel at its f32 MXU point: rtol 1e-4 and 1e-5 x max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels import attention as jax_attention
from geotransformer_tpu.kernels import kpconv as jax_kpconv_kernels
from geotransformer_tpu.kernels.sinkhorn import sinkhorn_log_iterations as jax_sinkhorn
from geotransformer_tpu.kernels.sinkhorn import (
    sinkhorn_log_iterations_train as jax_sinkhorn_train,
)
from geotransformer_tpu.preprocess.pyramid import build_input_stream

from geotransformer_tpu_torch.kernels.attention import (
    attention_route,
    fused_masked_attention,
    pair_scores_route,
    rpe_pair_scores,
)
from geotransformer_tpu_torch.kernels.kpconv import input_conv_variant, kpconv_stream_fused
from geotransformer_tpu_torch.kernels.sinkhorn import (
    Route,
    backward_route,
    forward_route,
    sinkhorn_bwd_train,
    sinkhorn_fwd_train,
    sinkhorn_log_iterations,
)
from torch_routes import numpy_pyramids  # noqa: F401  (both packages on numpy)

H100_BLOCK_BYTES = 232448  # a block's opt-in shared memory on an H100
ITERATIONS = 4


def bf16_exact(rng, shape, scale=1.0):
    """Normal samples rounded to bf16, as float32."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def within(got, want, rtol, atol):
    got, want = np.asarray(got), np.asarray(want)
    assert np.all(np.isfinite(got))
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), f"max |diff| {np.abs(got - want).max()}"


def sinkhorn_case(seed, p=2, m1=300, n1=260):
    """Padded patches with masked rows and columns (the dustbins kept) and
    patch 0 masked but for its dustbin corner."""
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(p, m1, n1)).astype(np.float32)
    rows = rng.uniform(size=(p, m1)) < 0.85
    cols = rng.uniform(size=(p, n1)) < 0.85
    rows[:, -1] = cols[:, -1] = True
    rows[0, :-1] = cols[0, :-1] = False
    masked = ~(rows[:, :, None] & cols[:, None, :])
    scores = np.where(masked, -1e12, scores).astype(np.float32)
    log_mu = np.where(rows, -np.log(m1 + n1), -1e12).astype(np.float32)
    log_nu = np.where(cols, -np.log(m1 + n1), -1e12).astype(np.float32)
    dout = np.where(masked, 0.0, rng.normal(size=(p, m1, n1))).astype(np.float32)
    return scores, log_mu, log_nu, dout, masked


def test_sinkhorn_forward_past_the_register_instances_matches_jax():
    scores, log_mu, log_nu, _, masked = sinkhorn_case(0)
    want = np.asarray(jax_sinkhorn(*map(jnp.asarray, (scores, log_mu, log_nu)), ITERATIONS))
    got = sinkhorn_log_iterations(*map(torch.from_numpy, (scores, log_mu, log_nu)), ITERATIONS)
    within(got.numpy()[~masked], want[~masked], 1e-4, 1e-4)


def test_sinkhorn_training_past_the_register_instances_matches_jax():
    scores, log_mu, log_nu, dout, masked = sinkhorn_case(1)
    args = [jnp.asarray(x) for x in (scores, log_mu, log_nu)]
    want_out, vjp = jax.vjp(lambda *a: jax_sinkhorn_train(*a, ITERATIONS), *args)
    want_grads = vjp(jnp.asarray(dout))
    t = [torch.from_numpy(x) for x in (scores, log_mu, log_nu)]
    out, v_hist = sinkhorn_fwd_train(*t, ITERATIONS)
    assert v_hist.shape == (2, ITERATIONS, 260) and not v_hist[:, 0].any()
    grads = sinkhorn_bwd_train(t[0], t[1], v_hist, torch.from_numpy(dout))
    within(out.numpy()[~masked], np.asarray(want_out)[~masked], 1e-4, 1e-4)
    for got, want in zip(grads, want_grads):
        within(got.numpy(), want, 1e-4, 1e-4)


@pytest.mark.parametrize("c", [130, 640])
def test_rpe_pair_scores_any_width_and_heads_matches_jax(c):
    rng = np.random.default_rng(c)
    n, m, h, nv_q, nv_k = 40, 36, 12, 33, 30
    embed, qw = bf16_exact(rng, (n, m, c), 0.5), bf16_exact(rng, (n, h, c), 0.5)
    want = np.asarray(jax_attention.rpe_pair_scores(
        jnp.asarray(embed), jnp.asarray(qw), jnp.int32(nv_q), jnp.int32(nv_k), interpret=True))
    got = rpe_pair_scores(torch.from_numpy(embed), torch.from_numpy(qw), nv_q, nv_k).numpy()
    inside = (np.arange(n) < nv_q)[:, None, None] & (np.arange(m) < nv_k)[None, None, :]
    inside = np.broadcast_to(inside, got.shape)
    bound = 1e-5 * np.abs(want[inside]).max()
    assert np.abs(got[inside] - want[inside]).max() <= bound
    assert not got[~inside].any()


@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_attention_head_width_48_matches_jax(with_bias):
    rng = np.random.default_rng(48)
    h, n, m, dh, nv_q, nv_k = 2, 50, 45, 48, 41, 40
    q, k, v, bias = (bf16_exact(rng, s, 0.5) for s in ((h, n, dh), (h, m, dh), (h, m, dh),
                                                       (n, h, m)))
    bias = bias if with_bias else None
    scale = dh ** -0.5
    got = fused_masked_attention(*(None if x is None else torch.from_numpy(x)
                                   for x in (q, k, v, bias)), nv_q, nv_k, scale).numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_attention._xla_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if bias is None else jnp.asarray(bias), nv_k, scale))
    assert np.abs(got[:nv_q] - want[:nv_q]).max() <= 1e-5 * np.abs(want[:nv_q]).max()
    assert not got[nv_q:].any()
    pallas = np.asarray(jax_attention.fused_masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), jnp.int32(nv_q), jnp.int32(nv_k),
        scale=scale, interpret=True))
    np.testing.assert_allclose(got[:nv_q], pallas[:nv_q], rtol=2e-2, atol=2e-2)


def test_stream_conv_with_20_kernel_points_matches_jax(monkeypatch):
    # the Pallas stream kernel at its f32 MXU point (bf16 operands would
    # round t1 W by up to 2^-9)
    monkeypatch.setattr(jax_kpconv_kernels, "MXU_DTYPE", jnp.float32)
    rng = np.random.default_rng(20)
    m, h, k, c_out, sigma = 200, 16, 20, 32, 0.08
    points = rng.uniform(0, 0.5, (m, 3)).astype(np.float32)
    d = np.linalg.norm(points[:, None] - points[None], axis=-1)
    nbrs = np.argsort(d, axis=1)[:, :h].astype(np.int32)
    nbrs[rng.uniform(size=(m, h)) < 0.2] = m
    nbrs[:, 0] = np.arange(m)
    feats = (rng.uniform(size=(m, 1)) > 0.1).astype(np.float32)
    stream = build_input_stream(points, feats, nbrs)
    kp = ((rng.uniform(size=(k, 3)) - 0.5) * 0.12).astype(np.float32)
    w = rng.normal(size=(k, 1, c_out)).astype(np.float32)
    bias = rng.normal(size=c_out).astype(np.float32)
    want = np.asarray(jax_kpconv_kernels.kpconv_stream_fused(
        jnp.asarray(stream), jnp.asarray(kp), jnp.asarray(w), sigma, bias=jnp.asarray(bias),
        tile_m=64))
    got = kpconv_stream_fused(torch.from_numpy(stream), torch.from_numpy(kp),
                              torch.from_numpy(w), sigma, torch.from_numpy(bias)).numpy()
    within(got, want, 1e-4, 1e-5 * np.abs(want).max())


# ---- each wrapper's instance, as a plain function --------------------------

@pytest.mark.parametrize("m1, n1, want", [
    (65, 65, Route(False, True, True, 0, 0)), (129, 129, Route(False, True, True, 0, 0)),
    (224, 224, Route(False, True, True, 0, 0)), (225, 225, Route(False, True, True, 224, 0)),
    (239, 239, Route(False, True, True, 16, 0)), (256, 33, Route(False, True, True, 0, 0)),
    (240, 240, Route(True, True, False, 0, 32 * 240)), (256, 256, Route(True, False, True, 0, 0)),
    (300, 260, Route(True, False, True, 0, 0)), (60000, 2, Route(True, False, False, 0, 64))])
def test_sinkhorn_forward_route(m1, n1, want):
    """Register instances up to M1, N1 <= 256 where S and the partials of all
    columns (or of groups of 16 to 224 columns, M1 = N1 = 225-239) fit a block; the
    general kernel elsewhere, S in shared memory before its partials."""
    assert forward_route(m1, n1, H100_BLOCK_BYTES) == want


@pytest.mark.parametrize("m1, n1, want", [
    (129, 129, Route(False, True, True, 0, 0)), (160, 160, Route(False, True, True, 0, 0)),
    (161, 161, Route(True, True, True, 0, 0)), (300, 260, Route(True, False, True, 0, 0)),
    (600, 600, Route(True, False, False, 0, 3 * 32 * 600))])
def test_sinkhorn_backward_route(m1, n1, want):
    assert backward_route(m1, n1, H100_BLOCK_BYTES) == want


@pytest.mark.parametrize("c, h, aligned, want", [
    (256, 4, True, "float4"), (128, 4, True, "float4"), (512, 8, True, "float4"),
    (130, 4, True, "scalar"), (640, 4, True, "scalar"), (64, 12, True, "scalar"),
    (256, 4, False, "scalar")])
def test_pair_scores_route(c, h, aligned, want):
    assert pair_scores_route(c, h, aligned) == want


@pytest.mark.parametrize("dh, aligned, want", [
    (64, True, (64, True, True)), (32, True, (32, True, True)), (8, True, (8, True, True)),
    (64, False, (64, False, True)), (24, True, (32, False, True)),
    (48, True, (64, False, True)), (5, True, (8, False, True)), (96, True, (0, False, True)),
    (128, True, (0, False, True)), (3088, True, (0, False, True)),
    (3100, True, (0, False, False)), (4096, True, (0, False, False))])
def test_attention_route(dh, aligned, want):
    assert attention_route(dh, aligned, 300) == want


@pytest.mark.parametrize("k, want", [(15, 0), (7, 1), (16, 1), (17, 2), (20, 2), (32, 2)])
def test_input_conv_variant(k, want):
    assert input_conv_variant(k) == want
