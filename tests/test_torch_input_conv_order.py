"""The arithmetic of the c_in = 1 input convs on the card (``kpconv_stream_kernel``
and ``kpconv_union_kernel`` in ``csrc/kpconv.cu``), emulated in numpy float32
and checked on the CPU (the kernels themselves run on the card: ``-m cuda``,
chip_smoke.py).

The kernels give each query a group of L lanes (the stream kernel 8 on
3DMatch's H = 38 and KITTI's H = 65, 16 on ModelNet's H = 34; the union
kernel, which runs on 3DMatch, 4); lane l takes the slots
l + L j in order of j and, for each slot that is not skipped (flag and
feature both 0), all K kernel points:

    d2 = fma(dz, dz, fma(dy, dy, dx * dx)),  d = sqrt.approx(d2),
    acc[k] = fma(saturate(fma(-d, 1 / sigma, 1)), feat, acc[k]),  cnt += flag,

with (dx, dy, dz) = off - kp_k and off = s - q rounded to float32 (the
stream holds it; the union kernel takes it in the same order). The lanes
then add their sums by xor butterflies (offsets 1, 2, 4, ...), and out[q, d]
= (sum over k in order of fma(t1[k], W[k, d], .)) * (1 / max(cnt, 1)).

Emulated here in that order (an fma as its exact float64 product and sum
rounded once to float32; ``sqrt.approx`` as the correctly rounded root times
1 + e, e drawn uniformly within +-2^-22, a stand-in well above float32's
rounding) at the three paths' H, sigma, kernel radius and lanes (and the
union's on 3DMatch), three seeds, the
paths' all-ones features and signed features whose flags differ from them:

  * the emulation and the plain float32 version
    (``kpconv_stream_fused_plain``) each stand within a quarter of
    chip_smoke.py's ``tol_kpconv`` (1e-4 |exact| + 1e-5 max |exact|) of the
    float64 evaluation, out and t1, so the kernel and the plain version
    stand within half of it of each other;
  * the skip is exact: evaluating the skipped slots too gives the same bits;
  * the count (a sum of 0/1 flags) equals the plain version's exactly.
"""

import numpy as np
import pytest
import torch

from geotransformer_tpu_torch.configs import (
    make_3dmatch_config,
    make_kitti_config,
    make_modelnet_config,
)
from geotransformer_tpu_torch.kernels.kpconv import kpconv_stream_fused_plain
from geotransformer_tpu_torch.models.kernel_points import load_kernel_points

F32 = np.float32
SQRT_ERROR = 2.0 ** -22
QUERIES = 256

# (config, the lanes a query of csrc/kpconv.cu's launch for that path)
PATHS = {"3dmatch": (make_3dmatch_config, 8), "kitti": (make_kitti_config, 8),
         "modelnet": (make_modelnet_config, 16), "3dmatch-union": (make_3dmatch_config, 4)}


def fma(a, b, c):
    """float32 fma: the exact float64 product plus c, rounded once (double
    rounding aside)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def merge_lanes(x):
    """Lane 0's value of xor butterflies over axis 1 (offsets 1, 2, 4, ...)."""
    while x.shape[1] > 1:
        x = (x[:, 0::2] + x[:, 1::2]).astype(F32)
    return x[:, 0]


def kernel_conv(off, flag, feat, kp, w, sigma, lanes, rng, skip=True):
    """The kernel's t1, count and out in its order of operations."""
    m, h, _ = off.shape
    k = kp.shape[0]
    inv_sigma = F32(1.0) / F32(sigma)
    acc = np.zeros((m, lanes, k), F32)
    cnt = np.zeros((m, lanes), F32)
    for j in range(-(-h // lanes)):
        slot = j * lanes + np.arange(lanes)
        inside = slot < h
        slot = np.minimum(slot, h - 1)
        o, fl, fe = off[:, slot], flag[:, slot], feat[:, slot]  # (m, L, 3), (m, L)
        live = inside[None, :] & ~((fl == 0) & (fe == 0)) if skip else np.broadcast_to(
            inside[None, :], fl.shape)
        dx, dy, dz = (o[..., None, c] - kp[:, c] for c in range(3))  # (m, L, K) float32
        d2 = fma(dz, dz, fma(dy, dy, (dx * dx).astype(F32)))
        d = (np.sqrt(d2) * (1.0 + rng.uniform(-SQRT_ERROR, SQRT_ERROR, d2.shape))).astype(F32)
        infl = np.clip(fma(-d, inv_sigma, F32(1.0)), 0.0, 1.0).astype(F32)
        acc = np.where(live[..., None], fma(infl, fe[..., None], acc), acc)
        cnt = np.where(live, (cnt + fl).astype(F32), cnt)
    t1, count = merge_lanes(acc), np.maximum(merge_lanes(cnt), F32(1.0))
    out = np.zeros((m, w.shape[1]), F32)
    for kk in range(k):
        out = fma(t1[:, kk:kk + 1], w[kk][None, :], out)
    return t1, count, (out * (F32(1.0) / count)[:, None]).astype(F32)


def exact_conv(off, flag, feat, kp, w, sigma):
    """The same conv in float64 from the same float32 inputs."""
    off, feat, kp, w = (np.float64(x) for x in (off, feat, kp, w))
    dist = np.linalg.norm(off[:, :, None, :] - kp, axis=-1)
    infl = np.maximum(1.0 - dist / sigma, 0.0)
    t1 = np.einsum("mhk,mh->mk", infl, feat)
    count = np.maximum(np.float64(flag).sum(1), 1.0)
    return t1, count, t1 @ w / count[:, None]


def make_case(cfg, seed, signed):
    """A stream as build_input_stream lays it out: neighbors within the
    radius, a valid prefix of each row, zeros on padded slots (and every
    seventh query without a valid slot); the self-neighbor (offset 0) first."""
    rng = np.random.default_rng(seed)
    h, radius, sigma = cfg.caps.neighbor_limits[0], cfg.backbone.init_radius, cfg.backbone.init_sigma
    direction = rng.standard_normal((QUERIES, h, 3))
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    s = direction * radius * rng.uniform(0.0, 1.0, (QUERIES, h, 1)) ** (1 / 3)
    q = rng.uniform(-50.0, 50.0, (QUERIES, 1, 3))  # offsets as f32(s - q) at a scene's scale
    off = ((q + s).astype(F32) - q.astype(F32)).astype(F32)
    off[:, 0] = 0.0
    valid = np.arange(h)[None, :] < rng.integers(1, h + 1, (QUERIES, 1))
    valid[::7] = False
    if signed:
        feat = rng.standard_normal((QUERIES, h)).astype(F32)
        flag = (feat > 0) ^ (rng.uniform(size=(QUERIES, h)) < 0.05)
    else:
        feat, flag = np.ones((QUERIES, h), F32), np.ones((QUERIES, h), bool)
    off, flag, feat = off * valid[..., None], F32(flag * valid), feat * valid
    kp = load_kernel_points(radius, cfg.backbone.kernel_size).astype(F32)
    w = rng.standard_normal((cfg.backbone.kernel_size, cfg.backbone.init_dim)).astype(F32)
    return off, flag, feat, kp, w, sigma


def within(got, exact, share):
    bound = 1e-4 * np.abs(exact) + 1e-5 * np.abs(exact).max()
    return float(np.max(np.abs(np.float64(got) - exact) / bound)) <= share


@pytest.mark.parametrize("signed", [False, True], ids=["ones", "signed"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("path", list(PATHS))
def test_kernel_order_stands_within_tolerance_of_float64(path, seed, signed):
    make_config, lanes = PATHS[path]
    off, flag, feat, kp, w, sigma = make_case(make_config(), seed, signed)
    t1, count, out = kernel_conv(off, flag, feat, kp, w, sigma, lanes,
                                 np.random.default_rng(seed + 100))
    exact_t1, exact_count, exact_out = exact_conv(off, flag, feat, kp, w, sigma)
    stream = torch.from_numpy(np.stack([off[..., 0], off[..., 1], off[..., 2], flag, feat]))
    plain_out, plain_t1, plain_count = kpconv_stream_fused_plain(
        stream, torch.from_numpy(kp), torch.from_numpy(w[:, None, :]), sigma, residuals=True)
    for got in ((t1, out), (plain_t1.numpy(), plain_out.numpy())):
        assert within(got[0], exact_t1, 0.25)
        assert within(got[1], exact_out, 0.25)
    assert np.array_equal(count, plain_count.numpy()) and np.array_equal(count, exact_count)
    assert not out[::7].any() and (count[::7] == 1).all()


@pytest.mark.parametrize("path", list(PATHS))
def test_skipping_empty_slots_is_exact(path):
    make_config, lanes = PATHS[path]
    off, flag, feat, kp, w, sigma = make_case(make_config(), 3, True)
    skipped = kernel_conv(off, flag, feat, kp, w, sigma, lanes, np.random.default_rng(7))
    every = kernel_conv(off, flag, feat, kp, w, sigma, lanes, np.random.default_rng(7), skip=False)
    assert ((flag == 0) & (feat == 0)).mean() > 0.2
    for a, b in zip(skipped, every):
        assert np.array_equal(a, b)
