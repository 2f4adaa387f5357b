"""The schedule of the Sinkhorn training backward kernel
(``sinkhorn_bwd_train_kernel`` in ``csrc/sinkhorn_train.cu``), stated in
plain torch and checked on the CPU (the kernel itself runs on the card:
``-m cuda``, chip_smoke.py).

The kernel gives each of 32 warps the rows w + 32 r of a patch and each
lane the columns l + 32 j. An iteration is one sweep over the warp's rows
and one merge of the warps' column partials:

  * the sweep does pass 3 of iteration k (g, du, dmu, h, dS), sums h down
    the warp's rows for each column (pass 4 without its own sweep: dv_{k-1}
    is the column sum of pass 3's h), and the row LSE of iteration k - 1
    (pass 1) with its column (max, sum exp) over the warp's rows (pass 2);
  * the merge adds the 32 warps' partials per column in a fixed order (an
    xor butterfly over the lanes, lane 0's value), giving the column LSE
    and dv_{k-1}.

Sums over a row take each lane's columns in order and then the butterfly.
Past the register instances (M1 or N1 > 160) the general kernel
(``sinkhorn_bwd_general_kernel``) takes the same sums in the same order
from shared or device memory (200 x 200 below).
Emulated here in exactly that order, at 17 x 17 and 65 x 65 patches with
masked rows and columns and a patch masked but for its dustbin corner, the
schedule in float64 stays within rtol 1e-5 and atol 1e-6 of
``sinkhorn_bwd_train_plain`` in float64 (it reads ~1e-13: the same
algebra). In float32 the plain version itself stands up to ~1e-4 off its
float64 run at 100 iterations (dmu and dnu sum 200 rounded terms of up to
~40), so there the schedule is held to chip_smoke.py's tolerance of the
plain version (1e-4 + 1e-4 |plain|), to twice the plain version's distance
from float64, and to the 1e-4 of tests/test_torch_sinkhorn_train.py
against the JAX ``_bwd_train`` in interpret mode, every output finite.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels.sinkhorn import (
    sinkhorn_log_iterations_train as jax_sinkhorn_train,
)

from geotransformer_tpu_torch.kernels.sinkhorn import (
    sinkhorn_bwd_train,
    sinkhorn_bwd_train_plain,
    sinkhorn_fwd_train_plain,
)

WARPS = LANES = 32


def butterfly(x):
    """Lane 0's value of an xor-butterfly sum over the last dim (32)."""
    for off in (16, 8, 4, 2, 1):
        x = x[..., :off] + x[..., off:2 * off]
    return x[..., 0]


def lane_sums(x):
    """Row sums of (..., N) as the kernel takes them: each lane's columns
    l + 32 j in order of j, then the butterfly over the lanes."""
    n = x.shape[-1]
    slots = -(-n // LANES)
    x = torch.nn.functional.pad(x, (0, slots * LANES - n)).unflatten(-1, (slots, LANES))
    acc = torch.zeros_like(x[..., 0, :])
    for j in range(slots):
        acc = acc + x[..., j, :]
    return butterfly(acc)


def warp_rows(x, fill):
    """(P, M, N) -> (P, R, 32, N): row w + 32 r at [r, w], ``fill`` beyond M."""
    p, m, n = x.shape
    slots = -(-m // WARPS)
    pad = torch.full((p, slots * WARPS - m, n), fill, dtype=x.dtype)
    return torch.cat([x, pad], dim=1).unflatten(1, (slots, WARPS))


def warp_partial_sums(x):
    """Each warp's column sums over its rows, in order of r: (P, 32, N)."""
    x = warp_rows(x, 0.0)
    acc = torch.zeros_like(x[:, 0])
    for r in range(x.shape[1]):
        acc = acc + x[:, r]
    return acc


def merge_sums(partials):
    """(P, 32, N) warp partials -> (P, N): the butterfly over the warps."""
    return butterfly(partials.transpose(1, 2))


def column_lse(scores, u):
    """The column LSE of S + u: each warp's (max, sum exp) over its rows,
    merged over the warps."""
    t = warp_rows(scores + u[:, :, None], -torch.inf)  # (P, R, 32, N)
    pm = t.amax(dim=1)  # (P, 32, N): -inf where a warp has no row
    ps = torch.zeros_like(pm)
    for r in range(t.shape[1]):
        # rows beyond M1 are skipped (a warp without rows keeps max -inf, sum 0)
        ps = ps + torch.where(t[:, r] == -torch.inf, 0.0, torch.exp(t[:, r] - pm))
    mx = pm.amax(dim=1)
    return mx + torch.log(merge_sums(ps * torch.exp(pm - mx[:, None])))


def row_lse(scores, v):
    t = scores + v[:, None, :]
    mx = t.amax(dim=2)
    return mx + torch.log(lane_sums(torch.exp(t - mx[:, :, None])))


def schedule_bwd(scores, log_mu, v_hist, dout):
    """The kernel's backward in float32: a prologue sweep, then for
    k = T-1 .. 0 one sweep (pass 3 of k, passes 1-2 of k - 1) and one merge."""
    iterations = v_hist.shape[1]
    ds, dmu = dout.clone(), torch.zeros_like(log_mu)
    dnu = torch.zeros_like(v_hist[:, 0] if iterations else dout[:, 0])
    if iterations == 0:
        return ds, dmu, dnu
    du0 = lane_sums(dout)
    dv = merge_sums(warp_partial_sums(dout))
    dnu = dnu + dv
    lse_n = row_lse(scores, v_hist[:, -1])
    u = log_mu - lse_n
    lse_m = column_lse(scores, u)
    for k in range(iterations - 1, -1, -1):
        g = torch.exp(scores + u[:, :, None] - lse_m[:, None, :]) * dv[:, None, :]
        ds = ds - g
        du = (du0 if k == iterations - 1 else torch.zeros_like(du0)) - lane_sums(g)
        dmu = dmu + du
        h = torch.exp(scores + v_hist[:, k][:, None, :] - lse_n[:, :, None]) * du[:, :, None]
        ds = ds - h
        if k == 0:
            break
        dv = -merge_sums(warp_partial_sums(h))
        dnu = dnu + dv
        lse_n = row_lse(scores, v_hist[:, k - 1])
        u = log_mu - lse_n
        lse_m = column_lse(scores, u)
    return ds, dmu, dnu


def make_case(seed, p, m1):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(p, m1, m1)).astype(np.float32)
    rows = rng.uniform(size=(p, m1)) < 0.85
    cols = rng.uniform(size=(p, m1)) < 0.85
    rows[:, -1] = cols[:, -1] = True  # the dustbins
    rows[0, :-1] = cols[0, :-1] = False  # a patch masked but for its dustbin corner
    rows[1] = cols[1] = True
    masked = ~(rows[:, :, None] & cols[:, None, :])
    scores = np.where(masked, -1e12, scores).astype(np.float32)
    log_mu = np.where(rows, -np.log(2 * m1), -1e12).astype(np.float32)
    log_nu = np.where(cols, -np.log(2 * m1), -1e12).astype(np.float32)
    dout = np.where(masked, 0.0, rng.normal(size=(p, m1, m1))).astype(np.float32)
    return scores, log_mu, log_nu, dout


def assert_close(got, want, rtol, atol):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("m1, iterations", [(17, 0), (17, 1), (17, 100), (65, 1), (65, 100),
                                            (200, 4)])
def test_schedule_matches_plain(m1, iterations):
    case = [torch.from_numpy(x) for x in make_case(m1, 4, m1)]
    runs = {}
    for dtype in (torch.float32, torch.float64):
        scores, log_mu, log_nu, dout = (x.to(dtype) for x in case)
        _, v_hist = sinkhorn_fwd_train_plain(scores, log_mu, log_nu, iterations)
        runs[dtype] = (schedule_bwd(scores, log_mu, v_hist, dout),
                       sinkhorn_bwd_train_plain(scores, log_mu, v_hist, dout))
    # the schedule is the plain reverse sweep reordered: equal in float64
    assert_close(*runs[torch.float64], rtol=1e-5, atol=1e-6)
    # in float32 both accumulate rounding over the iterations (dmu and dnu
    # sum 2T terms of ~1): the schedule stands within chip_smoke.py's
    # tol_sinkhorn_bwd of the plain version and no farther from float64
    # than twice the plain version
    (got, want), (exact, _) = runs[torch.float32], runs[torch.float64]
    for g, w, x in zip(got, want, exact):
        assert bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= 1e-4 + 1e-4 * w.abs()).all())
        assert (g.double() - x).abs().max() <= 2 * (w.double() - x).abs().max() + 1e-7
    # the wrapper on the CPU is the plain version
    scores, log_mu, log_nu, dout = case
    _, v_hist = sinkhorn_fwd_train_plain(scores, log_mu, log_nu, iterations)
    for a, b in zip(sinkhorn_bwd_train(scores, log_mu, v_hist, dout), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m1", [17, 65])
def test_schedule_matches_jax_kernel_interpret(m1):
    iterations = 30
    scores, log_mu, log_nu, dout = make_case(m1 + 1, 3, m1)
    args = [jnp.asarray(x) for x in (scores, log_mu, log_nu)]
    _, vjp = jax.vjp(lambda *a: jax_sinkhorn_train(*a, iterations), *args)
    want = vjp(jnp.asarray(dout))
    t = [torch.from_numpy(x) for x in (scores, log_mu, log_nu, dout)]
    _, v_hist = sinkhorn_fwd_train_plain(t[0], t[1], t[2], iterations)
    got = schedule_bwd(t[0], t[1], v_hist, t[3])
    assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_butterfly_is_lane_zeros_xor_sum():
    x = torch.from_numpy(np.random.default_rng(0).normal(size=32).astype(np.float32))
    lanes = x.clone()
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[torch.arange(32) ^ off]
    assert torch.equal(butterfly(x), lanes[0])
