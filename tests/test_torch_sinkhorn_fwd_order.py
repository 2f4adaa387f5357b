"""The schedule of the Sinkhorn forward kernel (``sinkhorn_kernel`` in
``csrc/sinkhorn.cu``: the inference loop, and with ``STORE_HIST`` the
training forward), stated in plain torch and checked on the CPU (the kernel
itself runs on the card: ``-m cuda``, chip_smoke.py).

The kernel gives each of 16 warps the rows w + 16 r of a patch and each
lane the columns l + 32 j. An iteration is one sweep over the warp's rows
and one merge of the warps' column partials:

  * the sweep takes each row's LSE of S + v (each lane's columns in order
    of j, then an xor butterfly over the 32 lanes, lane 0's value) into u,
    then each column's (max, sum exp) of S + u over the warp's rows, rows in
    order (the warp's column partials);
  * the merge adds the 16 warps' partials per column (lane i holds warp i's,
    16 lanes a column): the max over the lanes, each partial sum scaled by
    exp(its max - the max), an xor butterfly over the 16 lanes, lane 0's
    value; v = log_nu - LSE. Where S and the partials of every column do
    not fit in shared memory, the partials and the merge run a group of
    columns at a time: each column's sums are the same either way. Past
    the register instances (M1 or N1 > 256, or S beside its partials too
    large for a block) the general kernel (``sinkhorn_general_kernel``)
    takes the same sums in the same order from shared or device memory, so
    the schedule covers it too (300 x 260 below).

The kernel takes each exponential of x = t - max <= 0 as 2^(x log2(e))
(ex2.approx), the same function to ~2^-22. The training forward stores v
before each iteration (zeros first). Emulated here in exactly that order,
at 65 x 65, 129 x 129 and 239 x 239 patches with masked rows and columns
and a patch masked but for its dustbin corner (and at 17 x 30, a warp
without rows),
the schedule in float64 equals
``sinkhorn_fwd_train_plain`` in float64 to 1e-12 (the same algebra in
another order); in float32 it stands within chip_smoke.py's
``tol_sinkhorn_scores`` of the plain version (1e-4 + 1e-4 |plain| on the
valid entries, v_hist whole) and within the 1e-4 of
tests/test_torch_sinkhorn.py of the JAX ``sinkhorn_log_iterations`` in
interpret mode, every output finite.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels.sinkhorn import (
    sinkhorn_log_iterations as jax_sinkhorn_iterations,
)

from geotransformer_tpu_torch.kernels.sinkhorn import (
    sinkhorn_fwd_train,
    sinkhorn_fwd_train_plain,
    sinkhorn_log_iterations,
)

WARPS, LANES = 16, 32


def butterfly(x):
    """Lane 0's value of an xor-butterfly sum over the last dim (a power of 2)."""
    off = x.shape[-1] // 2
    while off:
        x = x[..., :off] + x[..., off:2 * off]
        off //= 2
    return x[..., 0]


def row_lse(scores, v):
    """Each row's LSE of S + v: the max over the row, each lane's exp(t -
    max) over its columns l + 32 j in order of j, the butterfly over the
    lanes."""
    t = scores + v[:, None, :]
    mx = t.amax(dim=2)
    terms = torch.exp(t - mx[:, :, None])
    n = terms.shape[-1]
    slots = -(-n // LANES)
    terms = torch.nn.functional.pad(terms, (0, slots * LANES - n)).unflatten(-1, (slots, LANES))
    acc = torch.zeros_like(terms[..., 0, :])
    for j in range(slots):
        acc = acc + terms[..., j, :]
    return mx + torch.log(butterfly(acc))


def column_lse(scores, u):
    """Each column's LSE of S + u: warp w's (max, sum exp) over its rows
    w + 16 r in order of r, then the merge of the 16 warps' partials."""
    p, m, n = scores.shape
    rows = -(-m // WARPS)
    t = torch.cat([scores + u[:, :, None],
                   torch.full((p, rows * WARPS - m, n), -torch.inf, dtype=scores.dtype)], dim=1)
    t = t.unflatten(1, (rows, WARPS))  # (P, R, 16, N): row w + 16 r at [r, w]
    pm = t.amax(dim=1)  # (P, 16, N): -inf for a warp without rows
    ps = torch.zeros_like(pm)
    for r in range(rows):
        # rows beyond M1 are skipped: a warp without rows keeps (-inf, 0)
        ps = ps + torch.where(t[:, r] == -torch.inf, 0.0, torch.exp(t[:, r] - pm))
    mx = pm.amax(dim=1)
    return mx + torch.log(butterfly((ps * torch.exp(pm - mx[:, None])).transpose(1, 2)))


def schedule_fwd(scores, log_mu, log_nu, iterations):
    """The kernel's forward: (out, v_hist)."""
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    history = []
    for _ in range(iterations):
        history.append(v)
        u = log_mu - row_lse(scores, v)
        v = log_nu - column_lse(scores, u)
    v_hist = (torch.stack(history, dim=1) if history
              else log_nu.new_zeros((log_nu.shape[0], 0, log_nu.shape[1])))
    return scores + u[:, :, None] + v[:, None, :], v_hist


def make_case(seed, p, m1, n1):
    rng = np.random.default_rng(seed)
    scores = rng.normal(size=(p, m1, n1)).astype(np.float32)
    rows = rng.uniform(size=(p, m1)) < 0.85
    cols = rng.uniform(size=(p, n1)) < 0.85
    rows[:, -1] = cols[:, -1] = True  # the dustbins
    rows[0, :-1] = cols[0, :-1] = False  # a patch masked but for its dustbin corner
    rows[1] = cols[1] = True
    masked = ~(rows[:, :, None] & cols[:, None, :])
    scores = np.where(masked, -1e12, scores).astype(np.float32)
    log_mu = np.where(rows, -np.log(m1 + n1), -1e12).astype(np.float32)
    log_nu = np.where(cols, -np.log(m1 + n1), -1e12).astype(np.float32)
    return scores, log_mu, log_nu


@pytest.mark.parametrize("m1, n1, iterations", [(65, 65, 100), (129, 129, 100), (129, 129, 1),
                                                (17, 30, 20), (239, 239, 10), (300, 260, 4)])
def test_schedule_matches_plain(m1, n1, iterations):
    case = [torch.from_numpy(x) for x in make_case(m1 + n1, 4, m1, n1)]
    runs = {}
    for dtype in (torch.float32, torch.float64):
        args = [x.to(dtype) for x in case]
        runs[dtype] = (schedule_fwd(*args, iterations), sinkhorn_fwd_train_plain(*args, iterations))
    # the schedule is the plain forward reordered: equal in float64
    for got, want in zip(*runs[torch.float64]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
    # in float32 within chip_smoke.py's tol_sinkhorn_scores of the plain version
    (out, v_hist), (want_out, want_hist) = runs[torch.float32]
    valid = case[0] > -1e11
    for got, want in ((out[valid], want_out[valid]), (v_hist, want_hist)):
        assert bool(torch.isfinite(got).all())
        assert bool(((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    assert bool(torch.isfinite(out).all())
    # the wrappers on the CPU are the plain version
    plain_out, plain_hist = sinkhorn_fwd_train(*case, iterations)
    assert torch.equal(plain_out, want_out) and torch.equal(plain_hist, want_hist)
    assert torch.equal(sinkhorn_log_iterations(*case, iterations), want_out)


@pytest.mark.parametrize("m1", [17, 65])
def test_schedule_matches_jax_kernel_interpret(m1):
    iterations = 30
    scores, log_mu, log_nu = make_case(m1 + 7, 3, m1, m1)
    want = np.asarray(jax_sinkhorn_iterations(jnp.asarray(scores), jnp.asarray(log_mu),
                                              jnp.asarray(log_nu), iterations))
    got, _ = schedule_fwd(torch.from_numpy(scores), torch.from_numpy(log_mu),
                          torch.from_numpy(log_nu), iterations)
    valid = scores > -1e11
    np.testing.assert_allclose(got.numpy()[valid], want[valid], rtol=1e-4, atol=1e-4)
    assert np.all(np.isfinite(got.numpy()))


def test_butterfly_is_lane_zeros_xor_sum():
    for width in (16, 32):
        x = torch.from_numpy(np.random.default_rng(width).normal(size=width).astype(np.float32))
        lanes = x.clone()
        off = width // 2
        while off:
            lanes = lanes + lanes[torch.arange(width) ^ off]
            off //= 2
        assert torch.equal(butterfly(x), lanes[0])
