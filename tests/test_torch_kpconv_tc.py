"""The arithmetic the KPConv kernels of ``csrc/kpconv_common.cuh`` rely on,
checked on the CPU (the kernels themselves run on the card: ``-m cuda``,
chip_smoke.py).

  * The contraction's 3xTF32 products. ``gemm_3xtf32_kernel`` multiplies
    f32 operands on the tensor cores as TF32 halves (big + small) and adds
    each 32-deep ring stage's products (three a k8 step) into a fresh tile,
    which one f32 add brings into the accumulator, stages in order.
    Where the output tiles would not fill the card the k range is cut into
    slices whose partial sums are added in order (split-K). Emulated here
    over K * C-long sums at the widths of the KITTI, 3DMatch and ModelNet
    convs (up to 7,680 terms at C = 512), in the slices the kernel takes for
    each call, and over the rows of a dW slice, it stands within 1e-6 of
    max|exact| of the float64 product (as the plain f32 product does); one
    TF32 product alone does not.
  * The one-pass split conv. The kernel walks each query's head columns and
    then its tail row (through ``tail_rank``) in one pass. Emulated as the
    plain conv over those concatenated columns with the split's pool rule (a
    query without a tail row pools the zero shadow row but counts no tie
    there), it equals the two-pass combine of ``kpconv_split_fused``'s plain
    version: count, pooled and ties exactly, out within 1e-6 of max|out|.
    Against the unsplit plain conv on the whole table: count and pooled
    exactly, out within 1e-6, ties exactly wherever the query has a tail row
    or its max is not the zero shadow; a query without a tail row whose max
    is 0 counts the whole table's (pool_cols - H1) shadow columns there and
    not in the split (the JAX split conv's ``_split_pool_ties`` counts the
    same way).
  * The one-pass split backward. The split inverse table's head columns and
    each support row's tail row rebuild the whole inverse table exactly, and
    the two-pass plain backward over the split table equals the plain
    backward over the whole one within 1e-6 of max|plain| (d_s, dW, d_pool).
"""

import numpy as np
import pytest
import torch

from geotransformer_tpu_torch.kernels.kpconv import (
    kpconv_bwd_fused_plain,
    kpconv_fused_plain,
    kpconv_split_fused_plain,
)
from geotransformer_tpu_torch.models.kernel_points import load_kernel_points
from geotransformer_tpu_torch.ops.gather import gather_with_shadow
from geotransformer_tpu_torch.preprocess.pyramid import build_inverse_table, build_split_tables

from test_torch_attention import tf32

K8 = 8  # the k depth of one mma.sync m16n8k8
STAGE = 32  # the k depth of one stage of the kernel's cp.async ring


def contraction_slices(m, n, kdim, sms=132, stages=4):
    """The k slices ``plan_contraction`` (csrc/kpconv_common.cuh) cuts an
    (m x kdim) (kdim x n) contraction into: (slices, k a slice)."""
    bn = 64 if n >= 64 else 32
    tiles_n = -(-n // bn)
    bm = 128 if -(-m // 128) * tiles_n >= sms else 64
    tiles = -(-m // bm) * tiles_n
    ktiles = -(-kdim // STAGE)
    slices = min(-(-2 * sms // tiles), max(ktiles // stages, 1)) if tiles < sms else 1
    k_per_slice = -(-ktiles // slices) * STAGE
    return -(-kdim // k_per_slice), k_per_slice


def gemm_3xtf32_emulation(a, b, terms=3, k_per_slice=None):
    """a @ b as ``gemm_3xtf32_kernel`` sums it: the k range in slices of
    ``k_per_slice`` (split-K; one slice by default), their partial sums
    added in order; within a slice, 32-deep ring stages in order; within a
    stage, k8 steps in order, each step's products (small . big,
    big . small, big . big with ``terms`` 3; big . big alone with 1) added
    one by one into a fresh f32 tile, which one f32 add brings into the
    slice's accumulator at the end of the stage."""
    kdim = a.shape[1]
    pad = (-kdim) % K8  # the kernel's zero-filled tail of the last k slice
    a = torch.nn.functional.pad(a, (0, pad)).reshape(a.shape[0], -1, K8).transpose(0, 1)
    b = torch.nn.functional.pad(b, (0, 0, 0, pad)).reshape(-1, K8, b.shape[1])
    a_big, b_big = tf32(a), tf32(b)
    products = [torch.bmm(a_big, b_big)]
    if terms == 3:
        a_small, b_small = tf32(a - a_big), tf32(b - b_big)
        products = [torch.bmm(a_small, b_big), torch.bmm(a_big, b_small)] + products
    steps = a.shape[0]
    per_slice = steps if k_per_slice is None else k_per_slice // K8
    out = torch.zeros(a.shape[1], b.shape[2])
    for first in range(0, steps, per_slice):
        acc = torch.zeros_like(out)
        last = min(first + per_slice, steps)
        for stage in range(first, last, STAGE // K8):
            tile = torch.zeros_like(acc)
            for step in range(stage, min(stage + STAGE // K8, last)):
                for product in products:
                    tile = tile + product[step]
            acc = acc + tile
        out = out + acc
    return out


# (rows emulated, K * C, D, M of the real call): the forward's T (queries,
# K * C) @ W at the widths of the convs (KITTI C = D = 32 ... 512, 3DMatch
# up to 256, ModelNet up to 128; the backward's d_s = u (N, K * D) @ Wt has
# the same shapes), split into k slices as the kernel splits the real call
# (M queries), and one dW slice: s^T (C, rows) @ u (rows, D)
CONTRACTIONS = [(64, 15 * 512, 512, 1024), (64, 15 * 256, 256, 1024), (128, 15 * 32, 32, 58880),
                (64, 15 * 128, 128, 384), (64, 15 * 128, 48, 7168), (512, 2304, 64, None)]


@pytest.mark.parametrize("rows, kdim, d, m", CONTRACTIONS,
                         ids=["kitti-stage4", "3dmatch-stage3", "kitti-stage0", "modelnet-stage2",
                              "c128-d48", "dw-slice"])
def test_3xtf32_contraction_keeps_f32_accuracy(rows, kdim, d, m):
    rng = np.random.default_rng(kdim + d)
    # T holds influence-weighted sums of features: mostly one sign, varied magnitudes
    a = torch.from_numpy((rng.gamma(2.0, 1.0, (rows, kdim))
                          * rng.choice([1.0, -1.0], (rows, kdim), p=[0.8, 0.2])).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(kdim, d)) / np.sqrt(kdim)).astype(np.float32))
    exact = a.double() @ b.double()
    bound = 1e-6 * exact.abs().max().item()
    k_per_slice = None if m is None else contraction_slices(m, d, kdim)[1]
    split = gemm_3xtf32_emulation(a, b, 3, k_per_slice)
    single = gemm_3xtf32_emulation(a, b, 1, k_per_slice)
    assert (split.double() - exact).abs().max().item() <= bound
    assert (single.double() - exact).abs().max().item() > bound


def test_contraction_plan_splits_small_grids_only():
    """Split-K cuts the k range only where the output tiles leave the card
    short of a wave: KITTI's stage 0 (58,880 queries) is one slice, its
    stage 4 (1,024 queries, C = D = 512) three, ModelNet's stage 2 (384
    queries) fifteen."""
    assert contraction_slices(58880, 32, 15 * 32) == (1, 480)
    assert contraction_slices(1024, 512, 15 * 512) == (3, 2560)
    assert contraction_slices(384, 128, 15 * 128) == (15, 128)


SIGMA = 0.05


def split_conv_case(seed, m, n, h, h1, c, deep, c_pool=6):
    """A conv over an (M, H) table of the nearest supports with random
    sentinels, valid columns first, split at h1. ``deep``: "some" (every
    other query shallow), "none" (no tail row at all) or "all" (every query
    has one). Pool features are small integers: ties, zeros and all-negative
    maxima are common."""
    g = torch.Generator().manual_seed(seed)
    s_points = torch.rand(n, 3, generator=g) * 0.2
    q_points = torch.rand(m, 3, generator=g) * 0.2
    table = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    table[torch.rand(m, h, generator=g) < 0.3] = n
    table = torch.sort(table, dim=1).values  # valid columns first
    if deep == "some":
        table[::2, h1:] = n
    elif deep == "none":
        table[:, h1:] = n
    elif deep == "all":
        table[:, :h1 + 1] = torch.arange(h1 + 1, dtype=torch.int32)
    m2 = int((table[:, h1:] < n).any(1).sum())
    tail, tail_q, rank = (torch.from_numpy(x) for x in
                          build_split_tables(table.numpy(), n, h1, m2 + 3))
    feats = torch.randn(n, c, generator=g)
    pool = torch.randint(-2, 2, (n, c_pool), generator=g).float()
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))
    w = torch.randn(15, c, c, generator=g) / c
    q_mask = torch.rand(m, generator=g) < 0.9
    return dict(s_feats=feats, q_points=q_points, s_points=s_points, table=table,
                head=table[:, :h1].contiguous(), tail=tail, tail_q=tail_q, rank=rank, kp=kp, w=w,
                pool=pool, q_mask=q_mask)


def one_pass_conv(x, pool_cols):
    """The one-pass kernel's walk in torch: per query its head columns, then
    its tail row (all sentinels without one); out and count as the plain
    conv over those columns, the pool over the head's first min(pool_cols,
    H1) columns and the tail row's first pool_cols - H1, a query without a
    tail row taking the zero shadow row into its max but no tie from it."""
    head, tail, rank = x["head"], x["tail"], x["rank"].long()
    n, h1, m2 = x["s_points"].shape[0], head.shape[1], tail.shape[0]
    has_tail = rank < m2
    tail_rows = torch.cat([tail, torch.full_like(tail[:1], n)])[rank]
    walked = torch.cat([head, tail_rows], dim=1)
    out, count = kpconv_fused_plain(x["s_feats"], x["q_points"], x["s_points"], walked, x["kp"],
                                    x["w"], SIGMA, q_mask=x["q_mask"], residuals=True)
    nbr = torch.where(x["q_mask"][:, None], walked.long(), n)
    cols2 = min(pool_cols - h1, tail.shape[1])
    pooled_cols = torch.cat([nbr[:, :min(pool_cols, h1)], nbr[:, h1:h1 + cols2]], dim=1)
    block = gather_with_shadow(x["pool"], pooled_cols, 0.0)  # shadows read 0
    counted = torch.ones(block.shape[:2], dtype=torch.bool)
    counted[:, min(pool_cols, h1):] = has_tail[:, None]  # a missing tail row has no columns
    block_max = torch.where(counted[..., None], block, -torch.inf).amax(dim=1)
    pooled = torch.where(has_tail[:, None], block_max, torch.clamp(block_max, min=0.0))
    ties = ((block == pooled[:, None, :]) & counted[..., None]).sum(dim=1).float()
    return out, pooled, count, torch.clamp(ties, min=1.0)


@pytest.mark.parametrize("deep", ["some", "none", "all"])
@pytest.mark.parametrize("c", [1, 8])
def test_one_pass_split_conv_equals_the_combine_and_the_whole_table(deep, c):
    m, n, h, h1, pool_cols = 150, 200, 32, 8, 20
    x = split_conv_case(3, m, n, h, h1, c, deep)
    walk = one_pass_conv(x, pool_cols)
    combine = kpconv_split_fused_plain(
        x["s_feats"], x["q_points"], x["s_points"], x["head"], x["tail"], x["tail_q"], x["rank"],
        x["kp"], x["w"], SIGMA, pool_feats=x["pool"], pool_cols=pool_cols, q_mask=x["q_mask"],
        residuals=True)
    whole = kpconv_fused_plain(x["s_feats"], x["q_points"], x["s_points"], x["table"], x["kp"],
                               x["w"], SIGMA, pool_feats=x["pool"], pool_cols=pool_cols,
                               q_mask=x["q_mask"], residuals=True)
    scale = whole[0].abs().max().item()
    for ref in (combine, whole):
        assert (walk[0] - ref[0]).abs().max().item() <= 1e-6 * scale  # out
        assert torch.equal(walk[1], ref[1])  # pooled
        assert torch.equal(walk[2], ref[2])  # count
    assert torch.equal(walk[3], combine[3])  # ties against the combined max
    has_tail = x["rank"].long() < x["tail"].shape[0]
    at_shadow = ~has_tail[:, None] & (walk[1] == 0.0)
    assert torch.equal(walk[3][~at_shadow], whole[3][~at_shadow])
    # the whole table also counts its (pool_cols - H1) shadow columns there
    nbr = torch.where(x["q_mask"][:, None], x["head"].long(), n)
    head_ties = (gather_with_shadow(x["pool"], nbr, 0.0) == 0.0).sum(dim=1).float()
    want = torch.clamp(head_ties + (pool_cols - h1), min=1.0)
    assert torch.equal(whole[3][at_shadow], want[at_shadow])
    assert torch.equal(walk[3][at_shadow], torch.clamp(head_ties, min=1.0)[at_shadow])
    if deep == "none":
        assert not has_tail.any()
    elif deep == "all":
        assert has_tail.all()


def split_inverse_case(seed, deep):
    g = torch.Generator().manual_seed(seed)
    m, n, h, j, j1 = 120, 160, 20, 48, 16
    s_points = torch.rand(n, 3, generator=g) * 0.2
    q_points = torch.rand(m, 3, generator=g) * 0.2
    table = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    table[torch.rand(m, h, generator=g) < 0.2] = n
    table[m - 5:] = n  # padding queries
    inv = torch.from_numpy(build_inverse_table(table.numpy(), n, j))
    if deep == "none":
        inv[:, j1:] = m
    n2 = int((inv[:, j1:] < m).any(1).sum())
    tail, tail_s, rank = (torch.from_numpy(x) for x in
                          build_split_tables(inv.numpy(), m, j1, n2 + 3))
    split = (inv[:, :j1].contiguous(), tail, tail_s, rank)
    c_in, c_out, c_pool = 12, 8, 6
    feats = torch.randn(n, c_in, generator=g)
    w = torch.randn(15, c_in, c_out, generator=g) / c_in
    gdiv = torch.randn(m, c_out, generator=g)
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))
    pool = torch.randint(-2, 2, (n, c_pool), generator=g).float()
    _, pooled, _, ties = kpconv_fused_plain(torch.ones(n, 1), q_points, s_points, table, kp,
                                            torch.zeros(15, 1, 1), SIGMA, pool_feats=pool,
                                            residuals=True)
    pool_kw = dict(pool_feats=pool, pooled=pooled,
                   dpool_over_ties=torch.randn(m, c_pool, generator=g) / ties)
    return [feats, s_points, q_points, gdiv], inv, split, [kp, w], pool_kw


@pytest.mark.parametrize("deep", ["some", "none"])
def test_one_pass_split_backward_equals_the_whole_inverse_table(deep):
    args, inv, split, rest, pool_kw = split_inverse_case(5, deep)
    head, tail, _, rank = split
    n = inv.shape[0]
    tail_rows = torch.cat([tail, torch.full_like(tail[:1], args[2].shape[0])])[rank.long()]
    assert torch.equal(torch.cat([head, tail_rows], dim=1), inv)  # the walk is the whole table
    if deep == "none":
        assert not (rank.long() < tail.shape[0]).any()
    else:
        assert (rank.long() < tail.shape[0]).sum() > n // 10
    got = kpconv_bwd_fused_plain(*args, split, *rest, SIGMA, **pool_kw)
    want = kpconv_bwd_fused_plain(*args, inv, *rest, SIGMA, **pool_kw)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-6 * w.abs().max().item()
