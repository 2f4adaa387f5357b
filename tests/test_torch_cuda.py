"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips where no CUDA device exists (the kernels
have no CPU or interpret mode). Run on the H100 with
``python -m pytest tests/test_torch_cuda.py -m cuda -q``. Tolerances are
chip_smoke.py's: KPConv forward and backward rtol 1e-4 + atol 1e-5 x
max|plain| (f32 sums in another order), GSE atol 1e-3 (256-term f32
projections in another order, sincosf arguments up to ~12), its parameter
gradients atol 1e-4 x max|plain|, Sinkhorn forward and backward 1e-4 (at
3DMatch's 65 x 65 patches and KITTI's 129 x 129); the
split-table and union convs as the KPConv forward (their counts and pooled
values exactly), the GT patch overlaps exactly (the kernel and its plain
version round the same direct distance alike), the RPE pair scores and the
fused attention 1e-5 x max|plain| (f32 dot products in another order; exact
zeros outside the valid rectangle and on padded rows), the attention's
gradients (the plain version's, recomputed) 1e-5. The attention kernel
also repeats bit for bit, and an attention call and a KPConv call are
captured in a CUDA graph (one launch counted at capture, a replay equal to
an eager call). The KPConv kernels (an edge pass and a 3xTF32 tensor-core
contraction, one launch a conv or a backward, whole or split table) are
also held to their plain versions at C_in x C_out from 1 x 4 to 512 x 512
(tensor-core and CUDA-core widths), ragged M and N, whole masked and
all-sentinel tiles, J = 136 inverse tables of mostly sentinels, split tables
without tail rows and with every query in the tail, and pool ties at the
zero shadow; they repeat bit for bit (dW over several row slices included)
and a split conv and its backward replay from a CUDA graph as run eagerly.
The GSE backward (3xTF32 tensor-core products, ties settled in float64 in
the kernel) is held to its plain version at C = 32 to 256, ragged N,
n_valid N, below N and 1, and exact ties of two angle projections; both GSE
rows also at every even width and angle count their JAX kernels take (C =
6, 48, 160 to 224, 288 and 512, A = 1 to 5: padded widths, the new
instances, two channel blocks or row chunks, two angle groups), one launch
each, repeating bit for bit and replaying from a CUDA graph, and an odd C
raises ValueError before any launch; the KPConv rows 1, 5 and 6 at K = 16,
20 and 32 kernel points and rows past 256 channel groups (C = 1,028 and
1,030), repeating and replaying at K = 20; the
Sinkhorn backward (one sweep and one merge an iteration) at (P, M1) from
(1, 17) to (200, 129) and 0, 1 and 100 iterations; both repeat bit for bit,
replay from a CUDA graph as run eagerly, and raise beyond their capacity.
The GSE forward (3xTF32 tensor-core projections) is held to its plain
version at C = 32 to 256, A = 1 to 4, ragged N, n_valid N, below N and 1,
and on the diagonal (angle 0) to the cosine rows' sum; the Sinkhorn
forward (rows 4 and 9, one kernel) at the paths' (P, M1) of (256, 65),
(256, 129), (128, 129) and odd shapes with a patch masked entirely, within
1e-4 + 1e-4 |plain|, the training forward's result the inference result
bit for bit; both repeat bit for bit and replay from a CUDA graph as run
eagerly. The input convs (rows 2 and 7:
lanes split a query's slots, bulk copies or 4-byte cp.async into the
stream's ring) are held to their plain versions at the three paths' (H,
D), ragged M, K = 7 and 15, both copy routes with blocks that walk one to
six tiles of the ring, features of both signs with flags that differ
from them, queries without a valid slot, a union at its cap and a tile of
100 queries, with t1 and the count (bit-equal); both repeat bit for bit
and replay from a CUDA graph as run eagerly. Every shape the JAX kernels
compute computes here: the input convs at K = 16, 20 and 32 (chunks of 16
kernel points), the Sinkhorn forwards at 240 to 400 x 300 and the
backward at 160 to 600 (the general kernels, S and the partials in shared
memory or not), the pair scores at C = 130, 640, 1024 and 12 or 16 heads,
the attention at head widths 5, 24, 48, 96 and 128, and misaligned views
for both: each case launches the kernel (its counter rises) and agrees
with the plain version within its row's tolerance, and the general routes
replay from a CUDA graph; the Sinkhorn kernels raise only past their
vectors' shared memory. The GT patch overlaps are bit-equal to their
plain version at K = 16, 48, 128 and 129, S = 13, 64 and 300, int64 and
int32 indices, with non-prefix masks, empty patches, a ref node whose
candidates are all off, masked candidates with indices out of range, and
from a CUDA graph. The vanilla, PE and LRPE transformers launch the
attention kernel twice a block and agree with their einsum route within
1e-4; the quaternion Kabsch agrees with its CPU run within 1e-5 and
replays from a CUDA graph. Two torch.profiler sessions in one process count
the same hand-written kernel events around a full-width 3DMatch forward;
TransformerEncoder and TransformerDecoder launch the attention kernel once
a self-attention layer and twice a decoder layer, within 1e-4 of their
einsum route; rows 3 and 8 agree with their plain versions at C = 96.
Past the launchers' former limits (the general routes, each chosen by the
route function beside its wrapper): the stream input conv at H = 360 and
512 and K D = 61,440, the union input conv at a ~14,000-row union and
K D = 61,440, rows 1, 5 and 6 with the pool over 1,024 columns (the pooled
max and tie counts bit for bit), patch_overlaps at K = 2,048 (bit-equal),
the attention at dh = 3,100 and 4,096, the GSE backward at A = 255 and 300,
the search at cand_cap 32,768 and brute over 40,000 rows with K = 40 and
1,500 (bit-equal), the pair scores at 65,540 rows and the attention at
65,540 heads: each launches once, agrees with its plain version, repeats
bit for bit and replays from a CUDA graph; the shipped shapes keep their
instances.
"""

import numpy as np
import pytest
import torch

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.kernels import gse as gse_kernels
from geotransformer_tpu_torch.kernels import sinkhorn as sinkhorn_kernels
from geotransformer_tpu_torch.kernels.attention import (
    fused_masked_attention,
    fused_masked_attention_diff,
    fused_masked_attention_plain,
    rpe_pair_scores,
    rpe_pair_scores_plain,
)
from geotransformer_tpu_torch.kernels.gse import (
    gse_embedding_full,
    gse_embedding_full_plain,
    gse_full_bwd,
    gse_full_bwd_plain,
)
from geotransformer_tpu_torch.kernels.kpconv import (
    kpconv_bwd_fused,
    kpconv_bwd_fused_plain,
    kpconv_fused,
    kpconv_fused_diff,
    kpconv_fused_plain,
    kpconv_pool_fused_diff,
    kpconv_split_fused,
    kpconv_split_fused_plain,
    kpconv_split_pool_scatter_diff,
    kpconv_split_scatter_diff,
    kpconv_stream_fused,
    kpconv_stream_fused_plain,
    kpconv_union_input_fused,
    kpconv_union_input_fused_plain,
)
from geotransformer_tpu_torch.kernels.overlap import patch_overlaps, patch_overlaps_plain
from geotransformer_tpu_torch.kernels.sinkhorn import (
    sinkhorn_bwd_train,
    sinkhorn_bwd_train_plain,
    sinkhorn_fwd_train,
    sinkhorn_fwd_train_plain,
    sinkhorn_log_iterations,
    sinkhorn_log_iterations_plain,
)
from geotransformer_tpu_torch.models.kernel_points import load_kernel_points
from geotransformer_tpu_torch.preprocess.pyramid import (
    build_inverse_table,
    build_split_tables,
    build_union_tables,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def assert_kpconv_close(got, want):
    bound = 1e-4 * want.abs() + 1e-5 * want.abs().max()
    assert bool(((got - want).abs() <= bound).all()), (got - want).abs().max().item()


def kpconv_case(device, c, m=300, n=500, h=40, c_pool=0, seed=0):
    g = torch.Generator().manual_seed(seed)
    s_points = torch.rand(n, 3, generator=g) * 0.3
    q_points = torch.rand(m, 3, generator=g) * 0.3
    nbrs = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    nbrs[torch.rand(m, h, generator=g) < 0.3] = n
    feats = torch.randn(n, c, generator=g)
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))
    w = torch.randn(15, c, c, generator=g) / c
    bias = torch.randn(c, generator=g)
    pool = torch.randn(n, c_pool, generator=g) if c_pool else None
    q_mask = torch.rand(m, generator=g) < 0.9
    q_mask[m // 2:] = False  # whole padding tiles
    to = lambda t: None if t is None else t.to(device)  # noqa: E731
    return [to(t) for t in (feats, q_points, s_points, nbrs, kp, w)], to(bias), to(pool), to(q_mask)


@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("with_pool", [False, True])
def test_kpconv_fused_matches_plain(device, c, with_pool):
    args, bias, pool, q_mask = kpconv_case(device, c, c_pool=2 * c if with_pool else 0)
    kw = dict(pool_feats=pool, pool_cols=38) if with_pool else {}
    before = cuda.launches["kpconv_fused"]
    got = kpconv_fused(*args, 0.05, bias, q_mask=q_mask, **kw)
    assert cuda.launches["kpconv_fused"] == before + 1
    want = kpconv_fused_plain(*args, 0.05, bias, q_mask=q_mask, **kw)
    torch.cuda.synchronize()
    if with_pool:
        assert torch.equal(got[1], want[1])  # max is exact
        got, want = got[0], want[0]
    assert_kpconv_close(got, want)


def stream_case(device, m, h, k=15, d=64, seed=1):
    """An edge stream as build_input_stream lays it out (padded slots all
    zeros), with features of both signs, flags that differ from the
    features on some slots (flag 1 on a zero feature, flag 0 on a positive
    one) and every seventh query without a valid slot."""
    g = torch.Generator().manual_seed(seed)
    valid = torch.rand(m, h, generator=g) < 0.8
    valid[::7] = False
    feat = torch.randn(m, h, generator=g)
    feat[torch.rand(m, h, generator=g) < 0.05] = 0.0
    flag = feat > 0
    flag ^= torch.rand(m, h, generator=g) < 0.05
    stream = torch.randn(5, m, h, generator=g) * 0.03
    stream[3] = flag.float()
    stream[4] = feat
    stream *= valid
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))[:k].contiguous()
    w = torch.randn(k, 1, d, generator=g)
    return [t.to(device) for t in (stream, kp, w)]


def stream_launch(m, h):
    """What csrc/kpconv.cu's kpconv_stream_launch picks for an (M, H)
    stream on this card: 32-query tiles (8 lanes a query) where they cover
    the SMs, else 16-query tiles (two 32-query blocks fit an SM at every H
    here); the bulk-copy ring where M H % 4 == 0 (a fresh tensor is 16-byte
    aligned), else 4-byte cp.async; two blocks an SM, so a block walks up to
    `walk` tiles (three or more cycle its ring's mbarrier parities)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    queries = 32 if -(-m // 32) >= sms else 16
    tiles = -(-m // queries)
    return {"queries": queries, "bulk": m * h % 4 == 0, "walk": -(-tiles // min(tiles, 2 * sms))}


# M not a multiple of the tile; the three paths' (H, D), tiles of 32 queries
# (3DMatch, KITTI) and 16 (ModelNet), a K the configs do not use, blocks that
# walk one to six tiles, the bulk-copy route and (unaligned) the 4-byte one
@pytest.mark.parametrize("m, h, k, queries, bulk, walk", [
    (50002, 38, 15, 32, True, 6), (20004, 65, 15, 32, True, 3), (1502, 34, 15, 16, True, 1),
    (1000, 40, 7, 16, True, 1), (17002, 38, 7, 32, True, 3), (9001, 38, 15, 32, False, 2)],
    ids=["3dmatch", "kitti", "modelnet", "k7", "k7-walk", "unaligned"])
def test_kpconv_stream_matches_plain(device, m, h, k, queries, bulk, walk):
    assert stream_launch(m, h) == {"queries": queries, "bulk": bulk, "walk": walk}
    stream, kp, w = stream_case(device, m, h, k)
    before = cuda.launches["kpconv_stream_fused"]
    got = kpconv_stream_fused(stream, kp, w, 0.05, residuals=True)
    out = kpconv_stream_fused(stream, kp, w, 0.05)
    assert cuda.launches["kpconv_stream_fused"] == before + 2
    want = kpconv_stream_fused_plain(stream, kp, w, 0.05, residuals=True)
    torch.cuda.synchronize()
    assert torch.equal(out, got[0])
    assert_kpconv_close(got[0], want[0])
    assert_kpconv_close(got[1], want[1])  # t1
    assert torch.equal(got[2], want[2])  # count: a sum of 0/1 flags
    empty = ~(stream[3] != 0).any(1) & ~(stream[4] != 0).any(1)
    assert bool(empty[::7].all())
    assert not got[0][empty].any() and not got[1][empty].any()
    assert bool((got[2][empty] == 1).all())


@pytest.mark.parametrize("c", [32, 256])
@pytest.mark.parametrize("n_valid", [90, 100])
def test_gse_matches_plain(device, c, n_valid):
    g = torch.Generator().manual_seed(2)
    n, k = 100, 3
    points = torch.rand(n, 3, generator=g)
    ref_vectors = torch.randn(n, k, 3, generator=g) * 0.1
    ref_vectors[0] = -0.1  # the signed-zero diagonal case
    w_d, w_a = (torch.randn(c, c, generator=g) / c**0.5 for _ in range(2))
    b_d, b_a = torch.randn(c, generator=g), torch.randn(c, generator=g)
    nv = torch.tensor(n_valid, dtype=torch.int32)
    args = [t.to(device) for t in (points, ref_vectors, w_d, b_d, w_a, b_a)]
    got = gse_embedding_full(*args, 0.2, 15.0, nv.to(device))
    want = gse_embedding_full_plain(*args, 0.2, 15.0, nv.to(device))
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-3
    assert not got[n_valid:].any() and not got[:, n_valid:].any()


def test_sinkhorn_matches_plain(device):
    g = torch.Generator().manual_seed(3)
    p, m1 = 64, 65
    scores = torch.randn(p, m1, m1, generator=g)
    masked = torch.rand(p, m1, m1, generator=g) < 0.1
    masked[0] = True  # an empty patch
    masked[0, -1, -1] = False
    scores = torch.where(masked, -1e12, scores)
    log_mu = torch.where(masked.all(dim=2), -1e12, -np.log(2 * m1))
    log_nu = torch.where(masked.all(dim=1), -1e12, -np.log(2 * m1))
    args = [t.to(device) for t in (scores, log_mu, log_nu)]
    got = sinkhorn_log_iterations(*args, 100)
    want = sinkhorn_log_iterations_plain(*args, 100)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    valid = ~masked.to(device)
    torch.testing.assert_close(got[valid], want[valid], rtol=1e-4, atol=1e-4)


def test_wrapper_rejects_bad_inputs(device):
    args, bias, _, _ = kpconv_case(device, 32, m=20, n=30, h=8)
    args[3] = args[3].long()  # neighbor table must be int32
    with pytest.raises(ValueError, match="dtype"):
        kpconv_fused(*args, 0.05, bias)


@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("with_pool", [False, True])
def test_kpconv_fused_residuals_match_plain(device, c, with_pool):
    args, bias, pool, q_mask = kpconv_case(device, c, c_pool=2 * c if with_pool else 0)
    kw = dict(pool_feats=pool, pool_cols=38) if with_pool else {}
    got = kpconv_fused(*args, 0.05, bias, q_mask=q_mask, residuals=True, **kw)
    want = kpconv_fused_plain(*args, 0.05, bias, q_mask=q_mask, residuals=True, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[1:], want[1:]):  # pooled, count, ties are exact
        assert torch.equal(g, w)
    assert_kpconv_close(got[0], want[0])


def kpconv_bwd_case(device, c_in, c_out, n, m, j, c_pool=0, seed=0):
    g = torch.Generator().manual_seed(seed)
    s_points = torch.rand(n, 3, generator=g) * 0.3
    q_points = torch.rand(m, 3, generator=g) * 0.3
    h = min(24, n)
    nbrs = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    nbrs[torch.rand(m, h, generator=g) < 0.3] = n
    nbrs[m - 7:] = n  # padding queries
    inv = torch.from_numpy(build_inverse_table(nbrs.numpy(), n, j))
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))
    feats = torch.randn(n, c_in, generator=g)
    w = torch.randn(15, c_in, c_out, generator=g) / c_in
    gdiv = torch.randn(m, c_out, generator=g)
    args = [feats, s_points, q_points, gdiv, inv, kp, w]
    kw = {}
    if c_pool:
        pool = torch.randint(-2, 2, (n, c_pool), generator=g).float()  # tied maxima
        _, pooled, _, ties = kpconv_fused_plain(
            torch.ones(n, 1), q_points, s_points, nbrs, kp, torch.zeros(15, 1, 1), 0.05,
            pool_feats=pool, residuals=True)
        kw = dict(pool_feats=pool, pooled=pooled,
                  dpool_over_ties=torch.randn(m, c_pool, generator=g) / ties)
    return [t.to(device) for t in args], {k: v.to(device) for k, v in kw.items()}


@pytest.mark.parametrize("c_in, c_out, n, m, j", [
    (32, 32, 1000, 997, 80), (64, 128, 333, 301, 40), (128, 128, 517, 250, 32),
    (256, 256, 130, 129, 80), (32, 64, 5, 3, 8)])
@pytest.mark.parametrize("with_pool", [False, True])
def test_kpconv_bwd_matches_plain(device, c_in, c_out, n, m, j, with_pool):
    args, kw = kpconv_bwd_case(device, c_in, c_out, n, m, j, c_pool=2 * c_in if with_pool else 0)
    before = cuda.launches["kpconv_bwd_fused"]
    got = kpconv_bwd_fused(*args, 0.05, **kw)
    assert cuda.launches["kpconv_bwd_fused"] == before + 1
    want = kpconv_bwd_fused_plain(*args, 0.05, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (3 if with_pool else 2)
    for g, w in zip(got, want):
        assert_kpconv_close(g, w)


@pytest.mark.parametrize("c_in, c_out, n, m, j, h1", [
    (32, 32, 1000, 997, 80, 8), (64, 128, 333, 301, 40, 16), (128, 128, 517, 250, 32, 8),
    (256, 256, 130, 129, 80, 72)], ids=["deep", "wide", "narrow", "all-shallow"])
@pytest.mark.parametrize("with_pool", [False, True])
def test_kpconv_bwd_split_matches_plain_and_unsplit(device, c_in, c_out, n, m, j, h1, with_pool):
    args, kw = kpconv_bwd_case(device, c_in, c_out, n, m, j, c_pool=2 * c_in if with_pool else 0)
    inv = args[4].cpu().numpy()
    m2 = int((inv[:, h1:] < m).any(axis=1).sum())
    tail, tail_s, rank = build_split_tables(inv, m, h1, m2 + 3)  # padding tail rows too
    split = (args[4][:, :h1].contiguous(),) + tuple(
        torch.from_numpy(x).to(device) for x in (tail, tail_s, rank))
    call = args[:4] + [split] + args[5:]
    before = cuda.launches["kpconv_bwd_fused"]
    got = kpconv_bwd_fused(*call, 0.05, **kw)
    assert cuda.launches["kpconv_bwd_fused"] == before + 1  # head and tail in one pass
    want = kpconv_bwd_fused_plain(*call, 0.05, **kw)
    whole = kpconv_bwd_fused_plain(*args, 0.05, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(whole) == (3 if with_pool else 2)
    for g, w, u in zip(got, want, whole):
        assert_kpconv_close(g, w)
        assert_kpconv_close(g, u)


@pytest.mark.parametrize("split", [False, True], ids=["whole", "split"])
@pytest.mark.parametrize("with_pool", [False, True])
def test_kpconv_scatter_backward_matches_plain_and_repeats(device, split, with_pool):
    """The backward without inverse tables (PyTorch operations around the
    forward kernel) on the card against the same Function on the CPU
    (the plain forward), the KPConv tolerance; bit-equal on a repeat."""
    args, bias, pool, q_mask = kpconv_case(device, 64, c_pool=128 if with_pool else 0)
    feats, q_points, s_points, nbrs, kp, w = args
    n = s_points.shape[0]
    tables = None
    if split:
        table = nbrs.cpu().numpy()
        m2 = int((table[:, 16:] < n).any(axis=1).sum())
        tables = tuple(torch.from_numpy(x).to(device)
                       for x in build_split_tables(table, n, 16, m2 + 3))
    g = torch.Generator().manual_seed(5)
    dout = torch.randn(q_points.shape[0], 64, generator=g).to(device)
    dpool = torch.randn(q_points.shape[0], 128, generator=g).to(device)

    def grads(dev):
        to = lambda t: t.to(dev)  # noqa: E731
        sf, w_, b = (to(t).clone().requires_grad_() for t in (feats, w, bias))
        pf = to(pool).clone().requires_grad_() if with_pool else None
        common = (to(q_points), to(s_points))
        kw = dict(q_mask=to(q_mask))
        if split:
            head = to(nbrs[:, :16].contiguous())
            split_tables = tuple(to(t) for t in tables)
            out = (kpconv_split_pool_scatter_diff(sf, pf, *common, head, split_tables, to(kp), w_,
                                                  0.05, b, pool_cols=38, **kw) if with_pool
                   else kpconv_split_scatter_diff(sf, *common, head, split_tables, to(kp), w_,
                                                  0.05, b, **kw))
        else:
            out = (kpconv_pool_fused_diff(sf, pf, *common, to(nbrs), to(kp), w_, 0.05, b,
                                          pool_cols=38, **kw) if with_pool
                   else kpconv_fused_diff(sf, *common, to(nbrs), to(kp), w_, 0.05, b, **kw))
        if with_pool:
            loss = (out[0] * to(dout)).sum() + (out[1] * to(dpool)).sum()
            return torch.autograd.grad(loss, (sf, pf, w_, b))
        return torch.autograd.grad((out * to(dout)).sum(), (sf, w_, b))

    got, again, want = grads(device), grads(device), grads("cpu")
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)
        assert_kpconv_close(g_.cpu(), w_)


@pytest.mark.parametrize("c", [32, 256])
@pytest.mark.parametrize("n, n_valid", [(100, 100), (100, 61), (37, 1)])
def test_gse_bwd_matches_plain(device, c, n, n_valid):
    g = torch.Generator().manual_seed(4)
    points = torch.rand(n, 3, generator=g)
    ref_vectors = torch.randn(n, 3, 3, generator=g) * 0.1
    ref_vectors[0] = -0.1  # the signed-zero diagonal case
    w_a = torch.randn(c, c, generator=g) / c**0.5
    de = torch.randn(n, n, c, generator=g)
    nv = torch.tensor(n_valid, dtype=torch.int32)
    args = [t.to(device) for t in (points, ref_vectors, w_a)]
    before = cuda.launches["gse_full_bwd"]
    got = gse_full_bwd(*args, 0.2, 15.0, de.to(device), nv.to(device))
    assert cuda.launches["gse_full_bwd"] == before + 1
    want = gse_full_bwd_plain(*args, 0.2, 15.0, de.to(device), nv.to(device))
    torch.cuda.synchronize()
    for name, gv, wv in zip(("dW_d", "db_d", "dW_a", "db_a"), got, want):
        err = (gv - wv).abs().max().item()
        assert err <= 1e-4 * wv.abs().max().item() + 1e-6, f"{name}: {err}"


def sinkhorn_train_case(device, p=64, m1=65, iterations=100):
    g = torch.Generator().manual_seed(5)
    scores = torch.randn(p, m1, m1, generator=g)
    masked = torch.rand(p, m1, m1, generator=g) < 0.1
    masked[0] = True  # an all-masked patch but for the dustbin corner
    masked[0, -1, -1] = False
    masked[1] = False
    scores = torch.where(masked, -1e12, scores)
    log_mu = torch.where(masked.all(dim=2), -1e12, -np.log(2 * m1))
    log_nu = torch.where(masked.all(dim=1), -1e12, -np.log(2 * m1))
    dout = torch.where(masked, 0.0, torch.randn(p, m1, m1, generator=g))
    return [t.to(device) for t in (scores, log_mu, log_nu, dout)], masked.to(device)


@pytest.mark.parametrize("p, m1", [(64, 65), (3, 17), (16, 129)])
def test_sinkhorn_train_matches_plain(device, p, m1):
    (scores, log_mu, log_nu, dout), masked = sinkhorn_train_case(device, p, m1)
    out, v_hist = sinkhorn_fwd_train(scores, log_mu, log_nu, 100)
    want_out, want_hist = sinkhorn_fwd_train_plain(scores, log_mu, log_nu, 100)
    # the training forward is the inference kernel's arithmetic
    assert torch.equal(out, sinkhorn_log_iterations(scores, log_mu, log_nu, 100))
    got = sinkhorn_bwd_train(scores, log_mu, v_hist, dout)
    want = sinkhorn_bwd_train_plain(scores, log_mu, want_hist, dout)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[~masked], want_out[~masked], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(v_hist, want_hist, rtol=1e-4, atol=1e-4)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def split_case(device, c, m, h1, deep, seed=0):
    """A conv case with its table split at h1; ``deep``: "some", "none" (M2
    = 0 used rows) or "all"."""
    args, bias, pool, q_mask = kpconv_case(device, c, m=m, c_pool=2 * c, seed=seed)
    n = args[0].shape[0]
    table = args[3].cpu().clone()
    table = torch.where(table < n, table, n)
    table = torch.sort(table, dim=1).values.to(torch.int32)  # valid columns first
    if deep == "some":
        table[::2, h1:] = n  # every other query shallow
    elif deep == "none":
        table[:, h1:] = n
    elif deep == "all":
        table[:, :h1 + 1] = torch.arange(h1 + 1, dtype=torch.int32)
    m2 = int((table[:, h1:] < n).any(1).sum())
    tail, tail_q, rank = build_split_tables(table.numpy(), n, h1, m2 + 3)
    split = [torch.from_numpy(x).to(device) for x in (tail, tail_q, rank)]
    args[3] = table.to(device)
    return args, bias, pool, q_mask, table[:, :h1].contiguous().to(device), split


@pytest.mark.parametrize("c, m, deep", [(32, 301, "some"), (128, 77, "some"), (64, 200, "none"),
                                        (32, 130, "all")])
@pytest.mark.parametrize("with_pool", [False, True])
def test_kpconv_split_matches_plain_and_unsplit(device, c, m, deep, with_pool):
    args, bias, pool, q_mask, head, split = split_case(device, c, m, 8, deep)
    kw = dict(pool_feats=pool, pool_cols=38) if with_pool else {}
    call = (args[0], args[1], args[2], head, *split, args[4], args[5], 0.05, bias)
    before = dict(cuda.launches)
    got = kpconv_split_fused(*call, q_mask=q_mask, residuals=True, **kw)
    # one pass over head and tail, counted as the split conv's
    assert cuda.launches["kpconv_split_fused"] == before.get("kpconv_split_fused", 0) + 1
    assert cuda.launches["kpconv_fused"] == before.get("kpconv_fused", 0)
    want = kpconv_split_fused_plain(*call, q_mask=q_mask, residuals=True, **kw)
    whole = kpconv_fused_plain(*args, 0.05, bias, q_mask=q_mask, residuals=True, **kw)
    torch.cuda.synchronize()
    for ref in (want, whole):
        assert_kpconv_close(got[0], ref[0])
        assert torch.equal(got[2 if with_pool else 1], ref[2 if with_pool else 1])  # count
        if with_pool:
            assert torch.equal(got[1], ref[1])  # pooled
    if with_pool:
        assert torch.equal(got[3], want[3])  # ties against the combined max


@pytest.mark.parametrize("m, tile, h", [(300, 128, 40), (257, 64, 24)], ids=["ragged", "odd"])
def test_kpconv_union_matches_plain(device, m, tile, h):
    args, bias, _, _ = kpconv_case(device, 1, m=m, n=400, h=h)
    feats = (torch.rand(400, 1, generator=torch.Generator().manual_seed(3)) > 0.2).float()
    table = args[3].cpu().numpy()
    rows, sel = build_union_tables(table, 400, tile=tile, union_cap=512)
    rows, sel = torch.from_numpy(rows).to(device), torch.from_numpy(sel).to(device)
    call = (feats.to(device), args[1], args[2], rows, sel, args[4], args[5], 0.05, bias)
    before = cuda.launches["kpconv_union_input_fused"]
    got = kpconv_union_input_fused(*call, tile=tile, residuals=True)
    assert cuda.launches["kpconv_union_input_fused"] == before + 1
    want = kpconv_union_input_fused_plain(*call, tile=tile, residuals=True)
    torch.cuda.synchronize()
    assert_kpconv_close(got[0], want[0])
    assert torch.equal(got[1], want[1])  # count
    assert_kpconv_close(got[2], want[2])  # t1


def union_case(device, m, n, h, tile, seed=0):
    """The union conv's inputs at a tile's union cap: the cap is the largest
    tile's union; every eleventh query has no edge; features of both signs
    and some zeros."""
    args, _, _, _ = kpconv_case(device, 1, m=m, n=n, h=h, seed=seed)
    g = torch.Generator().manual_seed(seed)
    w, bias = torch.randn(15, 1, 64, generator=g).to(device), torch.randn(64, generator=g).to(device)
    table = args[3].cpu().numpy().copy()
    table[5::11] = n
    blocks = [table[t:t + tile] for t in range(0, m, tile)]
    cap = max(np.unique(b[b < n]).size for b in blocks)
    rows, sel = build_union_tables(table, n, tile=tile, union_cap=cap)
    feats = args[0].clone()
    feats[::9] = 0.0
    call = (feats, args[1], args[2], torch.from_numpy(rows).to(device),
            torch.from_numpy(sel).to(device), args[4], w, 0.05, bias)
    return call, torch.from_numpy((table >= n).all(1)).to(device)


@pytest.mark.parametrize("m, n, h, tile", [(700, 900, 38, 128), (611, 700, 65, 100)],
                         ids=["3dmatch", "odd-tile"])
def test_kpconv_union_at_cap_with_empty_queries(device, m, n, h, tile):
    call, empty = union_case(device, m, n, h, tile)
    assert bool(empty.any())
    got = kpconv_union_input_fused(*call, tile=tile, residuals=True)
    want = kpconv_union_input_fused_plain(*call, tile=tile, residuals=True)
    torch.cuda.synchronize()
    assert_kpconv_close(got[0], want[0])
    assert torch.equal(got[1], want[1])  # count
    assert_kpconv_close(got[2], want[2])  # t1
    bias = call[-1]
    assert torch.equal(got[0][empty], bias.expand(int(empty.sum()), -1))
    assert bool((got[1][empty] == 1).all()) and not got[2][empty].any()


def test_input_convs_repeat_bit_for_bit_and_replay_from_a_graph(device):
    """Both input convs (the stream on its bulk-copy route with blocks that
    walk six tiles, and on the 4-byte one): two runs bit-equal, and a
    CUDA-graph capture (one launch counted) whose replay equals the eager
    call."""
    streams = {shape: stream_case(device, *shape) for shape in [(50002, 38), (9001, 38)]}
    assert [stream_launch(*shape)["bulk"] for shape in streams] == [True, False]
    call, _ = union_case(device, 700, 900, 38, 128)
    convs = [("kpconv_stream_fused", lambda s=s: kpconv_stream_fused(*s, 0.05, residuals=True))
             for s in streams.values()]
    convs.append(("kpconv_union_input_fused",
                  lambda: kpconv_union_input_fused(*call, tile=128, residuals=True)))
    for name, conv in convs:
        first, second = conv(), conv()
        graph, out, launches = captured(conv, name)
        assert launches == 1
        for x in out:
            x.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(first, second))
        assert all(torch.equal(a, b) for a, b in zip(out, first))


@pytest.mark.parametrize("m, n, k, s", [(64, 70, 128, 64), (37, 41, 64, 8), (5, 9, 33, 13)])
def test_patch_overlaps_match_plain(device, m, n, k, s):
    g = torch.Generator().manual_seed(6)
    ref_nodes, src_nodes = torch.rand(m, 1, 3, generator=g) * 3, torch.rand(n, 1, 3, generator=g) * 3
    ref = ref_nodes + torch.rand(m, k, 3, generator=g) - 0.5
    src = src_nodes + torch.rand(n, k, 3, generator=g) - 0.5
    ref_mask = torch.rand(m, k, generator=g) > 0.2
    src_mask = torch.rand(n, k, generator=g) > 0.2
    ref_mask[0] = False  # an empty ref patch
    src_mask[1] = False  # an empty candidate patch
    cand = torch.randint(0, n, (m, s), generator=g)
    cand_mask = torch.rand(m, s, generator=g) > 0.25
    cand_mask[2] = False  # a ref node whose candidates are all masked
    call = [x.to(device) for x in (ref, ref_mask, src, src_mask, cand, cand_mask)]
    before = cuda.launches["patch_overlaps"]
    got = patch_overlaps(*call, 0.3)
    assert cuda.launches["patch_overlaps"] == before + 1
    want = patch_overlaps_plain(*call, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert 0.0 < (got > 0).float().mean().item() < 1.0
    assert not got[2].any() and not got[0].any()


@pytest.mark.parametrize("n, m, c, h, nv_q, nv_k", [
    (192, 192, 256, 4, 150, 150), (300, 293, 128, 4, 281, 250), (50, 40, 64, 8, None, None),
    (33, 70, 36, 2, 1, 69)], ids=["modelnet", "kitti-width", "eight-heads", "ragged"])
def test_rpe_pair_scores_matches_plain(device, n, m, c, h, nv_q, nv_k):
    g = torch.Generator().manual_seed(7)
    embed = torch.randn(n, m, c, generator=g).to(device)
    qw = torch.randn(n, h, c, generator=g).to(device)
    nvq = None if nv_q is None else torch.tensor(nv_q, dtype=torch.int32, device=device)
    before = cuda.launches["rpe_pair_scores"]
    got = rpe_pair_scores(embed, qw, nvq, nv_k)
    assert cuda.launches["rpe_pair_scores"] == before + 1
    want = rpe_pair_scores_plain(embed, qw, nvq, nv_k)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    rows, cols = nv_q or n, nv_k or m
    assert not got[rows:].any() and not got[:, :, cols:].any()


def test_rpe_pair_scores_rejects_misaligned_embed(device):
    """A misaligned embed (once refused) takes the kernel's 4-byte route."""
    embed = torch.randn(8 * 8 * 32 + 1, device=device)[1:].view(8, 8, 32)
    qw = torch.randn(8, 2, 32, device=device)
    before = cuda.launches["rpe_pair_scores"]
    got = rpe_pair_scores(embed, qw)
    assert cuda.launches["rpe_pair_scores"] == before + 1
    want = rpe_pair_scores_plain(embed, qw)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def attention_case(device, h, n, m, dh, with_bias, holes, seed=8):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(h, r, dh, generator=g) for r in (n, m, m))
    bias = torch.randn(n, h, m, generator=g) if with_bias else None
    key_masks = torch.rand(m, generator=g) > 0.3 if holes else None
    to = lambda t: None if t is None else t.to(device)  # noqa: E731
    return [to(t) for t in (q, k, v, bias)], to(key_masks)


@pytest.mark.parametrize("h, n, m, dh, nv_q, nv_k", [
    (4, 512, 512, 64, 411, 299), (4, 192, 192, 64, 136, 136), (4, 256, 256, 32, 256, 200),
    (2, 100, 75, 16, 83, 61), (2, 17, 9, 8, None, None)],
    ids=["3dmatch", "modelnet", "kitti", "ragged", "tiny"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("holes", [False, True], ids=["prefix", "key-holes"])
def test_fused_attention_matches_plain(device, h, n, m, dh, nv_q, nv_k, with_bias, holes):
    (q, k, v, bias), key_masks = attention_case(device, h, n, m, dh, with_bias, holes)
    scale = dh ** -0.5
    before = cuda.launches["fused_masked_attention"]
    got = fused_masked_attention(q, k, v, bias, nv_q, nv_k, scale, key_masks)
    assert cuda.launches["fused_masked_attention"] == before + 1
    want = fused_masked_attention_plain(q, k, v, bias, nv_q, nv_k, scale, key_masks)
    torch.cuda.synchronize()
    rows = nv_q or n
    assert bool(torch.isfinite(got).all())
    assert (got[:rows] - want[:rows]).abs().max().item() <= 1e-5 * want[:rows].abs().max().item()
    assert not got[rows:].any()


def test_fused_attention_diff_gradients_on_the_card(device):
    (q, k, v, bias), key_masks = attention_case(device, 4, 192, 160, 64, True, True)
    inputs = [t.requires_grad_() for t in (q, k, v, bias)]
    dout = torch.randn(192, 256, device=device)
    out = fused_masked_attention_diff(*inputs, 150, 140, 0.125, key_masks)
    got = torch.autograd.grad(out, inputs, dout)
    want_out = fused_masked_attention_plain(*inputs, 150, 140, 0.125, key_masks)
    want = torch.autograd.grad(want_out, inputs, dout)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# the attention kernel's edges: N and M off the 16-row tile and the 16-key
# chunk, nv_k of 0, 1 and below one chunk, nv_q of 0, M = 640 (several
# chunks a warp, so the 8 warps' partial softmaxes merge), a bias row stride
# that is no multiple of 4 floats (the 4-byte copies), every head width
@pytest.mark.parametrize("h, n, m, dh, nv_q, nv_k", [
    (4, 77, 83, 64, 70, 81), (4, 64, 64, 64, 50, 0), (4, 64, 64, 32, 50, 1),
    (4, 64, 64, 16, 64, 11), (4, 64, 64, 8, 0, 64), (4, 640, 640, 64, 600, 640),
    (4, 640, 640, 32, 640, 555), (2, 50, 67, 16, 50, 67), (3, 130, 257, 8, 129, 250)],
    ids=["ragged", "no-key", "one-key", "part-chunk", "no-row", "640-dh64", "640-dh32",
         "odd-stride", "dh8"])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("holes", [False, True], ids=["prefix", "key-holes"])
def test_fused_attention_edges_match_plain(device, h, n, m, dh, nv_q, nv_k, with_bias, holes):
    (q, k, v, bias), key_masks = attention_case(device, h, n, m, dh, with_bias, holes, seed=3)
    nvq = torch.tensor(nv_q, dtype=torch.int32, device=device)
    got = fused_masked_attention(q, k, v, bias, nvq, nv_k, dh ** -0.5, key_masks)
    want = fused_masked_attention_plain(q, k, v, bias, nvq, nv_k, dh ** -0.5, key_masks)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert not got[nv_q:].any()
    if nv_q:
        bound = 1e-5 * want[:nv_q].abs().max().item()
        assert (got[:nv_q] - want[:nv_q]).abs().max().item() <= bound
    if nv_k == 0:
        assert not got.any()


def test_fused_attention_repeats_bit_for_bit(device):
    (q, k, v, bias), key_masks = attention_case(device, 4, 512, 512, 64, True, True, seed=5)
    runs = [fused_masked_attention(q, k, v, bias, 411, 299, 0.125, key_masks) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def test_fused_attention_rejects_misaligned_kv(device):
    """A misaligned k (once refused) takes the kernel's 4-byte copies."""
    (q, k, v, _), _ = attention_case(device, 2, 16, 16, 8, False, False)
    shifted = torch.randn(k.numel() + 1, device=device)[1:].view(k.shape)
    shifted.copy_(k)
    before = cuda.launches["fused_masked_attention"]
    got = fused_masked_attention(q, shifted, v)
    assert cuda.launches["fused_masked_attention"] == before + 1
    want = fused_masked_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


def captured(fn, kernel):
    """fn() captured in a CUDA graph after a warm-up run: (graph, output of
    the captured call, the launches the capture counted)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = cuda.launches[kernel]
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out, cuda.launches[kernel] - before


def test_graph_capture_of_attention_and_rpe_scores(device):
    (q, k, v, _), key_masks = attention_case(device, 4, 192, 192, 64, False, True, seed=6)
    embed = torch.randn(192, 192, 64, device=device)
    qw = torch.randn(192, 4, 64, device=device)
    nv = torch.tensor(107, dtype=torch.int32, device=device)

    def forward():
        bias = rpe_pair_scores(embed, qw, nv, nv)
        return fused_masked_attention(q, k, v, bias, nv, nv, 0.125, key_masks)

    graph, out, launches = captured(forward, "fused_masked_attention")
    assert launches == 1
    graph.replay()
    want = fused_masked_attention_plain(q, k, v, rpe_pair_scores_plain(embed, qw, nv, nv), nv,
                                        nv, 0.125, key_masks)
    torch.cuda.synchronize()
    assert torch.equal(out, forward())
    assert (out[:107] - want[:107]).abs().max().item() <= 1e-5 * want[:107].abs().max().item()
    qw.mul_(2.0)  # a replay reads the captured inputs anew
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, forward())


def test_graph_capture_of_kpconv(device):
    args, bias, pool, q_mask = kpconv_case(device, 64, c_pool=64)
    kw = dict(pool_feats=pool, pool_cols=38, q_mask=q_mask)
    graph, out, launches = captured(lambda: kpconv_fused(*args, 0.05, bias, **kw),
                                    "kpconv_fused")
    assert launches == 1
    args[0].mul_(0.5)
    graph.replay()
    want = kpconv_fused_plain(*args, 0.05, bias, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out[1], want[1])
    assert_kpconv_close(out[0], want[0])


# ---- the KPConv kernels of csrc/kpconv_common.cuh: widths, edges, splits ----

def wide_case(device, c, d, m, n, h, c_pool=0, seed=11, sentinel_share=0.3):
    """A conv of C_in = c, C_out = d over an (M, H) table of the nearest
    supports, ``sentinel_share`` of its slots sentinels, valid columns first,
    a ragged query mask with whole masked runs."""
    g = torch.Generator().manual_seed(seed)
    s_points = torch.rand(n, 3, generator=g) * 0.3
    q_points = torch.rand(m, 3, generator=g) * 0.3
    nbrs = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    nbrs[torch.rand(m, h, generator=g) < sentinel_share] = n
    nbrs = torch.sort(nbrs, dim=1).values
    feats = torch.randn(n, c, generator=g)
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))
    w = torch.randn(15, c, d, generator=g) / c
    pool = torch.randint(-2, 2, (n, c_pool), generator=g).float() if c_pool else None
    q_mask = torch.rand(m, generator=g) < 0.9
    q_mask[m // 3: m // 3 + 150] = False  # whole masked tiles
    to = lambda t: None if t is None else t.to(device)  # noqa: E731
    return [to(t) for t in (feats, q_points, s_points, nbrs, kp, w)], to(pool), to(q_mask)


def split_of(table, n, h1):
    m2 = int((table[:, h1:] < n).any(1).sum())
    tail, tail_q, rank = build_split_tables(table.cpu().numpy(), n, h1, m2 + 5)
    return (table[:, :h1].contiguous(),) + tuple(
        torch.from_numpy(x).to(table.device) for x in (tail, tail_q, rank))


# (C_in, C_out): the tensor-core widths of the three configurations (32 ...
# 512), a width that is a multiple of 8 but not of 32 (48), and the CUDA-core
# widths (1: the input conv, 4)
WIDTHS = [(1, 64), (1, 4), (4, 4), (4, 32), (32, 32), (48, 48), (32, 48), (512, 512)]


@pytest.mark.parametrize("c, d", WIDTHS, ids=[f"{c}x{d}" for c, d in WIDTHS])
@pytest.mark.parametrize("split", [False, True])
def test_kpconv_widths_match_plain(device, c, d, split):
    m, n, h = (301, 517, 40) if c < 512 else (133, 211, 40)
    args, pool, q_mask = wide_case(device, c, d, m, n, h, c_pool=0 if c == 1 else 24)
    kw = dict(q_mask=q_mask, residuals=True)
    if c == 1:
        kw["return_t1"] = True
    else:
        kw.update(pool_feats=pool, pool_cols=30)
    name = "kpconv_split_fused" if split else "kpconv_fused"
    before = cuda.launches[name]
    if split:
        call = (*args[:3], *split_of(args[3], n, 16), args[4], args[5], 0.05)
        got = kpconv_split_fused(*call, **kw)
        want = kpconv_split_fused_plain(*call, **kw)
    else:
        got = kpconv_fused(*args, 0.05, **kw)
        want = kpconv_fused_plain(*args, 0.05, **kw)
    assert cuda.launches[name] == before + 1
    torch.cuda.synchronize()
    assert_kpconv_close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        if c == 1 and g is got[-1]:
            assert_kpconv_close(g, w)  # t1
        else:
            assert torch.equal(g, w)  # pooled, count, ties
    assert not got[0][~q_mask].any()


@pytest.mark.parametrize("case", ["all-masked", "all-sentinel"])
@pytest.mark.parametrize("split", [False, True])
def test_kpconv_dead_tiles_match_plain(device, case, split):
    m, n, h = 200, 300, 40
    args, pool, q_mask = wide_case(device, 32, 32, m, n, h, c_pool=16)
    if case == "all-masked":
        q_mask = torch.zeros_like(q_mask)
    else:
        args[3] = torch.full_like(args[3], n)
        args[3][: m // 2, 0] = 7  # some live queries, whole dead tiles after them
    kw = dict(q_mask=q_mask, residuals=True, pool_feats=pool, pool_cols=30)
    if split:
        call = (*args[:3], *split_of(args[3], n, 16), args[4], args[5], 0.05)
        got = kpconv_split_fused(*call, **kw)
        want = kpconv_split_fused_plain(*call, **kw)
    else:
        got = kpconv_fused(*args, 0.05, **kw)
        want = kpconv_fused_plain(*args, 0.05, **kw)
    torch.cuda.synchronize()
    assert_kpconv_close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


def test_kpconv_split_pool_ties_at_the_zero_shadow(device):
    """Pool features in {-2, -1, 0, 1}: many maxima are 0, the zero shadow
    of a query without a tail row among them; the kernel counts the ties as
    the plain combine does (against the combined max, no tie from a missing
    tail row)."""
    m, n, h, h1 = 300, 400, 40, 16
    args, pool, q_mask = wide_case(device, 8, 8, m, n, h, c_pool=32, seed=5, sentinel_share=0.5)
    table = args[3].clone()
    table[::3, h1:] = n  # every third query without a tail row
    head, tail, tail_q, rank = split_of(table, n, h1)
    call = (*args[:3], head, tail, tail_q, rank, args[4], args[5], 0.05)
    kw = dict(q_mask=q_mask, residuals=True, pool_feats=pool, pool_cols=38)
    got = kpconv_split_fused(*call, **kw)
    want = kpconv_split_fused_plain(*call, **kw)
    torch.cuda.synchronize()
    shadow = (rank.long() == tail.shape[0])[:, None] & (want[1] == 0)
    assert shadow.sum() > 50
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)
    assert_kpconv_close(got[0], want[0])


def bwd_wide_case(device, c_in, c_out, n, m, j, seed=2):
    """A backward over an (N, J) inverse table of a 24-column conv table:
    with J = 136 (KITTI's inverse limit) mostly sentinels."""
    g = torch.Generator().manual_seed(seed)
    s_points = torch.rand(n, 3, generator=g) * 0.3
    q_points = torch.rand(m, 3, generator=g) * 0.3
    h = min(24, n)
    nbrs = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    nbrs[torch.rand(m, h, generator=g) < 0.3] = n
    nbrs[m - 70:] = n  # padding queries
    inv = torch.from_numpy(build_inverse_table(nbrs.numpy(), n, j))
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))
    feats = torch.randn(n, c_in, generator=g)
    w = torch.randn(15, c_in, c_out, generator=g) / c_in
    gdiv = torch.randn(m, c_out, generator=g)
    c_pool = 0 if c_in == 1 else 16
    kw = {}
    if c_pool:
        pool = torch.randint(-2, 2, (n, c_pool), generator=g).float()
        _, pooled, _, ties = kpconv_fused_plain(
            torch.ones(n, 1), q_points, s_points, nbrs, kp, torch.zeros(15, 1, 1), 0.05,
            pool_feats=pool, residuals=True)
        kw = dict(pool_feats=pool, pooled=pooled,
                  dpool_over_ties=torch.randn(m, c_pool, generator=g) / ties)
    args = [t.to(device) for t in (feats, s_points, q_points, gdiv, inv, kp, w)]
    return args, {k: v.to(device) for k, v in kw.items()}


@pytest.mark.parametrize("c, d", WIDTHS, ids=[f"{c}x{d}" for c, d in WIDTHS])
@pytest.mark.parametrize("split", [False, True])
def test_kpconv_bwd_widths_match_plain(device, c, d, split):
    n, m = (1037, 901) if c < 512 else (301, 283)
    args, kw = bwd_wide_case(device, c, d, n, m, 136)
    assert (args[4] < m).float().mean() < 0.25  # mostly sentinels
    if split:
        inv = args[4].cpu().numpy()
        n2 = int((inv[:, 16:] < m).any(1).sum())
        tail, tail_s, rank = build_split_tables(inv, m, 16, n2 + 3)
        args[4] = (args[4][:, :16].contiguous(),) + tuple(
            torch.from_numpy(x).to(device) for x in (tail, tail_s, rank))
    before = cuda.launches["kpconv_bwd_fused"]
    got = kpconv_bwd_fused(*args, 0.05, **kw)
    assert cuda.launches["kpconv_bwd_fused"] == before + 1
    want = kpconv_bwd_fused_plain(*args, 0.05, **kw)
    torch.cuda.synchronize()
    assert len(got) == len(want) == (2 if c == 1 else 3)
    for g, w in zip(got, want):
        assert_kpconv_close(g, w)


def test_kpconv_forward_and_backward_repeat_bit_for_bit(device):
    """Three runs of a split conv, a whole-table conv and a split backward
    whose dW sums several row slices: bit-equal."""
    m, n = 1500, 1700
    args, pool, q_mask = wide_case(device, 64, 64, m, n, 40, c_pool=32)
    split = split_of(args[3], n, 16)
    kw = dict(q_mask=q_mask, residuals=True, pool_feats=pool, pool_cols=30)
    runs = [(kpconv_fused(*args, 0.05, **kw),
             kpconv_split_fused(*args[:3], *split, args[4], args[5], 0.05, **kw))
            for _ in range(3)]
    bargs, bkw = bwd_wide_case(device, 64, 64, 5000, 4000, 80)
    inv = bargs[4].cpu().numpy()
    tail, tail_s, rank = build_split_tables(inv, 4000, 16, int((inv[:, 16:] < 4000).any(1).sum()))
    bargs[4] = (bargs[4][:, :16].contiguous(),) + tuple(
        torch.from_numpy(x).to(device) for x in (tail, tail_s, rank))
    bwd = [kpconv_bwd_fused(*bargs, 0.05, **bkw) for _ in range(3)]
    torch.cuda.synchronize()
    for fwd in runs[1:]:
        for a, b in zip(fwd, runs[0]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    for grads in bwd[1:]:
        assert all(torch.equal(x, y) for x, y in zip(grads, bwd[0]))  # d_s, dW, d_pool


def test_graph_capture_of_split_kpconv_and_its_backward(device):
    m, n = 300, 400
    args, pool, q_mask = wide_case(device, 32, 32, m, n, 40, c_pool=32)
    split = split_of(args[3], n, 16)
    kw = dict(q_mask=q_mask, residuals=True, pool_feats=pool, pool_cols=30)
    bargs, bkw = bwd_wide_case(device, 32, 32, 1037, 901, 136)
    inv = bargs[4].cpu().numpy()
    tail, tail_s, rank = build_split_tables(inv, 901, 16, int((inv[:, 16:] < 901).any(1).sum()))
    bargs[4] = (bargs[4][:, :16].contiguous(),) + tuple(
        torch.from_numpy(x).to(device) for x in (tail, tail_s, rank))

    def both():
        return (kpconv_split_fused(*args[:3], *split, args[4], args[5], 0.05, **kw),
                kpconv_bwd_fused(*bargs, 0.05, **bkw))

    before = cuda.launches["kpconv_bwd_fused"]
    graph, out, launches = captured(both, "kpconv_split_fused")
    assert launches == 1 and cuda.launches["kpconv_bwd_fused"] == before + 2  # warm-up, capture
    args[0].mul_(0.5)
    bargs[3].mul_(2.0)
    graph.replay()
    eager = both()
    torch.cuda.synchronize()
    for a, b in zip(out, eager):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- gse_full_bwd on the tensor cores, the Sinkhorn backward's merged sweeps ----

def gse_bwd_case(device, c, n, n_valid, tied=False, seed=12):
    g = torch.Generator().manual_seed(seed)
    points = torch.rand(n, 3, generator=g)
    ref_vectors = torch.randn(n, 3, 3, generator=g) * 0.1
    if tied:  # two equal reference vectors: their projections tie exactly everywhere
        ref_vectors[:, 2] = ref_vectors[:, 0]
    w_a = torch.randn(c, c, generator=g) / c**0.5
    de = torch.randn(n, n, c, generator=g)
    nv = torch.tensor(n_valid, dtype=torch.int32)
    return [t.to(device) for t in (points, ref_vectors, w_a)], de.to(device), nv.to(device)


def assert_gse_bwd_close(got, want):
    for name, gv, wv in zip(("dW_d", "db_d", "dW_a", "db_a"), got, want):
        err = (gv - wv).abs().max().item()
        assert err <= 1e-4 * wv.abs().max().item() + 1e-6, f"{name}: {err}"


@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("n, n_valid, tied", [(37, 37, False), (53, 29, False), (21, 1, False),
                                              (45, 40, True)])
def test_gse_bwd_tensor_cores_match_plain(device, c, n, n_valid, tied):
    """Ragged N (no multiple of the 16-pair tile or the 64-channel block),
    partial and single valid rows, and exact ties of two angle projections
    (every off-diagonal entry settled in float64, to the first k)."""
    args, de, nv = gse_bwd_case(device, c, n, n_valid, tied)
    got = gse_full_bwd(*args, 0.2, 15.0, de, nv)
    settled = int(gse_kernels.last_settled)
    want = gse_full_bwd_plain(*args, 0.2, 15.0, de, nv)
    torch.cuda.synchronize()
    assert_gse_bwd_close(got, want)
    if tied:  # wherever k = 0 and 2 are the best two
        assert settled > 0


def test_gse_bwd_repeats_bit_for_bit_and_replays_from_a_graph(device):
    args, de, nv = gse_bwd_case(device, 256, 150, 131)
    runs = [gse_full_bwd(*args, 0.2, 15.0, de, nv) for _ in range(3)]
    graph, out, launches = captured(lambda: gse_full_bwd(*args, 0.2, 15.0, de, nv),
                                    "gse_full_bwd")
    assert launches == 1
    de.mul_(0.5)  # a replay reads the captured inputs anew
    graph.replay()
    eager = gse_full_bwd(*args, 0.2, 15.0, de, nv)
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))
    assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert all(torch.equal(a, 0.5 * b) for a, b in zip(eager, runs[0]))


@pytest.mark.parametrize("c, angles", [(512, 3), (256, 4)])
def test_gse_bwd_beyond_capacity_raises(device, c, angles):
    """The shapes the backward once refused (C past 256: two chunks of 256
    basis rows; A past 3: two angle groups) now launch its kernel once and
    agree with the plain version as the shipped widths do."""
    g = torch.Generator().manual_seed(0)
    n = 20
    points = torch.rand(n, 3, generator=g).to(device)
    ref_vectors = torch.randn(n, angles, 3, generator=g).to(device)
    w_a = torch.randn(c, c, generator=g).to(device)
    de = torch.randn(n, n, c, generator=g).to(device)
    before = cuda.launches["gse_full_bwd"]
    got = gse_full_bwd(points, ref_vectors, w_a, 0.2, 15.0, de)
    assert cuda.launches["gse_full_bwd"] == before + 1
    want = gse_full_bwd_plain(points, ref_vectors, w_a, 0.2, 15.0, de)
    torch.cuda.synchronize()
    assert_gse_bwd_close(got, want)


@pytest.mark.parametrize("p, m1", [(1, 17), (128, 65), (128, 129), (200, 129)])
@pytest.mark.parametrize("iterations", [0, 1, 100])
def test_sinkhorn_bwd_merged_sweeps_match_plain(device, p, m1, iterations):
    (scores, log_mu, log_nu, dout), _ = sinkhorn_train_case(device, max(p, 2), m1, iterations)
    if p == 1:  # the case's unmasked patch alone
        scores, log_mu, log_nu, dout = (x[1:2].contiguous() for x in (scores, log_mu, log_nu, dout))
    _, v_hist = sinkhorn_fwd_train_plain(scores, log_mu, log_nu, iterations)
    got = sinkhorn_bwd_train(scores, log_mu, v_hist, dout)
    want = sinkhorn_bwd_train_plain(scores, log_mu, v_hist, dout)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_sinkhorn_bwd_repeats_bit_for_bit_and_replays_from_a_graph(device):
    (scores, log_mu, log_nu, dout), _ = sinkhorn_train_case(device, 128, 129, 100)
    _, v_hist = sinkhorn_fwd_train(scores, log_mu, log_nu, 100)
    runs = [sinkhorn_bwd_train(scores, log_mu, v_hist, dout) for _ in range(3)]
    graph, out, launches = captured(lambda: sinkhorn_bwd_train(scores, log_mu, v_hist, dout),
                                    "sinkhorn_bwd_train")
    assert launches == 1
    dout.mul_(2.0)
    graph.replay()
    eager = sinkhorn_bwd_train(scores, log_mu, v_hist, dout)
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))
    assert all(torch.equal(a, b) for a, b in zip(out, eager))


def test_sinkhorn_bwd_beyond_capacity_raises(device):
    """The backward's one capacity left: its 3 N1 + 5 M1 floats of vectors
    in a block's shared memory (232,448 bytes on an H100)."""
    m1, n1 = 12000, 2
    scores = torch.zeros(1, m1, n1, device=device)
    log_mu = torch.zeros(1, m1, device=device)
    v_hist = torch.zeros(1, 3, n1, device=device)
    with pytest.raises(RuntimeError, match="sinkhorn_bwd_train"):
        sinkhorn_bwd_train(scores, log_mu, v_hist, torch.zeros_like(scores))


# ---- gse_embedding_full on the tensor cores, the Sinkhorn forward's sweep and merge ----

def gse_case(device, c, n, angles, seed=13):
    g = torch.Generator().manual_seed(seed)
    points = torch.rand(n, 3, generator=g)
    ref_vectors = torch.randn(n, angles, 3, generator=g) * 0.1
    ref_vectors[0] = -0.1  # the signed-zero diagonal case
    w_d, w_a = (torch.randn(c, c, generator=g) / c**0.5 for _ in range(2))
    b_d, b_a = torch.randn(c, generator=g), torch.randn(c, generator=g)
    return [t.to(device) for t in (points, ref_vectors, w_d, b_d, w_a, b_a)]


@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("angles", [1, 2, 3, 4])
@pytest.mark.parametrize("n, n_valid", [(77, 77), (77, 45), (21, 1)])
def test_gse_tensor_cores_match_plain(device, c, angles, n, n_valid):
    """Every width and angle count, ragged N (no multiple of the 64-pair
    tile), n_valid N, below N and 1; zeros outside the valid square; the
    diagonal (v = 0: distance and every angle 0) equal to the sum of the
    cosine rows of W_d and W_a plus the biases."""
    args = gse_case(device, c, n, angles)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=device)
    before = cuda.launches["gse_embedding_full"]
    got = gse_embedding_full(*args, 0.2, 15.0, nv)
    assert cuda.launches["gse_embedding_full"] == before + 1
    want = gse_embedding_full_plain(*args, 0.2, 15.0, nv)
    torch.cuda.synchronize()
    assert (got[:n_valid, :n_valid] - want[:n_valid, :n_valid]).abs().max().item() <= 1e-3
    assert not got[n_valid:].any() and not got[:, n_valid:].any()
    _, _, w_d, b_d, w_a, b_a = args
    diagonal = w_d[1::2].sum(dim=0) + w_a[1::2].sum(dim=0) + b_d + b_a
    rows = torch.arange(n_valid, device=device)
    assert (got[rows, rows] - diagonal).abs().max().item() <= 1e-3


def test_gse_repeats_bit_for_bit_and_replays_from_a_graph(device):
    args = gse_case(device, 256, 150, 3)
    nv = torch.tensor(131, dtype=torch.int32, device=device)
    runs = [gse_embedding_full(*args, 0.2, 15.0, nv) for _ in range(3)]
    graph, out, launches = captured(lambda: gse_embedding_full(*args, 0.2, 15.0, nv),
                                    "gse_embedding_full")
    assert launches == 1
    for t in args[2:]:  # a replay reads the captured weights anew: halved, exactly half
        t.mul_(0.5)
    graph.replay()
    eager = gse_embedding_full(*args, 0.2, 15.0, nv)
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert torch.equal(run, runs[0])
    assert torch.equal(out, eager)
    assert torch.equal(eager, 0.5 * runs[0])


@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_gse_stands_within_bound_of_float64(device, c):
    """Row 3 at 3DMatch's size (293 valid of 300) against the float64
    embedding (float64 bases of the same f32 indices): every valid (pair,
    channel) within 2^-22 of sum_f |W_d[f, c]| + sum_f |W_a[f, c]|, the
    3xTF32 products' f32 accuracy (tests/test_torch_gse_fwd_tc.py emulates
    the kernel's sums within 2^-23 of it; the plain version's f32 loop
    reads ~2^-23.5)."""
    n, n_valid = 300, 293
    points, ref_vectors, w_d, b_d, w_a, b_a = args = gse_case(device, c, n, 3)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=device)
    got = gse_embedding_full(*args, 0.2, 15.0, nv)[:n_valid, :n_valid].double()
    d_idx, a_idx = gse_kernels._pair_indices(points, ref_vectors, 0.2, 15.0)
    d_idx, a_idx = d_idx[:n_valid, :n_valid], a_idx[:n_valid, :n_valid]
    exact = (gse_kernels._exact_bases(d_idx, c) @ w_d.double()
             + (gse_kernels._exact_bases(a_idx, c) @ w_a.double()).amax(dim=2)
             + (b_d.double() + b_a.double()))
    scale = w_d.abs().sum(dim=0).double() + w_a.abs().sum(dim=0).double()
    err = ((got - exact).abs() / scale).max().item()
    assert err <= 2.0**-22, f"2^{np.log2(err):.2f} of sum |W|"


@pytest.mark.parametrize("c, angles", [(512, 3), (256, 5), (48, 3)])
def test_gse_beyond_capacity_raises(device, c, angles):
    """The shapes the forward once refused (two channel blocks of 256, two
    angle groups, a width padded to 64) now launch its kernel once and
    agree with the plain version within 1e-3."""
    args = gse_case(device, c, 20, angles)
    before = cuda.launches["gse_embedding_full"]
    got = gse_embedding_full(*args, 0.2, 15.0)
    assert cuda.launches["gse_embedding_full"] == before + 1
    want = gse_embedding_full_plain(*args, 0.2, 15.0)
    torch.cuda.synchronize()
    assert got.shape == (20, 20, c)
    assert (got - want).abs().max().item() <= 1e-3


def sinkhorn_fwd_case(device, p, m1, n1, seed=14):
    g = torch.Generator().manual_seed(seed)
    scores = torch.randn(p, m1, n1, generator=g)
    rows = torch.rand(p, m1, generator=g) < 0.85
    cols = torch.rand(p, n1, generator=g) < 0.85
    rows[:, -1] = cols[:, -1] = True  # the dustbins
    rows[0, :-1] = cols[0, :-1] = False  # masked but for the dustbin corner
    if p > 2:
        rows[2] = cols[2] = False  # masked entirely
    if p > 1:
        rows[1] = cols[1] = True
    masked = ~(rows[:, :, None] & cols[:, None, :])
    scores = torch.where(masked, -1e12, scores)
    log_mu = torch.where(rows, -np.log(m1 + n1), -1e12)
    log_nu = torch.where(cols, -np.log(m1 + n1), -1e12)
    return [t.to(device) for t in (scores, log_mu, log_nu)], masked.to(device)


@pytest.mark.parametrize("p, m1, n1", [(256, 65, 65), (256, 129, 129), (128, 129, 129),
                                       (5, 17, 30), (3, 160, 97), (2, 1, 1), (3, 200, 200),
                                       (3, 225, 225), (3, 239, 239), (3, 256, 33)])
@pytest.mark.parametrize("iterations", [0, 1, 100])
def test_sinkhorn_sweep_and_merge_match_plain(device, p, m1, n1, iterations):
    """Rows 4 and 9 at the paths' shapes (P = 256 at inference, 128 in
    training) and odd ones (rectangular, 160 and 256 rows, a warp without
    rows, 225 x 225 and 239 x 239: the column partials a group of 224 and of
    16 columns at a time), a
    patch masked but for its dustbin and one masked entirely: within
    chip_smoke.py's tol_sinkhorn_scores of the plain version, every output
    finite, the training forward's result the inference result bit for bit."""
    (scores, log_mu, log_nu), masked = sinkhorn_fwd_case(device, p, m1, n1)
    before = cuda.launches["sinkhorn_log_iterations"], cuda.launches["sinkhorn_fwd_train"]
    out = sinkhorn_log_iterations(scores, log_mu, log_nu, iterations)
    out_t, v_hist = sinkhorn_fwd_train(scores, log_mu, log_nu, iterations)
    assert (cuda.launches["sinkhorn_log_iterations"], cuda.launches["sinkhorn_fwd_train"]) == (
        before[0] + 1, before[1] + 1)
    want, want_hist = sinkhorn_fwd_train_plain(scores, log_mu, log_nu, iterations)
    torch.cuda.synchronize()
    assert torch.equal(out, out_t)
    assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(v_hist).all())
    assert v_hist.shape == want_hist.shape
    valid = ~masked
    for got, ref in ((out[valid], want[valid]), (v_hist, want_hist)):
        assert bool(((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()), (
            (got - ref).abs().max().item())


def test_sinkhorn_fwd_repeats_bit_for_bit_and_replays_from_a_graph(device):
    (scores, log_mu, log_nu), _ = sinkhorn_fwd_case(device, 256, 129, 129)
    runs = [sinkhorn_fwd_train(scores, log_mu, log_nu, 100) for _ in range(3)]
    infer = [sinkhorn_log_iterations(scores, log_mu, log_nu, 100) for _ in range(3)]
    graph, out, launches = captured(lambda: sinkhorn_fwd_train(scores, log_mu, log_nu, 100),
                                    "sinkhorn_fwd_train")
    graph_i, out_i, launches_i = captured(
        lambda: sinkhorn_log_iterations(scores, log_mu, log_nu, 100), "sinkhorn_log_iterations")
    assert launches == launches_i == 1
    scores.mul_(0.5)  # a replay reads the captured scores anew
    graph.replay()
    graph_i.replay()
    eager = sinkhorn_fwd_train(scores, log_mu, log_nu, 100)
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(run, runs[0]))
    for run in infer[1:]:
        assert torch.equal(run, infer[0])
    assert torch.equal(infer[0], runs[0][0])
    assert all(torch.equal(a, b) for a, b in zip(out, eager))
    assert torch.equal(out_i, eager[0])
    assert not torch.equal(eager[0], runs[0][0])


@pytest.mark.parametrize("m1, n1", [(60000, 2), (2, 60000)])
def test_sinkhorn_fwd_beyond_capacity_raises(device, m1, n1):
    """The forward's one capacity left: its M1 + N1 floats of u and v in a
    block's shared memory (232,448 bytes on an H100)."""
    scores = torch.zeros(1, m1, n1, device=device)
    log_mu, log_nu = torch.zeros(1, m1, device=device), torch.zeros(1, n1, device=device)
    with pytest.raises(RuntimeError, match="sinkhorn_log_iterations"):
        sinkhorn_log_iterations(scores, log_mu, log_nu, 3)
    with pytest.raises(RuntimeError, match="sinkhorn_fwd_train"):
        sinkhorn_fwd_train(scores, log_mu, log_nu, 3)


# ---- every shape the JAX kernels compute: the general instances -------------
# Each case asserts that the kernel's launch counter rose (no plain route was
# taken) and holds the kernel to its plain version within its row's
# tolerance, at the former limit and two shapes beyond it.

def any_kernel_points(k, seed=21):
    """K kernel points in a ball of radius 0.0625 (the configs' dispositions
    hold 15)."""
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(k, 3, generator=g) - 0.5) * 0.1


@pytest.mark.parametrize("k", [16, 20, 32])
@pytest.mark.parametrize("m, h", [(20004, 65), (1502, 34), (9001, 38)],
                         ids=["kitti-bulk", "modelnet", "unaligned"])
def test_kpconv_stream_any_kernel_points(device, m, h, k):
    stream, _, _ = stream_case(device, m, h)
    kp = any_kernel_points(k).to(device)
    w = torch.randn(k, 1, 64, generator=torch.Generator().manual_seed(k)).to(device)
    before = cuda.launches["kpconv_stream_fused"]
    got = kpconv_stream_fused(stream, kp, w, 0.05, residuals=True)
    assert cuda.launches["kpconv_stream_fused"] == before + 1
    want = kpconv_stream_fused_plain(stream, kp, w, 0.05, residuals=True)
    torch.cuda.synchronize()
    assert_kpconv_close(got[0], want[0])
    assert_kpconv_close(got[1], want[1])  # t1
    assert torch.equal(got[2], want[2])  # count


@pytest.mark.parametrize("k", [16, 20, 32])
def test_kpconv_union_any_kernel_points(device, k):
    call, _ = union_case(device, 611, 700, 65, 100)
    g = torch.Generator().manual_seed(k)
    call = list(call)
    call[5] = any_kernel_points(k).to(device)
    call[6] = torch.randn(k, 1, 64, generator=g).to(device)
    before = cuda.launches["kpconv_union_input_fused"]
    got = kpconv_union_input_fused(*call, tile=100, residuals=True)
    assert cuda.launches["kpconv_union_input_fused"] == before + 1
    want = kpconv_union_input_fused_plain(*call, tile=100, residuals=True)
    torch.cuda.synchronize()
    assert_kpconv_close(got[0], want[0])
    assert torch.equal(got[1], want[1])  # count
    assert_kpconv_close(got[2], want[2])  # t1


@pytest.mark.parametrize("p, m1, n1", [(3, 240, 240), (3, 256, 256), (3, 257, 257),
                                       (3, 400, 300), (2, 300, 600)])
@pytest.mark.parametrize("iterations", [0, 7])
def test_sinkhorn_fwd_any_shape(device, p, m1, n1, iterations):
    """Rows 4 and 9 past the register instances: 240 x 240 (S in shared
    memory, the partials in device memory), the former limit 256 x 256 and
    beyond (S read from device memory), within tol_sinkhorn_scores; the
    training forward's result is the inference result bit for bit."""
    route = sinkhorn_kernels.forward_route(m1, n1, 232448)
    assert route.general and route.part_shared == (m1 != 240)
    (scores, log_mu, log_nu), masked = sinkhorn_fwd_case(device, p, m1, n1)
    before = cuda.launches["sinkhorn_log_iterations"], cuda.launches["sinkhorn_fwd_train"]
    out = sinkhorn_log_iterations(scores, log_mu, log_nu, iterations)
    out_t, v_hist = sinkhorn_fwd_train(scores, log_mu, log_nu, iterations)
    assert (cuda.launches["sinkhorn_log_iterations"], cuda.launches["sinkhorn_fwd_train"]) == (
        before[0] + 1, before[1] + 1)
    want, want_hist = sinkhorn_fwd_train_plain(scores, log_mu, log_nu, iterations)
    torch.cuda.synchronize()
    assert torch.equal(out, out_t)
    valid = ~masked
    for got, ref in ((out[valid], want[valid]), (v_hist, want_hist)):
        assert bool(torch.isfinite(got).all())
        assert bool(((got - ref).abs() <= 1e-4 + 1e-4 * ref.abs()).all()), (
            (got - ref).abs().max().item())


@pytest.mark.parametrize("p, m1", [(3, 160), (3, 161), (2, 257), (2, 400), (2, 600)])
@pytest.mark.parametrize("iterations", [1, 7])
def test_sinkhorn_bwd_any_shape(device, p, m1, iterations):
    """Row 10 at the former limit (160) and beyond (the general kernel: dS
    in device memory, S in shared memory at 161, the partials in device
    memory at 600)."""
    route = sinkhorn_kernels.backward_route(m1, m1, 232448)
    assert route.general == (m1 > 160) and route.part_shared == (m1 < 600)
    (scores, log_mu, log_nu, dout), _ = sinkhorn_train_case(device, p, m1, iterations)
    _, v_hist = sinkhorn_fwd_train_plain(scores, log_mu, log_nu, iterations)
    before = cuda.launches["sinkhorn_bwd_train"]
    got = sinkhorn_bwd_train(scores, log_mu, v_hist, dout)
    assert cuda.launches["sinkhorn_bwd_train"] == before + 1
    want = sinkhorn_bwd_train_plain(scores, log_mu, v_hist, dout)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert bool(((g - w).abs() <= 1e-4 + 1e-4 * w.abs()).all()), (g - w).abs().max().item()


def test_sinkhorn_general_kernels_repeat_and_replay_from_a_graph(device):
    (scores, log_mu, log_nu, dout), _ = sinkhorn_train_case(device, 2, 300, 5)
    fwd = lambda: sinkhorn_fwd_train(scores, log_mu, log_nu, 5)  # noqa: E731
    first = fwd()
    graph, out, launches = captured(fwd, "sinkhorn_fwd_train")
    assert launches == 1
    bwd = lambda: sinkhorn_bwd_train(scores, log_mu, first[1], dout)  # noqa: E731
    first_b = bwd()
    graph_b, out_b, launches_b = captured(bwd, "sinkhorn_bwd_train")
    assert launches_b == 1
    graph.replay()
    graph_b.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, first))
    assert all(torch.equal(a, b) for a, b in zip(out_b, first_b))


@pytest.mark.parametrize("c, h", [(130, 4), (640, 4), (1024, 2), (64, 12), (256, 16)],
                         ids=["c130", "c640", "c1024", "h12", "h16"])
def test_rpe_pair_scores_any_shape(device, c, h):
    g = torch.Generator().manual_seed(c + h)
    n, m = 70, 83
    embed = torch.randn(n, m, c, generator=g).to(device)
    qw = torch.randn(n, h, c, generator=g).to(device)
    nv_q = torch.tensor(61, dtype=torch.int32, device=device)
    before = cuda.launches["rpe_pair_scores"]
    got = rpe_pair_scores(embed, qw, nv_q, 77)
    assert cuda.launches["rpe_pair_scores"] == before + 1
    want = rpe_pair_scores_plain(embed, qw, nv_q, 77)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert not got[61:].any() and not got[:, :, 77:].any()


def test_rpe_pair_scores_misaligned_qw(device):
    embed = torch.randn(40, 50, 64, device=device)
    qw = torch.randn(40 * 4 * 64 + 1, device=device)[1:].view(40, 4, 64)
    before = cuda.launches["rpe_pair_scores"]
    got = rpe_pair_scores(embed, qw, 33, 45)
    assert cuda.launches["rpe_pair_scores"] == before + 1
    want = rpe_pair_scores_plain(embed, qw, 33, 45)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.parametrize("dh", [24, 48, 96, 128, 5])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("holes", [False, True], ids=["prefix", "key-holes"])
def test_fused_attention_any_head_width(device, dh, with_bias, holes):
    (q, k, v, bias), key_masks = attention_case(device, 4, 130, 257, dh, with_bias, holes)
    nv_q = torch.tensor(111, dtype=torch.int32, device=device)
    before = cuda.launches["fused_masked_attention"]
    got = fused_masked_attention(q, k, v, bias, nv_q, 250, dh ** -0.5, key_masks)
    assert cuda.launches["fused_masked_attention"] == before + 1
    want = fused_masked_attention_plain(q, k, v, bias, nv_q, 250, dh ** -0.5, key_masks)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert (got[:111] - want[:111]).abs().max().item() <= 1e-5 * want[:111].abs().max().item()
    assert not got[111:].any()


@pytest.mark.parametrize("dh", [64, 48, 128])
def test_fused_attention_misaligned_views(device, dh):
    """q, k and v 4 bytes off a 16-byte boundary (views into a larger
    buffer), with a bias: the 4-byte copies (or, at dh > 64, the in-place
    reads)."""
    (q, k, v, bias), key_masks = attention_case(device, 4, 100, 90, dh, True, True, seed=9)
    views = []
    for t in (q, k, v):
        buf = torch.empty(t.numel() + 1, device=device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        assert view.data_ptr() % 16 != 0
        views.append(view)
    before = cuda.launches["fused_masked_attention"]
    got = fused_masked_attention(*views, bias, 93, 80, dh ** -0.5, key_masks)
    assert cuda.launches["fused_masked_attention"] == before + 1
    want = fused_masked_attention_plain(q, k, v, bias, 93, 80, dh ** -0.5, key_masks)
    torch.cuda.synchronize()
    assert (got[:93] - want[:93]).abs().max().item() <= 1e-5 * want[:93].abs().max().item()


def test_attention_general_routes_repeat_and_replay_from_a_graph(device):
    (q, k, v, bias), key_masks = attention_case(device, 2, 64, 70, 96, True, True, seed=4)
    embed = torch.randn(64, 70, 130, device=device)
    qw = torch.randn(64, 12, 130, device=device)
    nv = torch.tensor(60, dtype=torch.int32, device=device)

    def forward():
        return (rpe_pair_scores(embed, qw, nv, nv),
                fused_masked_attention(q, k, v, bias, nv, nv, 0.1, key_masks))

    first = forward()
    graph, out, launches = captured(forward, "fused_masked_attention")
    assert launches == 1
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, first))


# ---- patch_overlaps (row 11): bit-equal to its plain version ----------------

def overlap_case(device, m, n, k, s, seed=6, index_dtype=torch.int64):
    """Patches with non-prefix masks (valid slots scattered), an empty ref
    patch (0) and an empty candidate patch (1), a ref node whose candidates
    are all off (2), masked candidates whose indices lie outside [0, N)
    (-1 and N + 5), and unmasked ones (ref node 3: -1 and N)."""
    g = torch.Generator().manual_seed(seed)
    ref_nodes, src_nodes = torch.rand(m, 1, 3, generator=g) * 3, torch.rand(n, 1, 3, generator=g) * 3
    ref = ref_nodes + torch.rand(m, k, 3, generator=g) - 0.5
    src = src_nodes + torch.rand(n, k, 3, generator=g) - 0.5
    ref_mask = torch.rand(m, k, generator=g) > 0.3
    src_mask = torch.rand(n, k, generator=g) > 0.3
    ref_mask[0] = False
    src_mask[1] = False
    cand = torch.randint(0, n, (m, s), generator=g)
    cand[:, 0] = 1
    cand_mask = torch.rand(m, s, generator=g) > 0.25
    cand_mask[2] = False
    off = ~cand_mask & (torch.rand(m, s, generator=g) < 0.5)
    cand[off] = torch.where(torch.rand(int(off.sum()), generator=g) < 0.5, -1, n + 5)
    cand[3, 1:3] = torch.tensor([-1, n])
    cand_mask[3, 1:3] = True
    return [x.to(device) for x in (ref, ref_mask, src, src_mask, cand.to(index_dtype), cand_mask)]


@pytest.mark.parametrize("k", [16, 48, 128, 129])
@pytest.mark.parametrize("s", [13, 64, 300])
@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32], ids=["int64", "int32"])
def test_patch_overlaps_bit_equal_to_plain(device, k, s, index_dtype):
    call = overlap_case(device, 37, 41, k, s, index_dtype=index_dtype)
    before = cuda.launches["patch_overlaps"]
    got = patch_overlaps(*call, 0.3)
    assert cuda.launches["patch_overlaps"] == before + 1
    want = patch_overlaps_plain(*call, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert 0.0 < (got > 0).float().mean().item() < 1.0
    assert not got[2].any() and not got[0].any() and not got[:, 0].any()
    assert not got[~call[5]].any() and not got[3, 1:3].any()


def test_patch_overlaps_on_every_candidate_off(device):
    call = overlap_case(device, 9, 12, 64, 8)
    call[5] = torch.zeros_like(call[5])
    got = patch_overlaps(*call, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.zeros_like(got))


def test_patch_overlaps_replays_from_a_graph(device):
    call = overlap_case(device, 64, 70, 128, 64, seed=8)
    graph, out, launches = captured(lambda: patch_overlaps(*call, 0.3), "patch_overlaps")
    assert launches == 1
    call[0].add_(0.0625)  # a replay reads the captured patches anew
    graph.replay()
    want = patch_overlaps_plain(*call, 0.3)
    torch.cuda.synchronize()
    assert torch.equal(out, want)


# --- the device pyramid's kernels (kernels/pyramid.py) -----------------------

def search_case(device, n_q=3000, n_s=4000, cap=4096, radius=0.08, seed=0, empty_second=True):
    """Two clouds' queries and cell-sorted supports: cloud 0 a wavy sheet,
    cloud 1 empty (or a second sheet); query rows past n_q are padding."""
    from geotransformer_tpu_torch.preprocess.device import _search_support

    g = torch.Generator().manual_seed(seed)

    def sheet(n):
        xy = torch.rand(n, 2, generator=g)
        z = 0.1 * torch.sin(8 * xy[:, :1]) + 0.01 * torch.randn(n, 1, generator=g)
        return torch.cat([xy, z], dim=1)

    q = torch.full((2, cap, 3), 1e6)
    s = torch.full((2, cap, 3), 1e6)
    q[0, :n_q], s[0, :n_s] = sheet(n_q), sheet(n_s)
    q[1, :n_q], s[1, :n_s] = sheet(n_q), sheet(n_s)
    q_len = torch.tensor([n_q, n_q], dtype=torch.int32)
    s_len = torch.tensor([n_s, 0 if empty_second else n_s], dtype=torch.int32)
    q, s, q_len, s_len = (t.to(device) for t in (q, s, q_len, s_len))
    return (q, q_len, s_len) + _search_support(s, s_len, radius, 1 << 20)


@pytest.mark.parametrize("k", [16, 38, 65])
@pytest.mark.parametrize("brute", [False, True], ids=["grid", "brute"])
def test_grid_radius_search_matches_plain(device, k, brute):
    from geotransformer_tpu_torch.kernels.pyramid import (
        grid_radius_search,
        grid_radius_search_plain,
    )

    radius = 0.08 if k < 40 else 0.12
    q, q_len, s_len, support, starts, origin, dims, _ = search_case(device, radius=radius)
    if brute:  # every valid support row a candidate, its index its row
        q, q_len, s_len = q[:, :1500].contiguous(), torch.full_like(q_len, 1400), torch.full_like(
            s_len, 1800)
        support, starts, origin, dims = support[:, :1800].clone(), None, None, None
        support[..., 3] = torch.arange(1800, device=device, dtype=torch.float32)
    before = cuda.launches["grid_radius_search"]
    got = grid_radius_search(q, q_len, support, s_len, starts, origin, dims, radius, k, 1024)
    assert cuda.launches["grid_radius_search"] == before + 1
    want = grid_radius_search_plain(q, q_len, support, s_len, starts, origin, dims, radius, k,
                                    1024)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    full = (got[0][0, :int(q_len[0])] < support.shape[1]).sum(dim=1)
    assert int(full.max()) == k  # some rows full
    assert bool((got[0][:, int(q_len[0]):] == support.shape[1]).all())  # padding rows
    if not brute:
        assert bool((got[0][1] == support.shape[1]).all())  # the empty cloud
        assert int(got[1].max()) <= 1024


def test_voxel_segment_mean_matches_plain(device):
    from geotransformer_tpu_torch.kernels.pyramid import (
        voxel_segment_mean,
        voxel_segment_mean_plain,
    )

    g = torch.Generator().manual_seed(3)
    points = (torch.rand(2, 5000, 3, generator=g) * 60 - 30).to(device)
    seg = torch.sort(torch.randint(0, 1500, (2, 5000), generator=g), dim=1).values
    seg = torch.unique_consecutive(seg[0], return_inverse=True)[1].expand(2, -1).clone()
    seg[:, 4700:] = -1
    seg[1] = -1  # an empty cloud
    seg = seg.to(torch.int32).to(device)
    voxels = torch.stack([seg[0].max() + 1, torch.zeros((), dtype=torch.int32, device=device)])
    voxels = voxels.to(torch.int32)
    before = cuda.launches["voxel_segment_mean"]
    means, counts = voxel_segment_mean(points, seg, voxels, 1400)  # voxels past 1400 dropped
    assert cuda.launches["voxel_segment_mean"] == before + 1
    want_means, want_counts = voxel_segment_mean_plain(points, seg, voxels, 1400)
    torch.cuda.synchronize()
    assert torch.equal(counts, want_counts)
    assert float((means - want_means).abs().max()) <= 1e-6 * 30
    assert bool((means[1] == 1e6).all()) and not counts[1].any()


def pyramid_inputs(device, seed=0, n_ref=19000, n_src=15000, cap0=19200):
    from geotransformer_tpu_torch.preprocess.device import pad_stage0

    g = np.random.default_rng(seed)
    xy = g.uniform(0, 1.3, (n_ref + n_src, 2))
    z = 0.5 * np.sin(25 * xy[:, 0]) * np.cos(20 * xy[:, 1])
    points = np.column_stack([xy, z]).astype(np.float32)
    pts, lens, feats = pad_stage0(points, [n_ref, n_src], cap0)
    return [torch.from_numpy(a).to(device) for a in (pts, lens, feats)] + [
        torch.eye(4, device=device)]


PYRAMID_SPEC = dict(num_stages=4, voxel_size=0.025, radius=0.0625,
                    neighbor_limits=(38, 36, 36, 38), stage_caps=(19200, 5632, 1536, 512),
                    inverse_limits=(80, 80, 80, 80), knn_cand_cap=512)


def flat_batch(batch):
    return {f"{k}{i}": v for k, vs in batch.items()
            for i, v in enumerate(vs if isinstance(vs, list) else [vs])}


def test_build_pyramid_device_equals_its_cpu_build(device):
    """The build on the card (both kernels) equals the CPU build (their plain
    versions) bit for bit: the same float32 voxel keys and d^2 arithmetic,
    each voxel's points added in sorted order."""
    from geotransformer_tpu_torch.preprocess.device import build_pyramid_device

    cuda.launches.clear()
    got, overflow = build_pyramid_device(*pyramid_inputs(device), **PYRAMID_SPEC)
    assert cuda.launches["voxel_segment_mean"] == 3 and cuda.launches["grid_radius_search"] == 10
    want, want_overflow = build_pyramid_device(*pyramid_inputs("cpu"), **PYRAMID_SPEC)
    assert not bool(overflow.any()) and torch.equal(overflow.cpu(), want_overflow)
    got, want = flat_batch(got), flat_batch(want)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key].cpu(), want[key]), key


def test_build_pyramid_device_makes_no_host_sync_and_replays_from_a_graph(device):
    from geotransformer_tpu_torch.preprocess.device import build_pyramid_device

    inputs = pyramid_inputs(device, seed=1)
    build_pyramid_device(*inputs, **PYRAMID_SPEC)  # builds the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        build_pyramid_device(*inputs, **PYRAMID_SPEC)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        out, overflow = build_pyramid_device(*inputs, **PYRAMID_SPEC)
    inputs[0].copy_(pyramid_inputs(device, seed=2)[0])  # a replay reads the new points
    graph.replay()
    want, want_overflow = build_pyramid_device(*pyramid_inputs(device, seed=2), **PYRAMID_SPEC)
    torch.cuda.synchronize()
    assert torch.equal(overflow, want_overflow)
    out, want = flat_batch(out), flat_batch(want)
    for key in want:
        assert torch.equal(out[key], want[key]), key


@pytest.mark.parametrize("variant", ["vanilla", "pe", "lrpe"])
def test_transformer_variants_route_through_the_attention_kernel(device, variant):
    """The variants' kernel route launches fused_masked_attention twice a
    block and nothing else, within 1e-4 of the einsum route on every row."""
    from geotransformer_tpu_torch.models import transformer_variants as variants

    gen = torch.Generator().manual_seed(5)
    d_model, heads, blocks, n0, n1 = 64, 4, ("self", "cross"), 40, 33
    feats = [torch.randn((1, n, d_model), generator=gen) for n in (n0, n1)]
    masks = [(torch.arange(n) < n - 5)[None] for n in (n0, n1)]
    extra = {"lrpe": {"num_embeddings": 12}}.get(variant, {})
    cls = {"vanilla": variants.VanillaConditionalTransformer,
           "pe": variants.PEConditionalTransformer,
           "lrpe": variants.LRPEConditionalTransformer}[variant]
    middle = {"vanilla": [],
              "pe": [torch.randn((1, n, d_model), generator=gen) for n in (n0, n1)],
              "lrpe": [torch.randint(0, 16, (1, n, n), generator=gen) for n in (n0, n1)]}[variant]
    model = cls(blocks, d_model, heads, **extra)
    plain = cls(blocks, d_model, heads, force=False, **extra)
    plain.load_state_dict(model.state_dict())
    inputs = [t.to(device) for t in (*feats, *middle, *masks)]
    with torch.no_grad():
        cuda.launches.clear()
        got = model.to(device)(*inputs)
        torch.cuda.synchronize()
        assert dict(cuda.launches) == {"fused_masked_attention": 2 * len(blocks)}
        want = plain.to(device)(*inputs)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() <= 1e-4


def test_quaternion_kabsch_on_the_card(device):
    """The quaternion Kabsch on the card within 1e-5 of its CPU run, proper,
    and replayed from a CUDA graph as run eagerly."""
    from geotransformer_tpu_torch.models.procrustes import rotation_from_covariance_quat

    h = torch.randn((128, 3, 3), generator=torch.Generator().manual_seed(6))
    got = rotation_from_covariance_quat(h.to(device))
    assert (got.cpu() - rotation_from_covariance_quat(h)).abs().max().item() <= 1e-5
    eye = torch.eye(3, device=device)
    assert (got @ got.transpose(1, 2) - eye).abs().max().item() <= 1e-5
    static = h.to(device)
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        replayed = rotation_from_covariance_quat(static)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)


def test_profiler_sessions_count_the_same_kernels(device):
    """Two torch.profiler sessions in one process, each around the same
    full-width 3DMatch forward (utils.timing.top_device_ops), count the same
    hand-written kernel events by name, and the second holds every kernel
    the forward launched: sessions after the first keep the kernels
    launched through ctypes (top_device_ops raises where a session holds
    fewer events of a hand-written kernel than its wrapper launched)."""
    import re

    from geotransformer_tpu_torch.models import create_model
    from geotransformer_tpu_torch.scripts import pairs
    from geotransformer_tpu_torch.scripts.profile_ops import hand_written
    from geotransformer_tpu_torch.utils.timing import top_device_ops

    cfg, batch = pairs.tool_batch(pairs.tool_config(False), pairs.make_3dmatch_pair(0, n_ref=4000),
                                  False, device)
    model = create_model(cfg, device=device)
    counts = []
    for _ in range(2):
        kernels, _ = top_device_ops(lambda: model(batch))
        counts.append({op.name: op.count for op in kernels if re.search(hand_written(), op.name)})
    assert counts[0] == counts[1]
    launched = {"edge_kernel", "gse_kernel", "pair_scores_kernel", "attention_kernel",
                "sinkhorn_kernel", "kpconv_stream_kernel"}
    found = {name for name in launched if any(re.search(rf"\b{name}\b", k) for k in counts[1])}
    assert found == launched, counts[1]


@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_encoder_and_decoder_route_through_the_attention_kernel(device, stack):
    """TransformerEncoder and TransformerDecoder at the 3DMatch width (256,
    4 heads, 2 layers) launch fused_masked_attention once a self-attention
    layer and twice a decoder layer, and agree with their einsum route
    (force=False) within 1e-4 of the largest magnitude."""
    from geotransformer_tpu_torch.models import TransformerDecoder, TransformerEncoder

    gen = torch.Generator().manual_seed(9)
    layers, n0, n1 = 2, 300, 261
    q = torch.randn((1, n0, 256), generator=gen).to(device)
    s = torch.randn((1, n1, 256), generator=gen).to(device)
    q_masks, s_masks = (torch.arange(n0) < 281)[None].to(device), (torch.arange(n1) < 250)[None].to(device)
    cls, inputs, calls = {"encoder": (TransformerEncoder, (q, q_masks), layers),
                          "decoder": (TransformerDecoder, (q, s, q_masks, s_masks), 2 * layers)}[stack]
    model = cls(256, 4, layers)
    plain = cls(256, 4, layers, force=False)
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        cuda.launches.clear()
        got = model.to(device)(*inputs)
        torch.cuda.synchronize()
        assert dict(cuda.launches) == {"fused_masked_attention": calls}
        want = plain.to(device)(*inputs)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-4


@pytest.mark.parametrize("n, n_valid, tied", [(77, 77, False), (77, 45, False), (45, 40, True)])
def test_gse_at_c96_matches_plain(device, n, n_valid, tied):
    """Rows 3 and 8 at C = 96, the small synthetic workflow's hidden width
    (the forward's channels across 4 warps, the backward in three 32-channel
    blocks), against their plain versions: the forward within 1e-3 and zero
    outside the valid square, the backward as at the other widths (exact
    ties of two angle projections settled in float64)."""
    args = gse_case(device, 96, n, 3)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=device)
    got = gse_embedding_full(*args, 0.2, 15.0, nv)
    want = gse_embedding_full_plain(*args, 0.2, 15.0, nv)
    torch.cuda.synchronize()
    assert (got[:n_valid, :n_valid] - want[:n_valid, :n_valid]).abs().max().item() <= 1e-3
    assert not got[n_valid:].any() and not got[:, n_valid:].any()
    bwd_args, de, bwd_nv = gse_bwd_case(device, 96, n, n_valid, tied)
    before = cuda.launches["gse_full_bwd"]
    got = gse_full_bwd(*bwd_args, 0.2, 15.0, de, bwd_nv)
    assert cuda.launches["gse_full_bwd"] == before + 1
    settled = int(gse_kernels.last_settled)
    want = gse_full_bwd_plain(*bwd_args, 0.2, 15.0, de, bwd_nv)
    torch.cuda.synchronize()
    assert_gse_bwd_close(got, want)
    if tied:
        assert settled > 0


# ---- every shape of rows 1, 3, 5, 6 and 8 --------------------------------------

@pytest.mark.parametrize("c", [47, 161])
def test_gse_odd_width_raises_before_any_launch(device, c):
    """An odd width (the interleaved bases cannot hold it, in JAX either)
    raises ValueError naming it, before either kernel launches."""
    args = gse_case(device, c, 20, 3)
    de = torch.randn(20, 20, c, device=device)
    before = dict(cuda.launches)
    with pytest.raises(ValueError, match=f"C = {c}"):
        gse_embedding_full(*args, 0.2, 15.0)
    with pytest.raises(ValueError, match=f"C = {c}"):
        gse_full_bwd(args[0], args[1], args[4], 0.2, 15.0, de)
    assert dict(cuda.launches) == before


ANY_WIDTH = [(6, 1), (48, 3), (160, 3), (192, 4), (224, 3), (288, 5), (512, 3), (256, 5)]


@pytest.mark.parametrize("c, angles", ANY_WIDTH, ids=[f"C{c}-A{a}" for c, a in ANY_WIDTH])
@pytest.mark.parametrize("n, n_valid", [(77, 60), (21, 1)])
def test_gse_any_width_and_angles_match_plain(device, c, angles, n, n_valid):
    """Rows 3 and 8 at widths that pad (6, 48, 288), the new instances (160,
    192, 224: ragged row tiles in the backward), two channel blocks and two
    row chunks (512, 288) and two angle groups (A = 4, 5): one launch each,
    the forward within 1e-3 of its plain version and zero outside the valid
    square, the diagonal the cosine rows' sum, the backward as at the
    shipped widths."""
    args = gse_case(device, c, n, angles)
    nv = torch.tensor(n_valid, dtype=torch.int32, device=device)
    before = cuda.launches["gse_embedding_full"]
    got = gse_embedding_full(*args, 0.2, 15.0, nv)
    assert cuda.launches["gse_embedding_full"] == before + 1
    want = gse_embedding_full_plain(*args, 0.2, 15.0, nv)
    torch.cuda.synchronize()
    assert got.shape == (n, n, c)
    assert (got[:n_valid, :n_valid] - want[:n_valid, :n_valid]).abs().max().item() <= 1e-3
    assert not got[n_valid:].any() and not got[:, n_valid:].any()
    _, _, w_d, b_d, w_a, b_a = args
    diagonal = w_d[1::2].sum(dim=0) + w_a[1::2].sum(dim=0) + b_d + b_a
    rows = torch.arange(n_valid, device=device)
    assert (got[rows, rows] - diagonal).abs().max().item() <= 1e-3
    de = torch.randn(n, n, c, generator=torch.Generator().manual_seed(c)).to(device)
    before = cuda.launches["gse_full_bwd"]
    grads = gse_full_bwd(args[0], args[1], w_a, 0.2, 15.0, de, nv)
    assert cuda.launches["gse_full_bwd"] == before + 1
    want = gse_full_bwd_plain(args[0], args[1], w_a, 0.2, 15.0, de, nv)
    torch.cuda.synchronize()
    assert all(g.shape == w.shape for g, w in zip(grads, want))
    assert_gse_bwd_close(grads, want)


@pytest.mark.parametrize("c", [160, 512])
def test_gse_bwd_ties_at_new_widths_settle_in_float64(device, c):
    """Two equal reference vectors (exact projection ties everywhere off the
    diagonal) at a new instance and across two row chunks: every tie goes
    to float64 and the gradients match the plain version."""
    args, de, nv = gse_bwd_case(device, c, 45, 40, tied=True)
    got = gse_full_bwd(*args, 0.2, 15.0, de, nv)
    settled = int(gse_kernels.last_settled)
    want = gse_full_bwd_plain(*args, 0.2, 15.0, de, nv)
    torch.cuda.synchronize()
    assert_gse_bwd_close(got, want)
    assert settled > 0


@pytest.mark.parametrize("c, angles", [(160, 5), (512, 4)])
def test_gse_any_width_repeats_bit_for_bit_and_replays_from_a_graph(device, c, angles):
    args = gse_case(device, c, 150, angles)
    nv = torch.tensor(131, dtype=torch.int32, device=device)
    de = torch.randn(150, 150, c, device=device)

    def both():
        return (gse_embedding_full(*args, 0.2, 15.0, nv),
                gse_full_bwd(args[0], args[1], args[4], 0.2, 15.0, de, nv))

    runs = [both() for _ in range(3)]
    before = cuda.launches["gse_full_bwd"]
    graph, out, launches = captured(both, "gse_embedding_full")
    assert launches == 1 and cuda.launches["gse_full_bwd"] == before + 2  # warm-up, capture
    de.mul_(0.5)  # a replay reads the captured inputs anew
    graph.replay()
    eager = both()
    torch.cuda.synchronize()
    for run in runs[1:]:
        assert torch.equal(run[0], runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(run[1], runs[0][1]))
    assert torch.equal(out[0], eager[0])
    assert all(torch.equal(a, b) for a, b in zip(out[1], eager[1]))
    assert all(torch.equal(a, 0.5 * b) for a, b in zip(eager[1], runs[0][1]))


def kernel_points_case(device, k, c_in, c_out, m=301, n=517, h=40, c_pool=16, seed=21):
    """A conv with ``k`` kernel points (random, within the influence radius
    of the offsets) over the nearest supports, a third of its slots
    sentinels, tied pool maxima, a ragged query mask."""
    g = torch.Generator().manual_seed(seed + k)
    s_points = torch.rand(n, 3, generator=g) * 0.3
    q_points = torch.rand(m, 3, generator=g) * 0.3
    nbrs = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    nbrs[torch.rand(m, h, generator=g) < 0.3] = n
    nbrs = torch.sort(nbrs, dim=1).values
    kp = (torch.rand(k, 3, generator=g) - 0.5) * 0.1
    feats = torch.randn(n, c_in, generator=g)
    w = torch.randn(k, c_in, c_out, generator=g) / c_in
    pool = torch.randint(-2, 2, (n, c_pool), generator=g).float()
    q_mask = torch.rand(m, generator=g) < 0.9
    to = lambda t: t.to(device)  # noqa: E731
    return [to(t) for t in (feats, q_points, s_points, nbrs, kp, w)], to(pool), to(q_mask)


@pytest.mark.parametrize("k", [16, 20, 32])
@pytest.mark.parametrize("split", [False, True])
def test_kpconv_any_kernel_points_match_plain(device, k, split):
    """Rows 1 and 5 at K = 16, 20 and 32 (one and two chunks of 16 kernel
    points), with the shortcut pool and a query mask: one launch, the
    output within the KPConv tolerance, count, pooled and ties exact."""
    args, pool, q_mask = kernel_points_case(device, k, 64, 64)
    kw = dict(q_mask=q_mask, residuals=True, pool_feats=pool, pool_cols=40)
    name = "kpconv_split_fused" if split else "kpconv_fused"
    before = cuda.launches[name]
    if split:
        tables = split_of(args[3], args[0].shape[0], 16)
        got = kpconv_split_fused(*args[:3], *tables, args[4], args[5], 0.05, **kw)
        want = kpconv_split_fused_plain(*args[:3], *tables, args[4], args[5], 0.05, **kw)
    else:
        got = kpconv_fused(*args, 0.05, **kw)
        want = kpconv_fused_plain(*args, 0.05, **kw)
    assert cuda.launches[name] == before + 1
    torch.cuda.synchronize()
    assert_kpconv_close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g, w)


@pytest.mark.parametrize("k", [16, 20, 32])
@pytest.mark.parametrize("split", [False, True])
def test_kpconv_bwd_any_kernel_points_match_plain(device, k, split):
    """Row 6 at K = 16, 20 and 32 over a whole and a split inverse table,
    with the pool's gradient: one launch, within the KPConv tolerance."""
    args, pool, _ = kernel_points_case(device, k, 64, 64, seed=22)
    feats, q_points, s_points, nbrs, kp, w = args
    n, m = feats.shape[0], q_points.shape[0]
    _, pooled, _, ties = kpconv_fused_plain(*args, 0.05, pool_feats=pool, pool_cols=40,
                                            residuals=True)
    inv = build_inverse_table(nbrs.cpu().numpy(), n, 80)
    if split:
        tail, tail_s, rank = build_split_tables(inv, m, 16, int((inv[:, 16:] < m).any(1).sum()))
        inv = (inv[:, :16].copy(), tail, tail_s, rank)
        table = tuple(torch.from_numpy(x).to(device) for x in inv)
    else:
        table = torch.from_numpy(inv).to(device)
    gdiv = torch.randn(m, 64, generator=torch.Generator().manual_seed(k)).to(device)
    call = (feats, s_points, q_points, gdiv, table, kp, w, 0.05)
    kw = dict(pool_feats=pool, pooled=pooled, dpool_over_ties=torch.ones_like(pooled) / ties)
    before = cuda.launches["kpconv_bwd_fused"]
    got = kpconv_bwd_fused(*call, **kw)
    assert cuda.launches["kpconv_bwd_fused"] == before + 1
    want = kpconv_bwd_fused_plain(*call, **kw)
    torch.cuda.synchronize()
    assert got[1].shape == (k, 64, 64)
    for g, w_ in zip(got, want):
        assert_kpconv_close(g, w_)


@pytest.mark.parametrize("c_in, c_out", [(1028, 32), (1030, 32), (32, 1028)])
def test_kpconv_rows_past_256_channel_groups_match_plain(device, c_in, c_out):
    """Rows wider than a block's 256 threads: C_in = 1,028 (257 four-channel
    groups: two passes), 1,030 (no multiple of 4: five passes of single
    channels) in the forward, C_out = 1,028 in the backward's u pass."""
    args, pool, q_mask = kernel_points_case(device, 15, c_in, c_out, m=133, n=211)
    before = cuda.launches["kpconv_fused"]
    got = kpconv_fused(*args, 0.05, q_mask=q_mask, residuals=True)
    assert cuda.launches["kpconv_fused"] == before + 1
    want = kpconv_fused_plain(*args, 0.05, q_mask=q_mask, residuals=True)
    feats, q_points, s_points, nbrs, kp, w = args
    inv = torch.from_numpy(build_inverse_table(nbrs.cpu().numpy(), feats.shape[0], 80)).to(device)
    gdiv = torch.randn(q_points.shape[0], c_out, device=device)
    call = (feats, s_points, q_points, gdiv, inv, kp, w, 0.05)
    grads = kpconv_bwd_fused(*call)
    want_grads = kpconv_bwd_fused_plain(*call)
    torch.cuda.synchronize()
    assert_kpconv_close(got[0], want[0])
    assert torch.equal(got[1], want[1])
    for g, w_ in zip(grads, want_grads):
        assert_kpconv_close(g, w_)


def test_kpconv_any_kernel_points_repeat_bit_for_bit_and_replay_from_a_graph(device):
    """K = 20: a split conv and its split backward repeat bit for bit and
    replay from a CUDA graph as run eagerly."""
    args, pool, q_mask = kernel_points_case(device, 20, 32, 32)
    feats, q_points, s_points, nbrs, kp, w = args
    n, m = feats.shape[0], q_points.shape[0]
    tables = split_of(nbrs, n, 16)
    kw = dict(q_mask=q_mask, residuals=True, pool_feats=pool, pool_cols=40)
    inv = build_inverse_table(nbrs.cpu().numpy(), n, 80)
    tail, tail_s, rank = build_split_tables(inv, m, 16, int((inv[:, 16:] < m).any(1).sum()))
    inv_split = tuple(torch.from_numpy(x).to(device) for x in (inv[:, :16].copy(), tail, tail_s,
                                                               rank))
    gdiv = torch.randn(m, 32, device=device)

    def both():
        return (kpconv_split_fused(*args[:3], *tables, kp, w, 0.05, **kw),
                kpconv_bwd_fused(feats, s_points, q_points, gdiv, inv_split, kp, w, 0.05))

    runs = [both() for _ in range(3)]
    before = cuda.launches["kpconv_bwd_fused"]
    graph, out, launches = captured(both, "kpconv_split_fused")
    assert launches == 1 and cuda.launches["kpconv_bwd_fused"] == before + 2  # warm-up, capture
    feats.mul_(0.5)
    gdiv.mul_(2.0)
    graph.replay()
    eager = both()
    torch.cuda.synchronize()
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
    for a, b in zip(out, eager):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- the launcher limits the JAX kernels do not share: the general routes ---
# Each site at a shape its CUDA kernel refused before and its JAX kernel (or
# the JAX XLA search) takes: its route function picks the general route, the
# kernel launches once, agrees with its plain version within its row's
# tolerance, repeats bit for bit and replays from a CUDA graph; a shipped
# shape still takes its old instance (the route function on this card).

def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def launches_once_repeats_and_replays(fn, kernel):
    """fn() launches ``kernel`` once; a second call repeats the first bit for
    bit; captured in a CUDA graph it counts one launch, and a replay gives
    the eager result. Returns the first result."""
    before = cuda.launches[kernel]
    first = fn()
    assert cuda.launches[kernel] == before + 1
    again = fn()
    graph, out, launches = captured(fn, kernel)
    assert launches == 1
    graph.replay()
    torch.cuda.synchronize()
    for a, b, c in zip(as_tuple(first), as_tuple(again), as_tuple(out)):
        assert torch.equal(a, b) and torch.equal(a, c)
    return first


def test_shipped_shapes_keep_their_instances(device):
    """The shipped configurations' shapes (3DMatch, KITTI, ModelNet, the
    synthetic workflow, the device pyramid's buckets) take the instances
    they took before, on this card's block budget."""
    from geotransformer_tpu_torch.kernels.attention import attention_route
    from geotransformer_tpu_torch.kernels.kpconv import pool_route, stream_route, union_route
    from geotransformer_tpu_torch.kernels.overlap import overlap_route
    from geotransformer_tpu_torch.kernels.pyramid import search_route

    budget = sinkhorn_kernels.device_block_bytes(device)
    for h in (34, 38, 40, 65):
        assert stream_route(h, 15, 64, budget) == "shared"
    assert union_route(4096, 38, 15, 64, budget) == "shared"
    for c in (1, 64, 128, 256, 512, 1024):
        for width in (38, 40, 65):
            assert pool_route(15, c, width, width, budget) == width
    assert overlap_route(64, budget) == overlap_route(128, budget) == "shared"
    for dh in (32, 64):
        assert attention_route(dh, True, 768) == (dh, True, True)
    for cap in (256, 640, 1024, 2048, 4096):
        assert search_route(cap, 0, False, budget).chunk == 0
    for c in (96, 128, 256):
        assert gse_kernels.gse_route(c, 3).backward.resident


@pytest.mark.parametrize("m, h, k, d", [(3001, 512, 15, 64), (2001, 360, 20, 64),
                                        (2003, 40, 15, 4096)],
                         ids=["H512", "H360-K20", "KD61440"])
def test_kpconv_stream_general_route(device, m, h, k, d):
    from geotransformer_tpu_torch.kernels.kpconv import stream_route

    assert stream_route(h, k, d, sinkhorn_kernels.device_block_bytes(device)) == "global"
    stream, kp, w = stream_case(device, m, h, k=min(k, 15), d=d)
    if k > 15:
        kp = any_kernel_points(k).to(device)
        w = torch.randn(k, 1, d, generator=torch.Generator().manual_seed(k)).to(device)
    got = launches_once_repeats_and_replays(
        lambda: kpconv_stream_fused(stream, kp, w, 0.05, residuals=True), "kpconv_stream_fused")
    want = kpconv_stream_fused_plain(stream, kp, w, 0.05, residuals=True)
    assert_kpconv_close(got[0], want[0])
    assert_kpconv_close(got[1], want[1])  # t1
    assert torch.equal(got[2], want[2])  # count


def wide_union_case(device, m, n, h, tile, d=64, seed=3):
    """Random neighbors over many supports, so a tile of 512 queries
    unions ~15,000 rows (past the ~13,400 a block once staged); every
    eleventh query without an edge."""
    g = torch.Generator().manual_seed(seed)
    s_points, q_points = torch.rand(n, 3, generator=g), torch.rand(m, 3, generator=g)
    table = torch.randint(0, n, (m, h), generator=g).to(torch.int32)
    table[torch.rand(m, h, generator=g) < 0.1] = n
    table[5::11] = n
    table = table.numpy()
    cap = max(np.unique(table[t:t + tile][table[t:t + tile] < n]).size for t in range(0, m, tile))
    rows, sel = build_union_tables(table, n, tile=tile, union_cap=cap)
    feats = (torch.rand(n, 1, generator=g) > 0.2).float() * torch.randn(n, 1, generator=g)
    kp = torch.from_numpy(load_kernel_points(0.3, 15))
    w, bias = torch.randn(15, 1, d, generator=g), torch.randn(d, generator=g)
    call = [t.to(device) for t in (feats, q_points, s_points, torch.from_numpy(rows),
                                   torch.from_numpy(sel), kp, w)]
    return call + [0.3, bias.to(device)], cap


@pytest.mark.parametrize("m, n, h, tile, d", [(1100, 60000, 38, 512, 64),
                                              (611, 700, 65, 100, 4096)],
                         ids=["U15000", "KD61440"])
def test_kpconv_union_general_route(device, m, n, h, tile, d):
    from geotransformer_tpu_torch.kernels.kpconv import union_route

    call, cap = wide_union_case(device, m, n, h, tile, d)
    assert union_route(cap, h, 15, d, sinkhorn_kernels.device_block_bytes(device)) == "global"
    got = launches_once_repeats_and_replays(
        lambda: kpconv_union_input_fused(*call, tile=tile, residuals=True),
        "kpconv_union_input_fused")
    want = kpconv_union_input_fused_plain(*call, tile=tile, residuals=True)
    assert_kpconv_close(got[0], want[0])
    assert torch.equal(got[1], want[1])  # count
    assert_kpconv_close(got[2], want[2])  # t1


def wide_pool_case(device, m=300, n=1500, h=1024, c=4, seed=4):
    """A conv over a 1,024-column table at C = 4 (64 rows a block: the pool
    phase in 128-column chunks), pool features in {-2, -1, 0, 1} (ties, and
    maxima at the zero shadow)."""
    g = torch.Generator().manual_seed(seed)
    s_points, q_points = torch.rand(n, 3, generator=g) * 0.3, torch.rand(m, 3, generator=g) * 0.3
    table = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    table[torch.rand(m, h, generator=g) < 0.3] = n
    table[7::13] = n
    feats = torch.randn(n, c, generator=g)
    pool = torch.randint(-2, 2, (n, c), generator=g).float()
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))
    w = torch.randn(15, c, 8, generator=g) / c
    return [t.to(device) for t in (feats, q_points, s_points, table, kp, w)], pool.to(device)


@pytest.mark.parametrize("split", [False, True])
def test_kpconv_pool_phase_in_chunks(device, split):
    """Rows 1 and 5: the pooled max bit-equal and the tie counts exact over
    1,024 columns staged 128 at a time."""
    from geotransformer_tpu_torch.kernels.kpconv import pool_route

    args, pool = wide_pool_case(device)
    n, h = args[2].shape[0], args[3].shape[1]
    assert pool_route(15, 4, h, h, sinkhorn_kernels.device_block_bytes(device)) == 128
    kw = dict(pool_feats=pool, residuals=True)
    if split:
        head, tail, tail_q, rank = split_of(args[3], n, 16)
        call = (*args[:3], head, tail, tail_q, rank, args[4], args[5], 0.05)
        kernel, plain, name = kpconv_split_fused, kpconv_split_fused_plain, "kpconv_split_fused"
    else:
        call = (*args, 0.05)
        kernel, plain, name = kpconv_fused, kpconv_fused_plain, "kpconv_fused"
    got = launches_once_repeats_and_replays(lambda: kernel(*call, **kw), name)
    want = plain(*call, **kw)
    assert torch.equal(got[1], want[1])  # pooled: the max is exact
    assert torch.equal(got[3], want[3])  # ties
    assert int((want[3] > 1).sum()) > 100
    assert_kpconv_close(got[0], want[0])


def test_kpconv_bwd_pool_phase_in_chunks(device):
    """Row 6: the pool gradient over a 1,024-column inverse table at C_out =
    4, its columns staged 128 at a time."""
    from geotransformer_tpu_torch.kernels.kpconv import pool_route

    g = torch.Generator().manual_seed(6)
    n, m, h, j, c_in, c_out, c_pool = 160, 1300, 160, 1024, 8, 4, 4
    s_points, q_points = torch.rand(n, 3, generator=g) * 0.1, torch.rand(m, 3, generator=g) * 0.1
    nbrs = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    nbrs[torch.rand(m, h, generator=g) < 0.3] = n
    inv = torch.from_numpy(build_inverse_table(nbrs.numpy(), n, j))
    assert int((inv < m).sum(1).max()) > 850
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))
    pool = torch.randint(-2, 2, (n, c_pool), generator=g).float()
    _, pooled, _, ties = kpconv_fused_plain(
        torch.ones(n, 1), q_points, s_points, nbrs, kp, torch.zeros(15, 1, 1), 0.05,
        pool_feats=pool, residuals=True)
    dpt = torch.randn(m, c_pool, generator=g) / ties
    args = [t.to(device) for t in (torch.randn(n, c_in, generator=g), s_points, q_points,
                                   torch.randn(m, c_out, generator=g), inv, kp,
                                   torch.randn(15, c_in, c_out, generator=g) / c_in)]
    kw = {k: v.to(device) for k, v in dict(pool_feats=pool, pooled=pooled,
                                           dpool_over_ties=dpt).items()}
    assert pool_route(15, c_out, j, j, sinkhorn_kernels.device_block_bytes(device)) == 128
    got = launches_once_repeats_and_replays(lambda: kpconv_bwd_fused(*args, 0.05, **kw),
                                            "kpconv_bwd_fused")
    want = kpconv_bwd_fused_plain(*args, 0.05, **kw)
    for gv, wv in zip(got, want):
        assert_kpconv_close(gv, wv)


@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32], ids=["int64", "int32"])
def test_patch_overlaps_general_route(device, index_dtype):
    """Row 11 at K = 2,048 points a patch (past ~1,600): bit-equal."""
    from geotransformer_tpu_torch.kernels.overlap import overlap_route

    assert overlap_route(2048, sinkhorn_kernels.device_block_bytes(device)) == "global"
    call = overlap_case(device, 12, 16, 2048, 8, index_dtype=index_dtype)
    got = launches_once_repeats_and_replays(lambda: patch_overlaps(*call, 0.1),
                                            "patch_overlaps")
    want = patch_overlaps_plain(*call, 0.1)
    assert torch.equal(got, want)
    assert 0.0 < (got > 0).float().mean().item() < 1.0
    assert not got[2].any() and not got[0].any() and not got[:, 0].any()


@pytest.mark.parametrize("dh", [3100, 4096])
def test_fused_attention_past_the_q_tile(device, dh):
    """Row 13 at head widths whose q tile does not fit a block (4 heads,
    256 keys): within 1e-5 x max|plain|, padded rows zero."""
    from geotransformer_tpu_torch.kernels.attention import attention_route

    assert not attention_route(dh, True, 256).q_tile
    (q, k, v, bias), key_masks = attention_case(device, 4, 40, 256, dh, True, True)
    nv_q = torch.tensor(33, dtype=torch.int32, device=device)
    nv_k = torch.tensor(250, dtype=torch.int32, device=device)
    scale = dh ** -0.5
    got = launches_once_repeats_and_replays(
        lambda: fused_masked_attention(q, k, v, bias, nv_q, nv_k, scale, key_masks),
        "fused_masked_attention")
    want = fused_masked_attention_plain(q, k, v, bias, nv_q, nv_k, scale, key_masks)
    assert (got[:33] - want[:33]).abs().max().item() <= 1e-5 * want[:33].abs().max().item()
    assert not got[33:].any()


@pytest.mark.parametrize("angles", [255, 300])
def test_gse_bwd_past_a_byte_of_angles(device, angles):
    """Row 8 at A = 255 and 300, C = 8 (the general instance, k* 16-bit),
    with two reference vectors tied (every entry of those settled in
    float64)."""
    assert not gse_kernels.gse_route(8, angles).backward.resident
    g = torch.Generator().manual_seed(angles)
    n = 24
    points = torch.rand(n, 3, generator=g)
    ref_vectors = torch.randn(n, angles, 3, generator=g) * 0.1
    ref_vectors[:, angles - 1] = ref_vectors[:, 7]
    w_a = torch.randn(8, 8, generator=g) / 8**0.5
    de = torch.randn(n, n, 8, generator=g)
    nv = torch.tensor(21, dtype=torch.int32)
    points, ref_vectors, w_a, de, nv = (t.to(device) for t in (points, ref_vectors, w_a, de, nv))
    got = launches_once_repeats_and_replays(
        lambda: gse_full_bwd(points, ref_vectors, w_a, 0.2, 15.0, de, nv), "gse_full_bwd")
    want = gse_full_bwd_plain(points, ref_vectors, w_a, 0.2, 15.0, de, nv)
    assert_gse_bwd_close(got, want)


@pytest.mark.parametrize("k", [40, 1500])
@pytest.mark.parametrize("brute", [False, True], ids=["grid", "brute"])
def test_grid_radius_search_general_route(device, k, brute):
    """The search at cand_cap 32,768 and brute over 40,000 support rows
    (past the 29,056 keys a block holds): the table and the counts bit for
    bit. A dense cloud gives each query thousands of keys in radius, so
    the 1,024-key chunks merge many times (K = 1,500: more than a chunk)."""
    from geotransformer_tpu_torch.kernels.pyramid import (
        grid_radius_search,
        grid_radius_search_plain,
        search_route,
    )
    from geotransformer_tpu_torch.preprocess.device import _search_support

    g = torch.Generator().manual_seed(k)
    cs, n_s, n_q, radius = 40960, 40000, 1200, 0.25
    q = torch.full((1, 1280, 3), 1e6)
    s = torch.full((1, cs, 3), 1e6)
    # queries inside [0.25, 0.75]^3: their whole radius ball lies in the cloud
    q[0, :n_q] = 0.25 + 0.5 * torch.rand(n_q, 3, generator=g)
    s[0, :n_s] = torch.rand(n_s, 3, generator=g)
    q_len, s_len = torch.tensor([n_q], dtype=torch.int32), torch.tensor([n_s], dtype=torch.int32)
    q, s, q_len, s_len = (t.to(device) for t in (q, s, q_len, s_len))
    if brute:
        index = torch.arange(cs, device=device, dtype=torch.float32)
        support = torch.cat([s, index[None, :, None]], dim=2)
        starts = origin = dims = None
        cap = 0
    else:
        support, starts, origin, dims, _ = _search_support(s, s_len, radius, 1 << 20)
        cap = 32768
    budget = sinkhorn_kernels.device_block_bytes(device)
    assert search_route(cap, cs, brute, budget).chunk == 1024
    call = (q, q_len, support, s_len, starts, origin, dims, radius, k, cap)
    got = launches_once_repeats_and_replays(lambda: grid_radius_search(*call),
                                            "grid_radius_search")
    want = grid_radius_search_plain(*call)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int((got[0][0, :n_q] < cs).sum(dim=1).min()) == k  # every row full
    assert bool((got[0][0, n_q:] == cs).all())


def test_rows_and_heads_past_the_launch_grid(device):
    """Row 12 at N = 65,540 query rows and row 13 at H = 65,540 heads (the
    grid's y dimension holds 65,535: a second launch takes the rest, within
    one wrapper call): each agrees with its plain version within 1e-5 x
    max|plain|, repeats bit for bit and replays from a CUDA graph."""
    from geotransformer_tpu_torch.kernels.attention import pair_scores_route

    g = torch.Generator().manual_seed(65540)
    n, m, c, h = 65540, 5, 8, 2
    embed, qw = (torch.randn(s, generator=g).to(device) for s in ((n, m, c), (n, h, c)))
    nv_q = torch.tensor(65537, dtype=torch.int32, device=device)
    assert pair_scores_route(c, h, True, n) == "scalar"
    got = launches_once_repeats_and_replays(lambda: rpe_pair_scores(embed, qw, nv_q, None),
                                            "rpe_pair_scores")
    want = rpe_pair_scores_plain(embed, qw, nv_q, None)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert not got[65537:].any()
    heads = 65540
    q, k, v = (torch.randn(s, generator=g).to(device)
               for s in ((heads, 20, 8), (heads, 24, 8), (heads, 24, 8)))
    bias = torch.randn(20, heads, 24, generator=g).to(device)
    nv_k = torch.tensor(21, dtype=torch.int32, device=device)
    got = launches_once_repeats_and_replays(
        lambda: fused_masked_attention(q, k, v, bias, None, nv_k, 0.3), "fused_masked_attention")
    want = fused_masked_attention_plain(q, k, v, bias, None, nv_k, 0.3)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# --- the bfloat16 instances (PrecisionConfig at the JAX package's point) ------

BF16 = torch.bfloat16


def assert_bf16_close(got, want, f32, bound):
    """A bfloat16 instance against its plain version at the same point:
    every entry within the row's float32 ``bound`` plus 2^-7 of the largest
    |want| (a value within an ulp of a rounding boundary may round the other
    way on the two, moving one term by a bfloat16 ulp), at least 99 % within
    ``bound``, and |got - want| under a quarter of |f32 - want| (``f32``: the
    plain version at float32): the kernel rounds where the plain version
    does."""
    got, want, f32 = got.float(), want.float(), f32.float()
    diff = (got - want).abs()
    assert bool((diff <= bound + 2.0**-7 * want.abs().max()).all()), diff.max().item()
    assert (diff <= bound).float().mean().item() >= 0.99
    assert (got - want).norm().item() <= 0.25 * (f32 - want).norm().item()


def kpconv_bound(want):
    return 1e-4 * want.abs() + 1e-5 * want.abs().max()


@pytest.mark.parametrize("c, k", [(64, 15), (6, 15), (1, 15), (64, 20)],
                         ids=["four-channels", "one-channel", "c_in_1", "K20-chunks"])
def test_kpconv_fused_bf16_matches_plain(device, c, k):
    """Row 1 at kpconv_mxu="bfloat16": the edge pass's rounding instances
    (four channels a thread, one, K in chunks of 16) and at C_in = 1 the
    CUDA-core product rounding t1 and W; the pool, the count and t1 as at
    float32, bit for bit; repeats and replays."""
    args, bias, pool, q_mask = kpconv_case(device, c, c_pool=8)
    if c == 1:
        args[0] = args[0].abs()  # the network input: non-negative
    if k != 15:
        g = torch.Generator().manual_seed(k)
        args[4] = ((torch.rand(k, 3, generator=g) - 0.5) * 0.1).to(device)
        args[5] = (torch.randn(k, c, c, generator=g) / c).to(device)
    kw = dict(pool_feats=pool, pool_cols=38, q_mask=q_mask, residuals=True,
              return_t1=c == 1)
    got = launches_once_repeats_and_replays(
        lambda: kpconv_fused(*args, 0.05, bias, mxu_dtype=BF16, **kw), "kpconv_fused")
    want = kpconv_fused_plain(*args, 0.05, bias, mxu_dtype=BF16, **kw)
    f32 = kpconv_fused_plain(*args, 0.05, bias, **kw)
    torch.cuda.synchronize()
    assert_bf16_close(got[0], want[0], f32[0], kpconv_bound(want[0]))
    for i in (1, 2, 3):  # pooled, count, ties: no rounding touches them
        assert torch.equal(got[i], want[i])
    if c == 1:
        assert_kpconv_close(got[4], want[4])  # t1, unrounded
        assert_kpconv_close(got[4], f32[4])


@pytest.mark.parametrize("c", [32, 1])
def test_kpconv_split_bf16_matches_plain(device, c):
    """Row 5 at kpconv_mxu="bfloat16" on a split table: one pass rounds each
    edge's operands (C_in > 1) or the whole t1 once (C_in = 1), as the
    plain version's combine does."""
    args, bias, _, q_mask = kpconv_case(device, c, m=301, h=40)
    if c == 1:
        args[0] = args[0].abs()
    table = args[3].cpu().numpy()
    n = args[2].shape[0]
    m2 = int((table[:, 16:] < n).any(axis=1).sum())
    split = [torch.from_numpy(x).to(device) for x in build_split_tables(table, n, 16, m2 + 8)]
    call = (args[0], args[1], args[2], args[3][:, :16].contiguous(), *split, args[4], args[5],
            0.05, bias)
    got = launches_once_repeats_and_replays(
        lambda: kpconv_split_fused(*call, q_mask=q_mask, mxu_dtype=BF16), "kpconv_split_fused")
    want = kpconv_split_fused_plain(*call, q_mask=q_mask, mxu_dtype=BF16)
    f32 = kpconv_split_fused_plain(*call, q_mask=q_mask)
    torch.cuda.synchronize()
    assert_bf16_close(got, want, f32, kpconv_bound(want))


@pytest.mark.parametrize("m, h, k", [(50002, 38, 15), (4000, 512, 15), (20004, 65, 20)],
                         ids=["shared", "global", "K20-chunks"])
def test_kpconv_stream_bf16_matches_plain(device, m, h, k):
    """Row 2 at kpconv_mxu="bfloat16" on its staged route, its general
    route and in chunks of 16 kernel points: t1 and W rounded in the
    epilogue, the t1 residual and the count unrounded, bit for bit with
    the float32 instance's."""
    from geotransformer_tpu_torch.kernels.kpconv import stream_route

    stream, kp, w = stream_case(device, m, h, k if k <= 15 else 15)
    if k > 15:
        g = torch.Generator().manual_seed(k)
        kp = ((torch.rand(k, 3, generator=g) - 0.5) * 0.1).to(device)
        w = torch.randn(k, 1, 64, generator=g).to(device)
    budget = sinkhorn_kernels.device_block_bytes(device)
    assert stream_route(h, k, 64, budget) == ("global" if h == 512 else "shared")
    got = launches_once_repeats_and_replays(
        lambda: kpconv_stream_fused(stream, kp, w, 0.05, residuals=True, mxu_dtype=BF16),
        "kpconv_stream_fused")
    f32_kernel = kpconv_stream_fused(stream, kp, w, 0.05, residuals=True)
    want = kpconv_stream_fused_plain(stream, kp, w, 0.05, residuals=True, mxu_dtype=BF16)
    f32 = kpconv_stream_fused_plain(stream, kp, w, 0.05, residuals=True)
    torch.cuda.synchronize()
    assert_bf16_close(got[0], want[0], f32[0], kpconv_bound(want[0]))
    assert torch.equal(got[1], f32_kernel[1]) and torch.equal(got[2], f32_kernel[2])


@pytest.mark.parametrize("d, k", [(64, 15), (4096, 15), (64, 20)],
                         ids=["shared", "global", "K20-chunks"])
def test_kpconv_union_bf16_matches_plain(device, d, k):
    """Row 7 at kpconv_mxu="bfloat16" on its staged route, its general route
    (K D = 61,440) and in chunks of 16 kernel points."""
    from geotransformer_tpu_torch.kernels.kpconv import union_route

    call, _ = union_case(device, 700, 900, 38, 128)
    g = torch.Generator().manual_seed(d + k)
    kp = call[5] if k == 15 else ((torch.rand(k, 3, generator=g) - 0.5) * 0.1).to(device)
    w = torch.randn(k, 1, d, generator=g).to(device)
    bias = torch.randn(d, generator=g).to(device)
    call = call[:5] + (kp, w, 0.05, bias)
    budget = sinkhorn_kernels.device_block_bytes(device)
    route = union_route(call[3].shape[1], call[4].shape[1], k, d, budget)
    assert route == ("global" if d == 4096 else "shared")
    got = launches_once_repeats_and_replays(
        lambda: kpconv_union_input_fused(*call, tile=128, residuals=True, mxu_dtype=BF16),
        "kpconv_union_input_fused")
    want = kpconv_union_input_fused_plain(*call, tile=128, residuals=True, mxu_dtype=BF16)
    f32 = kpconv_union_input_fused_plain(*call, tile=128, residuals=True)
    torch.cuda.synchronize()
    assert_bf16_close(got[0], want[0], f32[0], kpconv_bound(want[0]))
    assert torch.equal(got[1], want[1])  # count
    assert_kpconv_close(got[2], f32[2])  # t1, unrounded


@pytest.mark.parametrize("c, angles, basis, embed", [
    (256, 3, BF16, BF16), (128, 3, BF16, BF16), (32, 4, BF16, BF16), (48, 5, BF16, BF16),
    (512, 3, BF16, BF16), (96, 3, torch.float32, BF16), (96, 3, BF16, torch.float32)],
    ids=["C256", "C128", "C32-A4", "C48-A5-general", "C512-two-blocks", "embed-only",
         "basis-only"])
def test_gse_bf16_matches_plain(device, c, angles, basis, embed):
    """Row 3 at the bfloat16 points: the BF16 instances (bases rounded as
    built, weights once, one TF32 pass) of gse_kernel<C> and of
    gse_general_kernel, and the bfloat16 embedding store, against the plain
    version at the same point; exact zeros outside the valid rectangle;
    repeats and replays."""
    g = torch.Generator().manual_seed(c + angles)
    n, n_valid = 100, 90
    points = torch.rand(n, 3, generator=g)
    ref_vectors = torch.randn(n, angles, 3, generator=g) * 0.1
    w_d, w_a = (torch.randn(c, c, generator=g) / c**0.5 for _ in range(2))
    b_d, b_a = torch.randn(c, generator=g), torch.randn(c, generator=g)
    args = [t.to(device) for t in (points, ref_vectors, w_d, b_d, w_a, b_a)]
    nv = torch.tensor(n_valid, dtype=torch.int32, device=device)
    point = dict(basis_dtype=basis, embed_dtype=embed)
    got = launches_once_repeats_and_replays(
        lambda: gse_embedding_full(*args, 0.2, 15.0, nv, **point), "gse_embedding_full")
    want = gse_embedding_full_plain(*args, 0.2, 15.0, nv, **point)
    f32 = gse_embedding_full_plain(*args, 0.2, 15.0, nv)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == embed
    v = n_valid
    got_v, want_v = got[:v, :v], want[:v, :v]
    assert_bf16_close(got_v, want_v, f32[:v, :v], torch.full_like(want_v.float(), 1e-3))
    assert not got[v:].any() and not got[:, v:].any()


@pytest.mark.parametrize("c, h, aligned", [(256, 4, True), (130, 4, True), (64, 4, False)],
                         ids=["float4", "scalar", "misaligned"])
def test_rpe_pair_scores_on_a_bf16_embedding_matches_plain(device, c, h, aligned):
    """Row 12 on a bfloat16 embedding (widened exactly; qw and the scores in
    float32) on both routes: within 1e-5 x max|plain| of the plain version,
    which is the float32 function of the widened embedding; half the
    embedding's bytes."""
    from geotransformer_tpu_torch.kernels.attention import pair_scores_route

    g = torch.Generator().manual_seed(c)
    n = 300
    embed = torch.randn(n, n, c, generator=g).to(device).to(BF16)
    qw = torch.randn(n, h, c, generator=g).to(device)
    if not aligned:
        embed = torch.empty(n * n * c + 1, dtype=BF16, device=device)[1:].view(n, n, c).copy_(
            embed)
    nv = torch.tensor(281, dtype=torch.int32, device=device)
    route = pair_scores_route(c, h, embed.data_ptr() % 16 == 0 and qw.data_ptr() % 16 == 0, n)
    assert route == ("float4" if c == 256 else "scalar")
    got = launches_once_repeats_and_replays(lambda: rpe_pair_scores(embed, qw, nv, nv),
                                            "rpe_pair_scores")
    want = rpe_pair_scores_plain(embed, qw, nv, nv)
    torch.cuda.synchronize()
    assert torch.equal(want, rpe_pair_scores_plain(embed.float(), qw, nv, nv))
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    assert not got[281:].any() and not got[:, :, 281:].any()


def test_bf16_gradients_raise(device):
    """Training at the bfloat16 point is not ported: a KPConv at that point
    and the differentiable GSE and pair-score forms raise on the card too,
    before any launch."""
    from geotransformer_tpu_torch.kernels.attention import rpe_pair_scores_diff
    from geotransformer_tpu_torch.kernels.gse import gse_embedding_full_diff
    from geotransformer_tpu_torch.models.kpconv import KPConv

    args, _, _, _ = kpconv_case(device, 32)
    conv = KPConv(32, 32, 15, 0.0625, 0.05, mxu_dtype=BF16).to(device)
    before = cuda.launches["kpconv_fused"]
    with pytest.raises(NotImplementedError):
        conv(args[0], *args[1:4])  # gradients are on
    assert cuda.launches["kpconv_fused"] == before
    points = torch.rand(10, 3, device=device)
    vectors = torch.randn(10, 3, 3, device=device)
    w, b = torch.randn(32, 32, device=device), torch.randn(32, device=device)
    with pytest.raises(NotImplementedError):
        gse_embedding_full_diff(points, vectors, w, b, w, b, 0.2, 15.0, basis_dtype=BF16)
    with pytest.raises(NotImplementedError):
        rpe_pair_scores_diff(torch.zeros(4, 4, 8, dtype=BF16, device=device),
                             torch.zeros(4, 2, 8, device=device))
