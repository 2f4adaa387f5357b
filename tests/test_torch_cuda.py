"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips where no CUDA device exists (the kernels
have no CPU or interpret mode). Run on the H100 with
``python -m pytest tests/test_torch_cuda.py -m cuda -q``. Tolerances are
chip_smoke.py's: KPConv rtol 1e-4 + atol 1e-5 x max|plain| (f32 sums in
another order), GSE atol 1e-3 (256-term f32 projections in another order,
sincosf arguments up to ~12), Sinkhorn 1e-4.
"""

import numpy as np
import pytest
import torch

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.kernels.gse import gse_embedding_full, gse_embedding_full_plain
from geotransformer_tpu_torch.kernels.kpconv import (
    kpconv_fused,
    kpconv_fused_plain,
    kpconv_stream_fused,
    kpconv_stream_fused_plain,
)
from geotransformer_tpu_torch.kernels.sinkhorn import (
    sinkhorn_log_iterations,
    sinkhorn_log_iterations_plain,
)
from geotransformer_tpu_torch.models.kernel_points import load_kernel_points

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


def test_kpconv_stream_matches_plain(device):
    g = torch.Generator().manual_seed(1)
    m, h = 1000, 40
    stream = torch.randn(5, m, h, generator=g) * 0.03
    stream[3] = (torch.rand(m, h, generator=g) < 0.8).float()
    stream[4] = stream[3]
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))
    w = torch.randn(15, 1, 64, generator=g)
    args = [t.to(device) for t in (stream, kp, w)]
    got = kpconv_stream_fused(*args, 0.05)
    want = kpconv_stream_fused_plain(*args, 0.05)
    torch.cuda.synchronize()
    assert_kpconv_close(got, want)


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
