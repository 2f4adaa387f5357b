#!/usr/bin/env python
r"""Bounded probes of the hand-written CUDA kernels, one at a time (the
port's ``scripts/probe_kernels.py``).

    python -m geotransformer_tpu_torch.scripts.probe_kernels <name> [<name> ...] | all

Each probe builds its kernel's library, launches that kernel alone on the
card at small representative shapes made from a seed, synchronises, and
holds the result against the kernel's plain PyTorch version on the same
inputs: integer outputs exactly, floating ones within 1e-3 of the plain
output's largest magnitude (entries of a masked -1e12 left out). The GSE
probes call each of their kernel instances' widths (C = 256 and 96). It prints
``PASS <name>`` with the largest difference, or ``FAIL <name>`` and the
error, and exits non-zero if any probe failed. It covers the 13 rows of the
TPU kernel table and the two device-pyramid kernels. A kernel that hangs
the card cannot be interrupted from inside its process, so run each probe
under a process timeout and stop at the first failure:

    for k in $(python -m geotransformer_tpu_torch.scripts.probe_kernels --list); do
        timeout 300 python -m geotransformer_tpu_torch.scripts.probe_kernels $k \
            || { echo "HUNG/FAILED: $k"; break; }
    done

Without a CUDA device it raises: the kernels have no CPU mode.
"""

import argparse
import sys

import numpy as np
import torch

from geotransformer_tpu_torch.kernels import attention, cuda, gse, kpconv, overlap, pyramid
from geotransformer_tpu_torch.kernels import sinkhorn
from geotransformer_tpu_torch.models.kernel_points import load_kernel_points
from geotransformer_tpu_torch.preprocess.device import _search_support
from geotransformer_tpu_torch.preprocess.pyramid import (
    build_input_stream,
    build_inverse_table,
    build_split_tables,
    build_union_tables,
)
from geotransformer_tpu_torch.utils import timing

TOLERANCE = 1e-3
MASKED = 1e11  # entries of larger magnitude are masked (-1e12) scores


def _conv_case(g, c, m=300, n=500, h=40):
    """A KPConv's inputs: support and query points in a 0.3 m cube, each
    query's h nearest supports with 30 % sentinels, the 15 kernel points."""
    s_points = torch.rand(n, 3, generator=g) * 0.3
    q_points = torch.rand(m, 3, generator=g) * 0.3
    nbrs = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    nbrs[torch.rand(m, h, generator=g) < 0.3] = n
    feats = torch.randn(n, c, generator=g)
    kp = torch.from_numpy(load_kernel_points(0.0625, 15))
    w = torch.randn(15, c, c, generator=g) / c
    return feats, q_points, s_points, nbrs, kp, w


def _sinkhorn_case(g, p=256, m1=65):
    scores = torch.randn(p, m1, m1, generator=g)
    masked = torch.rand(p, m1, m1, generator=g) < 0.1
    masked[:, -1, -1] = False
    scores = torch.where(masked, -1e12, scores)
    log_mu = torch.where(masked.all(dim=2), -1e12, -np.log(2 * m1))
    log_nu = torch.where(masked.all(dim=1), -1e12, -np.log(2 * m1))
    return scores, log_mu, log_nu


def probe_kpconv_fused(g, device):
    feats, q, s, nbrs, kp, w = _conv_case(g, 64)
    pool = torch.randn(s.shape[0], 128, generator=g)
    args = [t.to(device) for t in (feats, q, s, nbrs, kp, w)]
    return lambda force: kpconv.kpconv_fused(*args, 0.05, pool_feats=pool.to(device),
                                             pool_cols=38, force=force)


def probe_kpconv_stream_fused(g, device):
    feats, _, s, nbrs, kp, w = _conv_case(g, 1, m=2000, n=2000, h=38)
    feats = (feats > -0.5).float()
    stream = torch.from_numpy(build_input_stream(s.numpy(), feats.numpy(), nbrs.numpy()))
    w = torch.randn(15, 1, 64, generator=g)
    args = [t.to(device) for t in (stream, kp, w)]
    return lambda force: kpconv.kpconv_stream_fused(*args, 0.05, force=force)


def probe_gse_embedding_full(g, device):
    """C = 256 (the configs' width) and C = 96 (the small synthetic
    workflow's: its channels across 4 warps)."""
    def call(n, c, n_valid):
        points = torch.rand(n, 3, generator=g)
        ref_vectors = torch.randn(n, 3, 3, generator=g) * 0.1
        w_d, w_a = (torch.randn(c, c, generator=g) / c**0.5 for _ in range(2))
        b_d, b_a = torch.randn(c, generator=g), torch.randn(c, generator=g)
        args = [t.to(device) for t in (points, ref_vectors, w_d, b_d, w_a, b_a)]
        nv = torch.tensor(n_valid, dtype=torch.int32, device=device)
        return lambda force: gse.gse_embedding_full(*args, 0.2, 15.0, nv, force=force)

    return call(256, 256, 230), call(160, 96, 150)


def probe_sinkhorn_log_iterations(g, device):
    args = [t.to(device) for t in _sinkhorn_case(g)]
    return lambda force: sinkhorn.sinkhorn_log_iterations(*args, 100, force=force)


def probe_kpconv_split_fused(g, device):
    feats, q, s, nbrs, kp, w = _conv_case(g, 64)
    n, h1 = s.shape[0], 8
    table = torch.sort(torch.where(nbrs < n, nbrs, n), dim=1).values.to(torch.int32)
    table[::2, h1:] = n  # every other query shallow
    m2 = int((table[:, h1:] < n).any(1).sum())
    split = build_split_tables(table.numpy(), n, h1, m2 + 3)
    args = [t.to(device) for t in (feats, q, s, table[:, :h1].contiguous(),
                                   *(torch.from_numpy(x) for x in split), kp, w)]
    return lambda force: kpconv.kpconv_split_fused(*args, 0.05, force=force)


def probe_kpconv_bwd_fused(g, device):
    feats, q, s, nbrs, kp, w = _conv_case(g, 64)
    inv = torch.from_numpy(build_inverse_table(nbrs.numpy(), s.shape[0], 80))
    gdiv = torch.randn(q.shape[0], 64, generator=g)
    args = [t.to(device) for t in (feats, s, q, gdiv, inv, kp, w)]
    return lambda force: kpconv.kpconv_bwd_fused(*args, 0.05, force=force)


def probe_kpconv_union_input_fused(g, device):
    feats, q, s, nbrs, kp, _ = _conv_case(g, 1, m=700, n=900, h=38)
    feats = (feats > -0.5).float()
    rows, sel = build_union_tables(nbrs.numpy(), s.shape[0], tile=128, union_cap=1536)
    w = torch.randn(15, 1, 64, generator=g)
    args = [t.to(device) for t in (feats, q, s, torch.from_numpy(rows), torch.from_numpy(sel),
                                   kp, w)]
    return lambda force: kpconv.kpconv_union_input_fused(*args, 0.05, tile=128, force=force)


def probe_gse_full_bwd(g, device):
    """C = 256 and C = 96 (the small synthetic workflow's width: 32-channel
    blocks)."""
    def call(n, c, n_valid):
        points = torch.rand(n, 3, generator=g)
        ref_vectors = torch.randn(n, 3, 3, generator=g) * 0.1
        w_a = torch.randn(c, c, generator=g) / c**0.5
        de = torch.randn(n, n, c, generator=g).to(device)
        args = [t.to(device) for t in (points, ref_vectors, w_a)]
        nv = torch.tensor(n_valid, dtype=torch.int32, device=device)
        return lambda force: gse.gse_full_bwd(*args, 0.2, 15.0, de, nv, force=force)

    return call(128, 256, 110), call(96, 96, 80)


def probe_sinkhorn_fwd_train(g, device):
    args = [t.to(device) for t in _sinkhorn_case(g, p=64)]
    return lambda force: sinkhorn.sinkhorn_fwd_train(*args, 100, force=force)


def probe_sinkhorn_bwd_train(g, device):
    scores, log_mu, log_nu = (t.to(device) for t in _sinkhorn_case(g, p=64))
    _, v_hist = sinkhorn.sinkhorn_fwd_train(scores, log_mu, log_nu, 100, force=False)
    dout = torch.where(scores > -MASKED, torch.randn(scores.shape, generator=g).to(device), 0.0)
    return lambda force: sinkhorn.sinkhorn_bwd_train(scores, log_mu, v_hist, dout, force=force)


def probe_patch_overlaps(g, device):
    m, n, k, s = 64, 70, 64, 8
    ref = torch.rand(m, 1, 3, generator=g) * 3 + torch.rand(m, k, 3, generator=g) - 0.5
    src = torch.rand(n, 1, 3, generator=g) * 3 + torch.rand(n, k, 3, generator=g) - 0.5
    args = [t.to(device) for t in (ref, torch.rand(m, k, generator=g) > 0.2, src,
                                   torch.rand(n, k, generator=g) > 0.2,
                                   torch.randint(0, n, (m, s), generator=g),
                                   torch.rand(m, s, generator=g) > 0.25)]
    return lambda force: overlap.patch_overlaps(*args, 0.3, force=force)


def probe_rpe_pair_scores(g, device):
    n, c, h = 256, 256, 4
    embed = torch.randn(n, n, c, generator=g).to(device)
    qw = torch.randn(n, h, c, generator=g).to(device)
    nv = torch.tensor(230, dtype=torch.int32, device=device)
    return lambda force: attention.rpe_pair_scores(embed, qw, nv, nv, force=force)


def probe_fused_masked_attention(g, device):
    h, n, dh = 4, 256, 64
    q, k, v = (torch.randn(h, n, dh, generator=g).to(device) for _ in range(3))
    bias = torch.randn(n, h, n, generator=g).to(device)
    return lambda force: attention.fused_masked_attention(q, k, v, bias, 230, 230, dh ** -0.5,
                                                          force=force)


def probe_grid_radius_search(g, device):
    cap, n, radius = 4096, 4000, 0.08
    xy = torch.rand(2, cap, 2, generator=g)
    points = torch.cat([xy, 0.1 * torch.sin(8 * xy[..., :1])], dim=2)
    lengths = torch.tensor([n, n - 500], dtype=torch.int32)
    points, lengths = points.to(device), lengths.to(device)
    support, starts, origin, dims, _ = _search_support(points, lengths, radius, 1 << 20)
    return lambda force: pyramid.grid_radius_search(points, lengths, support, lengths, starts,
                                                    origin, dims, radius, 38, 1024, force=force)


def probe_voxel_segment_mean(g, device):
    points = (torch.rand(2, 5000, 3, generator=g) * 60 - 30).to(device)
    seg = torch.sort(torch.randint(0, 1500, (2, 5000), generator=g), dim=1).values
    seg = torch.unique_consecutive(seg[0], return_inverse=True)[1].expand(2, -1).clone()
    seg[:, 4700:] = -1
    voxels = (seg[0].max() + 1).repeat(2).to(torch.int32).to(device)
    seg = seg.to(torch.int32).to(device)
    return lambda force: pyramid.voxel_segment_mean(points, seg, voxels, 1500, force=force)


PROBES = {name[len("probe_"):]: fn for name, fn in globals().items() if name.startswith("probe_")}


def largest_difference(got, want):
    """The largest |kernel - plain| over the outputs, after checking them."""
    worst = 0.0
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        if a.shape != b.shape:
            raise RuntimeError(f"shape {tuple(a.shape)} against the plain {tuple(b.shape)}")
        if not a.is_floating_point():
            if not torch.equal(a, b):
                raise RuntimeError("integer outputs differ from the plain version's")
            continue
        keep = b.abs() < MASKED
        diff = (a[keep] - b[keep]).abs().max().item() if bool(keep.any()) else 0.0
        scale = b[keep].abs().max().item() if bool(keep.any()) else 0.0
        if not diff <= TOLERANCE * scale + 1e-6:
            raise RuntimeError(f"max |kernel - plain| {diff:.3e} > {TOLERANCE} x {scale:.3e}")
        worst = max(worst, diff)
    return worst


def probe_calls(name, device):
    """The probe's calls, each ``call(force)``: most probes make one, some
    one a kernel instance."""
    calls = PROBES[name](torch.Generator().manual_seed(0), device)
    return calls if isinstance(calls, tuple) else (calls,)


def probe(name, device):
    """Run one probe; (passed, message)."""
    worst = []
    for call in probe_calls(name, device):
        before = cuda.launches[name]
        got = call(None)
        torch.cuda.synchronize()
        if cuda.launches[name] != before + 1:
            return False, (f"the kernel was launched {cuda.launches[name] - before} times, "
                           f"expected 1")
        try:
            worst.append(largest_difference(got, call(False)))
        except RuntimeError as error:
            return False, str(error)
    return True, "max|kernel - plain| " + ", ".join(f"{w:.3e}" for w in worst)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("names", nargs="*", help=f"all, or any of {', '.join(PROBES)}")
    parser.add_argument("--list", action="store_true", help="print the probe names and exit")
    args = parser.parse_args(argv)
    if args.list:
        print("\n".join(PROBES))
        return {}
    names = list(PROBES) if args.names in ([], ["all"]) else args.names
    unknown = [n for n in names if n not in PROBES]
    if unknown:
        raise SystemExit(f"unknown probes {unknown}; known: {list(PROBES)}")
    timing.require_card()
    print(timing.card("cuda"), flush=True)
    results = {}
    for name in names:
        print(f"probing {name} ...", flush=True)
        passed, message = probe(name, torch.device("cuda"))
        print(f"{'PASS' if passed else 'FAIL'} {name} {message}", flush=True)
        results[name] = passed
    if not all(results.values()):
        sys.exit(1)
    return results


if __name__ == "__main__":
    main()
