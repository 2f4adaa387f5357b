#!/usr/bin/env python
r"""KPConv at stage 0 on the card (the port's ``scripts/profile_kpconv.py``):
the row 1 kernel, its plain version and the backward (row 6).

    python -m geotransformer_tpu_torch.scripts.profile_kpconv

The 3DMatch tool pair's stage 0 at full width: its neighbor table
(M = 34,560 padded rows, H = 38 (+ alignment), K = 15 kernel points; the
JAX tool's stage 0 of the demo pair was M, H, K, C = 38144, 38, 15, 64)
and its inverse table, a 64 -> 64 conv with seeded features and weights.
For the forward (``kpconv_fused``) and the backward (``kpconv_bwd_fused``)
it prints the kernel's device time from a CUDA-graph replay, its CUDA-event
time, its plain version's, the largest difference from the plain version,
and the split of the device time between the edge pass
(``edge_kernel``) and the contraction (``gemm_*_kernel``, with its split-K
reduce) read off ``torch.profiler``. With ``--device cpu`` each call runs
once and no time is measured.
"""

import argparse
import re

import torch

from geotransformer_tpu_torch.kernels import kpconv as kernels
from geotransformer_tpu_torch.models.kernel_points import load_kernel_points
from geotransformer_tpu_torch.scripts import pairs
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    print_result,
    resolve_device,
)
from geotransformer_tpu_torch.utils import timing

CHANNELS = 64
PHASES = (("edge pass", r"edge_kernel"), ("contraction", r"gemm_\w*kernel|reduce_slices_kernel"))


def split(device, fn):
    """{phase: ms} of fn()'s kernels under torch.profiler (None on the CPU)."""
    ops = timing.on_card(device, timing.top_device_ops, fn)
    if ops is None:
        return None
    out = {phase: sum(op.ms for op in ops[0] if re.search(pattern, op.name))
           for phase, pattern in PHASES}
    out["other"] = sum(op.ms for op in ops[0]) - sum(out.values())
    return out


def measure(device, name, kernel, plain, reps):
    worst = max((k - p).abs().max().item() for k, p in zip(kernel(), plain()))
    r = dict(graph_ms=timing.on_card(device, timing.graph_ms, kernel, name, 1),
             events_ms=timing.on_card(device, timing.time_ms, kernel, reps),
             plain_ms=timing.on_card(device, timing.time_ms, plain, max(1, reps // 5)),
             max_abs_err=worst, phases=split(device, kernel))
    phases = "not measured" if r["phases"] is None else ", ".join(
        f"{k} {v:.3f} ms" for k, v in r["phases"].items())
    print(f"{name}: device {timing.fmt_ms(r['graph_ms'])} (graph), "
          f"{timing.fmt_ms(r['events_ms'])} (CUDA events); plain "
          f"{timing.fmt_ms(r['plain_ms'])}; max|kernel - plain| {worst:.3e}; {phases}",
          flush=True)
    return r


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--reps", type=int, default=20)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(timing.card(device), flush=True)
    cfg, batch = pairs.tool_batch(pairs.tool_config(False), pairs.make_tool_pair(False, 0),
                                  False, device, training=True)
    bb = cfg.backbone
    points, table, inverse = batch["points"][0], batch["neighbors"][0], batch["neighbors_inv"][0]
    m, h = table.shape
    generator = torch.Generator().manual_seed(0)
    feats = torch.randn((m, CHANNELS), generator=generator).to(device)
    weights = (torch.randn((bb.kernel_size, CHANNELS, CHANNELS), generator=generator)
               / CHANNELS).to(device)
    gdiv = torch.randn((m, CHANNELS), generator=generator).to(device)
    kp = torch.from_numpy(load_kernel_points(bb.init_radius, bb.kernel_size)).to(device)
    sigma = bb.init_sigma
    print(f"stage 0: M {m}, H {h}, K {bb.kernel_size}, C {CHANNELS} -> {CHANNELS}, inverse "
          f"table J {inverse.shape[1]}", flush=True)

    def forward(force=None):
        return (kernels.kpconv_fused(feats, points, points, table, kp, weights, sigma,
                                     force=force),)

    def backward(force=None):
        return kernels.kpconv_bwd_fused(feats, points, points, gdiv, inverse, kp, weights, sigma,
                                        force=force)

    result = {"M": m, "H": h, "K": bb.kernel_size, "C": CHANNELS,
              "kpconv_fused": measure(device, "kpconv_fused", forward,
                                      lambda: forward(False), args.reps),
              "kpconv_bwd_fused": measure(device, "kpconv_bwd_fused", backward,
                                          lambda: backward(False), args.reps)}
    print_result("profile_kpconv", result)
    return result


if __name__ == "__main__":
    main()
