#!/usr/bin/env python
r"""Time of each stage of the registration pipeline on the card (the port's
``scripts/profile_stages.py``).

    python -m geotransformer_tpu_torch.scripts.profile_stages [--kitti]

On one synthetic pair at full width, seeded weights: the full inference
forward, the KPConv FPN, the geometric transformer on the backbone's
superpoint features, the learnable Sinkhorn on 256 patches of 64 points
(100 iterations) and LGR on 256 random patch pairs. Each stage is timed
three ways: its launches replayed from a CUDA graph (``graph_ms``; a stage
that synchronises the host cannot be captured, and the line says so), CUDA
events around eager calls (host dispatch included), and the sum of its
kernels' self device time under ``torch.profiler``. With ``--device cpu``
each stage runs once and no time is measured.
"""

import argparse

import numpy as np
import torch

from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.models.geotransformer import split_pair
from geotransformer_tpu_torch.models.lgr import local_to_global_registration
from geotransformer_tpu_torch.models.sinkhorn import LearnableLogOptimalTransport
from geotransformer_tpu_torch.scripts import pairs
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    print_result,
    resolve_device,
)
from geotransformer_tpu_torch.utils import timing

PATCHES, PATCH_POINTS, ITERATIONS = 256, 64, 100


def graph_or_reason(fn):
    """(device ms from a CUDA-graph replay, None), or (None, why the
    capture failed)."""
    try:
        return timing.graph_ms(fn), None
    except RuntimeError as error:
        torch.cuda.synchronize()
        return None, str(error).strip().splitlines()[0][:120]


def stage_times(device, fn, reps):
    """{graph, events, profiler} ms of fn() (None on the CPU)."""
    if torch.device(device).type != "cuda":
        fn()
        return dict(graph_ms=None, events_ms=None, profiler_ms=None, note=None)
    graph, note = graph_or_reason(fn)
    kernels, _ = timing.top_device_ops(fn)
    return dict(graph_ms=graph, events_ms=timing.time_ms(fn, reps),
                profiler_ms=sum(op.ms for op in kernels), note=note)


def stages(cfg, model, batch, device):
    """{stage name: fn} over ``batch``."""
    out = model(batch)
    with torch.no_grad():
        feats_c = model.backbone(batch["features"], batch)[-1]
    ref_feats_c, src_feats_c = split_pair(feats_c, out["ref_points_c"].shape[0])
    ot = LearnableLogOptimalTransport(ITERATIONS).to(device)
    scores = torch.full((PATCHES, PATCH_POINTS, PATCH_POINTS), 0.1, device=device)
    masks = torch.ones((PATCHES, PATCH_POINTS), dtype=torch.bool, device=device)
    rng = np.random.default_rng(0)
    ref_knn = torch.as_tensor(rng.uniform(0, 1, (PATCHES, PATCH_POINTS, 3)),
                              dtype=torch.float32, device=device)
    src_knn = ref_knn + 0.01
    log_scores = torch.zeros((PATCHES, PATCH_POINTS, PATCH_POINTS), device=device)
    fm = cfg.fine_matching

    @torch.no_grad()
    def transformer():
        return model.transformer(
            out["ref_points_c"][None], out["src_points_c"][None], ref_feats_c[None],
            src_feats_c[None], ref_masks=out["ref_masks_c"][None],
            src_masks=out["src_masks_c"][None])

    @torch.no_grad()
    def lgr():
        return local_to_global_registration(
            ref_knn, src_knn, masks, masks, log_scores, k=fm.topk, acceptance_radius=0.1,
            correspondence_limit=cfg.caps.correspondence_capacity)

    return {
        "full forward": lambda: model(batch),
        "backbone (KPConv FPN)": torch.no_grad()(lambda: model.backbone(batch["features"], batch)),
        "geometric transformer": transformer,
        f"sinkhorn ({PATCHES} x {PATCH_POINTS}, {ITERATIONS} it)":
            torch.no_grad()(lambda: ot(scores, masks, masks)),
        "LGR": lgr,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kitti", action="store_true", help="the KITTI pair and model")
    parser.add_argument("--reps", type=int, default=10)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(timing.card(device), flush=True)
    cfg, batch = pairs.tool_batch(pairs.tool_config(args.kitti),
                                  pairs.make_tool_pair(args.kitti, 0), args.kitti, device)
    model = create_model(cfg, device=device).eval()
    result = {}
    for name, fn in stages(cfg, model, batch, device).items():
        t = stage_times(device, fn, args.reps)
        graph = timing.fmt_ms(t["graph_ms"]) if t["note"] is None else \
            f"not capturable ({t['note']})"
        print(f"{name:38s}: graph {graph}; events {timing.fmt_ms(t['events_ms'])}; "
              f"profiler kernels {timing.fmt_ms(t['profiler_ms'])}", flush=True)
        result[name] = t
    print_result("profile_stages", {"kitti": args.kitti, "stages": result})
    return result


if __name__ == "__main__":
    main()
