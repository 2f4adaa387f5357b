#!/usr/bin/env python
r"""Training smoke on the card: overfit 4 synthetic pairs and check that the
loss drops (the port's ``scripts/train_smoke.py``).

    python -m geotransformer_tpu_torch.scripts.train_smoke [--steps 40]

Drives the whole training stack: the host pyramid with inverse tables, the
forward kernels and the kernel backwards (KPConv, GSE, Sinkhorn), the GT
overlaps computed in the step (``patch_overlaps``), the circle and
Sinkhorn-NLL losses and the Adam update. The 3DMatch architecture at full
width on reduced capacities (stage caps (4096, 1280, 384, 128) a cloud,
correspondence capacity 2048, 64 GT candidates), 3,500-point wavy-surface
pairs. The mean loss of the last 8 steps must sit at least ``--min_drop``
below that of the first 8 (fewer steps: halves of the run).
"""

import argparse
import statistics

import numpy as np
import torch

from geotransformer_tpu_torch.configs import make_3dmatch_config
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.parallel import make_optimizer, make_train_step
from geotransformer_tpu_torch.preprocess import batch_to_torch, build_pyramid, pad_registration_batch
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    print_result,
    resolve_device,
)
from geotransformer_tpu_torch.utils import timing

PAIRS, POINTS = 4, 3500
MODEL_SEED, TARGET_SEED = 0, 7


def smoke_config():
    """The 3DMatch architecture at the smoke's capacities."""
    return make_3dmatch_config().with_caps(stage_caps=(4096, 1280, 384, 128),
                                           correspondence_capacity=2048, gt_candidates=64)


def make_smoke_pair(cfg, seed, device, with_inverse=True):
    """A wavy surface of POINTS points, z = 0.2 sin(5 x) cos(4 y) + 1 cm
    noise, and its part with x < 0.8, rotated about z by up to 0.5 rad and
    shifted by up to 0.2 m: the padded batch on ``device`` (inverse tables
    for training)."""
    r = np.random.default_rng(seed)
    xy = r.uniform(0, 1, (POINTS, 2)).astype(np.float32)
    z = 0.2 * np.sin(5 * xy[:, 0]) * np.cos(4 * xy[:, 1]) + 0.01 * r.normal(size=POINTS)
    ref = np.column_stack([xy, z]).astype(np.float32)
    src = ref[ref[:, 0] < 0.8]
    ang = r.uniform(0, 0.5)
    rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                   np.float32)
    t = r.uniform(-0.2, 0.2, 3).astype(np.float32)
    src_t = ((src - t) @ rot).astype(np.float32)  # rot @ src_t + t aligns to ref
    transform = np.eye(4, dtype=np.float32)
    transform[:3, :3], transform[:3, 3] = rot, t
    pts = np.concatenate([ref, src_t], 0)
    bb = cfg.backbone
    pyramid = build_pyramid(pts, np.asarray([len(ref), len(src_t)]), bb.num_stages,
                            bb.init_voxel_size, bb.init_radius, list(cfg.caps.neighbor_limits))
    batch = pad_registration_batch(
        pyramid, np.ones((pts.shape[0], 1), np.float32), transform, cfg.caps.stage_caps,
        inverse_limits=cfg.caps.inverse_limits if with_inverse else None)
    return batch_to_torch(batch, device)


def train(cfg, pairs, steps, device, log_every=10):
    """``steps`` steps over ``pairs`` in turn from seeded weights; the model,
    the losses and the steps' CUDA-event times (None on the CPU)."""
    model = create_model(cfg, seed=MODEL_SEED, device=device)
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=10)
    step = make_train_step(model, cfg, optimizer, scheduler, device=device)
    generator = torch.Generator().manual_seed(TARGET_SEED)
    losses, times = [], []
    for i in range(steps):
        batch = pairs[i % len(pairs)]
        if torch.device(device).type == "cuda":
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            metrics = step(batch, generator)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            metrics = step(batch, generator)
            times.append(None)
        if metrics["grad_finite"].item() != 1.0:
            raise RuntimeError(f"step {i + 1}: non-finite gradients, the step was skipped")
        losses.append(metrics["loss"].item())
        if (i + 1) % log_every == 0 or i + 1 == steps:
            print(f"step {i + 1:3d}: loss {losses[-1]:.4f}", flush=True)
    return model, losses, times


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--min_drop", type=float, default=0.2,
                        help="the least fall of the mean loss, first 8 steps to last 8")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(timing.card(device), flush=True)
    cfg = smoke_config()
    pairs = [make_smoke_pair(cfg, seed, device) for seed in range(PAIRS)]
    _, losses, times = train(cfg, pairs, args.steps, device)
    window = max(1, min(8, args.steps // 2))
    first, last = float(np.mean(losses[:window])), float(np.mean(losses[-window:]))
    if not np.isfinite(losses).all():
        raise RuntimeError(f"non-finite loss: {losses}")
    step_ms = None if times[0] is None else statistics.median(times)
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps (means of {window}); step "
          f"{timing.fmt_ms(step_ms)} median (CUDA events)", flush=True)
    print_result("train_smoke", {"steps": args.steps, "first": first, "last": last,
                                 "step_ms": step_ms, "losses": losses})
    if not last < first - args.min_drop:
        raise SystemExit(f"FAIL: the loss did not fall by {args.min_drop}: {first:.3f} -> "
                         f"{last:.3f}")
    print("OK", flush=True)
    return losses


if __name__ == "__main__":
    main()
