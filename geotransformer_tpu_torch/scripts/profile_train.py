#!/usr/bin/env python
r"""The top device operations of one training step on the card, and the
device's busy share of an unprofiled step (the port's
``scripts/profile_train.py``).

    python -m geotransformer_tpu_torch.scripts.profile_train [--kitti] [--top 30]

One synthetic pair at full width with its inverse tables (3DMatch: GT
targets precomputed as the loader does; ``--kitti``: split and split
inverse tables, the GT overlaps computed in the step), seeded weights, the
config's optimizer. ``torch.profiler`` over ``--runs`` steps after a
warm-up step; the busy share is the kernels' self device time a step over
the CUDA-event time of an unprofiled step. With ``--device cpu`` a step
runs once and no time is measured.
"""

import argparse

import torch

from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.parallel import make_optimizer, make_train_step
from geotransformer_tpu_torch.scripts import pairs
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    print_result,
    resolve_device,
)
from geotransformer_tpu_torch.scripts.profile_forward import print_ops, top_result
from geotransformer_tpu_torch.utils import timing


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kitti", action="store_true", help="the KITTI pair and model")
    parser.add_argument("--top", type=int, default=30)
    parser.add_argument("--runs", type=int, default=2)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(timing.card(device), flush=True)
    cfg, batch = pairs.tool_batch(pairs.tool_config(args.kitti),
                                  pairs.make_tool_pair(args.kitti, 0), args.kitti, device,
                                  training=True)
    model = create_model(cfg, device=device)
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=10)
    train_step = make_train_step(model, cfg, optimizer, scheduler, device=device)
    generator = torch.Generator().manual_seed(0)
    losses = []

    def step():
        losses.append(train_step(batch, generator)["loss"])

    ops = timing.on_card(device, timing.top_device_ops, step, runs=args.runs)
    step_ms = timing.on_card(device, timing.time_ms, step, 5)
    losses = [float(loss) for loss in losses]
    if not all(torch.isfinite(torch.tensor(losses))):
        raise RuntimeError(f"non-finite training loss: {losses}")
    result = {"kitti": args.kitti, "step_ms": step_ms, "device_ms": None, "busy": None,
              "losses": losses, "top": []}
    if ops is not None:
        result["device_ms"] = print_ops("kernels of a training step", ops[0], args.top)
        result["busy"] = result["device_ms"] / step_ms
        result["top"] = top_result(ops[0], args.top)
    busy = "not measured" if result["busy"] is None else (
        f"busy {100 * result['busy']:.1f} %, idle {100 * (1 - result['busy']):.1f} %")
    print(f"device time {timing.fmt_ms(result['device_ms'])} a step (profiler) against a "
          f"{timing.fmt_ms(step_ms)} unprofiled step (CUDA events): {busy}", flush=True)
    print(f"losses {[round(loss, 4) for loss in losses]}", flush=True)
    print_result("profile_train", result)
    return result


if __name__ == "__main__":
    main()
