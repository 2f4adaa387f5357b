#!/usr/bin/env python
r"""The top device operations of one inference forward on the card (the
port's ``scripts/profile_forward.py``).

    python -m geotransformer_tpu_torch.scripts.profile_forward [--kitti] [--top 40]

One synthetic pair at full width (the 3DMatch surface pair, or with
``--kitti`` the KITTI ray-cast pair with its split tables), seeded
weights; ``torch.profiler`` over ``--runs`` forwards after a warm-up one.
Prints each kernel's self device time and launches a forward, largest
first, and the kernels' total beside the forward's CUDA-event time. With
``--device cpu`` the forward runs once and no time is measured.
"""

import argparse

from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.scripts import pairs
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    print_result,
    resolve_device,
)
from geotransformer_tpu_torch.utils import timing


def print_ops(what, ops, top):
    """The ``top`` largest of ``ops`` (DeviceOp, per run), and their total."""
    total = sum(op.ms for op in ops)
    print(f"{what}: {total:.3f} ms of self device time a run, top {min(top, len(ops))} of "
          f"{len(ops)}:", flush=True)
    for op in ops[:top]:
        print(f"{op.ms:9.3f} ms {op.count:7.1f}x {100 * op.ms / max(total, 1e-12):5.1f} %  "
              f"{op.name[:110]}", flush=True)
    return total


def top_result(ops, top):
    return [dict(name=op.name[:160], ms=op.ms, count=op.count) for op in ops[:top]]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kitti", action="store_true", help="the KITTI pair and model")
    parser.add_argument("--top", type=int, default=40)
    parser.add_argument("--runs", type=int, default=2)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(timing.card(device), flush=True)
    cfg, batch = pairs.tool_batch(pairs.tool_config(args.kitti),
                                  pairs.make_tool_pair(args.kitti, 0), args.kitti, device)
    model = create_model(cfg, device=device).eval()
    print(f"caps {cfg.caps.stage_caps}", flush=True)
    ops = timing.on_card(device, timing.top_device_ops, lambda: model(batch), runs=args.runs)
    forward_ms = timing.on_card(device, timing.time_ms, lambda: model(batch), 5)
    result = {"kitti": args.kitti, "forward_ms": forward_ms, "device_ms": None, "top": []}
    if ops is not None:
        result["device_ms"] = print_ops("kernels of a forward", ops[0], args.top)
        result["top"] = top_result(ops[0], args.top)
    print(f"forward {timing.fmt_ms(forward_ms)} (CUDA events), kernels "
          f"{timing.fmt_ms(result['device_ms'])} (profiler)", flush=True)
    print_result("profile_forward", result)
    return result


if __name__ == "__main__":
    main()
