#!/usr/bin/env python
r"""Inference pairs a second at 1, 2, 4 and 8 pairs on the card (the port's
``scripts/profile_batch.py``).

    python -m geotransformer_tpu_torch.scripts.profile_batch [--kitti]

The JAX tool vmaps a padded batch over B pairs. The port's model takes one
pair a forward (the GSE and attention wrappers loop over the batch, one
kernel call a pair: ``models/transformer.py``), and no batched model is
added: B forwards of the tool pair are issued back to back in one
CUDA-event window, so the host's dispatch of one forward overlaps the
card's work on the one before. With ``--device cpu`` each size runs once
and no time is measured.
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

SIZES = (1, 2, 4, 8)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kitti", action="store_true", help="the KITTI pair and model")
    parser.add_argument("--reps", type=int, default=3)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(timing.card(device), flush=True)
    cfg, batch = pairs.tool_batch(pairs.tool_config(args.kitti),
                                  pairs.make_tool_pair(args.kitti, 0), args.kitti, device)
    model = create_model(cfg, device=device).eval()
    print("one pair a forward: B forwards back to back in one CUDA-event window "
          "(no batched model)", flush=True)
    result = {"kitti": args.kitti, "batches": {}}
    for size in SIZES:
        ms = timing.on_card(device, timing.time_ms,
                            lambda size=size: [model(batch) for _ in range(size)], args.reps)
        rate = None if ms is None else size * 1e3 / ms
        print(f"batch {size}: {timing.fmt_ms(ms, 2)} -> "
              f"{'not measured' if rate is None else f'{rate:.2f}'} pairs/s", flush=True)
        result["batches"][size] = dict(ms=ms, pairs_per_s=rate)
    print_result("profile_batch", result)
    return result


if __name__ == "__main__":
    main()
