#!/usr/bin/env python
r"""The inference forward's device time by operation and by kernel family
(the port's ``scripts/profile_ops.py``).

    python -m geotransformer_tpu_torch.scripts.profile_ops [--kitti] [--top 30]

One synthetic pair at full width, seeded weights, ``torch.profiler`` over
``--runs`` forwards. Two tables: the host-side operations (``aten::*``,
the port's autograd Functions) by their own device time, and the kernels
summed by family: the hand-written CUDA kernels of
``geotransformer_tpu_torch/kernels/csrc``, GEMMs (cuBLAS), copies and
fills, reductions and scans, sorts and top-k, indexing, other elementwise
kernels, and the rest. With ``--device cpu`` the forward runs once and no
time is measured.
"""

import argparse
import collections
import functools
import glob
import os
import re

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.scripts import pairs
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    print_result,
    resolve_device,
)
from geotransformer_tpu_torch.scripts.profile_forward import print_ops, top_result
from geotransformer_tpu_torch.utils import timing

# (family, pattern of a demangled kernel name), first match wins, after
# the hand-written kernels (hand_written)
FAMILIES = (
    ("gemm", r"gemm|gemv|xmma|cutlass|splitK"),
    ("copy / fill", r"[Cc]opy|Memcpy|Memset|CatArray|Fill"),
    ("reduction / scan", r"reduce|[Ss]can|softmax|norm_|Norm"),
    ("sort / top-k", r"[Ss]ort|topk|radix|bitonic"),
    ("indexing", r"index|gather|scatter"),
    ("elementwise", r"elementwise"),
)


@functools.cache
def hand_written():
    """A pattern matching the name of every ``__global__`` function of
    ``kernels/csrc``."""
    names = set()
    for path in glob.glob(os.path.join(cuda.CSRC_DIR, "*.cu*")):
        with open(path) as f:
            names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
                                    f.read()))
    return r"\b(" + "|".join(sorted(names)) + r")\b"


def family(name):
    if re.search(hand_written(), name):
        return "hand-written"
    for label, pattern in FAMILIES:
        if re.search(pattern, name):
            return label
    return "other"


def by_family(kernels):
    """{family: [ms, launches]} of the kernels, largest first."""
    sums = collections.defaultdict(lambda: [0.0, 0.0])
    for op in kernels:
        entry = sums[family(op.name)]
        entry[0] += op.ms
        entry[1] += op.count
    return dict(sorted(sums.items(), key=lambda kv: -kv[1][0]))


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
                                  pairs.make_tool_pair(args.kitti, 0), args.kitti, device)
    model = create_model(cfg, device=device).eval()
    ops = timing.on_card(device, timing.top_device_ops, lambda: model(batch), runs=args.runs)
    result = {"kitti": args.kitti, "device_ms": None, "families": {}, "operators": []}
    if ops is not None:
        kernels, operators = ops
        print_ops("operations of a forward", operators, args.top)
        total = sum(op.ms for op in kernels)
        families = by_family(kernels)
        print(f"kernel families of a forward ({total:.3f} ms of kernel time):", flush=True)
        for label, (ms, count) in families.items():
            print(f"{ms:9.3f} ms {count:7.1f}x {100 * ms / max(total, 1e-12):5.1f} %  {label}",
                  flush=True)
        result.update(device_ms=total, operators=top_result(operators, args.top),
                      families={k: dict(ms=v[0], count=v[1]) for k, v in families.items()})
    print(f"kernel time of a forward {timing.fmt_ms(result['device_ms'])} (profiler)",
          flush=True)
    print_result("profile_ops", result)
    return result


if __name__ == "__main__":
    main()
