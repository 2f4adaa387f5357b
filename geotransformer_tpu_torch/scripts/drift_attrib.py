#!/usr/bin/env python
r"""The kernel route's drift, attributed to each kernel family (the port's
``scripts/drift_attrib.py``).

    python -m geotransformer_tpu_torch.scripts.drift_attrib [--weights PATH]

On the weights ``scripts.drift`` trained and saved (``--weights``, its
default path), the four synthetic pairs' inference forwards with one
kernel family at a time routed to its plain PyTorch version (the others on
their kernels, TF32 off), each against the float64 plain route: coarse and
fine feature drift, the coarse rows' median cosine, the
superpoint-correspondence Jaccard and a digest of the fine features' bits.
A family's share is the part of the kernel route's drift (above the plain
float32 route's) that routing it to its plain version removes: within
``drift.plain_wrappers`` each chosen wrapper is replaced, in every module
of the package that holds it, by a call of it with ``force=False`` (as
``chip_smoke.py``'s ``capture_kernel_calls`` wraps the wrappers), and each
row checks that the chosen wrappers launched nothing and, on the card, the
others launched their kernels.

Then the JAX tool's sweep of the precision knobs (``PrecisionConfig``'s
``kpconv_mxu``, ``gse_basis`` and ``gse_embed``; ``kpconv_table`` is not
ported): the kernel route at each of the seven points with one or more of
them in bfloat16, the last the JAX package's default point, each against
the float64 plain route as above (plus the transform's RRE and RTE against
the float64 route's), under ``points`` in the result line. The weights were
trained at the float32 point (``scripts.drift``); the sweep is inference
only.
"""

import argparse
import collections
import dataclasses
import itertools
import zlib

import torch

from geotransformer_tpu_torch.configs import PrecisionConfig
from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.scripts import drift, train_smoke
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    print_result,
    resolve_device,
)
from geotransformer_tpu_torch.utils import timing

# the wrappers an inference forward calls, by family
FAMILIES = {
    "kpconv": ("kpconv_fused", "kpconv_split_fused", "kpconv_stream_fused",
               "kpconv_union_input_fused"),
    "gse": ("gse_embedding_full",),
    "attention": ("rpe_pair_scores", "fused_masked_attention"),
    "sinkhorn": ("sinkhorn_log_iterations",),
}
# the wrappers the smoke pairs' forward calls (3DMatch: no split tables, the
# edge stream)
CALLED = ("kpconv_fused", "kpconv_stream_fused", "gse_embedding_full", "rpe_pair_scores",
          "fused_masked_attention", "sinkhorn_log_iterations")


def outputs(weights, cfg, pairs, device, plain):
    """Each pair's outputs with the wrappers of ``plain`` on their plain
    versions, the others on their kernels, TF32 off; raises if a wrapper of
    ``plain`` launched its kernel, or, on the card, one of the others the
    forward calls launched none."""
    model = create_model(cfg, device=device)
    model.load_state_dict(weights)
    before = collections.Counter(cuda.launches)
    with drift.plain_wrappers(plain), drift.tf32(False):
        outs = [drift.forward(model, pair) for pair in pairs]
    launched = {name for name, n in cuda.launches.items() if n > before[name]}
    if launched & set(plain):
        raise RuntimeError(f"plain wrappers launched their kernels: {launched & set(plain)}")
    if torch.device(device).type == "cuda":
        idle = [name for name in CALLED if name not in plain and name not in launched]
        if idle:
            raise RuntimeError(f"the kernel wrappers {idle} launched nothing")
    return outs


# the knobs the sweep turns to bfloat16 (kpconv_table stays float32)
KNOBS = ("kpconv_mxu", "gse_basis", "gse_embed")


def knob_sweep(weights, cfg, pairs, device, refs, gts):
    """The kernel route at every point with some of ``KNOBS`` in bfloat16,
    each against the float64 route ``refs``: {name: drift.compare's row},
    named by the bfloat16 knobs."""
    points = {}
    for values in itertools.product(("float32", "bfloat16"), repeat=len(KNOBS)):
        if "bfloat16" not in values:
            continue  # the float32 point: the "all kernels" row
        point = dataclasses.replace(cfg, precision=PrecisionConfig(**dict(zip(KNOBS, values))))
        name = "+".join(k for k, v in zip(KNOBS, values) if v == "bfloat16")
        points[name] = drift.compare(outputs(weights, point, pairs, device, ()), refs, gts)
    return points


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", default="output/drift/weights.pt")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(timing.card(device), flush=True)
    cfg = train_smoke.smoke_config()
    pairs = [train_smoke.make_smoke_pair(cfg, seed, device) for seed in range(train_smoke.PAIRS)]
    gts = [p["transform"].double().cpu().numpy() for p in pairs]
    weights = torch.load(args.weights, map_location=device, weights_only=True)
    refs = drift.route_outputs(weights, cfg, pairs, "f64", device)
    combos = {"all kernels": (), **{f"{name} plain": names for name, names in FAMILIES.items()},
              "all plain (f32)": sum(FAMILIES.values(), ())}
    rows = {}
    for name, plain in combos.items():
        outs = outputs(weights, cfg, pairs, device, plain)
        rec = drift.compare(outs, refs, gts)
        rec["digest"] = f"{zlib.crc32(outs[0]['ref_feats_f'].tobytes()):08x}"
        rows[name] = rec
    kernels, floor = rows["all kernels"], rows["all plain (f32)"]
    for name, rec in rows.items():
        share = {}
        for key in ("feats_c", "feats_f"):
            excess = kernels[key] - floor[key]
            share[key] = None if excess <= 0 else (kernels[key] - rec[key]) / excess
        rec["share"] = share
        shares = "  ".join("n/a" if s is None else f"{s:6.1%}" for s in share.values())
        print(f"{name:18s} coarse {rec['feats_c']:.4e}  fine {rec['feats_f']:.4e}  cos_med "
              f"{rec['cos_med']:.7f}  jaccard {rec['jaccard']:.3f}  bits {rec['digest']}  "
              f"share of the drift (coarse, fine) {shares}", flush=True)
    points = knob_sweep(weights, cfg, pairs, device, refs, gts)
    for name, rec in points.items():
        print(f"bfloat16 {name:31s} coarse {rec['feats_c']:.4e}  fine {rec['feats_f']:.4e}  "
              f"jaccard {rec['jaccard']:.3f}  vs f64 RRE {rec['rre_delta']:.4f} deg, RTE "
              f"{rec['rte_delta'] * 1000:.3f} mm", flush=True)
    print_result("drift_attrib", {"rows": rows, "points": points})
    return rows


if __name__ == "__main__":
    main()
