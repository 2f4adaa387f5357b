"""Device time of every call of the KPConv and GSE rows (kpconv_fused,
kpconv_split_fused, kpconv_bwd_fused, gse_embedding_full, gse_full_bwd),
the input convs (kpconv_stream_fused, kpconv_union_input_fused), the
attention (fused_masked_attention), the GT overlaps (patch_overlaps) and the
device pyramid's search (grid_radius_search) on the shipped paths, run by
the kernels of two checkouts of the port in turns, on one CUDA card:

    python3 compare_checkouts.py capture CALLS.pt
    python3 compare_checkouts.py time CALLS.pt OUT.json --root CHECKOUT [--reps 20]
    python3 compare_checkouts.py report A1.json B1.json B2.json A2.json
    python3 compare_checkouts.py capture CALLS.pt --paths kitti --kernels gse_embedding_full

``capture`` (this checkout) builds chip_smoke.py's 3DMatch, KITTI and
ModelNet pair 0 at their full-width configs (launch_profile.path_batch),
records the wrappers' calls in one inference forward and one training step
(seed-0 weights), the GSE rows' calls again with the 3DMatch pair at
hidden_dim 96 (the small synthetic workflow's width), the union input
conv's in a 3DMatch forward over the union tables (chip_smoke.py phase 5)
and the search's in the device build of the 3DMatch and KITTI pair 0
(phase 17's caps), and saves them on the CPU. ``time`` imports the port from CHECKOUT (built there with its own
sources), replays each saved call alone from its own CUDA graph
(utils.timing.graph_ms) and writes its device ms. ``report`` reads the runs
in the order given (the first checkout's, then the second's, then the
second's and the first's again, so a drift of the card shows in both) and
prints, for each path and row, each checkout's device ms summed over the
calls (the mean of its runs) and each later checkout's over the first's,
and one JSON line of them (more than two checkouts compare to the first).
``--paths`` and ``--kernels`` restrict what ``capture`` records; the paths
3dmatch_jax and kitti_jax, which it records only when asked, are the
3DMatch and KITTI forwards at the JAX package's default point
(configs.JAX_PRECISION: the bfloat16 instances). Every run also records the
card's name and power limit.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile

import torch

ROWS = ("kpconv_fused", "kpconv_split_fused", "kpconv_bwd_fused", "gse_embedding_full",
        "gse_full_bwd", "kpconv_stream_fused", "kpconv_union_input_fused",
        "fused_masked_attention", "patch_overlaps", "grid_radius_search")
GSE = ("gse_embedding_full", "gse_full_bwd")
UNION, SEARCH = "kpconv_union_input_fused", "grid_radius_search"
PATHS = ("3dmatch", "3dmatch_c96", "kitti", "modelnet")
JAX_POINT = ("3dmatch_jax", "kitti_jax")  # inference only
MODULES = {"kpconv_fused": "kpconv", "kpconv_split_fused": "kpconv",
           "kpconv_bwd_fused": "kpconv", "gse_embedding_full": "gse", "gse_full_bwd": "gse",
           "kpconv_stream_fused": "kpconv", "kpconv_union_input_fused": "kpconv",
           "fused_masked_attention": "attention", "patch_overlaps": "overlap",
           "grid_radius_search": "pyramid"}


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()


def moved(x, device):
    """x with every tensor in it (tuples and lists too) on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (tuple, list)):
        return type(x)(moved(v, device) for v in x)
    if isinstance(x, dict):
        return {k: moved(v, device) for k, v in x.items()}
    return x


def capture(out_path, paths, kernels):
    import dataclasses

    import numpy as np

    import chip_smoke as cs
    import launch_profile
    from geotransformer_tpu_torch.configs import JAX_PRECISION
    from geotransformer_tpu_torch.models import create_model
    from geotransformer_tpu_torch.preprocess import batch_to_torch, pad_registration_batch

    cs.cuda.build()
    calls = []

    def keep(path, records, names):
        # the precision keywords at float32, every checkout's default, left
        # out: a checkout from before them takes the calls too
        for name in names:
            calls.extend((path, name, moved(args, "cpu"), moved(
                {k: v for k, v in kwargs.items()
                 if not (k in cs.DTYPE_KEYS and v == torch.float32)}, "cpu"))
                for args, kwargs in records[name])

    def record(path, cfg, batch, names, train=True):
        names = [n for n in names if n in kernels and n not in (UNION, SEARCH)]
        if path not in paths or not names:
            return
        model = create_model(cfg, device=cs.DEVICE)
        with cs.capture_kernel_calls(names) as records:
            with torch.set_grad_enabled(train):
                model(batch)
            if train:
                cs.step_gradients(model, cfg, batch, 0)
        keep(path, records, names)

    def record_union(cfg):
        """A 3DMatch forward over pair 0's union tables (phase 5's batch)."""
        pyramid, n, transform = cs.SHARED["3dmatch"][0]
        feats, caps = np.ones((n, 1), np.float32), cfg.caps.stage_caps
        union_cap, _ = cs.union_capacity(
            [pad_registration_batch(pyramid, feats, transform, caps)], cs.UNION_TILE)
        batch = batch_to_torch(pad_registration_batch(
            pyramid, feats, transform, caps, input_stream=False, union_cap=union_cap,
            union_tile=cs.UNION_TILE), cs.DEVICE)
        model = create_model(cfg, device=cs.DEVICE)
        with cs.capture_kernel_calls([UNION]) as records, torch.no_grad():
            model(batch)
        keep("3dmatch", records, [UNION])

    def record_search(path, cfg):
        """The device build of pair 0 at phase 17's caps and candidate cap."""
        pyramids = cs.SHARED[path]
        caps, _, _, spec = cs.device_build(cfg, pyramids)
        pyramid, _, transform = pyramids[0]
        with cs.capture_kernel_calls([SEARCH]) as records:
            cs.build_pyramid_device(*cs.raw_inputs(pyramid, transform, caps[0], cs.DEVICE), **spec)
        keep(path, records, [SEARCH])

    with tempfile.TemporaryDirectory() as tmp:
        for path in ("3dmatch", "kitti", "modelnet"):
            if not {path, f"{path}_jax"} & set(paths) and not (
                    path == "3dmatch" and "3dmatch_c96" in paths):
                continue
            cfg, batch = launch_profile.path_batch(path, tmp)
            record(path, cfg, batch, ROWS)
            record(f"{path}_jax", dataclasses.replace(cfg, precision=JAX_PRECISION), batch, ROWS,
                   train=False)
            if path == "3dmatch" and path in paths and UNION in kernels:
                record_union(cfg)
            if path in ("3dmatch", "kitti") and path in paths and SEARCH in kernels:
                record_search(path, cfg)
            if path == "3dmatch":
                narrow = dataclasses.replace(cfg, geotransformer=dataclasses.replace(
                    cfg.geotransformer, hidden_dim=96))
                record("3dmatch_c96", narrow, batch, GSE)
    torch.save(calls, out_path)
    print(json.dumps({n: sum(1 for c in calls if c[1] == n) for n in ROWS}))


def time_calls(calls_path, out_path, root, reps):
    sys.path.insert(0, os.path.abspath(root))
    import importlib

    cuda = importlib.import_module("geotransformer_tpu_torch.kernels.cuda")
    timing = importlib.import_module("geotransformer_tpu_torch.utils.timing")
    modules = {m: importlib.import_module(f"geotransformer_tpu_torch.kernels.{m}")
               for m in set(MODULES.values())}
    package = os.path.dirname(os.path.dirname(cuda.__file__))
    if os.path.dirname(package) != os.path.abspath(root):
        raise RuntimeError(f"imported the port from {package}, not from {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build_s = cuda.build()
    result = []
    for path, name, args, kwargs in torch.load(calls_path, weights_only=False):
        args, kwargs = moved(args, "cuda"), moved(kwargs, "cuda")
        fn = getattr(modules[MODULES[name]], name)
        before = cuda.launches[name]
        fn(*args, **kwargs)
        launches = cuda.launches[name] - before
        if launches != 1:
            raise RuntimeError(f"{name}: {launches} launches, expected 1")
        ms = timing.graph_ms(lambda: fn(*args, **kwargs), name, 1, reps=reps)
        result.append({"path": path, "kernel": name, "device_ms": ms})
    with open(out_path, "w") as f:
        json.dump({"root": os.path.abspath(root), "card": card(), "build_s": build_s,
                   "calls": result}, f)
    print(f"{root}: {len(result)} calls timed, build {build_s:.1f} s", flush=True)


def report(paths):
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append(json.load(f))
    roots = list(dict.fromkeys(r["root"] for r in runs))
    if len(roots) < 2:
        raise SystemExit(f"report needs runs of two checkouts or more, got {roots}")
    sums = {root: collections.defaultdict(list) for root in roots}
    for run in runs:
        total = collections.defaultdict(float)
        for call in run["calls"]:
            total[call["path"], call["kernel"]] += call["device_ms"]
        for key, ms in total.items():
            sums[run["root"]][key].append(ms)
    first = roots[0]
    rows = []
    for key in sums[first]:
        runs_ms = [sums[root][key] for root in roots]
        means = [sum(r) / len(r) for r in runs_ms]
        rows.append({"path": key[0], "kernel": key[1], "ms": runs_ms,
                     "ratios": [m / means[0] for m in means[1:]]})
        print(f"{key[0]:12s} {key[1]:20s} {means[0]:9.4f} ms -> "
              + ", ".join(f"{m:9.4f} ms x{m / means[0]:.4f}" for m in means[1:])
              + f"  (runs {[[round(x, 4) for x in r] for r in runs_ms]})")
    print(json.dumps({"roots": roots, "cards": sorted({r["card"] for r in runs}), "rows": rows}))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", choices=("capture", "time", "report"))
    parser.add_argument("files", nargs="+")
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--paths", nargs="+", default=PATHS, choices=PATHS + JAX_POINT)
    parser.add_argument("--kernels", nargs="+", default=ROWS, choices=ROWS)
    opts = parser.parse_args()
    if opts.mode == "report":
        report(opts.files)
        return
    if not torch.cuda.is_available():
        raise SystemExit("compare_checkouts.py needs a CUDA device")
    if opts.mode == "capture":
        capture(opts.files[0], opts.paths, opts.kernels)
    else:
        time_calls(opts.files[0], opts.files[1], opts.root, opts.reps)


if __name__ == "__main__":
    main()
