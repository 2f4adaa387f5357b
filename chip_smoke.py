#!/usr/bin/env python3
r"""Drive the PyTorch port's 3DMatch inference path on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):
  1. build   — nvcc compiles the CUDA kernels of geotransformer_tpu_torch/
               kernels/csrc for sm_90a, one process per source, in parallel;
  2. batch   — three synthetic 3DMatch-scale pairs (19,000-point wavy
               surface, 80 % overlap, 4 mm noise, known rigid transform)
               through the port's host pyramid, caps as scripts/demo.py picks
               them (multiple 256, per cloud);
  3. forward — the full-width make_3dmatch_config() model, seeded random
               weights, registers the three pairs; the kernels' launch counts
               are cleared just before and read just after, and every kernel
               of the path must have launched; per-pair time from CUDA events;
  4. kernel vs plain — each kernel on the inputs it got in a forward, held
               against its plain PyTorch version (KPConv rtol 1e-4 and atol
               1e-5 x max|plain|; GSE atol 1e-3 on the valid rectangle;
               Sinkhorn 1e-4 on valid entries), both timed; and the whole
               model with force_pallas=False, whose ref/src_feats_c must agree
               with the kernel run to 1e-3 of their largest magnitude.
Then it prints the {"kernels": [...]} line, the card's name and power limit,
and, last, {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json.
"""

import collections
import contextlib
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from geotransformer_tpu_torch.configs import make_3dmatch_config
from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.kernels.gse import gse_embedding_full_plain
from geotransformer_tpu_torch.kernels.kpconv import (
    kpconv_fused_plain,
    kpconv_stream_fused_plain,
)
from geotransformer_tpu_torch.kernels.sinkhorn import sinkhorn_log_iterations_plain
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.models import kpconv as models_kpconv
from geotransformer_tpu_torch.models import sinkhorn as models_sinkhorn
from geotransformer_tpu_torch.models import transformer as models_transformer
from geotransformer_tpu_torch.preprocess import (
    batch_to_torch,
    build_pyramid,
    caps_for_pyramid,
    pad_registration_batch,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
SEEDS = (0, 1, 2)

# kernel -> (module attribute the model calls it through, plain version,
#            TPU kernel it replaces, CUDA source, launches per pair)
KERNELS = {
    "kpconv_stream_fused": (models_kpconv, kpconv_stream_fused_plain,
                            "geotransformer_tpu/kernels/kpconv.py:1679",
                            "geotransformer_tpu_torch/kernels/csrc/kpconv.cu", 1),
    "kpconv_fused": (models_kpconv, kpconv_fused_plain,
                     "geotransformer_tpu/kernels/kpconv.py:286",
                     "geotransformer_tpu_torch/kernels/csrc/kpconv.cu", 10),
    "gse_embedding_full": (models_transformer, gse_embedding_full_plain,
                           "geotransformer_tpu/kernels/gse.py:222",
                           "geotransformer_tpu_torch/kernels/csrc/gse.cu", 2),
    "sinkhorn_log_iterations": (models_sinkhorn, sinkhorn_log_iterations_plain,
                                "geotransformer_tpu/kernels/sinkhorn.py:53",
                                "geotransformer_tpu_torch/kernels/csrc/sinkhorn.cu", 1),
}


def make_pair(seed, n_ref=19000, extent=1.3):
    """Wavy surface (z = 0.5 sin(25 x) cos(20 y)) over extent x extent m;
    src is the part with x < 0.8 extent, 4 mm noise, in its own frame."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, extent, (n_ref, 2))
    z = 0.5 * np.sin(25.0 * xy[:, 0]) * np.cos(20.0 * xy[:, 1])
    ref = np.column_stack([xy, z]).astype(np.float32)
    keep = ref[:, 0] < 0.8 * extent
    world = ref[keep] + 0.004 * rng.normal(size=(int(keep.sum()), 3))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(0.2, 0.8)
    skew = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                     [-axis[1], axis[0], 0.0]])
    rot = np.eye(3) + np.sin(angle) * skew + (1.0 - np.cos(angle)) * skew @ skew
    trans = rng.uniform(-0.3, 0.3, 3)
    src = ((world - trans) @ rot).astype(np.float32)  # world = rot src + trans
    transform = np.eye(4, dtype=np.float32)
    transform[:3, :3], transform[:3, 3] = rot, trans
    return ref, src, transform


def build_batches(cfg, seeds):
    pyramids = []
    for seed in seeds:
        ref, src, transform = make_pair(seed)
        points = np.concatenate([ref, src], 0)
        pyramid = build_pyramid(points, [len(ref), len(src)], cfg.backbone.num_stages,
                                cfg.backbone.init_voxel_size, cfg.backbone.init_radius,
                                list(cfg.caps.neighbor_limits))
        pyramids.append((pyramid, points.shape[0], transform))
    # one capacity per stage and cloud covering every pair, as scripts/demo.py picks them
    per_pair = [caps_for_pyramid(p, multiple=256, per_cloud=True) for p, _, _ in pyramids]
    caps = tuple(tuple(max(c[s][i] for c in per_pair) for i in range(2))
                 for s in range(cfg.backbone.num_stages))
    batches = [pad_registration_batch(p, np.ones((n, 1), np.float32), t, caps)
               for p, n, t in pyramids]
    stages = [[[int(v) for v in l] for l in p["lengths"]] for p, _, _ in pyramids]
    return caps, batches, stages


@contextlib.contextmanager
def capture_kernel_calls():
    """Record the arguments of every kernel wrapper call the model makes."""
    records = collections.defaultdict(list)
    saved = []
    for name, (module, *_rest) in KERNELS.items():
        fn = getattr(module, name)
        saved.append((module, name, fn))

        def recorder(*args, _fn=fn, _name=name, **kwargs):
            records[_name].append((args, kwargs))
            return _fn(*args, **kwargs)

        setattr(module, name, recorder)
    try:
        yield records
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def time_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def expect(ok, message):
    if not ok:
        raise RuntimeError(message)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_call(name, kernel_out, plain_out, args):
    """Max |kernel - plain| of one call, after checking its tolerance."""
    worst = 0.0
    for got, want in zip(_as_tuple(kernel_out), _as_tuple(plain_out)):
        expect(got.shape == want.shape, f"{name}: shape {got.shape} vs plain {want.shape}")
        expect(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
        if name == "gse_embedding_full":
            nv = int(args[8])
            got, want = got[:nv, :nv], want[:nv, :nv]
            bound = torch.full_like(want, 1e-3)
        elif name == "sinkhorn_log_iterations":
            valid = args[0] > -1e11  # masked slots hold -1e12
            got, want = got[valid], want[valid]
            bound = 1e-4 + 1e-4 * want.abs()
        else:
            bound = 1e-4 * want.abs() + 1e-5 * want.abs().max()
        diff = (got - want).abs()
        expect(bool((diff <= bound).all()),
               f"{name}: kernel disagrees with its plain version, max |diff| {diff.max().item()}")
        worst = max(worst, diff.max().item())
    return worst


def compare_kernels(records):
    """Each kernel vs its plain version on the calls of one forward."""
    results = {}
    for name, (module, plain, *_rest) in KERNELS.items():
        calls = records[name]
        kernel = getattr(module, name)
        expect(calls, f"{name}: no call captured")
        worst = 0.0
        for args, kwargs in calls:
            plain_kwargs = {k: v for k, v in kwargs.items() if k != "force"}
            worst = max(worst, check_call(name, kernel(*args, **kwargs),
                                          plain(*args, **plain_kwargs), args))
        reps = 10 if name != "sinkhorn_log_iterations" else 5

        def run_kernel():
            for args, kwargs in calls:
                kernel(*args, **kwargs)

        def run_plain():
            for args, kwargs in calls:
                plain(*args, **{k: v for k, v in kwargs.items() if k != "force"})

        results[name] = {
            "calls_per_pair": len(calls),
            "max_abs_err": worst,
            "ms": time_ms(run_kernel, reps),
            "plain_ms": time_ms(run_plain, reps),
        }
    return results


def forward_ms(model, batch):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = model(batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def check_output(out, caps):
    est = out["estimated_transform"]
    expect(est.shape == (4, 4) and bool(torch.isfinite(est).all()), "non-finite transform")
    rot = est[:3, :3].double()
    ortho = (rot @ rot.T - torch.eye(3, dtype=torch.float64, device=rot.device)).abs().max().item()
    expect(ortho < 1e-3, f"R R^T deviates from I by {ortho}")
    expect(abs(torch.linalg.det(rot).item() - 1.0) < 1e-3, "det(R) is not 1")
    cfg = make_3dmatch_config()
    p, k = cfg.coarse_matching.num_correspondences, cfg.model.num_points_in_patch
    expect(out["matching_scores"].shape == (p, k + 1, k + 1), "matching_scores shape")
    expect(out["ref_corr_points"].shape == (cfg.caps.correspondence_capacity, 3),
           "ref_corr_points shape")
    expect(out["ref_feats_c"].shape == (caps[-1][0], cfg.geotransformer.output_dim),
           "ref_feats_c shape")
    for key in ("ref_feats_c", "src_feats_c", "ref_feats_f", "src_feats_f", "matching_scores"):
        expect(bool(torch.isfinite(out[key]).all()), f"non-finite {key}")
    expect(bool(out["node_corr_masks"].any()), "no superpoint correspondence")
    return ortho


def registration_error(est, gt):
    est, gt = est.double().cpu().numpy(), gt.astype(np.float64)
    cos = (np.trace(est[:3, :3].T @ gt[:3, :3]) - 1.0) / 2.0
    rre = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    return rre, float(np.linalg.norm(est[:3, 3] - gt[:3, 3]))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is False)")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}

    # 1. build
    build_s = cuda.build()
    print(f"build: {build_s:.1f} s for {', '.join(cuda.SOURCES)} (nvcc, sm_90a)", flush=True)
    report["build_s"] = build_s

    # 2. batch
    cfg = make_3dmatch_config()
    start = time.perf_counter()
    caps, batches_np, stages = build_batches(cfg, SEEDS)
    print(f"batch: {len(batches_np)} pairs in {time.perf_counter() - start:.1f} s; "
          f"stages {stages}; caps {caps}", flush=True)
    report.update(stages=stages, caps=caps)
    cfg = cfg.with_caps(stage_caps=caps)
    batches = [batch_to_torch(b, device) for b in batches_np]

    # 3. forward: the main path, counted
    model = create_model(cfg).to(device)
    forward_ms(model, batches[0])  # warm-up (cuBLAS, caching allocator)
    cuda.launches.clear()
    times, outs = [], []
    for batch in batches:
        ms, out = forward_ms(model, batch)
        times.append(ms)
        outs.append(out)
    launches = dict(cuda.launches)
    for name, (*_rest, per_pair) in KERNELS.items():
        expect(launches.get(name, 0) == per_pair * len(batches),
               f"{name}: {launches.get(name, 0)} launches in the main path, "
               f"expected {per_pair * len(batches)}")
    for out, batch_np, seed in zip(outs, batches_np, SEEDS):
        ortho = check_output(out, caps)
        rre, rte = registration_error(out["estimated_transform"], batch_np["transform"])
        print(f"pair {seed}: |R R^T - I| = {ortho:.2e}; random weights: RRE {rre:.2f} deg, "
              f"RTE {rte:.3f} m", flush=True)
    forward_median = statistics.median(times)
    print(f"forward: {forward_median:.3f} ms per pair (median of {times}, CUDA events)",
          flush=True)
    report.update(forward_ms=times, forward_median_ms=forward_median, launches=launches)

    # 4. kernel vs plain, on the inputs of a forward
    with capture_kernel_calls() as records:
        model(batches[0])
    results = compare_kernels(records)
    for name, r in results.items():
        print(f"{name}: {r['calls_per_pair']} calls/pair, max|kernel - plain| "
              f"{r['max_abs_err']:.3e}, kernel {r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms",
              flush=True)
    report["kernels"] = results

    plain_model = create_model(cfg.with_model(force_pallas=False)).to(device)
    plain_model.load_state_dict(model.state_dict())
    forward_ms(plain_model, batches[0])
    plain_times = []
    for batch in batches:
        ms, plain_out = forward_ms(plain_model, batch)
        plain_times.append(ms)
    for side in ("ref", "src"):
        rows = outs[-1][f"{side}_masks_c"]
        got, want = outs[-1][f"{side}_feats_c"][rows], plain_out[f"{side}_feats_c"][rows]
        rel = ((got - want).abs().max() / want.abs().max()).item()
        expect(rel <= 1e-3, f"{side}_feats_c: kernel model vs plain model {rel:.2e} > 1e-3")
        print(f"whole model vs force_pallas=False: {side}_feats_c max rel diff {rel:.2e}",
              flush=True)
    plain_median = statistics.median(plain_times)
    print(f"plain forward: {plain_median:.3f} ms per pair (median of {plain_times})", flush=True)
    report.update(plain_forward_ms=plain_times, plain_forward_median_ms=plain_median)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    report["nvidia_smi"] = smi
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
        for name, (_m, _p, replaces, source, _n) in KERNELS.items()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
