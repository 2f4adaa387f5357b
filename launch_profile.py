"""Device time of each launch of the GSE backward (gse_full_bwd) and the
Sinkhorn training backward (sinkhorn_bwd_train) on one path's training
step, on one CUDA card:

    python3 launch_profile.py --path 3dmatch|kitti|modelnet [--reps 20]

Builds chip_smoke.py's pairs of that path at its full-width config, records
the two wrappers' calls in one training step (seed-0 weights, pair 0), then
prints one JSON line: for each call its shape and its device ms replayed
alone from its own CUDA graph (chip_smoke.graph_ms), and for each kernel
the GSE backward's calls launch (by name) its device ms summed over the
calls, from torch.profiler's CUPTI durations of ``reps`` eager runs (one
profiler session a process: the profiler loses the events of
ctypes-launched kernels after its first). Written to
chiprun_out/launch_profile_<path>.json too."""

import argparse
import collections
import json
import os
import subprocess
import tempfile

import torch

import chip_smoke as cs
from geotransformer_tpu_torch.configs import (
    make_3dmatch_config,
    make_kitti_config,
    make_modelnet_config,
)
from geotransformer_tpu_torch.models import create_model, precompute_gt_targets
from geotransformer_tpu_torch.preprocess import batch_to_torch
from geotransformer_tpu_torch.preprocess.loader import prepare_pair

NAMES = ("gse_full_bwd", "sinkhorn_bwd_train")


def path_batch(path, tmp):
    """(config, pair 0's batch on the card) as chip_smoke.py builds them."""
    if path == "3dmatch":
        cfg = make_3dmatch_config()
        caps, _, batches_np, _ = cs.build_batches(cfg, cs.SEEDS)
        cfg = cfg.with_caps(stage_caps=caps)
        batch = batch_to_torch(batches_np[0], cs.DEVICE)
        batch.update(precompute_gt_targets(cfg, batch, device=cs.DEVICE))
        return cfg, batch
    if path == "kitti":
        cfg = make_kitti_config()
        caps, batches_np = cs.build_kitti_batches(cfg, cs.SEEDS)[:2]
        return cfg.with_caps(stage_caps=caps), batch_to_torch(batches_np[0], cs.DEVICE)
    cfg = make_modelnet_config()
    _, samples, caps, _, _ = cs.modelnet_dataset_and_caps(cfg, tmp)
    cfg = cfg.with_caps(stage_caps=caps)
    bb = cfg.backbone
    batch = prepare_pair(samples[0], num_stages=bb.num_stages, voxel_size=bb.init_voxel_size,
                         search_radius=bb.init_radius, neighbor_limits=cfg.caps.neighbor_limits,
                         stage_caps=caps, input_dim=bb.input_dim,
                         inverse_limits=cfg.caps.inverse_limits, precompute_targets=True,
                         model_cfg=cfg)
    batch.pop("meta")
    return cfg, batch_to_torch(batch, cs.DEVICE)


def call_shape(name, args):
    if name == "gse_full_bwd":
        nv = args[6]
        return {"N": args[0].shape[0], "n_valid": int(nv) if nv is not None else args[0].shape[0],
                "C": args[2].shape[0], "A": args[1].shape[1]}
    return {"P": args[0].shape[0], "M1": args[0].shape[1], "N1": args[0].shape[2],
            "iterations": args[2].shape[1]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--path", choices=("3dmatch", "kitti", "modelnet"), required=True)
    parser.add_argument("--reps", type=int, default=20)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("launch_profile.py needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.cuda.build()
    with tempfile.TemporaryDirectory() as tmp:
        cfg, batch = path_batch(opts.path, tmp)
    model = create_model(cfg, device=cs.DEVICE)
    with cs.capture_kernel_calls(NAMES) as records:
        cs.step_gradients(model, cfg, batch, 0)
    calls = []
    for name in NAMES:
        kernel = getattr(cs.KERNELS[name].module, name)
        for args, kwargs in records[name]:
            before = cs.cuda.launches[name]
            kernel(*args, **kwargs)
            calls.append(dict(kernel=name, **call_shape(name, args), device_ms=cs.graph_ms(
                lambda: kernel(*args, **kwargs), name, cs.cuda.launches[name] - before)))
    torch.cuda.synchronize()
    # row 8 launches several kernels a call: their device time by name, from
    # one profiler session over reps eager runs of its calls
    kernel = cs.KERNELS["gse_full_bwd"].module.gse_full_bwd
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(opts.reps):
            for args, kwargs in records["gse_full_bwd"]:
                kernel(*args, **kwargs)
        torch.cuda.synchronize()
    launch_ms = collections.defaultdict(float)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            launch_ms[e.key] += e.self_device_time_total / 1e3 / opts.reps
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"path": opts.path, "device": smi, "calls": calls,
              "gse_full_bwd_launch_ms": launch_ms}
    os.makedirs(os.path.join(cs.ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(cs.ROOT, "chiprun_out", f"launch_profile_{opts.path}.json")
    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
