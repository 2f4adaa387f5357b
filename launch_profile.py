"""Device time of each call of the GSE forward (gse_embedding_full), the
Sinkhorn forward (sinkhorn_log_iterations, and sinkhorn_fwd_train in
training), the GSE backward (gse_full_bwd) and the Sinkhorn training
backward (sinkhorn_bwd_train) on one path, on one CUDA card:

    python3 launch_profile.py --path 3dmatch|kitti|modelnet [--reps 20]

Builds chip_smoke.py's pairs of that path at its full-width config, records
the wrappers' calls in one inference forward (the GSE forward, the
inference Sinkhorn) and in one training step (the rest; seed-0 weights,
pair 0), then prints one JSON line: for each call its shape, its device ms
replayed alone from its own CUDA graph (chip_smoke.graph_ms) and its bound
ms (chip_smoke's cost functions), each gse_full_bwd call also the entries
it settled in float64, and for each kernel the GSE backward's calls launch
(by name) its device ms summed over the calls, from torch.profiler's CUPTI
durations of ``reps`` eager runs (one profiler session a process: the
profiler loses the events of ctypes-launched kernels after its first).
Written to chiprun_out/launch_profile_<path>.json too."""

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

FORWARD = ("gse_embedding_full", "sinkhorn_log_iterations")
TRAINING = ("sinkhorn_fwd_train", "gse_full_bwd", "sinkhorn_bwd_train")


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


def time_calls(records, names):
    """Each recorded call of ``names`` alone from its own CUDA graph, with
    its shape and bound."""
    calls = []
    for name in names:
        kernel = getattr(cs.KERNELS[name].module, name)
        for args, kwargs in records[name]:
            before = cs.cuda.launches[name]
            out = kernel(*args, **kwargs)
            launches = cs.cuda.launches[name] - before
            settled = (int(cs.kernels_gse.last_settled) if name == "gse_full_bwd" else None)
            device_ms = cs.graph_ms(lambda: kernel(*args, **kwargs), name, launches)
            calls.append(dict(kernel=name, **cs.BY_CALL[name](name, args, kwargs, {}),
                              settled=settled, device_ms=device_ms,
                              bound_ms=cs.call_bound(name, args, kwargs, out)["bound_ms"]))
    return calls


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
    with cs.capture_kernel_calls(FORWARD) as records:
        model(batch)
    calls = time_calls(records, FORWARD)
    with cs.capture_kernel_calls(TRAINING) as records:
        cs.step_gradients(model, cfg, batch, 0)
    calls += time_calls(records, TRAINING)
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
