#!/usr/bin/env python3
r"""Drive the PyTorch port's 3DMatch inference and training paths on one CUDA
card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught):
  1. build   — nvcc compiles the CUDA kernels of geotransformer_tpu_torch/
               kernels/csrc for sm_90a, one process per source, in parallel;
  2. batch   — three synthetic 3DMatch-scale pairs (19,000-point wavy
               surface, 80 % overlap, 4 mm noise, known rigid transform)
               through the port's host pyramid, caps as scripts/demo.py picks
               them (multiple 256, per cloud), with the inverse neighbor
               tables of training batches;
  3. forward — the full-width make_3dmatch_config() model, seeded random
               weights, registers the three pairs; the kernels' launch counts
               are cleared just before and read just after, and every kernel
               of the path must have launched; per-pair time from CUDA events;
  4. kernel vs plain — each inference kernel on the inputs it got in a
               forward, held against its plain PyTorch version (KPConv rtol
               1e-4 and atol 1e-5 x max|plain|; GSE atol 1e-3 on the valid
               rectangle; Sinkhorn 1e-4 on valid entries), both timed; and the
               whole model with force_pallas=False, whose ref/src_feats_c must
               agree with the kernel run to 1e-3 of their largest magnitude;
  5. train   — the same model takes 8 training steps (Adam at the config's
               lr; pairs 0, 1, 2 in turn; GT targets precomputed on the card):
               counts cleared before and read after every step, each exact;
               every loss finite, no step skipped by the finite-gradient
               guard, and the seed-0 loss after the steps below its first;
               per-step time (CUDA events) and peak device memory;
  6. backward kernels vs plain — each training kernel on the inputs it got
               in one step, against its plain version (KPConv backward as the
               forward; GSE gradients atol 1e-4 x the largest plain one; Sinkhorn
               1e-4), both timed; and the whole step: every parameter
               gradient of the kernel model within 1e-3 (relative norm) of the
               force_pallas=False model's from the same weights and batch;
  7. profile — torch.profiler over two more training steps: device time by
               kernel (chiprun_out/train_profile.txt) and the device's busy
               share of phase 5's median step.
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
from geotransformer_tpu_torch.kernels import gse as kernels_gse
from geotransformer_tpu_torch.kernels import kpconv as kernels_kpconv
from geotransformer_tpu_torch.kernels import sinkhorn as kernels_sinkhorn
from geotransformer_tpu_torch.losses import overall_loss
from geotransformer_tpu_torch.models import create_model, precompute_gt_targets
from geotransformer_tpu_torch.models import kpconv as models_kpconv
from geotransformer_tpu_torch.models import sinkhorn as models_sinkhorn
from geotransformer_tpu_torch.models import transformer as models_transformer
from geotransformer_tpu_torch.parallel import make_optimizer, make_train_step
from geotransformer_tpu_torch.preprocess import (
    batch_to_torch,
    build_pyramid,
    caps_for_pyramid,
    pad_registration_batch,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
SEEDS = (0, 1, 2)
TRAIN_STEPS = 8
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
DEVICE = "cuda"


# --- each kernel's tolerance against its plain version -------------------
# tolerance(i, got, want, args, plain) -> (got, want, bound) for output i of
# one call (plain: all the plain outputs), after restricting both sides to
# the entries the rule covers.

def tol_kpconv(i, got, want, args, plain):
    return got, want, 1e-4 * want.abs() + 1e-5 * want.abs().max()


def tol_gse_embedding(i, got, want, args, plain):
    nv = int(args[8])  # the valid rectangle
    return got[:nv, :nv], want[:nv, :nv], torch.full_like(want[:nv, :nv], 1e-3)


def tol_sinkhorn_scores(i, got, want, args, plain):
    # output 0 is the scores: masked slots (-1e12) are left out; v_hist is whole
    if i == 0:
        valid = args[0] > -1e11
        got, want = got[valid], want[valid]
    return got, want, 1e-4 + 1e-4 * want.abs()


def tol_sinkhorn_bwd(i, got, want, args, plain):
    return got, want, 1e-4 + 1e-4 * want.abs()


def tol_gse_bwd(i, got, want, args, plain):
    # the scale of the call's weight gradients (outputs 0 and 2): db vanishes
    # in exact arithmetic (a bias under the attention softmax), both sides
    # hold rounding noise there
    scale = max(w.abs().max().item() for w in plain[0::2])
    return got, want, torch.full_like(want, 1e-4 * scale)


Kernel = collections.namedtuple(
    "Kernel", "module plain replaces source per_pair per_step tolerance")
# module: the module attribute the caller reaches the wrapper through;
# per_pair / per_step: launches per inference pair / per training step
KERNELS = {
    "kpconv_stream_fused": Kernel(models_kpconv, kernels_kpconv.kpconv_stream_fused_plain,
                                  "geotransformer_tpu/kernels/kpconv.py:1679",
                                  "geotransformer_tpu_torch/kernels/csrc/kpconv.cu", 1, 1,
                                  tol_kpconv),
    "kpconv_fused": Kernel(models_kpconv, kernels_kpconv.kpconv_fused_plain,
                           "geotransformer_tpu/kernels/kpconv.py:286",
                           "geotransformer_tpu_torch/kernels/csrc/kpconv.cu", 10, 10, tol_kpconv),
    "gse_embedding_full": Kernel(models_transformer, kernels_gse.gse_embedding_full_plain,
                                 "geotransformer_tpu/kernels/gse.py:222",
                                 "geotransformer_tpu_torch/kernels/csrc/gse.cu", 2, 2,
                                 tol_gse_embedding),
    "sinkhorn_log_iterations": Kernel(models_sinkhorn,
                                      kernels_sinkhorn.sinkhorn_log_iterations_plain,
                                      "geotransformer_tpu/kernels/sinkhorn.py:53",
                                      "geotransformer_tpu_torch/kernels/csrc/sinkhorn.cu", 1, 0,
                                      tol_sinkhorn_scores),
    "kpconv_bwd_fused": Kernel(kernels_kpconv, kernels_kpconv.kpconv_bwd_fused_plain,
                               "geotransformer_tpu/kernels/kpconv.py:744",
                               "geotransformer_tpu_torch/kernels/csrc/kpconv_bwd.cu", 0, 10,
                               tol_kpconv),
    "gse_full_bwd": Kernel(kernels_gse, kernels_gse.gse_full_bwd_plain,
                           "geotransformer_tpu/kernels/gse.py:378",
                           "geotransformer_tpu_torch/kernels/csrc/gse_bwd.cu", 0, 2, tol_gse_bwd),
    "sinkhorn_fwd_train": Kernel(kernels_sinkhorn, kernels_sinkhorn.sinkhorn_fwd_train_plain,
                                 "geotransformer_tpu/kernels/sinkhorn.py:205",
                                 "geotransformer_tpu_torch/kernels/csrc/sinkhorn_train.cu", 0, 1,
                                 tol_sinkhorn_scores),
    "sinkhorn_bwd_train": Kernel(kernels_sinkhorn, kernels_sinkhorn.sinkhorn_bwd_train_plain,
                                 "geotransformer_tpu/kernels/sinkhorn.py:234",
                                 "geotransformer_tpu_torch/kernels/csrc/sinkhorn_train.cu", 0, 1,
                                 tol_sinkhorn_bwd),
}
INFERENCE = [k for k, v in KERNELS.items() if v.per_pair]
TRAINING = [k for k, v in KERNELS.items() if not v.per_pair]


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
    batches = [pad_registration_batch(p, np.ones((n, 1), np.float32), t, caps,
                                      inverse_limits=cfg.caps.inverse_limits)
               for p, n, t in pyramids]
    stages = [[[int(v) for v in l] for l in p["lengths"]] for p, _, _ in pyramids]
    return caps, batches, stages


@contextlib.contextmanager
def capture_kernel_calls(names):
    """Record the arguments of every call of the named kernel wrappers."""
    records = collections.defaultdict(list)
    saved = []
    for name in names:
        module = KERNELS[name].module
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


def _plain_kwargs(kwargs):
    return {k: v for k, v in kwargs.items() if k != "force"}


def check_call(name, kernel_out, plain_out, args):
    """Max |kernel - plain| of one call, after checking its tolerance."""
    tolerance, plain = KERNELS[name].tolerance, _as_tuple(plain_out)
    worst = 0.0
    for i, (got, want) in enumerate(zip(_as_tuple(kernel_out), plain)):
        expect(got.shape == want.shape, f"{name}: shape {got.shape} vs plain {want.shape}")
        expect(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
        got, want, bound = tolerance(i, got, want, args, plain)
        diff = (got - want).abs()
        expect(bool((diff <= bound).all()),
               f"{name}: kernel disagrees with its plain version, max |diff| {diff.max().item()}")
        worst = max(worst, diff.max().item())
    return worst


# --- the least time the card could take for each call (bound_ms) --------
# bytes: each input read once, each output written once; operations: what
# these inputs need (valid edges, active queries, the valid GSE rectangle),
# against 67 TFLOP/s f32 and 3.35 TB/s.

def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))


def cost_kpconv_fused(args, kwargs, out):
    s_feats, q_points, _, nbr, kp, weights = args[:6]
    n, c = s_feats.shape
    k, _, d = weights.shape
    valid = nbr < n
    if kwargs.get("q_mask") is not None:
        valid &= kwargs["q_mask"][:, None]
    edges = int(valid.sum())
    active = int(valid.any(dim=1).sum())
    ops = 10 * edges * k + 2 * edges * k * c + 2 * active * k * c * d
    pool = kwargs.get("pool_feats")
    if pool is not None:
        ops += edges * pool.shape[1]
    return _nbytes(*args[:6], *kwargs.values(), *_as_tuple(out)), ops


def cost_kpconv_stream_fused(args, kwargs, out):
    stream, kp, weights = args[:3]
    _, m, h = stream.shape
    k, _, d = weights.shape
    return _nbytes(*args[:3], *_as_tuple(out)), 12 * m * h * k + 2 * m * k * d


def cost_gse_embedding_full(args, kwargs, out):
    points, ref_vectors, w_d = args[:3]
    nv, c, a = int(args[8]), w_d.shape[0], ref_vectors.shape[1]
    return _nbytes(*args[:6], out), nv * nv * 2 * c * c * (a + 1)


def _sinkhorn_elements(scores, iterations):
    return scores.numel() * int(iterations)


def cost_sinkhorn_log_iterations(args, kwargs, out):
    # per element and iteration, two half-steps of add, max, add, sub, exp, add
    return _nbytes(*args[:3], out), 12 * _sinkhorn_elements(args[0], args[3])


def cost_sinkhorn_fwd_train(args, kwargs, out):
    return _nbytes(*args[:3], *out), 12 * _sinkhorn_elements(args[0], args[3])


def cost_sinkhorn_bwd_train(args, kwargs, out):
    # per element and iteration: two log-sum-exp passes (12) and the two
    # softmax-weighted updates of dS and the marginal gradients (16)
    scores, _, v_hist = args[:3]
    return _nbytes(*args[:4], *out), 28 * scores.numel() * v_hist.shape[1]


def cost_kpconv_bwd_fused(args, kwargs, out):
    s_feats, _, q_points, gdiv, inv, kp, weights = args[:7]
    c = s_feats.shape[1]
    m, d = gdiv.shape
    k = weights.shape[0]
    valid = inv < m
    edges = int(valid.sum())
    active = int(valid.any(dim=1).sum())
    ops = 10 * edges * k + 2 * edges * k * d + 4 * active * k * d * c  # u, d_s, dW
    pool = kwargs.get("pool_feats")
    if pool is not None:
        ops += 2 * edges * pool.shape[1]
    return _nbytes(*args[:7], *kwargs.values(), *out), ops


def cost_gse_full_bwd(args, kwargs, out):
    points, ref_vectors, w_a = args[:3]
    de = args[5]
    nv = int(args[6]) if len(args) > 6 and args[6] is not None else points.shape[0]
    c, a = w_a.shape[0], ref_vectors.shape[1]
    return _nbytes(points, ref_vectors, w_a, de, *out[:3]), nv * nv * 2 * c * c * (a + 2)


COSTS = {name: globals()[f"cost_{name}"] for name in KERNELS}


def compare_kernels(records, names, reps):
    """Each kernel vs its plain version on the captured calls."""
    results = {}
    for name in names:
        module, plain = KERNELS[name].module, KERNELS[name].plain
        calls = records[name]
        kernel = getattr(module, name)
        expect(calls, f"{name}: no call captured")
        worst, total_bytes, total_ops = 0.0, 0, 0
        for args, kwargs in calls:
            out = kernel(*args, **kwargs)
            worst = max(worst, check_call(name, out, plain(*args, **_plain_kwargs(kwargs)), args))
            nbytes, ops = COSTS[name](args, kwargs, out)
            total_bytes += nbytes
            total_ops += ops

        def run_kernel():
            for args, kwargs in calls:
                kernel(*args, **kwargs)

        def run_plain():
            for args, kwargs in calls:
                plain(*args, **_plain_kwargs(kwargs))

        bytes_ms = total_bytes / PEAK_BYTES * 1e3
        ops_ms = total_ops / PEAK_F32_FLOPS * 1e3
        results[name] = {
            "calls": len(calls),
            "max_abs_err": worst,
            "ms": time_ms(run_kernel, reps),
            "plain_ms": time_ms(run_plain, max(1, reps // 2)),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": total_bytes,
            "operations": total_ops,
            # no single PyTorch call computes any of these functions
            "library_ms": None,
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


def target_generator(seed):
    return torch.Generator().manual_seed(seed)


def step_gradients(model, cfg, batch, seed):
    """Parameter gradients of one training forward/backward (no update)."""
    model.zero_grad(set_to_none=True)
    out = model(batch, training=True, with_gt=True, generator=target_generator(seed))
    loss, _ = overall_loss(cfg, out, batch["transform"])
    loss.backward()
    return loss.item(), {k: p.grad.detach().clone() for k, p in model.named_parameters()}


def compare_step_gradients(got, want):
    """Per parameter |g_kernel - g_plain| <= 1e-3 |g_plain|. Gradients that
    vanish in exact arithmetic (biases under a softmax row shift or a
    one-channel GroupNorm group) are rounding noise on both sides and are
    held to the noise floor (1e-6 of the largest gradient norm) instead."""
    floor = 1e-6 * max(w.norm().item() for w in want.values())
    worst, vanishing = (0.0, None), []
    for name, w in want.items():
        norm, diff = w.norm().item(), (got[name] - w).norm().item()
        if norm <= floor:
            expect(got[name].norm().item() <= floor, f"{name}: kernel gradient above noise")
            vanishing.append(name)
            continue
        expect(diff <= 1e-3 * norm, f"{name}: step gradient kernel vs plain {diff / norm:.2e}")
        worst = max(worst, (diff / norm, name))
    return worst, vanishing


def train_phase(cfg, model, batches, report):
    """TRAIN_STEPS steps over the pairs in turn, counted step by step."""
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=len(batches))
    step = make_train_step(model, cfg, optimizer, scheduler, device=DEVICE)
    with torch.no_grad():
        first = overall_loss(cfg, model(batches[0], training=True, with_gt=True,
                                        generator=target_generator(0)),
                             batches[0]["transform"])[0].item()
    torch.cuda.reset_peak_memory_stats()
    cuda.launches.clear()
    losses, times, total = [], [], collections.Counter()
    for i in range(TRAIN_STEPS):
        seed = SEEDS[i % len(SEEDS)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        metrics = step(batches[seed], target_generator(seed))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        counts = dict(cuda.launches)
        cuda.launches.clear()
        total.update(counts)
        for name, kernel in KERNELS.items():
            expect(counts.get(name, 0) == kernel.per_step,
                   f"train step {i}: {name} launched {counts.get(name, 0)} times, expected "
                   f"{kernel.per_step}")
        expect(metrics["grad_finite"].item() == 1.0, f"train step {i} skipped by the guard")
        loss = metrics["loss"].item()
        expect(np.isfinite(loss), f"train step {i}: loss {loss}")
        losses.append((seed, loss))
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        last = overall_loss(cfg, model(batches[0], training=True, with_gt=True,
                                       generator=target_generator(0)),
                            batches[0]["transform"])[0].item()
    expect(last < first, f"seed-0 loss did not fall: {first} -> {last}")
    median = statistics.median(times)
    print(f"train: {TRAIN_STEPS} steps, losses {[round(l, 4) for _, l in losses]}; seed-0 loss "
          f"{first:.4f} -> {last:.4f}; {median:.3f} ms per step (median of "
          f"{[round(t, 2) for t in times]}, CUDA events); peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    report.update(train_losses=losses, train_step_ms=times, train_step_median_ms=median,
                  train_peak_bytes=peak, seed0_loss=[first, last], train_launches=dict(total))
    return dict(total)


def profile_train(cfg, model, batches, report):
    """torch.profiler over two training steps: device time by kernel
    (chiprun_out/train_profile.txt) and the device's busy share of an
    unprofiled step (phase 5's median), the profiler's own host cost left out."""
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=len(batches))
    step = make_train_step(model, cfg, optimizer, scheduler, device=DEVICE)
    step(batches[0], target_generator(0))
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for seed in (0, 1):
            step(batches[seed], target_generator(seed))
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernel events only, as the table's "Self CUDA time total": an
    # operator's self device time repeats its kernels' time, and a user
    # annotation's (Adam's step) spans kernels counted on their own
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)) / 1e3 / 2
    step_ms = report["train_step_median_ms"]
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "train_profile.txt"), "w") as f:
        f.write(f"two training steps; device time {device_ms:.3f} ms per step against a "
                f"{step_ms:.3f} ms unprofiled step\n{table}\n")
    busy = device_ms / step_ms
    print(f"profile: device time {device_ms:.3f} ms per training step against a {step_ms:.3f} ms "
          f"step: busy {100 * busy:.1f} %, idle {100 * (1 - busy):.1f} %", flush=True)
    report["train_profile"] = {"device_ms_per_step": device_ms, "step_ms": step_ms}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is False)")
    device = torch.device(DEVICE)
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
          f"stages {stages}; caps {caps}; inverse limits {cfg.caps.inverse_limits}", flush=True)
    report.update(stages=stages, caps=caps)
    cfg = cfg.with_caps(stage_caps=caps)
    batches = [batch_to_torch(b, device) for b in batches_np]

    # 3. forward: the inference path, counted
    model = create_model(cfg, device=device)
    forward_ms(model, batches[0])  # warm-up (cuBLAS, caching allocator)
    cuda.launches.clear()
    times, outs = [], []
    for batch in batches:
        ms, out = forward_ms(model, batch)
        times.append(ms)
        outs.append(out)
    launches = {"inference": dict(cuda.launches)}
    for name in KERNELS:
        per_pair = KERNELS[name].per_pair
        got = launches["inference"].get(name, 0)
        expect(got == per_pair * len(batches),
               f"{name}: {got} launches in the inference path, expected {per_pair * len(batches)}")
    for out, batch_np, seed in zip(outs, batches_np, SEEDS):
        ortho = check_output(out, caps)
        rre, rte = registration_error(out["estimated_transform"], batch_np["transform"])
        print(f"pair {seed}: |R R^T - I| = {ortho:.2e}; random weights: RRE {rre:.2f} deg, "
              f"RTE {rte:.3f} m", flush=True)
    forward_median = statistics.median(times)
    print(f"forward: {forward_median:.3f} ms per pair (median of {times}, CUDA events)",
          flush=True)
    report.update(forward_ms=times, forward_median_ms=forward_median)

    # 4. inference kernels vs plain, on the inputs of a forward
    with capture_kernel_calls(INFERENCE) as records:
        model(batches[0])
    results = compare_kernels(records, INFERENCE, reps=10)
    plain_model = create_model(cfg.with_model(force_pallas=False), device=device)
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

    # 5. train: the training path, counted step by step
    for batch in batches:
        batch.update(precompute_gt_targets(cfg, batch, device=device))
    launches["train"] = train_phase(cfg, model, batches, report)

    # 6. training kernels vs plain, on the inputs of one step; the whole step
    with capture_kernel_calls(TRAINING) as records:
        step_gradients(model, cfg, batches[0], 0)
    results.update(compare_kernels(records, TRAINING, reps=5))
    loss_kernel, grads_kernel = step_gradients(model, cfg, batches[0], 0)
    plain_model.load_state_dict(model.state_dict())
    loss_plain, grads_plain = step_gradients(plain_model, cfg, batches[0], 0)
    worst, vanishing = compare_step_gradients(grads_kernel, grads_plain)
    print(f"whole step vs force_pallas=False: loss {loss_kernel:.6f} vs {loss_plain:.6f}; "
          f"worst parameter gradient rel diff {worst[0]:.2e} ({worst[1]}) over "
          f"{len(grads_plain)} tensors ({len(vanishing)} vanishing biases at the noise floor)",
          flush=True)
    report.update(step_loss_kernel=loss_kernel, step_loss_plain=loss_plain,
                  step_grad_worst_rel=worst, step_grad_vanishing=vanishing)
    for name, r in results.items():
        print(f"{name}: {r['calls']} calls, max|kernel - plain| {r['max_abs_err']:.3e}, kernel "
              f"{r['ms']:.3f} ms vs plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    report["kernels"] = results

    # 7. profile two more training steps
    profile_train(cfg, model, batches, report)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    report["nvidia_smi"] = smi
    report["launches"] = launches
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)

    line = []
    for name, kernel in KERNELS.items():
        r = results[name]
        by_path = {path: counts.get(name, 0) for path, counts in launches.items()}
        line.append({"name": name, "route": "cuda", "source": kernel.source,
                     "replaces": kernel.replaces,
                     "launches": sum(by_path.values()), "launches_by_path": by_path,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
