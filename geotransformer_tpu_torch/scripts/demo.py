#!/usr/bin/env python
r"""Single-pair registration demo (the port's ``scripts/demo.py``; reference
`experiments/.../demo.py:44-87`).

    python -m geotransformer_tpu_torch.scripts.demo --ref_file ref.npy \
        --src_file src.npy --gt_file gt.npy [--device_preprocess] [--snapshot model.pth]

Registers one pair with the 3DMatch model: the point pyramid on the host
(capacities fitted to the pair, a multiple of 256 a cloud) or, with
``--device_preprocess``, built on the device at the config's capacities
from the raw points, then the forward and the estimated transform with its
RRE / RTE against the ground truth. The weights are a state dict of the
port's own parameter names (``--snapshot``: a ``Trainer`` checkpoint's
``model`` entry, or a plain state dict), else the seeded initial ones, with
which every stage runs but the transform means nothing.
"""

import argparse
import time

import numpy as np
import torch

from geotransformer_tpu_torch.configs import make_3dmatch_config
from geotransformer_tpu_torch.losses.metrics import isotropic_transform_error
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.preprocess import (
    batch_to_torch,
    build_pyramid,
    build_pyramid_device,
    caps_for_pyramid,
    pad_registration_batch,
    pad_stage0,
)
from geotransformer_tpu_torch.scripts.common import add_device_argument, resolve_device


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--ref_file", required=True, help="(N, 3) ref points, .npy")
    parser.add_argument("--src_file", required=True, help="(M, 3) src points, .npy")
    parser.add_argument("--gt_file", required=True, help="(4, 4) ground-truth transform, .npy")
    parser.add_argument("--snapshot", default=None,
                        help="a state dict of the port's parameter names (or a checkpoint "
                             "holding one under 'model')")
    parser.add_argument("--repeat", type=int, default=3, help="timed forwards")
    parser.add_argument("--device_preprocess", action="store_true",
                        help="build the pyramid on the device from the raw points")
    add_device_argument(parser)
    return parser.parse_args(argv)


def load_pair(ref_file, src_file, gt_file):
    ref = np.load(ref_file).astype(np.float32)
    src = np.load(src_file).astype(np.float32)
    return ref, src, np.load(gt_file).astype(np.float32)


def load_batch(cfg, ref, src, transform):
    """The host pyramid at capacities fitted to the pair: (batch, caps)."""
    points = np.concatenate([ref, src], axis=0)
    lengths = np.asarray([len(ref), len(src)])
    pyramid = build_pyramid(points, lengths, cfg.backbone.num_stages,
                            cfg.backbone.init_voxel_size, cfg.backbone.init_radius,
                            list(cfg.caps.neighbor_limits))
    caps = tuple(caps_for_pyramid(pyramid, multiple=256, per_cloud=True))
    feats = np.ones((points.shape[0], cfg.backbone.input_dim), np.float32)
    return pad_registration_batch(pyramid, feats, transform, caps), caps


def load_batch_device(cfg, ref, src, transform, device):
    """The pyramid built on ``device`` from the raw points at the config's
    capacities: (batch, caps, build ms). The build time is from CUDA events
    on the card, the host clock elsewhere. Raises on a capacity overflow."""
    caps = tuple(cfg.caps.stage_caps)
    points = np.concatenate([ref, src], axis=0)
    pts0, lens0, feats0 = pad_stage0(points, [len(ref), len(src)], caps[0],
                                     cfg.backbone.input_dim)
    raw = batch_to_torch({"points": pts0, "lengths": lens0, "feats": feats0,
                          "transform": transform}, device)

    def build():
        return build_pyramid_device(
            raw["points"], raw["lengths"], raw["feats"], raw["transform"],
            num_stages=cfg.backbone.num_stages, voxel_size=cfg.backbone.init_voxel_size,
            radius=cfg.backbone.init_radius, neighbor_limits=tuple(cfg.caps.neighbor_limits),
            stage_caps=caps)

    batch, overflow = build()  # the first build also builds the kernels' library
    if bool(overflow.any()):
        raise ValueError(f"stage capacity overflow {overflow.tolist()} at caps {caps}")
    if torch.device(device).type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        batch, _ = build()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
    else:
        start = time.perf_counter()
        batch, _ = build()
        ms = 1e3 * (time.perf_counter() - start)
    return batch, caps, ms


def load_weights(model, snapshot):
    state = torch.load(snapshot, map_location="cpu", weights_only=False)
    model.load_state_dict(state.get("model", state))


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = make_3dmatch_config()
    ref, src, gt_transform = load_pair(args.ref_file, args.src_file, args.gt_file)

    start = time.perf_counter()
    if args.device_preprocess:
        batch, caps, build_ms = load_batch_device(cfg, ref, src, gt_transform, device)
        print(f"pyramid built on {device}: {build_ms:.2f} ms (its second build)")
    else:
        batch, caps = load_batch(cfg, ref, src, gt_transform)
        print(f"pyramid built on the host: {time.perf_counter() - start:.2f} s")
    print(f"caps {caps}, stage sizes {[[int(v) for v in l] for l in batch['lengths']]}")
    cfg = cfg.with_caps(stage_caps=caps)

    model = create_model(cfg, device=device)
    if args.snapshot:
        load_weights(model, args.snapshot)
        print(f"loaded {args.snapshot}")
    batch = batch_to_torch(batch, device)
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    with torch.no_grad():
        out = model(batch, training=False, with_gt=False)  # warm-up
        times = []
        for _ in range(args.repeat):
            sync()
            start = time.perf_counter()
            out = model(batch, training=False, with_gt=False)
            sync()
            times.append(time.perf_counter() - start)
    est = out["estimated_transform"].float().cpu()
    rre, rte = isotropic_transform_error(torch.from_numpy(gt_transform), est)
    print(f"model time: {min(times) * 1e3:.1f} ms (best of {args.repeat})")
    print("estimated transform:\n", est.numpy())
    print(f"RRE={float(rre):.3f} deg  RTE={float(rte):.3f} m")
    print(f"correspondences: {int(out['corr_masks'].sum())}")
    return est.numpy()


if __name__ == "__main__":
    main()
