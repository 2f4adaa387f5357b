#!/usr/bin/env python
r"""Each phase of the on-device pyramid build on the card (the port's
``scripts/profile_device.py``; ``preprocess/device.py:build_pyramid_device``).

    python -m geotransformer_tpu_torch.scripts.profile_device [--kitti]

On the tool pair's stage 0 at symmetric caps (each stage's larger cloud, a
multiple of 256) with the candidate capacity calibrated on the host, as
``chip_smoke.py`` phase 17 builds: the whole build (with the training
batches' inverse tables), then each phase alone on the build's own stages,
both clouds a launch: the voxel subsamples, the self searches, the
subsampling and upsampling searches, the inverse tables and the input edge
stream; then the stage-0 self search split into the CSR build (cell sort,
counts, the cumsum of the starts) and the candidate selection
(``grid_radius_search``). Device times from a CUDA-graph replay, CUDA-event
times beside them, and the CSR build's kernels under ``torch.profiler``.
With ``--device cpu`` each phase runs once and no time is measured.
"""

import argparse

import torch

from geotransformer_tpu_torch.kernels.pyramid import grid_radius_search
from geotransformer_tpu_torch.preprocess import caps_for_pyramid, pad_stage0, round_up
from geotransformer_tpu_torch.preprocess.calibrate import largest_cell_population
from geotransformer_tpu_torch.preprocess.device import (
    _pair_search,
    _search_support,
    _subsample_cloud,
    build_inverse_table_device,
    build_pyramid_device,
    input_stream_device,
)
from geotransformer_tpu_torch.scripts import pairs
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    print_result,
    resolve_device,
)
from geotransformer_tpu_torch.scripts.profile_forward import print_ops, top_result
from geotransformer_tpu_torch.utils import timing

GRID_CAP = 1 << 20  # build_pyramid_device's dense cell-table capacity


def build_spec(cfg, pyramid):
    """build_pyramid_device's keywords at the pair's symmetric caps."""
    bb = cfg.backbone
    caps = tuple(int(c) for c in caps_for_pyramid(pyramid, multiple=256))
    largest = largest_cell_population(pyramid, bb.init_radius, caps)
    return dict(num_stages=bb.num_stages, voxel_size=bb.init_voxel_size, radius=bb.init_radius,
                neighbor_limits=tuple(cfg.caps.neighbor_limits), stage_caps=caps,
                inverse_limits=tuple(cfg.caps.inverse_limits),
                knn_cand_cap=max(round_up(largest, 64), 64))


def phases(built, spec):
    """{phase: fn} of the build's phases on its own stages."""
    s, caps, limits, cand = (spec["num_stages"], spec["stage_caps"], spec["neighbor_limits"],
                             spec["knn_cand_cap"])
    pts = [built["points"][i].reshape(2, caps[i], 3) for i in range(s)]
    lens = built["lengths"]
    out = {}
    v = spec["voxel_size"] * 2.0
    for i in range(1, s):
        out[f"subsample s{i - 1}->s{i} ({caps[i - 1]}->{caps[i]})"] = (
            lambda i=i, v=v: _subsample_cloud(pts[i - 1], lens[i - 1], v, caps[i]))
        v *= 2.0
    r = spec["radius"]
    for i in range(s):
        out[f"self search s{i} (q {caps[i]}, s {caps[i]}, k {limits[i]})"] = (
            lambda i=i, r=r: _pair_search(pts[i], lens[i], pts[i], lens[i], caps[i], caps[i], r,
                                          limits[i], cand_cap=cand))
        if i < s - 1:
            out[f"sub search s{i + 1}<-s{i} (q {caps[i + 1]}, s {caps[i]})"] = (
                lambda i=i, r=r: _pair_search(pts[i + 1], lens[i + 1], pts[i], lens[i],
                                              caps[i + 1], caps[i], r, limits[i],
                                              cand_cap=cand))
            out[f"up search s{i}->s{i + 1} (q {caps[i]}, s {caps[i + 1]}, 2r)"] = (
                lambda i=i, r=r: _pair_search(pts[i], lens[i], pts[i + 1], lens[i + 1], caps[i],
                                              caps[i + 1], 2 * r, limits[i + 1], cand_cap=cand))
        r *= 2.0
    inv = spec["inverse_limits"]

    def inverse_tables():
        for i in range(s):
            rows = built["neighbors"][i].shape[0]
            build_inverse_table_device(built["neighbors"][i], rows, int(inv[i]))
            if i < s - 1:
                # build_pyramid_device's default subsampling in-degree capacity
                build_inverse_table_device(built["subsampling"][i], rows,
                                           max(16, int(inv[i]) // 4 + 8))

    out["inverse tables"] = inverse_tables
    out["input edge stream"] = lambda: input_stream_device(
        built["neighbors"][0], built["points"][0], built["features"])
    return out


def stage0_split(built, spec):
    """{sub-phase: fn} of the stage-0 self search (as
    ``_radius_search_cloud_grid`` runs it): the CSR build, the candidate
    selection on its output, and both."""
    cap, r, k, cand = (spec["stage_caps"][0], spec["radius"], spec["neighbor_limits"][0],
                       spec["knn_cand_cap"])
    pts, n = built["points"][0].reshape(2, cap, 3), built["lengths"][0]

    def csr():
        return _search_support(pts, n, r, GRID_CAP)

    def select(support, starts, origin, dims, _=None):
        return grid_radius_search(pts, n, support, n, starts, origin, dims, r, k, cand)

    support = csr()
    return {"CSR build (cell sort, counts, cumsum of the starts)": csr,
            "candidate selection (grid_radius_search)": lambda: select(*support),
            "whole stage-0 self search": lambda: select(*csr())}


def timed(device, name, fn, reps):
    ms = timing.on_card(device, timing.graph_ms, fn)
    events = timing.on_card(device, timing.time_ms, fn, reps)
    print(f"  {name:52s} {timing.fmt_ms(ms)} (graph), {timing.fmt_ms(events)} (CUDA events)",
          flush=True)
    return dict(graph_ms=ms, events_ms=events)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--kitti", action="store_true", help="the KITTI pair and model")
    parser.add_argument("--reps", type=int, default=5)
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(timing.card(device), flush=True)
    cfg = pairs.tool_config(args.kitti)
    pair = pairs.make_tool_pair(args.kitti, 0)
    pyramid = pairs.tool_pyramid(cfg, pair)
    spec = build_spec(cfg, pyramid)
    print(f"caps {spec['stage_caps']}, knn_cand_cap {spec['knn_cand_cap']}", flush=True)
    raw = [torch.from_numpy(a).to(device) for a in
           (*pad_stage0(pyramid["points"][0], pyramid["lengths"][0], spec["stage_caps"][0]),
            pair[2])]
    built, overflow = build_pyramid_device(*raw, **spec)
    if bool(overflow.any()):
        raise RuntimeError(f"the device build overflowed: {overflow.tolist()}")
    result = {"kitti": args.kitti, "caps": spec["stage_caps"]}
    print("whole build:", flush=True)
    result["build"] = timed(device, "build_pyramid_device", lambda: build_pyramid_device(
        *raw, **spec), args.reps)
    print("phases, each alone:", flush=True)
    result["phases"] = {name: timed(device, name, fn, args.reps)
                        for name, fn in phases(built, spec).items()}
    covered = [r["graph_ms"] for r in result["phases"].values()]
    if None not in covered:
        print(f"  phase sum {sum(covered):.3f} ms against the whole build's "
              f"{result['build']['graph_ms']:.3f} ms (graph)", flush=True)
    print("stage-0 self search, split:", flush=True)
    split = stage0_split(built, spec)
    result["stage0"] = {name: timed(device, name, fn, args.reps) for name, fn in split.items()}
    csr = next(iter(split.values()))
    ops = timing.on_card(device, timing.top_device_ops, csr)
    result["csr_top"] = []
    if ops is not None:
        print_ops("the CSR build's kernels", ops[0], 8)
        result["csr_top"] = top_result(ops[0], 8)
    print_result("profile_device", result)
    return result


if __name__ == "__main__":
    main()
