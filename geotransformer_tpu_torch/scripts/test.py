#!/usr/bin/env python
r"""Benchmark inference CLI (the port's ``scripts/test.py``; reference
`experiments/.../test.py`).

    python -m geotransformer_tpu_torch.scripts.test --dataset 3dmatch \
        --data_root data/3DMatch --benchmark 3DMatch \
        --checkpoint_dir output/3dmatch/checkpoints

Runs the model on a test split, evaluates the device-side metrics, and dumps
one feature archive a pair (``<output_dir>/features/<benchmark>/``) for
``geotransformer_tpu_torch.scripts.eval``. The weights come from a
checkpoint of the port's trainer (``--checkpoint_dir``, ``--test_epoch``),
from a reference ``state_dict`` (``--torch_snapshot``: the port's parameter
names are the reference's keys), or else are the seeded initial ones. A
checkpoint also gives the caps and the input route (edge stream or neighbor
table) the model was trained with, unless ``--cap_buckets`` is asked for,
and the buckets of its device plan. With
``--device_preprocess`` each pair's pyramid is built on the card, an
overflow handled by ``--overflow_policy``.
"""

import argparse
import os.path as osp

import torch

from geotransformer_tpu_torch.configs import make_config
from geotransformer_tpu_torch.datasets import (
    ModelNetPairDataset,
    OdometryKittiPairDataset,
    ThreeDMatchPairDataset,
)
from geotransformer_tpu_torch.engine import CheckpointManager, Tester
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.preprocess import DevicePreprocessPlan, calibrate_stage_cap_buckets
from geotransformer_tpu_torch.preprocess.loader import PairLoader, _is_bucketed
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    pipeline_config,
    resolve_device,
)


def build_test_dataset(cfg, data_root, benchmark):
    if cfg.dataset == "3dmatch":
        return ThreeDMatchPairDataset(data_root, benchmark, point_limit=None)
    if cfg.dataset == "kitti":
        return OdometryKittiPairDataset(data_root, "test", point_limit=None)
    return ModelNetPairDataset(data_root, "test", num_points=717, noise_magnitude=0.05,
                               keep_ratio=0.7, twice_sample=True, deterministic=True)


def load_weights(model, args, checkpoint):
    """The weights of ``--torch_snapshot`` or of the restored ``checkpoint``
    into ``model`` (else it keeps its seeded initial ones)."""
    if args.torch_snapshot:
        state = torch.load(args.torch_snapshot, map_location="cpu", weights_only=False)
        state_dict = state.get("model", state)
        missing, unused = model.load_state_dict(state_dict, strict=False)
        if missing:
            raise KeyError(f"{args.torch_snapshot} lacks parameters {missing}")
        unused = [k for k in unused if not k.endswith("div_term")]
        print(f"loaded {args.torch_snapshot}; unused: {unused}")
    elif checkpoint is not None:
        state, step = checkpoint
        model.load_state_dict(state["model"])
        print(f"restored checkpoint step {step}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", choices=("3dmatch", "kitti", "modelnet"), required=True)
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--benchmark", default=None,
                        help="3DMatch subset name: 3DMatch | 3DLoMatch | val")
    parser.add_argument("--checkpoint_dir", default=None,
                        help="a trainer's checkpoint directory (<output_dir>/checkpoints)")
    parser.add_argument("--test_epoch", type=int, default=None,
                        help="restore this checkpoint step/epoch instead of "
                             "the latest (reference --test_epoch)")
    parser.add_argument("--torch_snapshot", default=None,
                        help="load a reference .pth.tar state_dict instead of a checkpoint")
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--cap_buckets", type=int, default=0,
                        help="calibrate N capacity buckets over the dataset "
                             "(pairs pad to the smallest fitting bucket). 0 = config caps.")
    parser.add_argument("--device_preprocess", action="store_true",
                        help="build the point pyramid on the device before each forward "
                             "(the loader only pads raw points)")
    parser.add_argument("--overflow_policy", choices=("raise", "escalate", "host"),
                        default="raise",
                        help="device-preprocess stage-capacity overflow policy")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = make_config(args.dataset)
    output_dir = args.output_dir or f"output/{args.dataset}"
    benchmark = args.benchmark or "test"
    dataset = build_test_dataset(cfg, args.data_root, benchmark)

    checkpoint = None
    if args.checkpoint_dir and not args.torch_snapshot:
        checkpoint = CheckpointManager(args.checkpoint_dir).restore(step=args.test_epoch)
    trained = {} if checkpoint is None else checkpoint[0].get("pipeline", {})
    stage_caps = cfg.caps.stage_caps
    input_stream = trained.get("input_stream", True)
    if args.cap_buckets > 0:
        stage_caps = calibrate_stage_cap_buckets(
            (dataset[i] for i in range(len(dataset))),
            cfg.backbone.num_stages, cfg.backbone.init_voxel_size,
            cfg.backbone.init_radius, list(cfg.caps.neighbor_limits),
            num_buckets=args.cap_buckets,
        )
        print(f"capacity buckets: {stage_caps}")
    elif "stage_caps" in trained:
        stage_caps = trained["stage_caps"]
        if not _is_bucketed(stage_caps, cfg.backbone.num_stages):
            cfg = cfg.with_caps(stage_caps=tuple(stage_caps))

    plan = None
    if args.device_preprocess:
        trained_plan = {} if checkpoint is None else checkpoint[0].get("device_plan", {})
        buckets = (stage_caps if args.cap_buckets > 0
                   else trained_plan.get("buckets", [tuple(cfg.caps.stage_caps)]))
        plan = DevicePreprocessPlan(cfg, buckets=buckets, overflow_policy=args.overflow_policy)
    pipeline = pipeline_config(cfg, stage_caps, input_stream=input_stream)
    loader = PairLoader(dataset, pipeline, batch_size=1, num_workers=args.num_workers,
                        device_plan=plan)
    model = create_model(cfg, device=device)
    load_weights(model, args, checkpoint)
    feature_dir = osp.join(output_dir, "features", benchmark)
    tester = Tester(cfg, model, loader, output_dir=output_dir, feature_dir=feature_dir,
                    device_plan=plan, device=device)
    try:
        summary, _ = tester.run()
    finally:
        loader.close()
    print({k: round(v, 4) for k, v in summary.items()})
    return summary


if __name__ == "__main__":
    main()
