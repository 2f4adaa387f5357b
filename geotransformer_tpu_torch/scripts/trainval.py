#!/usr/bin/env python
r"""Training CLI (the port's ``scripts/trainval.py``; reference
`experiments/.../trainval.py`).

    python -m geotransformer_tpu_torch.scripts.trainval --dataset 3dmatch --data_root data/3DMatch
    python -m geotransformer_tpu_torch.scripts.trainval --dataset modelnet \
        --data_root data/ModelNet --iters

One pair a step a card. On N cards, one process each (the launcher sets
RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; the process takes
``cuda:LOCAL_RANK`` and joins an NCCL group, or Gloo with ``--device cpu``):

    python -m torch.distributed.run --nproc_per_node N \
        -m geotransformer_tpu_torch.scripts.trainval --dataset 3dmatch --data_root data/3DMatch

Each rank trains on its shard of every epoch's order; the gradients and
metrics are averaged over the ranks and the lr is the config's x N. The
config's ``optim.grad_acc_steps`` accumulates that many steps' gradients
into one update. The training batches carry the inverse
neighbor tables of the KPConv backward and, unless
``--no_precompute_targets``, the partition and GT-overlap targets computed
in the loader's workers. With ``--device_preprocess`` the loader only pads
raw points and every step builds its pyramid on the card (the GT targets
then in the step too), an overflow handled by ``--overflow_policy``.
Checkpoints go to ``<output_dir>/checkpoints``.
"""

import argparse
import os

from geotransformer_tpu_torch.configs import make_config
from geotransformer_tpu_torch.datasets import (
    ModelNetPairDataset,
    OdometryKittiPairDataset,
    ThreeDMatchPairDataset,
)
from geotransformer_tpu_torch.engine import Trainer
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.parallel import mesh
from geotransformer_tpu_torch.preprocess import DevicePreprocessPlan
from geotransformer_tpu_torch.preprocess.loader import PairLoader
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    pipeline_config,
    resolve_device,
)


def build_dataset(cfg, data_root, subset, training):
    if cfg.dataset == "3dmatch":
        return ThreeDMatchPairDataset(data_root, subset, point_limit=30000 if training else None,
                                      use_augmentation=training)
    if cfg.dataset == "kitti":
        return OdometryKittiPairDataset(data_root, subset,
                                        point_limit=30000 if training else None,
                                        use_augmentation=training, augmentation_noise=0.01)
    if cfg.dataset == "modelnet":
        return ModelNetPairDataset(data_root, subset, num_points=717, noise_magnitude=0.05,
                                   keep_ratio=0.7, twice_sample=True, deterministic=not training)
    raise ValueError(cfg.dataset)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", choices=("3dmatch", "kitti", "modelnet"), required=True)
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="pairs per step and process: a process owns one card, which "
                             "takes 1 (the default)")
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--iters", action="store_true", help="iteration-based training")
    parser.add_argument(
        "--no_precompute_targets", action="store_true",
        help="compute partition/GT-overlap targets inside the train step "
             "instead of in the loader workers")
    parser.add_argument("--device_preprocess", action="store_true",
                        help="build the point pyramid on the device inside the train/eval step "
                             "(the loaders only pad raw points)")
    parser.add_argument("--overflow_policy", choices=("raise", "escalate", "host"),
                        default="raise",
                        help="device-preprocess stage-capacity overflow policy")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    mesh.check_pairs_per_process(args.batch_size or 1)
    device = resolve_device(args.device)
    group = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if group:
        device = mesh.init_process_group(device)

    cfg = make_config(args.dataset)
    output_dir = args.output_dir or f"output/{args.dataset}"
    pipeline_cfg = pipeline_config(cfg)
    train_pipeline_cfg = dict(
        pipeline_cfg,
        inverse_limits=cfg.caps.inverse_limits,
        inverse_splits=cfg.caps.inverse_splits,
        sub_inverse_splits=cfg.caps.sub_inverse_splits,
        # the raw mode has no host pyramid to take targets from
        precompute_targets=not (args.no_precompute_targets or args.device_preprocess),
        model_cfg=cfg,
    )
    plan = None
    if args.device_preprocess:
        plan = DevicePreprocessPlan(cfg, with_inverse=True, overflow_policy=args.overflow_policy)
    train_loader = PairLoader(build_dataset(cfg, args.data_root, "train", True),
                              train_pipeline_cfg, shuffle=True, num_workers=args.num_workers,
                              seed=cfg.seed, num_shards=mesh.world_size(),
                              shard_index=mesh.rank(), device_plan=plan)
    val_loader = PairLoader(build_dataset(cfg, args.data_root, "val", False), pipeline_cfg,
                            shuffle=False, num_workers=args.num_workers, device_plan=plan)
    try:
        trainer = Trainer(cfg, create_model(cfg, device=device), train_loader, val_loader,
                          output_dir=output_dir, device=device, device_plan=plan)
        trainer.initialize()
        metrics = trainer.run_iterations() if args.iters else trainer.run()
    finally:
        train_loader.close()
        val_loader.close()
        if group:
            mesh.destroy_process_group()
    return trainer, metrics


if __name__ == "__main__":
    main()
