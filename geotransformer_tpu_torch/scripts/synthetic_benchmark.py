#!/usr/bin/env python
r"""Full-workflow synthetic benchmark (the port's
``scripts/synthetic_benchmark.py``): train -> test.py-style feature dump ->
eval.py 3DMatch protocol, producing an RR/IR/FMR table.

    python -m geotransformer_tpu_torch.scripts.synthetic_benchmark --out output/synth --steps 2000
    python -m geotransformer_tpu_torch.scripts.synthetic_benchmark --scale small --steps 60 \
        --device cpu   # CI-size
    python -m geotransformer_tpu_torch.scripts.synthetic_benchmark --force_pallas true \
        --precision jax   # the JAX package's precision point, trained and tested

The reference workflow (`trainval.py` -> `test.py` -> `eval.py`, reference
`experiments/...3dmatch.../`) as one loop on a procedural multi-scene
benchmark with gt.log/gt.info protocol files (datasets/synthetic.py builds
the covariance-weighted RMSE acceptance metric the 3DMatch benchmark uses).
Train scenes and test scenes are disjoint. The evaluator runs in a process
of its own, as in the reference.
"""

import argparse
import dataclasses
import itertools
import os
import os.path as osp
import subprocess
import sys
import time

import geotransformer_tpu_torch
from geotransformer_tpu_torch.configs import (
    BackboneConfig,
    CapsConfig,
    JAX_PRECISION,
    CoarseMatchingConfig,
    GeoTransformerModuleConfig,
    ModelConfig,
    PrecisionConfig,
    make_3dmatch_config,
)
from geotransformer_tpu_torch.datasets.synthetic import SyntheticSceneBenchmark
from geotransformer_tpu_torch.engine import Tester, Trainer
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.preprocess import calibrate_stage_caps
from geotransformer_tpu_torch.preprocess.loader import PairLoader
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    pipeline_config,
    resolve_device,
)

# training pairs of the capacity calibration (every test pair is added)
CALIBRATION_TRAIN_PAIRS = 32
# --precision: the port's default point, or the JAX package's
PRECISIONS = {"float32": PrecisionConfig(), "jax": JAX_PRECISION}


def small_config():
    """Reduced model for the CI-sized run (CPU-friendly)."""
    cfg = make_3dmatch_config()
    return dataclasses.replace(
        cfg,
        backbone=BackboneConfig(num_stages=4, init_voxel_size=0.06,
                                init_dim=32, group_norm=8),
        model=ModelConfig(num_points_in_patch=32, num_sinkhorn_iterations=40),
        coarse_matching=CoarseMatchingConfig(num_targets=64, num_correspondences=96),
        geotransformer=GeoTransformerModuleConfig(
            input_dim=512, hidden_dim=96, output_dim=96,
            blocks=("self", "cross", "self", "cross"), num_heads=4,
        ),
        caps=CapsConfig(
            stage_caps=(2816, 1024, 384, 128),
            neighbor_limits=(40, 34, 34, 38),
            inverse_limits=(88, 80, 80, 80),
            gt_candidates=32, gt_chunk_size=32,
            correspondence_capacity=1024,
        ),
    )


def build_sets(scale, seed=0, test_fragments=6):
    """(config, train set, test set) of ``scale`` ("full" or "small"): the
    training scenes from the data ``seed``, the test scenes from seed + 777;
    at full scale ``test_fragments`` fragments a test scene."""
    if scale == "full":
        cfg = make_3dmatch_config()
        train_set = SyntheticSceneBenchmark(
            num_scenes=4, fragments_per_scene=8, num_points=60000,
            point_limit=12000, seed=seed, scene_prefix="synth-train-")
        test_set = SyntheticSceneBenchmark(
            num_scenes=2, fragments_per_scene=test_fragments, num_points=60000,
            point_limit=12000, seed=seed + 777, scene_prefix="synth-test-")
    else:
        cfg = small_config()
        train_set = SyntheticSceneBenchmark(
            num_scenes=2, fragments_per_scene=5, num_points=16000,
            point_limit=2500, seed=seed, scene_prefix="synth-train-")
        test_set = SyntheticSceneBenchmark(
            num_scenes=1, fragments_per_scene=5, num_points=16000,
            point_limit=2500, seed=seed + 777, scene_prefix="synth-test-")
    return cfg, train_set, test_set


def calibrate(cfg, train_set, test_set):
    """``cfg`` with stage caps calibrated over CALIBRATION_TRAIN_PAIRS
    training pairs and every test pair (the reference's
    calibrate_neighbors_stack_mode idea, utils/data.py:192-217): the test set
    is fixed at construction, so no test pair can overflow the caps."""
    n_cal = CALIBRATION_TRAIN_PAIRS + len(test_set)
    caps = calibrate_stage_caps(
        itertools.chain((train_set[i % len(train_set)] for i in range(CALIBRATION_TRAIN_PAIRS)),
                        (test_set[i] for i in range(len(test_set)))),
        cfg.backbone.num_stages, cfg.backbone.init_voxel_size,
        cfg.backbone.init_radius, list(cfg.caps.neighbor_limits),
        num_samples=n_cal,
    )
    return cfg.with_caps(stage_caps=tuple(caps))


def pipelines(cfg):
    """(train, test) keywords of ``prepare_pair``: no input edge stream, and
    the GT targets computed in the step (not in the loader)."""
    test = pipeline_config(cfg, input_stream=False)
    return dict(test, inverse_limits=cfg.caps.inverse_limits), test


def training_config(cfg, steps, train_pairs, lr=None, lr_decay=None, model_seed=None,
                    force_pallas=None, precision="float32"):
    """``cfg`` trained for whole epochs covering ``steps`` steps: at ``lr``,
    by default 3e-4 for a short run (at most 4000 steps) else the config's;
    at ``lr_decay`` an epoch, by default the config's; ``model_seed`` (the
    weights' and the shuffle's seed), by default the config's;
    ``force_pallas`` as ``ModelConfig.force_pallas``; ``precision`` a key of
    ``PRECISIONS`` (the model's ``PrecisionConfig``, trained and tested at
    that point)."""
    max_epoch = -(-steps // max(train_pairs, 1))
    if lr is None:
        lr = 3e-4 if steps <= 4000 else cfg.optim.lr
    optim = dataclasses.replace(cfg.optim, max_epoch=max_epoch, lr=lr,
                                lr_decay=cfg.optim.lr_decay if lr_decay is None else lr_decay)
    cfg = dataclasses.replace(cfg, optim=optim,
                              model=dataclasses.replace(cfg.model, force_pallas=force_pallas),
                              precision=PRECISIONS[precision])
    return cfg if model_seed is None else dataclasses.replace(cfg, seed=model_seed)


def eval_command(feature_dir, benchmark_root, registration_dir, device):
    """The evaluator's command line, and the environment that finds this
    package."""
    cmd = [sys.executable, "-m", "geotransformer_tpu_torch.scripts.eval",
           "--dataset", "3dmatch", "--feature_dir", feature_dir,
           "--benchmark_root", benchmark_root, "--registration_dir", registration_dir,
           "--method", "lgr", "--device", device]
    root = osp.dirname(osp.dirname(osp.abspath(geotransformer_tpu_torch.__file__)))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=root if not path else os.pathsep.join([root, path]))
    return cmd, env


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default="output/synthetic_benchmark")
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--scale", choices=("full", "small"), default="full")
    parser.add_argument("--num_workers", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0,
                        help="the data seed (scenes); keep it fixed when comparing kernel routes "
                             "so RR is measured on the same pairs")
    parser.add_argument("--model_seed", type=int, default=None,
                        help="the weights' and the shuffle's seed (default: the config's); "
                             "vary it for repeats on fixed data")
    parser.add_argument("--test_fragments", type=int, default=6,
                        help="fragments a test scene at full scale; 10 gives ~90 pairs")
    parser.add_argument("--lr", type=float, default=None,
                        help="the base learning rate (default: 3e-4 up to 4000 steps, else the "
                             "config's)")
    parser.add_argument("--lr_decay", type=float, default=None,
                        help="the learning rate's decay an epoch (default: the config's)")
    parser.add_argument("--skip_eval_script", action="store_true",
                        help="stop after the Tester's feature dump")
    parser.add_argument("--force_pallas", choices=("auto", "true", "false"), default="auto",
                        help="the kernel route: auto (the kernels on the card), true (the "
                             "kernels, else an error), false (the plain PyTorch modules)")
    parser.add_argument("--precision", choices=tuple(PRECISIONS), default="float32",
                        help="the kernels' precision point: float32 (the port's default) or "
                             "jax (the JAX package's default, configs.JAX_PRECISION: bfloat16 "
                             "KPConv operands, GSE bases and embedding), to price its drift in "
                             "RR/IR/FMR")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    out = osp.abspath(args.out)

    t0 = time.time()
    cfg, train_set, test_set = build_sets(args.scale, args.seed, args.test_fragments)
    print(f"train pairs: {len(train_set)}  test pairs: {len(test_set)} "
          f"({time.time() - t0:.1f}s)", flush=True)
    if len(train_set) < 4 or len(test_set) < 3:
        raise ValueError(f"too few overlapping pairs: {len(train_set)} training, "
                         f"{len(test_set)} test (at least 4 and 3)")

    benchmark_root = osp.join(out, "benchmark")
    test_set.write_benchmark(benchmark_root)
    cfg = calibrate(cfg, train_set, test_set)
    print(f"calibrated caps: {cfg.caps.stage_caps}", flush=True)
    train_pipeline, test_pipeline = pipelines(cfg)

    # ---- train (whole epochs covering --steps) ----
    force = {"auto": None, "true": True, "false": False}[args.force_pallas]
    cfg = training_config(cfg, args.steps, len(train_set), args.lr, args.lr_decay,
                          args.model_seed, force, args.precision)
    model = create_model(cfg, device=device)
    train_loader = PairLoader(train_set, train_pipeline, batch_size=1, shuffle=True,
                              num_workers=args.num_workers, seed=cfg.seed)
    test_loader = PairLoader(test_set, test_pipeline, batch_size=1,
                             num_workers=args.num_workers)
    try:
        trainer = Trainer(cfg, model, train_loader, val_loader=None,
                          output_dir=osp.join(out, "train"), log_steps=50, tensorboard=False,
                          device=device)
        trainer.initialize()
        t0 = time.time()
        trainer.run()
        print(f"trained {trainer.step} steps in {time.time() - t0:.1f}s", flush=True)

        # ---- test.py-equivalent: inference + npz feature dump ----
        feature_dir = osp.join(out, "features")
        tester = Tester(cfg, model, test_loader, output_dir=osp.join(out, "test"),
                        feature_dir=feature_dir, device=device)
        summary, _ = tester.run()
    finally:
        train_loader.close()
        test_loader.close()
    print("tester metrics:", {k: round(v, 4) for k, v in summary.items()}, flush=True)
    if args.skip_eval_script:
        return summary

    # ---- eval.py protocol (a process of its own, like the reference) ----
    cmd, env = eval_command(feature_dir, benchmark_root, osp.join(out, "registration"), device)
    print("running:", " ".join(cmd), flush=True)
    res = subprocess.run(cmd, capture_output=True, text=True, env=env)
    print(res.stdout)
    if res.returncode != 0:
        print(res.stderr[-4000:])
        raise SystemExit(res.returncode)
    return summary


if __name__ == "__main__":
    main()
