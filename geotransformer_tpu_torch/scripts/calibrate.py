#!/usr/bin/env python
r"""Static-shape calibration CLI (the port's ``scripts/calibrate.py``).

    python -m geotransformer_tpu_torch.scripts.calibrate --dataset 3dmatch \
        --data_root <dataset root> [--subset train] [--num_samples 64] [--quantile 1.0]

Builds the host pyramids of the dataset's pairs (the native library unless
``GEOTRANSFORMER_TPU_NATIVE=0``), measures the neighbor-count histograms,
the per-stage cloud sizes, the inverse-table in-degrees and the split
specs, and prints the ``CapsConfig`` values as one JSON line: neighbor
limits (reference `utils/data.py:192-217`), stage caps, inverse limits and
split specs. Host only: it takes no ``--device``.
"""

import argparse
import json

from geotransformer_tpu_torch.configs import make_config
from geotransformer_tpu_torch.preprocess import (
    calibrate_inverse_limits,
    calibrate_neighbor_limits,
    calibrate_split_specs,
    calibrate_stage_caps,
)


def make_dataset(name, data_root, subset):
    """The dataset a configuration trains on, at the calibration settings."""
    if name == "3dmatch":
        from geotransformer_tpu_torch.datasets import ThreeDMatchPairDataset

        return ThreeDMatchPairDataset(data_root, subset, point_limit=30000)
    if name == "kitti":
        from geotransformer_tpu_torch.datasets import OdometryKittiPairDataset

        return OdometryKittiPairDataset(data_root, subset, point_limit=30000)
    from geotransformer_tpu_torch.datasets import ModelNetPairDataset

    return ModelNetPairDataset(data_root, subset, num_points=717, twice_sample=True)


def calibrate(cfg, dataset, num_samples=64, quantile=1.0):
    """The ``CapsConfig`` values measured over ``dataset`` (a dict)."""
    bb = cfg.backbone

    def sample_iter():
        for i in range(len(dataset)):
            yield dataset[i]

    limits = calibrate_neighbor_limits(sample_iter(), bb.num_stages, bb.init_voxel_size,
                                       bb.init_radius)
    caps = calibrate_stage_caps(sample_iter(), bb.num_stages, bb.init_voxel_size, bb.init_radius,
                                limits, num_samples=num_samples, quantile=quantile)
    inverse_limits, sub_inverse_limits = calibrate_inverse_limits(
        sample_iter(), bb.num_stages, bb.init_voxel_size, bb.init_radius, limits,
        num_samples=num_samples)
    neighbor_splits, subsampling_splits = calibrate_split_specs(
        sample_iter(), bb.num_stages, bb.init_voxel_size, bb.init_radius, limits,
        num_samples=num_samples)
    return {
        "neighbor_limits": limits, "stage_caps": caps,
        "inverse_limits": inverse_limits,
        "sub_inverse_limits": sub_inverse_limits,
        "neighbor_splits": neighbor_splits,
        "subsampling_splits": subsampling_splits,
    }


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", choices=("3dmatch", "kitti", "modelnet"), required=True)
    parser.add_argument("--data_root", required=True)
    parser.add_argument("--subset", default="train")
    parser.add_argument("--num_samples", type=int, default=64)
    parser.add_argument("--quantile", type=float, default=1.0)
    args = parser.parse_args(argv)

    cfg = make_config(args.dataset)
    dataset = make_dataset(cfg.dataset, args.data_root, args.subset)
    result = calibrate(cfg, dataset, num_samples=args.num_samples, quantile=args.quantile)
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
