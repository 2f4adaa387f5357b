#!/usr/bin/env python
r"""DGR-protocol evaluation of 3DMatch / 3DLoMatch feature dumps (the port's
``scripts/eval_dgr.py``; reference `experiments/...3dmatch.../eval_dgr.py`).

    python -m geotransformer_tpu_torch.scripts.eval_dgr --feature_dir <dumps> \
        [--method lgr|ransac|svd] [--num_corr N] [--device cuda|cpu]

The npz dumps of ``scripts.eval``, one directory a scene, but registration
recall by Deep-Global-Registration thresholds (RRE < 15 deg and RTE < 0.3 m)
instead of the covariance-weighted gt.log protocol; coarse PMR at the
0 / 0.1 / 0.3 / 0.5 precision thresholds, and an optional score-ranked
correspondence budget (``--num_corr``). Methods: ``lgr`` reads the stored
estimate, ``ransac`` re-runs correspondence RANSAC on the host, ``svd``
re-runs the port's weighted Procrustes over every correspondence on
``--device`` (the card unless asked otherwise).
"""

import argparse
import glob
import os.path as osp

import numpy as np

from geotransformer_tpu_torch.engine.meters import SummaryBoard
from geotransformer_tpu_torch.scripts.common import add_device_argument, resolve_device
from geotransformer_tpu_torch.scripts.eval import estimate_transform
from geotransformer_tpu_torch.utils.registration import (
    compute_registration_error,
    evaluate_correspondences,
    evaluate_sparse_correspondences,
)

KEYS = ("PIR", "PMR>0", "PMR>=0.1", "PMR>=0.3", "PMR>=0.5",
        "IR", "OV", "FMR", "RR", "RRE", "RTE")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--feature_dir", required=True)
    parser.add_argument("--method", choices=("lgr", "ransac", "svd"), default="lgr")
    parser.add_argument("--num_corr", type=int, default=None,
                        help="keep only the top-k correspondences by score")
    parser.add_argument("--acceptance_radius", type=float, default=0.1)
    parser.add_argument("--inlier_ratio_threshold", type=float, default=0.05)
    parser.add_argument("--rre_threshold", type=float, default=15.0)
    parser.add_argument("--rte_threshold", type=float, default=0.3)
    parser.add_argument("--distance_threshold", type=float, default=0.05)
    parser.add_argument("--ransac_iterations", type=int, default=1000)
    parser.add_argument("--verbose", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    args.device = resolve_device(args.device)

    overall = SummaryBoard(names=KEYS)
    scene_rows = []
    for scene_root in sorted(glob.glob(osp.join(args.feature_dir, "*"))):
        npz_files = sorted(glob.glob(osp.join(scene_root, "*.npz")))
        if not npz_files:
            continue
        scene = SummaryBoard(names=KEYS)
        for npz_file in npz_files:
            data = np.load(npz_file)
            ref_corr = data["ref_corr_points"]
            src_corr = data["src_corr_points"]
            scores = data["corr_scores"]
            if args.num_corr is not None and scores.shape[0] > args.num_corr:
                sel = np.argsort(-scores)[: args.num_corr]
                ref_corr, src_corr, scores = ref_corr[sel], src_corr[sel], scores[sel]

            pir = evaluate_sparse_correspondences(
                data["ref_points_c"], data["src_points_c"], data["ref_node_corr_indices"],
                data["src_node_corr_indices"], data["gt_node_corr_indices"])["precision"]
            fine = evaluate_correspondences(ref_corr, src_corr, data["transform"],
                                            positive_radius=args.acceptance_radius)
            est = estimate_transform(args.method, data, ref_corr, src_corr, scores, args)
            rre, rte = compute_registration_error(data["transform"], est)
            accepted = rre < args.rre_threshold and rte < args.rte_threshold

            for board in (scene, overall):
                board.update("PIR", pir)
                board.update("PMR>0", float(pir > 0))
                board.update("PMR>=0.1", float(pir >= 0.1))
                board.update("PMR>=0.3", float(pir >= 0.3))
                board.update("PMR>=0.5", float(pir >= 0.5))
                board.update("IR", fine["inlier_ratio"])
                board.update("OV", fine["overlap"])
                board.update("FMR", float(fine["inlier_ratio"] >= args.inlier_ratio_threshold))
                board.update("RR", float(accepted))
                if accepted:
                    board.update("RRE", rre)
                    board.update("RTE", rte)
            if args.verbose:
                print(f"{osp.basename(npz_file)}: PIR {pir:.3f} "
                      f"IR {fine['inlier_ratio']:.3f} RRE {rre:.3f} RTE {rte:.3f}")
        scene_rows.append((osp.basename(scene_root), scene))

    print(f"\n== per scene ({args.method}) ==")
    for name, board in scene_rows:
        print(f"{name}: PIR {board.mean('PIR'):.3f} | IR {board.mean('IR'):.3f} "
              f"| FMR {board.mean('FMR'):.3f} | RR {board.mean('RR'):.3f} "
              f"| RRE {board.mean('RRE'):.3f} | RTE {board.mean('RTE'):.3f}")
    print("\n== overall (DGR protocol) ==")
    for key in KEYS:
        print(f"{key:9s}: {overall.mean(key):.4f}")
    return {key: overall.mean(key) for key in KEYS}


if __name__ == "__main__":
    main()
