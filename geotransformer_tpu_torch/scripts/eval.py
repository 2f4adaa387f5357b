#!/usr/bin/env python
r"""Offline benchmark evaluation from feature dumps (the port's
``scripts/eval.py``).

    python -m geotransformer_tpu_torch.scripts.eval --dataset 3dmatch \
        --feature_dir output/3dmatch/features/3DMatch --benchmark_root <gt dir>

Protocol of the reference evaluator
(`experiments/geotransformer.3dmatch.../eval.py:41-349`):

  * coarse matching: PIR plus the PMR>0 / >=0.1 / >=0.3 / >=0.5 tiers,
    per scene and overall (scene-mean of scene-means, reference :232-252)
  * fine matching: IR / FMR / OV per scene and overall (:255-262)
  * registration: ``--method {lgr,ransac,svd}`` re-estimation (:166-186) —
    lgr reads the stored transform, ransac re-runs correspondence RANSAC,
    svd re-runs the port's weighted Procrustes on the stored
    correspondences (on ``--device``); RRE/RTE mean AND median per scene
    (:274-292); RR via the 3DMatch covariance-weighted gt.log/gt.info
    protocol (scene-wise) or RRE/RTE thresholds (KITTI / ModelNet)
  * ``--num_corr`` truncation to the top-scoring correspondences (:125-129)
  * est.log output per scene (:229-230)
"""

import argparse
import glob
import os.path as osp

import numpy as np
import torch

from geotransformer_tpu_torch.engine.meters import SummaryBoard
from geotransformer_tpu_torch.models.procrustes import weighted_procrustes
from geotransformer_tpu_torch.scripts.common import add_device_argument, resolve_device
from geotransformer_tpu_torch.utils.ransac import registration_with_ransac_from_correspondences
from geotransformer_tpu_torch.utils.registration import (
    evaluate_sparse_correspondences,
    evaluate_correspondences,
    compute_registration_error,
)
from geotransformer_tpu_torch.eval import (
    get_gt_logs_and_infos,
    get_num_fragments,
    compute_transform_error,
    read_log_file,
    write_log_file,
)


def estimate_transform(method, data, ref_corr, src_corr, scores, args):
    """Re-estimate the pair transform (reference eval.py:166-186)."""
    if method == "lgr":
        return data["estimated_transform"]
    if method == "ransac":
        return registration_with_ransac_from_correspondences(
            src_corr, ref_corr,
            distance_threshold=args.distance_threshold,
            ransac_n=3,
            num_iterations=args.ransac_iterations,
        )
    if method == "svd":
        def tensor(x):
            return torch.from_numpy(np.asarray(x)).to(args.device)

        return weighted_procrustes(tensor(src_corr), tensor(ref_corr), tensor(scores),
                                   return_transform=True).cpu().numpy()
    raise ValueError(f"Unsupported registration method: {method}")


def eval_one_pair(npz_file, args):
    data = np.load(npz_file)
    result = {}

    coarse = evaluate_sparse_correspondences(
        data["ref_points_c"], data["src_points_c"],
        data["ref_node_corr_indices"], data["src_node_corr_indices"],
        data["gt_node_corr_indices"],
    )
    result["PIR"] = coarse["precision"]

    ref_corr = data["ref_corr_points"]
    src_corr = data["src_corr_points"]
    scores = data.get("corr_scores")
    if (
        args.num_corr is not None
        and scores is not None
        and scores.shape[0] > args.num_corr
    ):
        sel = np.argsort(-scores)[: args.num_corr]
        ref_corr, src_corr, scores = ref_corr[sel], src_corr[sel], scores[sel]

    fine = evaluate_correspondences(
        ref_corr, src_corr, data["transform"],
        positive_radius=args.acceptance_radius,
    )
    result["IR"] = fine["inlier_ratio"]
    result["OV"] = fine["overlap"]
    result["num_corr"] = fine["num_corr"]

    estimated = estimate_transform(args.method, data, ref_corr, src_corr, scores, args)
    rre, rte = compute_registration_error(data["transform"], estimated)
    result["RRE"] = rre
    result["RTE"] = rte
    result["estimated_transform"] = estimated
    return result


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", choices=("3dmatch", "kitti", "modelnet"), required=True)
    parser.add_argument("--feature_dir", required=True)
    parser.add_argument("--benchmark", default="3DMatch", help="3DMatch | 3DLoMatch")
    parser.add_argument("--benchmark_root", default=None,
                        help="dir with <scene>/gt.log+gt.info (3DMatch protocol)")
    parser.add_argument("--registration_dir", default=None, help="where to write est.log files")
    parser.add_argument("--method", choices=("lgr", "ransac", "svd"), default="lgr")
    parser.add_argument("--num_corr", type=int, default=None,
                        help="keep only the top-scoring correspondences")
    parser.add_argument("--acceptance_radius", type=float, default=0.1)
    parser.add_argument("--inlier_ratio_threshold", type=float, default=0.05)
    parser.add_argument("--rmse_threshold", type=float, default=0.2)
    parser.add_argument("--rre_threshold", type=float, default=5.0)
    parser.add_argument("--rte_threshold", type=float, default=2.0)
    parser.add_argument("--distance_threshold", type=float, default=0.05)
    parser.add_argument("--ransac_iterations", type=int, default=1000)
    parser.add_argument("--verbose", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    resolve_device(args.device)

    scene_results = {}
    for npz_file in sorted(glob.glob(osp.join(args.feature_dir, "*", "*.npz"))):
        scene = osp.basename(osp.dirname(npz_file))
        stem = osp.splitext(osp.basename(npz_file))[0]
        ref_frame, src_frame = (int(x) for x in stem.split("_"))
        result = eval_one_pair(npz_file, args)
        if args.verbose:
            print(
                f"{scene} {ref_frame}_{src_frame}: PIR={result['PIR']:.3f} "
                f"IR={result['IR']:.3f} RRE={result['RRE']:.3f} RTE={result['RTE']:.3f}"
            )
        scene_results.setdefault(scene, []).append(
            dict(test_pair=[ref_frame, src_frame], result=result)
        )

    # Per-scene aggregation; overall = mean of scene means (reference
    # updates the global meter once per scene, eval.py:240-292).
    summary = SummaryBoard()
    scene_rows = {}
    use_3dm_protocol = args.dataset == "3dmatch" and args.benchmark_root is not None
    for scene, pairs in sorted(scene_results.items()):
        pir = np.asarray([p["result"]["PIR"] for p in pairs])
        ir = np.asarray([p["result"]["IR"] for p in pairs])
        ov = np.asarray([p["result"]["OV"] for p in pairs])
        row = {
            "PIR": float(pir.mean()),
            "PMR>0": float((pir > 0).mean()),
            "PMR>=0.1": float((pir >= 0.1).mean()),
            "PMR>=0.3": float((pir >= 0.3).mean()),
            "PMR>=0.5": float((pir >= 0.5).mean()),
            "IR": float(ir.mean()),
            "FMR": float((ir >= args.inlier_ratio_threshold).mean()),
            "OV": float(ov.mean()),
        }

        accepted_rre, accepted_rte, accepted = [], [], []
        if use_3dm_protocol:
            try:
                num_fragments = get_num_fragments(scene)
            except ValueError:
                # non-official scene (e.g. the synthetic benchmark): the
                # count is in every gt.log block header
                num_fragments = read_log_file(
                    osp.join(args.benchmark_root, scene, "gt.log")
                )[0]["num_fragments"]
            gt_indices, gt_logs, gt_infos = get_gt_logs_and_infos(
                osp.join(args.benchmark_root, scene), num_fragments
            )
            if args.registration_dir is not None:
                est_logs = [
                    dict(
                        test_pair=p["test_pair"], num_fragments=num_fragments,
                        transform=p["result"]["estimated_transform"],
                    )
                    for p in pairs
                ]
                write_log_file(osp.join(args.registration_dir, scene, "est.log"), est_logs)
            for p in pairs:
                frag_id0, frag_id1 = p["test_pair"]
                gt_index = gt_indices[frag_id0, frag_id1]
                if gt_index < 0:
                    continue
                error = compute_transform_error(
                    gt_logs[gt_index]["transform"],
                    gt_infos[gt_index]["covariance"],
                    p["result"]["estimated_transform"],
                )
                ok = error <= args.rmse_threshold**2
                accepted.append(float(ok))
                if ok:
                    rre, rte = compute_registration_error(
                        gt_logs[gt_index]["transform"],
                        p["result"]["estimated_transform"],
                    )
                    accepted_rre.append(rre)
                    accepted_rte.append(rte)
        else:
            for p in pairs:
                ok = (
                    p["result"]["RRE"] < args.rre_threshold
                    and p["result"]["RTE"] < args.rte_threshold
                )
                accepted.append(float(ok))
                if ok:
                    accepted_rre.append(p["result"]["RRE"])
                    accepted_rte.append(p["result"]["RTE"])

        row["RR"] = float(np.mean(accepted)) if accepted else 0.0
        row["mean_RRE"] = float(np.mean(accepted_rre)) if accepted_rre else 0.0
        row["mean_RTE"] = float(np.mean(accepted_rte)) if accepted_rte else 0.0
        row["median_RRE"] = float(np.median(accepted_rre)) if accepted_rre else 0.0
        row["median_RTE"] = float(np.median(accepted_rte)) if accepted_rte else 0.0
        scene_rows[scene] = row
        for key, value in row.items():
            summary.update(key, value)

    print(f"Overall ({args.method}):")
    keys = ["PIR", "PMR>0", "PMR>=0.1", "PMR>=0.3", "PMR>=0.5",
            "IR", "FMR", "OV", "RR", "mean_RRE", "mean_RTE",
            "median_RRE", "median_RTE"]
    print("  " + ", ".join(f"{k}: {summary.mean(k):.4f}" for k in keys))
    print("Per scene:")
    for scene, row in scene_rows.items():
        print(
            f"  {scene}: RR={row['RR']:.4f}, PIR={row['PIR']:.3f}, "
            f"IR={row['IR']:.3f}, FMR={row['FMR']:.3f}, "
            f"RRE={row['mean_RRE']:.3f}/{row['median_RRE']:.3f}, "
            f"RTE={row['mean_RTE']:.3f}/{row['median_RTE']:.3f}"
        )


if __name__ == "__main__":
    main()
