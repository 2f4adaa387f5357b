r"""Benchmark inference engine (``geotransformer_tpu/engine/tester.py``;
reference `engine/single_tester.py:14-74`).

Runs the model pair by pair over a test loader on one card: the inference
forward with GT targets (``training=False, with_gt=True``) under
``torch.no_grad()``, the device-side metrics of
:func:`geotransformer_tpu_torch.losses.overall.evaluate`, and one feature
archive a pair for the offline evaluator (the reference's test.py ->
``features/<benchmark>/<scene>/<ref>_<src>.npz`` flow). With a
``device_plan`` (the loader's raw mode) each pair's pyramid is built on the
card first, at its capacity bucket, and an overflow is handled by the
plan's policy (an error, the next bucket, or the host pyramid);
``overflows`` counts the overflowed tries, ``host_fallbacks`` the pairs
that went to the host, and the log line with the times reports both.
"""

import os
import os.path as osp

import numpy as np
import torch

from geotransformer_tpu_torch.engine.logger import create_logger
from geotransformer_tpu_torch.engine.meters import SummaryBoard
from geotransformer_tpu_torch.engine.timer import Timer
from geotransformer_tpu_torch.losses.overall import evaluate
from geotransformer_tpu_torch.parallel.train import build_raw_batch
from geotransformer_tpu_torch.preprocess.pyramid import batch_to_torch


class Tester:
    def __init__(self, cfg, model, loader, output_dir="output", feature_dir=None,
                 device_plan=None, device="cuda"):
        self.cfg = cfg
        self.model = model
        self.loader = loader
        self.output_dir = output_dir
        self.feature_dir = feature_dir
        self.device = device
        self.device_plan = device_plan
        self.overflows = 0
        self.host_fallbacks = 0
        os.makedirs(output_dir, exist_ok=True)
        if feature_dir is not None:
            os.makedirs(feature_dir, exist_ok=True)
        self.logger = create_logger(log_file=osp.join(output_dir, "test.log"))
        self.timer = Timer(device)

    def _forward(self, batch):
        batch = batch_to_torch(batch, self.device)
        self.model.eval()
        with torch.no_grad():
            output = self.model(batch, training=False, with_gt=True)
            metrics = evaluate(self.cfg, output, batch["transform"])
        return output, metrics

    def _run_pair(self, batch):
        """One pair through the forward, its pyramid built on the card first
        in the raw mode, by the plan's overflow policy. Returns (output,
        metrics, transform)."""
        plan = self.device_plan
        if plan is None or "raw_points" not in batch:
            return self._forward(batch) + (batch["transform"],)

        def run_bucket(bucket, group):
            spec = plan.spec(bucket, with_inverse=False)
            built, overflowed = build_raw_batch(batch_to_torch(group[0], self.device), spec,
                                                self.cfg.precision)
            return None if overflowed else self._forward(built), overflowed

        def run_host(host_group):
            host = {k: v for k, v in host_group[0].items() if k != "meta"}
            return self._forward(host)

        (output, metrics), tries, host = plan.run(
            [batch], plan.bucket_for_cap0(batch["raw_points"].shape[0] // 2), run_bucket,
            run_host, self.logger.warning)
        self.overflows += tries
        self.host_fallbacks += host
        return output, metrics, batch["transform"]

    def run(self, save_features=True):
        """Test every pair of the loader. Returns (the metrics' means, one
        dict a pair: its meta and metrics); each pair's process seconds are
        ``self.timer.process_times()``."""
        summary = SummaryBoard()
        timer = self.timer
        timer.reset()
        results = []
        timer.tic_prepare()
        for group in self.loader:
            for batch in group:
                batch = dict(batch)
                meta = batch.pop("meta", {})
                timer.toc_prepare()
                timer.tic_process()
                output, metrics, transform = self._run_pair(batch)
                timer.toc_process()
                metrics = {k: float(v) for k, v in metrics.items()}
                summary.update_from_dict(metrics)
                results.append({**meta, **metrics})
                if save_features and self.feature_dir is not None:
                    self._dump_features(meta, transform, output)
                timer.tic_prepare()
        fallbacks = ("" if self.device_plan is None else
                     f" | overflows {self.overflows} host_fallbacks {self.host_fallbacks}")
        self.logger.info(
            f"test done: {summary.tostring()} | prep {timer.get_prepare_time():.3f}s "
            f"proc {timer.get_process_time():.3f}s{fallbacks}")
        return summary.summary(), results

    def _dump_features(self, meta, transform, output):
        """One npz archive a pair (reference test.py:65-92 contract), at
        ``<scene>/<ref_frame>_<src_frame>.npz``. A sample without frames
        (ModelNet) is filed as ``default/0_<index>.npz``: the JAX Tester
        writes every such pair to ``default/0_0.npz``, each over the last."""
        scene = meta.get("scene_name", meta.get("seq_id", "default"))
        ref_frame = meta.get("ref_frame", 0)
        src_frame = meta.get("src_frame", meta.get("index", 0))
        scene_dir = osp.join(self.feature_dir, str(scene))
        os.makedirs(scene_dir, exist_ok=True)
        file_name = osp.join(scene_dir, f"{ref_frame}_{src_frame}.npz")

        out = {k: v.detach().cpu().numpy() for k, v in output.items()
               if isinstance(v, torch.Tensor)}
        corr_masks = out["corr_masks"]
        node_masks = out["node_corr_masks"]
        np.savez_compressed(
            file_name,
            ref_points=out["ref_points_f"][out["ref_masks_f"]],
            src_points=out["src_points_f"][out["src_masks_f"]],
            ref_points_c=out["ref_points_c"][out["ref_masks_c"]],
            src_points_c=out["src_points_c"][out["src_masks_c"]],
            ref_feats_c=out["ref_feats_c"][out["ref_masks_c"]],
            src_feats_c=out["src_feats_c"][out["src_masks_c"]],
            ref_node_corr_indices=out["ref_node_corr_indices"][node_masks],
            src_node_corr_indices=out["src_node_corr_indices"][node_masks],
            ref_corr_points=out["ref_corr_points"][corr_masks],
            src_corr_points=out["src_corr_points"][corr_masks],
            corr_scores=out["corr_scores"][corr_masks],
            gt_node_corr_indices=_gt_corr_indices(out),
            gt_node_corr_overlaps=_gt_corr_overlaps(out),
            estimated_transform=out["estimated_transform"],
            transform=(transform.cpu().numpy() if isinstance(transform, torch.Tensor)
                       else np.asarray(transform)),
        )


def _gt_corr_indices(out):
    rows, cols = np.nonzero(out["gt_cand_masks"])
    return np.stack([rows, out["gt_cand_indices"][rows, cols]], axis=1)


def _gt_corr_overlaps(out):
    return out["gt_cand_overlaps"][out["gt_cand_masks"]]
