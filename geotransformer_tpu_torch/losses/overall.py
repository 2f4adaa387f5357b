r"""Training losses and evaluator (``geotransformer_tpu/losses/overall.py``;
reference `experiments/geotransformer.3dmatch.../loss.py:10-159`): the
coarse weighted circle loss on superpoint feature distances, the fine
Sinkhorn negative log-likelihood, and PIR / IR / RRE / RTE / RMSE / RR, all
on the statically shaped output of :class:`GeoTransformer`."""

import torch

from geotransformer_tpu_torch.losses.circle_loss import weighted_circle_loss
from geotransformer_tpu_torch.losses.metrics import (
    inlier_ratio,
    isotropic_transform_error,
    registration_rmse,
)
from geotransformer_tpu_torch.models.matching import candidates_to_dense_overlaps
from geotransformer_tpu_torch.ops.pairwise_distance import pairwise_distance
from geotransformer_tpu_torch.ops.se3 import apply_transform


def _dense_overlaps(output):
    return candidates_to_dense_overlaps(output["gt_cand_indices"], output["gt_cand_overlaps"],
                                        output["gt_cand_masks"], output["src_feats_c"].shape[0])


def coarse_labels(cfg, output, overlaps):
    """(positive, negative) masks of the coarse loss: valid node pairs whose
    GT overlap exceeds the positive threshold, and those with none."""
    valid = output["ref_masks_c"][:, None] & output["src_masks_c"][None, :]
    return (overlaps > cfg.coarse_loss.positive_overlap) & valid, (overlaps == 0.0) & valid


def fine_labels(cfg, output, transform):
    """(P, K, K) GT point matches of the fine loss: valid point pairs of
    each patch pair within the positive radius under ``transform``."""
    src_knn_points = apply_transform(output["src_node_corr_knn_points"], transform)
    dists = pairwise_distance(output["ref_node_corr_knn_points"], src_knn_points)  # (P, K, K)
    gt_masks = (output["ref_node_corr_knn_masks"][:, :, None]
                & output["src_node_corr_knn_masks"][:, None, :])
    return (dists < cfg.fine_loss.positive_radius**2) & gt_masks


def coarse_matching_loss(cfg, output):
    """Weighted circle loss on the coarse features (reference loss.py:10-40)."""
    ref_feats, src_feats = output["ref_feats_c"], output["src_feats_c"]
    feat_dists = torch.sqrt(pairwise_distance(ref_feats, src_feats, normalized=True))
    overlaps = _dense_overlaps(output)
    pos_masks, neg_masks = coarse_labels(cfg, output, overlaps)
    pos_scales = torch.sqrt(overlaps * pos_masks.to(overlaps.dtype))
    cl = cfg.coarse_loss
    return weighted_circle_loss(pos_masks, neg_masks, feat_dists, cl.positive_margin,
                                cl.negative_margin, cl.positive_optimal, cl.negative_optimal,
                                cl.log_scale, pos_scales=pos_scales)


def fine_matching_loss(cfg, output, transform):
    """Sinkhorn NLL over the GT point matches (reference loss.py:43-71)."""
    ref_knn_masks = output["ref_node_corr_knn_masks"]
    src_knn_masks = output["src_node_corr_knn_masks"]
    matching_scores = output["matching_scores"]  # (P, K+1, K+1)
    gt_corr_map = fine_labels(cfg, output, transform)
    labels = torch.zeros(matching_scores.shape, dtype=torch.bool, device=matching_scores.device)
    labels[:, :-1, :-1] = gt_corr_map
    labels[:, :-1, -1] = ~gt_corr_map.any(dim=2) & ref_knn_masks
    labels[:, -1, :-1] = ~gt_corr_map.any(dim=1) & src_knn_masks
    m = labels.to(matching_scores.dtype)
    return -torch.sum(matching_scores * m) / torch.clamp(torch.sum(m), min=1.0)


def overall_loss(cfg, output, transform):
    """Weighted sum of the coarse and fine losses (reference loss.py:74-92).
    Returns (loss, {"loss", "c_loss", "f_loss"})."""
    c_loss = coarse_matching_loss(cfg, output)
    f_loss = fine_matching_loss(cfg, output, transform)
    loss = cfg.loss.weight_coarse_loss * c_loss + cfg.loss.weight_fine_loss * f_loss
    return loss, {"loss": loss, "c_loss": c_loss, "f_loss": f_loss}


def evaluate(cfg, output, transform):
    """PIR / IR / RRE / RTE / RMSE / RR (reference loss.py:95-159)."""
    gt_map = _dense_overlaps(output) > cfg.eval.acceptance_overlap
    corr_masks = output["node_corr_masks"].float()
    hits = gt_map[output["ref_node_corr_indices"], output["src_node_corr_indices"]].float()
    metrics = {"PIR": torch.sum(hits * corr_masks) / torch.clamp(torch.sum(corr_masks), min=1.0)}
    metrics["IR"] = inlier_ratio(output["ref_corr_points"], output["src_corr_points"], transform,
                                 cfg.eval.acceptance_radius, masks=output["corr_masks"])
    est = output["estimated_transform"]
    metrics["RRE"], metrics["RTE"] = isotropic_transform_error(transform, est)
    metrics["RMSE"] = registration_rmse(output["src_points_f"], transform, est,
                                        masks=output["src_masks_f"])
    metrics["RR"] = (metrics["RMSE"] < cfg.eval.rmse_threshold).float()
    return metrics
