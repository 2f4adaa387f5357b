r"""Local-to-global registration with static shapes
(``geotransformer_tpu/models/lgr.py``; reference
`modules/geotransformer/local_global_registration.py:11-235`).

Mutual top-k correspondences by comparison with each row's k-th score
(keeping every exact tie, as pinned by ``tests/test_lgr_ties.py``), a
global top-C verification set, per-patch weighted-Procrustes hypotheses
from the (K, K) weight matrices, first-index argmax hypothesis selection,
and iterative global refinement.
"""

import torch

from geotransformer_tpu_torch.models.procrustes import ROTATION_SOLVERS, weighted_procrustes
from geotransformer_tpu_torch.ops.se3 import (
    apply_transform,
    get_transform_from_rotation_translation,
)


def _row_topk_mask(score_mat, k, threshold):
    """(entry >= its row's k-th value) AND (entry > threshold)."""
    kth = torch.topk(score_mat, k, dim=-1).values[..., k - 1]
    return (score_mat >= kth[..., None]) & (score_mat > threshold)


def compute_correspondence_matrix(score_mat, k, confidence_threshold, ref_knn_masks,
                                  src_knn_masks, mutual=True, use_dustbin=False):
    """(P, K, K) bool mutual (or union) top-k correspondence matrix.

    ``score_mat`` is (P, K, K), or (P, K+1, K+1) with ``use_dustbin``: the
    top-k runs over the whole matrix, then the dustbin row and column go.
    """
    mask_mat = ref_knn_masks[:, :, None] & src_knn_masks[:, None, :]
    ref_corr_mat = _row_topk_mask(score_mat, k, confidence_threshold)
    src_corr_mat = _row_topk_mask(score_mat.transpose(1, 2), k,
                                  confidence_threshold).transpose(1, 2)
    corr_mat = ref_corr_mat & src_corr_mat if mutual else ref_corr_mat | src_corr_mat
    if use_dustbin:
        corr_mat = corr_mat[:, :-1, :-1]
    return corr_mat & mask_mat


def procrustes_from_pair_weights(ref_knn_points, src_knn_points, weights, eps=1e-5,
                                 method="svd"):
    """(P, 4, 4) src -> ref transforms from (P, K, K) pair weights
    (weights[p, i, j] weighs ref point i against src point j)."""
    w_sum = weights.sum(dim=(1, 2), keepdim=True) + eps
    wn = weights / w_sum
    wr = wn.sum(dim=2)
    wc = wn.sum(dim=1)
    ref_centroid = torch.einsum("pi,pic->pc", wr, ref_knn_points)
    src_centroid = torch.einsum("pj,pjc->pc", wc, src_knn_points)
    ref_centered = ref_knn_points - ref_centroid[:, None, :]
    src_centered = src_knn_points - src_centroid[:, None, :]
    H = torch.einsum("pjc,pij,pid->pcd", src_centered, wn, ref_centered)
    R = ROTATION_SOLVERS[method](H)
    t = ref_centroid - torch.einsum("pcd,pd->pc", R, src_centroid)
    return get_transform_from_rotation_translation(R, t)


def _weighted_fit(ref_points, src_points, weights, method="svd"):
    return weighted_procrustes(src_points, ref_points, weights=weights, return_transform=True,
                               method=method)


def local_to_global_registration(ref_knn_points, src_knn_points, ref_knn_masks,
                                 src_knn_masks, log_score_mat, *, k, acceptance_radius,
                                 confidence_threshold=0.05, mutual=True, use_dustbin=False,
                                 use_global_score=False, global_scores=None,
                                 correspondence_threshold=3, correspondence_limit=2048,
                                 num_refinement_steps=5, patch_masks=None,
                                 procrustes_method="svd"):
    """Dense matching -> per-patch hypotheses -> global refinement.

    Args:
        ref_knn_points / src_knn_points: (P, K, 3) patch points.
        ref_knn_masks / src_knn_masks: (P, K) validity.
        log_score_mat: (P, K, K) log matching scores, or (P, K+1, K+1) with
            ``use_dustbin`` (the dustbin is stripped after the top-k).
        correspondence_limit: capacity C of the verification set.
        patch_masks: (P,) validity of each patch correspondence.
        procrustes_method: ``"svd"`` or ``"quat"`` for every Procrustes fit.

    Returns:
        dict: ref_corr_points (C, 3), src_corr_points (C, 3), corr_scores
        (C,), corr_masks (C,), estimated_transform (4, 4).
    """
    score_mat = torch.exp(log_score_mat)
    corr_mat = compute_correspondence_matrix(score_mat, k, confidence_threshold,
                                             ref_knn_masks, src_knn_masks, mutual=mutual,
                                             use_dustbin=use_dustbin)
    if use_dustbin:
        score_mat = score_mat[:, :-1, :-1]
    if use_global_score:
        score_mat = score_mat * global_scores[:, None, None]
    if patch_masks is not None:
        corr_mat = corr_mat & patch_masks[:, None, None]
    score_mat = score_mat * corr_mat.to(score_mat.dtype)
    num_patches, num_k = score_mat.shape[0], score_mat.shape[1]

    # verification set: exact global top-C in two stages (each row holds at
    # most k correspondences, so a patch holds at most k*K, 2k*K non-mutual)
    flat_scores = torch.where(corr_mat, score_mat, -1.0).reshape(num_patches, -1)
    per_patch_cap = max(min(num_k * num_k, k * num_k * (1 if mutual else 2)), 1)
    if num_patches * per_patch_cap >= correspondence_limit:
        p_scores, p_idx_local = torch.topk(flat_scores, per_patch_cap, dim=1)
        top_scores, stage2 = torch.topk(p_scores.reshape(-1), correspondence_limit)
        p_idx = stage2 // per_patch_cap
        ij_idx = p_idx_local.reshape(-1)[stage2]
    else:
        top_scores, top_flat = torch.topk(flat_scores.reshape(-1), correspondence_limit)
        p_idx = top_flat // (num_k * num_k)
        ij_idx = top_flat % (num_k * num_k)
    corr_masks = top_scores > 0.0
    corr_scores = torch.where(corr_masks, top_scores, 0.0)
    ref_corr_points = ref_knn_points[p_idx, ij_idx // num_k]
    src_corr_points = src_knn_points[p_idx, ij_idx % num_k]

    # per-patch hypotheses, scored by inliers over the verification set
    hypo_valid = corr_mat.sum(dim=(1, 2)) >= correspondence_threshold
    hypo_transforms = procrustes_from_pair_weights(ref_knn_points, src_knn_points, score_mat,
                                                   method=procrustes_method)
    aligned = apply_transform(src_corr_points[None].expand(num_patches, -1, -1), hypo_transforms)
    residuals = torch.linalg.vector_norm(ref_corr_points[None] - aligned, dim=-1)
    inliers = (residuals < acceptance_radius) & corr_masks[None]
    inlier_counts = torch.where(hypo_valid, inliers.sum(dim=1), -1)
    best_idx = torch.argmax(inlier_counts)  # first index on ties
    best_scores = corr_scores * inliers[best_idx].to(corr_scores.dtype)

    # degenerate fallback: no valid patch -> fit all correspondences
    fallback_transform = _weighted_fit(ref_corr_points, src_corr_points, corr_scores,
                                       procrustes_method)
    fallback_res = torch.linalg.vector_norm(
        ref_corr_points - apply_transform(src_corr_points, fallback_transform), dim=-1)
    fallback_scores = corr_scores * ((fallback_res < acceptance_radius) & corr_masks).to(
        corr_scores.dtype)
    cur_scores = torch.where(hypo_valid.any(), best_scores, fallback_scores)

    estimated_transform = _weighted_fit(ref_corr_points, src_corr_points, cur_scores,
                                        procrustes_method)
    for _ in range(num_refinement_steps - 1):
        res = torch.linalg.vector_norm(
            ref_corr_points - apply_transform(src_corr_points, estimated_transform), dim=-1)
        cur_scores = corr_scores * ((res < acceptance_radius) & corr_masks).to(corr_scores.dtype)
        estimated_transform = _weighted_fit(ref_corr_points, src_corr_points, cur_scores,
                                            procrustes_method)

    return {
        "ref_corr_points": ref_corr_points,
        "src_corr_points": src_corr_points,
        "corr_scores": corr_scores,
        "corr_masks": corr_masks,
        "estimated_transform": estimated_transform,
    }
