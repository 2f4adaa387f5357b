r"""Dense point matching head, the non-LGR variant of the ablations
(``geotransformer_tpu/models/point_matching.py``; reference
`modules/geotransformer/point_matching.py:5-115`).

Mutual top-k correspondences from the patch score matrices, returned as a
fixed-capacity set with validity masks. With the dustbin the top-k runs on
the (K+1, K+1) matrices and the dustbin row and column go afterwards, the
``[:, :-1, :-1]`` slice the JAX package reads (the reference's
``corr_mat[:, -1:, -1]`` is unreachable: no shipped configuration sets the
dustbin).
"""

import torch

from geotransformer_tpu_torch.models.lgr import compute_correspondence_matrix


def point_matching(ref_knn_points, src_knn_points, ref_knn_masks, src_knn_masks, ref_knn_indices,
                   src_knn_indices, log_score_mat, *, k, mutual=True, confidence_threshold=0.05,
                   use_dustbin=False, use_global_score=False, global_scores=None,
                   correspondence_limit=2048, patch_masks=None):
    """Dense correspondences from patch-to-patch score matrices.

    Args:
        ref_knn_points / src_knn_points: (P, K, 3) patch points.
        ref_knn_masks / src_knn_masks: (P, K) slot validity.
        ref_knn_indices / src_knn_indices: (P, K) fine-point indices.
        log_score_mat: (P, K, K), or (P, K+1, K+1) with ``use_dustbin``.
        k: per-row/col top-k.
        correspondence_limit: output capacity C.
        patch_masks: (P,) patch validity.

    Returns:
        dict: ref_corr_points / src_corr_points (C, 3), ref_corr_indices /
        src_corr_indices (C,), corr_scores (C,), corr_masks (C,), highest
        scores first.
    """
    score_mat = torch.exp(log_score_mat)
    corr_mat = compute_correspondence_matrix(score_mat, k, confidence_threshold, ref_knn_masks,
                                             src_knn_masks, mutual=mutual,
                                             use_dustbin=use_dustbin)
    if use_dustbin:
        score_mat = score_mat[:, :-1, :-1]
    if use_global_score:
        score_mat = score_mat * global_scores[:, None, None]
    if patch_masks is not None:
        corr_mat = corr_mat & patch_masks[:, None, None]
    score_mat = score_mat * corr_mat.to(score_mat.dtype)

    num_k = score_mat.shape[1]
    flat = torch.where(corr_mat, score_mat, -1.0).reshape(-1)
    top_scores, top_idx = torch.topk(flat, correspondence_limit)
    corr_masks = top_scores > 0.0
    p_idx = top_idx // (num_k * num_k)
    i_idx = (top_idx // num_k) % num_k
    j_idx = top_idx % num_k
    return {
        "ref_corr_points": ref_knn_points[p_idx, i_idx],
        "src_corr_points": src_knn_points[p_idx, j_idx],
        "ref_corr_indices": ref_knn_indices[p_idx, i_idx],
        "src_corr_indices": src_knn_indices[p_idx, j_idx],
        "corr_scores": torch.where(corr_masks, top_scores, 0.0),
        "corr_masks": corr_masks,
    }
