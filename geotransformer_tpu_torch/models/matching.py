r"""Superpoint matching (``geotransformer_tpu/models/matching.py:28-85``;
reference `modules/geotransformer/superpoint_matching.py:7-50`): dual
normalization and a global top-k on the padded grid, masked."""

import torch

from geotransformer_tpu_torch.ops.pairwise_distance import pairwise_distance


def superpoint_matching(ref_feats, src_feats, num_correspondences, ref_masks=None,
                        src_masks=None, dual_normalization=True):
    """Top-k superpoint correspondences by dual-normalized similarity.

    Args:
        ref_feats: (M, C) L2-normalized coarse features.
        src_feats: (N, C) L2-normalized coarse features.
        num_correspondences: k.
        ref_masks / src_masks: (M,) / (N,) node validity.

    Returns:
        ref_corr_indices (k,), src_corr_indices (k,), corr_scores (k,),
        corr_masks (k,) (False where fewer valid pairs exist). Exact ties
        may select differently from the JAX package (torch.topk has no
        tie order).
    """
    m, n = ref_feats.shape[0], src_feats.shape[0]
    device = ref_feats.device
    if ref_masks is None:
        ref_masks = torch.ones((m,), dtype=torch.bool, device=device)
    if src_masks is None:
        src_masks = torch.ones((n,), dtype=torch.bool, device=device)
    pair_masks = ref_masks[:, None] & src_masks[None, :]

    scores = torch.exp(-pairwise_distance(ref_feats, src_feats, normalized=True))
    scores = torch.where(pair_masks, scores, 0.0)
    if dual_normalization:
        ref_scores = scores / (scores.sum(dim=1, keepdim=True) + 1e-24)
        src_scores = scores / (scores.sum(dim=0, keepdim=True) + 1e-24)
        scores = ref_scores * src_scores

    masked = torch.where(pair_masks, scores, -1.0)
    corr_scores, flat = torch.topk(masked.reshape(-1), num_correspondences)
    corr_masks = corr_scores > -1.0
    corr_scores = torch.where(corr_masks, corr_scores, 0.0)
    return flat // n, flat % n, corr_scores, corr_masks
