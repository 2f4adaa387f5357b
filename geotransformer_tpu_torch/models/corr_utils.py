r"""Correspondence extraction, conversion and analysis
(``geotransformer_tpu/models/corr_utils.py``; reference
`modules/registration/matching.py:12-430`).

The reference returns variable-length ``nonzero`` lists; here every output
has a fixed capacity and a validity mask, as in the JAX package. Among the
qualifying entries the highest scores are kept, so with a capacity that
covers the qualifying count the result is the reference's set. The order
among exactly tied scores is ``torch.topk``'s, which may differ from
``jax.lax.top_k``'s (``ROADMAP.md`` §3, "Ties in top-k").
"""

import torch

from geotransformer_tpu_torch.ops.pairwise_distance import pairwise_distance
from geotransformer_tpu_torch.ops.partition import get_point_to_node_indices
from geotransformer_tpu_torch.ops.se3 import apply_transform


def _masked_topc(flat_scores, flat_valid, capacity):
    """Top-``capacity`` entries of a masked flat score vector.

    Returns (indices (C,), scores (C,), masks (C,))."""
    keyed = torch.where(flat_valid, flat_scores, -torch.inf)
    scores, indices = torch.topk(keyed, capacity)
    masks = scores > -torch.inf
    return indices, torch.where(masks, scores, 0.0), masks


def _clear_dustbin(masks_mat):
    masks_mat = masks_mat.clone()
    masks_mat[-1, :] = False
    masks_mat[:, -1] = False
    return masks_mat


def extract_correspondences_from_scores(score_mat, capacity, mutual=False, bilateral=False,
                                        has_dustbin=False, threshold=0.0):
    """Max-selection correspondences (reference matching.py:12-67).

    Args:
        score_mat: (N, M), or (N+1, M+1) with ``has_dustbin``, log matching
            probabilities.
        capacity: number of correspondences returned.

    Returns:
        (ref_indices (C,), src_indices (C,), scores (C,), masks (C,)).
    """
    probs = torch.exp(score_mat)
    m = probs.shape[1]
    row_best = probs >= probs.amax(dim=1, keepdim=True)
    masks_mat = row_best & (probs > threshold)
    if mutual or bilateral:
        col_best = probs >= probs.amax(dim=0, keepdim=True)
        src_masks_mat = col_best & (probs > threshold)
        masks_mat = masks_mat & src_masks_mat if mutual else masks_mat | src_masks_mat
    if has_dustbin:
        masks_mat = _clear_dustbin(masks_mat)
    flat_idx, scores, masks = _masked_topc(probs.reshape(-1), masks_mat.reshape(-1), capacity)
    return flat_idx // m, flat_idx % m, scores, masks


def extract_correspondences_from_scores_threshold(score_mat, threshold, capacity,
                                                  has_dustbin=False):
    """Threshold-selection correspondences (reference matching.py:70-98)."""
    probs = torch.exp(score_mat)
    m = probs.shape[1]
    valid = probs > threshold
    if has_dustbin:
        valid = _clear_dustbin(valid)
    flat_idx, scores, masks = _masked_topc(probs.reshape(-1), valid.reshape(-1), capacity)
    return flat_idx // m, flat_idx % m, scores, masks


def extract_correspondences_from_scores_topk(score_mat, k, has_dustbin=False, largest=True):
    """Global top-k correspondences (reference matching.py:101-133).

    Returns (ref_indices (k,), src_indices (k,), scores (k,), masks (k,));
    the masks clear entries on the dustbin row or column."""
    n, m = score_mat.shape
    scores, flat_idx = torch.topk(score_mat.reshape(-1), k, largest=largest)
    ref_idx = flat_idx // m
    src_idx = flat_idx % m
    masks = torch.ones((k,), dtype=torch.bool, device=score_mat.device)
    if has_dustbin:
        masks = (ref_idx != n - 1) & (src_idx != m - 1)
    return ref_idx, src_idx, scores, masks


def extract_correspondences_from_feats(ref_feats, src_feats, capacity, mutual=False,
                                       bilateral=False):
    """Nearest-neighbor feature correspondences (reference matching.py:136-170).

    Returns (ref_indices, src_indices, feat_dists, masks): the squared
    feature distances of the selected pairs, as the reference reports."""
    dists = pairwise_distance(ref_feats, src_feats)
    ref_idx, src_idx, _, masks = extract_correspondences_from_scores(
        -dists, capacity, mutual=mutual, bilateral=bilateral, threshold=-torch.inf)
    return ref_idx, src_idx, torch.where(masks, dists[ref_idx, src_idx], 0.0), masks


def dense_correspondences_to_node_correspondences(ref_points, src_points, ref_nodes, src_nodes,
                                                  corr_indices, corr_masks, capacity):
    """Point correspondences -> patch correspondences with proxy overlap
    scores (reference matching.py:177-228).

    Args:
        corr_indices: (C_in, 2) point correspondence indices.
        corr_masks: (C_in,) validity.
        capacity: number of node correspondences returned.

    Returns:
        (node_corr_indices (C, 2), counts (C,), scores (C,), masks (C,)),
        node pairs in ascending (ref, src) order.
    """
    num_src_nodes = src_nodes.shape[0]
    ref_p2n, ref_sizes = get_point_to_node_indices(ref_points, ref_nodes, return_counts=True)
    src_p2n, src_sizes = get_point_to_node_indices(src_points, src_nodes, return_counts=True)
    pair_ids = (ref_p2n[corr_indices[:, 0]].long() * num_src_nodes
                + src_p2n[corr_indices[:, 1]].long())
    invalid_id = ref_nodes.shape[0] * num_src_nodes
    pair_ids = torch.where(corr_masks, pair_ids, invalid_id)
    uniq, counts = torch.unique(pair_ids, sorted=True, return_counts=True)
    uniq, counts = uniq[:capacity], counts[:capacity]
    pad = capacity - uniq.shape[0]
    if pad > 0:
        uniq = torch.cat([uniq, uniq.new_full((pad,), invalid_id)])
        counts = torch.cat([counts, counts.new_zeros(pad)])
    masks = uniq < invalid_id
    counts = torch.where(masks, counts, 0).to(torch.int32)
    ref_node_corr = torch.where(masks, uniq // num_src_nodes, 0)
    src_node_corr = torch.where(masks, uniq % num_src_nodes, 0)
    scores = 0.5 * (counts / ref_sizes[ref_node_corr].clamp(min=1)
                    + counts / src_sizes[src_node_corr].clamp(min=1))
    scores = torch.where(masks, scores, 0.0)
    return torch.stack([ref_node_corr, src_node_corr], dim=1), counts, scores, masks


def node_correspondences_to_dense_correspondences(
        ref_knn_points, src_knn_points, ref_knn_indices, src_knn_indices, node_corr_indices,
        transform, matching_radius, capacity, ref_knn_masks=None, src_knn_masks=None,
        node_corr_masks=None):
    """Patch correspondences -> point correspondences within the radius
    (reference matching.py:319-357), nearest first.

    Returns (corr_indices (C, 2), distances (C,), masks (C,))."""
    p = node_corr_indices.shape[0]
    k = ref_knn_points.shape[1]
    device = ref_knn_points.device
    if ref_knn_masks is None:
        ref_knn_masks = torch.ones(ref_knn_indices.shape, dtype=torch.bool, device=device)
    if src_knn_masks is None:
        src_knn_masks = torch.ones(src_knn_indices.shape, dtype=torch.bool, device=device)
    if node_corr_masks is None:
        node_corr_masks = torch.ones((p,), dtype=torch.bool, device=device)
    src_knn_points = apply_transform(src_knn_points, transform)
    r_idx = node_corr_indices[:, 0]
    s_idx = node_corr_indices[:, 1]
    rm = ref_knn_masks[r_idx] & node_corr_masks[:, None]
    sm = src_knn_masks[s_idx] & node_corr_masks[:, None]
    dist = torch.sqrt(pairwise_distance(ref_knn_points[r_idx], src_knn_points[s_idx]))
    corr = (dist < matching_radius) & rm[:, :, None] & sm[:, None, :]
    flat_idx, neg_d, masks = _masked_topc(-dist.reshape(-1), corr.reshape(-1), capacity)
    pk = flat_idx // (k * k)
    ref_corr = ref_knn_indices[r_idx[pk], (flat_idx // k) % k]
    src_corr = src_knn_indices[s_idx[pk], flat_idx % k]
    corr_indices = torch.stack([torch.where(masks, ref_corr, 0),
                                torch.where(masks, src_corr, 0)], dim=1)
    return corr_indices, torch.where(masks, -neg_d, 0.0), masks


def get_node_overlap_ratios(ref_points, src_points, ref_knn_points, src_knn_points,
                            ref_knn_indices, src_knn_indices, node_corr_indices, transform,
                            matching_radius, ref_knn_masks, src_knn_masks, node_corr_masks=None,
                            capacity=None, eps=1e-5):
    """Fraction of each patch's points covered by dense GT correspondences
    (reference matching.py:361-397)."""
    if capacity is None:
        capacity = node_corr_indices.shape[0] * ref_knn_points.shape[1] ** 2
    corr_indices, _, masks = node_correspondences_to_dense_correspondences(
        ref_knn_points, src_knn_points, ref_knn_indices, src_knn_indices, node_corr_indices,
        transform, matching_radius, capacity, ref_knn_masks=ref_knn_masks,
        src_knn_masks=src_knn_masks, node_corr_masks=node_corr_masks)

    def covered(num, indices, knn_indices, knn_masks):
        hit = torch.zeros((num + 1,), dtype=torch.float32, device=indices.device)
        hit[torch.where(masks, indices, num)] = 1.0
        hit[num] = 0.0  # dropped correspondences and sentinel slots read 0
        rows = hit[torch.clamp(knn_indices, max=num)]
        weights = knn_masks.float()
        return (rows * weights).sum(dim=1) / (weights.sum(dim=1) + eps)

    return (covered(ref_points.shape[0], corr_indices[:, 0], ref_knn_indices, ref_knn_masks),
            covered(src_points.shape[0], corr_indices[:, 1], src_knn_indices, src_knn_masks))


def get_node_occlusion_ratios(*args, **kwargs):
    """1 - overlap ratio per patch (reference matching.py:400-430)."""
    ref_ratios, src_ratios = get_node_overlap_ratios(*args, **kwargs)
    return 1.0 - ref_ratios, 1.0 - src_ratios
