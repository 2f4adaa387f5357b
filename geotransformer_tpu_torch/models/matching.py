r"""Superpoint matching, training-target sampling and GT correspondences
(``geotransformer_tpu/models/matching.py``):

  * superpoint matching (reference `superpoint_matching.py:7-50`): dual
    normalization and a global top-k on the padded grid, masked;
  * target sampling (reference `superpoint_target.py:6-41`): a masked top-k
    over random keys;
  * GT node correspondences (reference `registration/matching.py:231-315`):
    a fixed number of candidate src nodes per ref node, overlaps from
    ``kernels.overlap.patch_overlaps``.
"""

import torch

from geotransformer_tpu_torch.kernels.overlap import patch_overlaps
from geotransformer_tpu_torch.ops.pairwise_distance import pairwise_distance
from geotransformer_tpu_torch.ops.se3 import apply_transform


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


def superpoint_target_sample(generator, gt_corr_overlaps, num_targets, overlap_threshold):
    """Randomly pick up to ``num_targets`` GT correspondences above threshold
    (``geotransformer_tpu/models/matching.py:88-110``; reference
    `superpoint_target.py:6-41`): masked top-k over uniform keys.

    Args:
        generator: CPU ``torch.Generator`` for the keys (so a seed picks the
            same targets on every device); the JAX version takes a PRNG key
            and draws other numbers.
        gt_corr_overlaps: (C,) overlaps (0 for invalid slots).
        num_targets: T.
        overlap_threshold: minimum overlap.

    Returns:
        sel_indices (T,) indices into the C axis, sel_masks (T,) validity.
    """
    eligible = gt_corr_overlaps > overlap_threshold
    keys = torch.rand(gt_corr_overlaps.shape, generator=generator).to(gt_corr_overlaps.device)
    keys = torch.where(eligible, keys, -1.0)
    top_keys, sel_indices = torch.topk(keys, num_targets)
    return sel_indices, top_keys > -1.0


def get_node_correspondences(ref_nodes, src_nodes, ref_knn_points, src_knn_points, transform,
                             pos_radius, ref_masks=None, src_masks=None, ref_knn_masks=None,
                             src_knn_masks=None, num_candidates=64, chunk_size=32, force=None):
    """Ground-truth patch overlaps with fixed-candidate static shapes
    (``geotransformer_tpu/models/matching.py:113-238``, its ``use_pallas``
    branch; reference `registration/matching.py:231-315`).

    Each ref node keeps the ``num_candidates`` nearest src nodes whose
    enclosing spheres (plus ``pos_radius``) intersect its own; the overlap
    of a candidate pair is the mean of the fractions of each patch's points
    with a partner within ``pos_radius`` under ``transform``.

    Args:
        ref_nodes: (M, 3); src_nodes: (N, 3).
        ref_knn_points / src_knn_points: (M, K, 3) / (N, K, 3) patches.
        transform: (4, 4) GT transform aligning src onto ref.
        pos_radius: matching radius.
        *_masks: node validity; *_knn_masks: patch-slot validity.
        num_candidates: S (at most N).
        chunk_size: ref nodes per chunk of the overlaps' plain version.
        force: ``ModelConfig.force_pallas``: the overlaps go through
            :func:`kernels.overlap.patch_overlaps`, the CUDA kernel for CUDA
            tensors.

    Returns:
        cand_indices (M, S), cand_overlaps (M, S) in [0, 1] (0 where
        invalid), cand_masks (M, S). Indices of invalid slots are arbitrary.
    """
    m, n, k = ref_nodes.shape[0], src_nodes.shape[0], ref_knn_points.shape[1]
    device = ref_nodes.device
    if ref_masks is None:
        ref_masks = torch.ones((m,), dtype=torch.bool, device=device)
    if src_masks is None:
        src_masks = torch.ones((n,), dtype=torch.bool, device=device)
    if ref_knn_masks is None:
        ref_knn_masks = torch.ones((m, k), dtype=torch.bool, device=device)
    if src_knn_masks is None:
        src_knn_masks = torch.ones(src_knn_points.shape[:2], dtype=torch.bool, device=device)

    src_nodes = apply_transform(src_nodes, transform)
    src_knn_points = apply_transform(src_knn_points, transform)

    # enclosing-sphere radii, masked slots excluded
    ref_dists = torch.linalg.vector_norm(ref_knn_points - ref_nodes[:, None, :], dim=-1)
    ref_max_dists = torch.where(ref_knn_masks, ref_dists, 0.0).amax(dim=1)
    src_dists = torch.linalg.vector_norm(src_knn_points - src_nodes[:, None, :], dim=-1)
    src_max_dists = torch.where(src_knn_masks, src_dists, 0.0).amax(dim=1)

    node_dist = torch.sqrt(pairwise_distance(ref_nodes, src_nodes))  # (M, N)
    intersect = (ref_max_dists[:, None] + src_max_dists[None, :] + pos_radius - node_dist) > 0
    intersect = intersect & ref_masks[:, None] & src_masks[None, :]

    # fixed-S candidates: the nearest intersecting src nodes
    sel_key = torch.where(intersect, -node_dist, -torch.inf)
    top_vals, cand_indices = torch.topk(sel_key, num_candidates, dim=1)
    cand_masks = top_vals > -torch.inf

    overlaps = patch_overlaps(ref_knn_points.contiguous(), ref_knn_masks.contiguous(),
                              src_knn_points.contiguous(), src_knn_masks.contiguous(),
                              cand_indices, cand_masks, pos_radius, chunk_size, force=force)
    cand_masks = cand_masks & (overlaps > 0.0)
    return cand_indices, torch.where(cand_masks, overlaps, 0.0), cand_masks


def candidates_to_dense_overlaps(cand_indices, cand_overlaps, cand_masks, num_src_nodes):
    """Scatter the (M, S) candidate table into a dense (M, N) overlap matrix."""
    m = cand_indices.shape[0]
    safe_idx = torch.where(cand_masks, cand_indices, num_src_nodes)  # extra column, dropped
    dense = torch.zeros((m, num_src_nodes + 1), dtype=cand_overlaps.dtype,
                        device=cand_overlaps.device)
    rows = torch.arange(m, device=cand_indices.device)[:, None].expand_as(safe_idx)
    dense[rows, safe_idx] = torch.where(cand_masks, cand_overlaps, 0.0)
    return dense[:, :num_src_nodes]
