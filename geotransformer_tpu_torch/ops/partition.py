r"""Point-to-node partition with static shapes
(``geotransformer_tpu/ops/partition.py:21-96``; reference
`modules/ops/pointcloud_partition.py:61-107`).

Each fine point goes to its nearest node; each node keeps its
``point_limit`` nearest owned points. Padded points and nodes are excluded
by masks, and empty slots hold the sentinel index ``num_points``.
"""

import torch

from geotransformer_tpu_torch.ops.pairwise_distance import pairwise_distance

_BIG = 1e12


def point_to_node_partition(points, nodes, point_limit, point_masks=None,
                            node_masks_in=None):
    """Assign each point to its nearest node; build per-node KNN patches.

    Args:
        points: (N, 3) fine points (possibly padded).
        nodes: (M, 3) superpoints (possibly padded).
        point_limit: static int K, patch capacity.
        point_masks: optional (N,) bool, True for real points.
        node_masks_in: optional (M,) bool, True for real nodes.

    Returns:
        point_to_node (N,), node_masks (M,) bool (real and owning >= 1
        point), node_knn_indices (M, K) (sentinel N), node_knn_masks (M, K).
    """
    num_points = points.shape[0]
    num_nodes = nodes.shape[0]
    device = points.device

    sq_dist_mat = pairwise_distance(nodes, points)  # (M, N)
    if node_masks_in is not None:
        sq_dist_mat = torch.where(node_masks_in[:, None], sq_dist_mat, _BIG)
    if point_masks is not None:
        sq_dist_mat = torch.where(point_masks[None, :], sq_dist_mat, _BIG)

    d_own, point_to_node = torch.min(sq_dist_mat, dim=0)  # first index on ties

    weights = None if point_masks is None else point_masks.long()
    node_sizes = torch.bincount(point_to_node, weights=weights, minlength=num_nodes)
    node_masks = node_sizes > 0
    if node_masks_in is not None:
        node_masks = torch.logical_and(node_masks, node_masks_in)

    # Sort points by (owner, distance-to-owner, index) — the JAX stable
    # two-key lax.sort — as two stable passes: distance first, then owner.
    invalid_point = d_own >= _BIG
    if point_masks is not None:
        invalid_point = torch.logical_or(invalid_point, ~point_masks)
    owner = torch.where(invalid_point, num_nodes, point_to_node)  # junk last
    by_dist = torch.sort(d_own, stable=True).indices
    by_owner = torch.sort(owner[by_dist], stable=True).indices
    sorted_idx = by_dist[by_owner]
    sorted_owner = owner[sorted_idx]

    point_indices = torch.arange(num_points, device=device)
    seg_start = sorted_owner != torch.cat(
        [torch.full((1,), -1, dtype=sorted_owner.dtype, device=device), sorted_owner[:-1]])
    start_run = torch.cummax(torch.where(seg_start, point_indices, 0), dim=0).values
    rank = point_indices - start_run  # position within the owner segment
    valid = torch.logical_and(rank < point_limit, sorted_owner < num_nodes)

    # invalid entries land in the extra row num_nodes, which is dropped
    table = torch.full(((num_nodes + 1) * point_limit,), num_points,
                       dtype=torch.long, device=device)
    slot = torch.where(valid, sorted_owner * point_limit + rank, num_nodes * point_limit)
    table[slot] = torch.where(valid, sorted_idx, num_points)
    node_knn_indices = table.reshape(num_nodes + 1, point_limit)[:num_nodes]
    node_knn_masks = node_knn_indices != num_points
    return point_to_node, node_masks, node_knn_indices, node_knn_masks


def get_point_to_node_indices(points, nodes, point_masks=None, return_counts=False):
    """Nearest-node index per point (``geotransformer_tpu/ops/partition.py:111-134``;
    reference `pointcloud_partition.py:9-31`): first index on ties.

    Args:
        points: (N, 3).
        nodes: (M, 3).
        point_masks: optional (N,) bool; masked points are left out of the
            counts (their index is still their nearest node).
        return_counts: also return the number of points each node owns.

    Returns:
        indices (N,) int32 [, node_sizes (M,) int32].
    """
    indices = torch.argmin(pairwise_distance(points, nodes), dim=1).to(torch.int32)
    if not return_counts:
        return indices
    weights = None if point_masks is None else point_masks.to(torch.int64)
    node_sizes = torch.bincount(indices.long(), weights=weights, minlength=nodes.shape[0])
    return indices, node_sizes.to(torch.int32)
