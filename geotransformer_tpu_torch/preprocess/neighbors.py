r"""Fixed-capacity radius neighbor search (host side, scipy cKDTree).

Same code as ``geotransformer_tpu/preprocess/neighbors.py`` (not importable
without JAX). Neighbors are sorted by distance (column 0 = nearest —
``nearest_upsample`` relies on this), offset to the stacked frame, and
missing slots hold the sentinel ``total_support_points``; the output width
is exactly ``neighbor_limit``.
"""

import numpy as np
from scipy.spatial import cKDTree


def radius_search(q_points, s_points, q_lengths, s_lengths, radius, neighbor_limit):
    """Stack-mode fixed-K radius search.

    Args:
        q_points: (N_q, 3) stacked query points.
        s_points: (N_s, 3) stacked support points.
        q_lengths: (B,) query cloud sizes.
        s_lengths: (B,) support cloud sizes.
        radius: search radius.
        neighbor_limit: static K.

    Returns:
        (N_q, K) int64 neighbor indices into the stacked support frame;
        sentinel = N_s where fewer than K neighbors exist in `radius`.
    """
    q_lengths = np.asarray(q_lengths)
    s_lengths = np.asarray(s_lengths)
    total_s = int(s_lengths.sum())
    out = []
    q_start = 0
    s_start = 0
    for q_len, s_len in zip(q_lengths, s_lengths):
        q = q_points[q_start : q_start + q_len]
        s = s_points[s_start : s_start + s_len]
        k = min(neighbor_limit, s_len)
        tree = cKDTree(s)
        dists, idx = tree.query(q, k=k, distance_upper_bound=radius)
        if k == 1:
            dists = dists[:, None]
            idx = idx[:, None]
        # cKDTree marks "not found" with idx == s_len and dist == inf.
        found = np.isfinite(dists)
        idx = np.where(found, idx + s_start, total_s)
        if k < neighbor_limit:
            pad = np.full((q_len, neighbor_limit - k), total_s, dtype=idx.dtype)
            idx = np.concatenate([idx, pad], axis=1)
        out.append(idx)
        q_start += q_len
        s_start += s_len
    return np.concatenate(out, axis=0).astype(np.int64)
