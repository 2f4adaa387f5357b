r"""Multi-stage pyramid precompute and fixed-capacity padding (host, numpy).

The default path of ``geotransformer_tpu/preprocess/pyramid.py``: the same
stacked pyramid (reference collate, `utils/data.py:13-77`), re-laid into the
same fixed-capacity ``PairBatch`` so the JAX package and the port see
byte-identical batches.

Padded layout (per stage, per-cloud capacities ``(C_ref, C_src)``): rows
``[0, C_ref)`` ref, ``[C_ref, C_ref + C_src)`` src, sentinel index
``C_ref + C_src``, padded coordinates at ``PAD_COORD``.

Optional tables, each byte-identical to the JAX package's: the inverse
neighbor tables of the KPConv backward (``inverse_limits``, optionally split
into head and compacted tail), the split forward tables
(``neighbor_splits``, ``subsampling_splits``: deep-column compaction) and
the stage-0 per-tile neighbor unions of the union-gather input conv
(``union_cap``).

The subsample and the radius search take the native library
(:mod:`geotransformer_tpu_torch.native`, the port's copy of ``geolib.cpp``)
by default, as the JAX pyramid does whenever its library builds;
``GEOTRANSFORMER_TPU_NATIVE=0``, the variable the JAX package reads, selects
the numpy / cKDTree route of ``voxel.py`` and ``neighbors.py`` in both
packages at once. The two routes give the same points bit for bit and the
same neighbor tables save rows whose order differs on exact distance ties.
"""

import os

import numpy as np
import torch

from geotransformer_tpu_torch import native
from geotransformer_tpu_torch.preprocess import neighbors, voxel

PAD_COORD = 1.0e6
# Neighbor-column alignment of the forward tables: what f32 tables give in
# the JAX package (kernels/kpconv.py:table_align), kept so batches match.
TABLE_ALIGN = 8


def use_native():
    """The native route unless ``GEOTRANSFORMER_TPU_NATIVE=0``."""
    return os.environ.get("GEOTRANSFORMER_TPU_NATIVE", "1") != "0"


def grid_subsample(points, lengths, voxel_size):
    """Stack-mode voxel subsampling: the native library, or numpy by name."""
    if use_native():
        return native.grid_subsample(points, lengths, voxel_size)
    return voxel.grid_subsample(points, lengths, voxel_size)


def radius_search(q_points, s_points, q_lengths, s_lengths, radius, neighbor_limit):
    """Stack-mode fixed-K radius search: the native library, or cKDTree by name."""
    if use_native():
        return native.radius_search(q_points, s_points, q_lengths, s_lengths, radius,
                                    neighbor_limit)
    return neighbors.radius_search(q_points, s_points, q_lengths, s_lengths, radius,
                                   neighbor_limit)


def build_pyramid(points, lengths, num_stages, voxel_size, radius, neighbor_limits):
    """Stack-mode multi-stage precompute (unpadded, mirrors the reference).

    Args:
        points: (N, 3) stacked ref+src points (stage-0 resolution).
        lengths: (B,) stacked cloud sizes (for registration, B=2: [ref, src]).
        num_stages: number of pyramid stages.
        voxel_size: stage-0 voxel size; doubles per stage.
        radius: stage-0 search radius; doubles per stage.
        neighbor_limits: per-stage neighbor capacity K_i.

    Returns:
        dict with per-stage lists: points, lengths, neighbors, subsampling,
        upsampling.
    """
    if num_stages != len(neighbor_limits):
        raise ValueError(f"{num_stages} stages but {len(neighbor_limits)} neighbor limits")
    points = np.asarray(points, dtype=np.float32)
    lengths = np.asarray(lengths, dtype=np.int64)

    points_list, lengths_list = [], []
    for i in range(num_stages):
        if i > 0:
            points, lengths = grid_subsample(points, lengths, voxel_size=voxel_size)
        points_list.append(points)
        lengths_list.append(lengths)
        voxel_size *= 2

    neighbors_list, subsampling_list, upsampling_list = [], [], []
    for i in range(num_stages):
        cur_points, cur_lengths = points_list[i], lengths_list[i]
        neighbors_list.append(
            radius_search(cur_points, cur_points, cur_lengths, cur_lengths, radius, neighbor_limits[i])
        )
        if i < num_stages - 1:
            sub_points, sub_lengths = points_list[i + 1], lengths_list[i + 1]
            subsampling_list.append(
                radius_search(sub_points, cur_points, sub_lengths, cur_lengths, radius, neighbor_limits[i])
            )
            upsampling_list.append(
                radius_search(cur_points, sub_points, cur_lengths, sub_lengths, radius * 2, neighbor_limits[i + 1])
            )
        radius *= 2

    return {
        "points": points_list,
        "lengths": lengths_list,
        "neighbors": neighbors_list,
        "subsampling": subsampling_list,
        "upsampling": upsampling_list,
    }


def _cloud_caps(cap):
    """A stage cap is an int (symmetric) or a (cap_ref, cap_src) pair."""
    if isinstance(cap, (tuple, list)):
        return int(cap[0]), int(cap[1])
    return int(cap), int(cap)


def _remap_indices(indices, ref_len, src_len, cap):
    """Stacked-frame indices -> padded frame (sentinel -> cap_r + cap_s)."""
    cap_r, cap_s = _cloud_caps(cap)
    total = ref_len + src_len
    out = np.where(
        indices >= total,
        cap_r + cap_s,
        np.where(indices >= ref_len, indices + (cap_r - ref_len), indices),
    )
    return out.astype(np.int32)


def _pad_rows(array, ref_len, src_len, cap, fill):
    """Re-lay stacked rows [ref ++ src] into [ref pad to cap_r ++ src pad to cap_s]."""
    cap_r, cap_s = _cloud_caps(cap)
    out = np.full((cap_r + cap_s,) + array.shape[1:], fill, dtype=array.dtype)
    out[:ref_len] = array[:ref_len]
    out[cap_r : cap_r + src_len] = array[ref_len : ref_len + src_len]
    return out


def round_up(value, multiple):
    return int(-(-value // multiple) * multiple)


def _pad_cols(table, sentinel, multiple=TABLE_ALIGN):
    """Pad a neighbor table's column count to ``multiple`` with sentinels
    (extra columns behave as shadow neighbors everywhere)."""
    h = table.shape[1]
    h_pad = round_up(h, multiple)
    if h_pad == h:
        return table
    out = np.full((table.shape[0], h_pad), sentinel, dtype=table.dtype)
    out[:, :h] = table
    return out


def build_inverse_table(table, num_support, j_cap):
    """Fixed-capacity inverse of a neighbor table, for the KPConv backward
    (``kernels.kpconv.kpconv_bwd_fused``).

    ``table`` is a padded (M, H) neighbor table (values in [0, num_support),
    sentinel >= num_support). Returns (num_support, j_cap) int32 where row n
    lists the query rows m with n in table[m] in ascending order, padded
    with sentinel M. Raises ValueError if a support point's in-degree
    exceeds ``j_cap``.
    """
    table = np.asarray(table)
    m_rows, h = table.shape
    q_idx = np.repeat(np.arange(m_rows, dtype=np.int64), h)
    v = table.reshape(-1).astype(np.int64)
    keep = v < num_support
    v, q_idx = v[keep], q_idx[keep]
    order = np.argsort(v, kind="stable")
    v, q_idx = v[order], q_idx[order]
    counts = np.bincount(v, minlength=num_support)
    if counts.max(initial=0) > j_cap:
        raise ValueError(
            f"max in-degree {int(counts.max())} exceeds inverse capacity "
            f"{j_cap}; raise caps.inverse_limits for this stage"
        )
    seg_starts = np.cumsum(counts) - counts
    rank = np.arange(len(v)) - np.repeat(seg_starts, counts)
    inv = np.full((num_support, j_cap), m_rows, dtype=np.int32)
    inv[v, rank] = q_idx
    return inv


def build_split_tables(table, num_support, h1, m2_cap):
    """Split a padded neighbor table into its first ``h1`` columns (the head,
    every query) and a compacted tail: the remaining columns of only the
    queries with a valid neighbor beyond ``h1`` (``kernels.kpconv_split_fused``).

    Args:
        table: (M, H) padded neighbor table, values < num_support are valid.
        num_support: sentinel base.
        h1: head width; a multiple of 8 with 0 < h1 < H.
        m2_cap: tail-row capacity.

    Returns:
        tail (m2_cap, H - h1) int32 sentinel-padded, tail_q (m2_cap,) int32
        query row per tail row (0 on padding rows), tail_rank (M,) int32
        query row -> tail row, sentinel m2_cap.
    Raises ValueError on a bad head width or more deep queries than m2_cap.
    """
    table = np.asarray(table)
    m, h = table.shape
    if not (0 < h1 < h and h1 % 8 == 0):
        raise ValueError(f"split head width {h1} invalid for table width {h}")
    rows = np.nonzero((table[:, h1:] < num_support).any(axis=1))[0]
    m2 = len(rows)
    if m2 > m2_cap:
        raise ValueError(
            f"{m2} deep queries exceed split capacity {m2_cap}; raise this "
            f"stage's split capacity (caps.neighbor_splits)")
    tail = np.full((m2_cap, h - h1), num_support, dtype=table.dtype)
    tail[:m2] = table[rows, h1:]
    tail_q = np.zeros(m2_cap, dtype=np.int32)
    tail_q[:m2] = rows
    rank = np.full(m, m2_cap, dtype=np.int32)
    rank[rows] = np.arange(m2, dtype=np.int32)
    return tail, tail_q, rank


def fit_split_for_table(table, num_support, multiple=128, min_saving=0.08, align=TABLE_ALIGN):
    """The (h1, m2_cap) split of this table with the fewest table rows
    M h1 + m2_cap (H - h1) (h1 sweeps multiples of ``align``, m2_cap the deep
    queries rounded up to ``multiple``), or None when it saves less than
    ``min_saving`` of the M H rows."""
    table = np.asarray(table)
    m, h = table.shape
    valid = table < num_support
    best = (m * h, None)
    for h1 in range(align, h, align):
        m2 = int(valid[:, h1:].any(axis=1).sum())
        m2_cap = max(round_up(m2, multiple), multiple)
        rows = m * h1 + m2_cap * (h - h1)
        if rows < best[0]:
            best = (rows, (h1, m2_cap))
    if best[1] is None or best[0] > (1.0 - min_saving) * m * h:
        return None
    return best[1]


def build_union_tables(table, num_support, tile=128, union_cap=1536):
    """Per-query-tile neighbor unions of the union-gather input conv
    (``kernels.kpconv_union_input_fused``).

    Args:
        table: (M, H) padded neighbor table, sentinel >= num_support.
        num_support: support row count (sentinel).
        tile: query rows per tile (the kernel's tile).
        union_cap: per-tile union capacity U.

    Returns:
        union_rows (ceil(M / tile), U) int32 the sorted distinct support rows
        of each tile, sentinel num_support; sel (M, H) int32 the position of
        each edge's support row in its tile's union, sentinel U.
    Raises ValueError if a tile's union exceeds ``union_cap``.
    """
    table = np.asarray(table)
    m, h = table.shape
    num_tiles = -(-m // tile)
    union_rows = np.full((num_tiles, union_cap), num_support, np.int32)
    sel = np.full((m, h), union_cap, np.int32)
    for t in range(num_tiles):
        blk = table[t * tile:(t + 1) * tile]
        uniq = np.unique(blk[blk < num_support])
        if uniq.size > union_cap:
            raise ValueError(
                f"tile {t}: neighbor union {uniq.size} exceeds capacity "
                f"{union_cap}; raise the stage-0 union capacity")
        union_rows[t, :uniq.size] = uniq
        pos = np.clip(np.searchsorted(uniq, blk), 0, max(uniq.size - 1, 0))
        hit = (blk < num_support) & (uniq[pos] == blk if uniq.size else False)
        sel[t * tile:t * tile + blk.shape[0]] = np.where(hit, pos, union_cap)
    return union_rows, sel


def _split_inverse(inv, query_rows, spec):
    """An inverse table, or with a (h1, m2_cap) spec its split 4-tuple
    (head, tail, tail_s, rank) that ``kernels.kpconv_bwd_fused`` takes."""
    if spec is None:
        return inv
    tail, tail_s, rank = build_split_tables(inv, query_rows, spec[0], spec[1])
    return (inv[:, :spec[0]], tail, tail_s, rank)


def pad_registration_batch(pyramid, feats, transform, stage_caps, inverse_limits=None,
                           sub_inverse_limits=None, union_cap=None, union_tile=128,
                           neighbor_splits=None, subsampling_splits=None,
                           inverse_splits=None, sub_inverse_splits=None, input_stream=True):
    """Convert an unpadded pyramid into a fixed-capacity PairBatch (numpy).

    Args:
        pyramid: dict from :func:`build_pyramid` with B=2 clouds [ref, src].
        feats: (N0, C_in) stacked stage-0 features.
        transform: (4, 4) ground-truth transform (identity if unknown).
        stage_caps: per-stage capacity — an int (symmetric) or a
            (cap_ref, cap_src) pair.
        inverse_limits: optional per-stage in-degree capacities J_i
            (training batches): adds ``neighbors_inv[i]`` (T_i, J_i)
            sentinel T_i, the inverse of ``neighbors[i]``, and
            ``subsampling_inv[i]`` (T_i, J'_i) sentinel T_{i+1}, the inverse
            of ``subsampling[i]``; columns padded to a multiple of 8.
        sub_inverse_limits: the J'_i of the subsampling inverses; default
            ``max(16, J_i // 4 + 8)`` (a coarse point pools ~4 fine voxels).
        union_cap, union_tile: adds ``union_rows0`` / ``union_sel0``, the
            stage-0 per-tile neighbor unions (:func:`build_union_tables`).
        neighbor_splits / subsampling_splits: per-stage (h1, m2_cap) or
            None; adds ``neighbors_split[i]`` / ``subsampling_split[i]``,
            the (tail, tail_q, tail_rank) of :func:`build_split_tables`
            (None where the spec is None).
        inverse_splits / sub_inverse_splits: per-stage (h1, m2_cap) or
            None; the inverse tables become (head, tail, tail_s, rank).
        input_stream: with 1-channel features, also build the
            ``input_stream`` edge planes of the input conv.

    Returns:
        dict of numpy arrays (T_i = cap_ref_i + cap_src_i):
          points[i] (T_i, 3) float32, masks[i] (T_i,) bool,
          lengths[i] (2,) int32, neighbors[i] (T_i, K_i) int32 sentinel T_i,
          subsampling[i] (T_{i+1}, K_i) sentinel T_i,
          upsampling[i] (T_i, K_{i+1}) sentinel T_{i+1},
          features (T_0, C_in) float32, transform (4, 4) float32,
          [input_stream (5, T_0, K_0) float32],
          [neighbors_inv, subsampling_inv per-stage lists].
    Raises ValueError if a cloud exceeds its capacity or an in-degree its
    inverse capacity.
    """
    num_stages = len(pyramid["points"])
    if len(stage_caps) != num_stages:
        raise ValueError(f"{len(stage_caps)} stage caps for {num_stages} stages")

    out = {"points": [], "masks": [], "lengths": [], "neighbors": [], "subsampling": [], "upsampling": []}
    ref_lens = [int(l[0]) for l in pyramid["lengths"]]
    src_lens = [int(l[1]) for l in pyramid["lengths"]]

    for i in range(num_stages):
        cap_r, cap_s = _cloud_caps(stage_caps[i])
        ref_len, src_len = ref_lens[i], src_lens[i]
        if ref_len > cap_r or src_len > cap_s:
            raise ValueError(
                f"stage {i}: cloud sizes ({ref_len}, {src_len}) exceed "
                f"capacity ({cap_r}, {cap_s})"
            )
        cap = (cap_r, cap_s)
        pts = _pad_rows(pyramid["points"][i].astype(np.float32), ref_len, src_len, cap, PAD_COORD)
        mask = np.zeros(cap_r + cap_s, dtype=bool)
        mask[:ref_len] = True
        mask[cap_r : cap_r + src_len] = True
        nbrs = _remap_indices(pyramid["neighbors"][i], ref_len, src_len, cap)
        nbrs = _pad_rows(nbrs, ref_len, src_len, cap, np.int32(cap_r + cap_s))
        out["points"].append(pts)
        out["masks"].append(mask)
        out["lengths"].append(np.asarray([ref_len, src_len], dtype=np.int32))
        out["neighbors"].append(_pad_cols(nbrs, np.int32(cap_r + cap_s)))

    for i in range(num_stages - 1):
        cap_cur, cap_sub = _cloud_caps(stage_caps[i]), _cloud_caps(stage_caps[i + 1])
        sent_cur = np.int32(sum(cap_cur))
        sent_sub = np.int32(sum(cap_sub))
        sub = _remap_indices(pyramid["subsampling"][i], ref_lens[i], src_lens[i], cap_cur)
        sub = _pad_rows(sub, ref_lens[i + 1], src_lens[i + 1], cap_sub, sent_cur)
        # the strided block's shortcut maxpool is bounded by the true neighbor
        # limit (KPConvFPN.neighbor_limits), not by this padded width
        out["subsampling"].append(_pad_cols(sub, sent_cur))
        up = _remap_indices(pyramid["upsampling"][i], ref_lens[i + 1], src_lens[i + 1], cap_sub)
        up = _pad_rows(up, ref_lens[i], src_lens[i], cap_cur, sent_sub)
        out["upsampling"].append(_pad_cols(up, sent_sub))

    if inverse_limits is not None:
        if sub_inverse_limits is None:
            sub_inverse_limits = tuple(max(16, int(l) // 4 + 8) for l in inverse_limits[:-1])
        out["neighbors_inv"], out["subsampling_inv"] = [], []
        for i in range(num_stages):
            rows = out["neighbors"][i].shape[0]
            inv = _pad_cols(
                build_inverse_table(out["neighbors"][i], rows, int(inverse_limits[i])),
                np.int32(rows))
            out["neighbors_inv"].append(_split_inverse(
                inv, rows, None if inverse_splits is None else inverse_splits[i]))
            if i < num_stages - 1:
                rows_sub = out["subsampling"][i].shape[0]
                sub_inv = _pad_cols(
                    build_inverse_table(out["subsampling"][i], rows,
                                        int(sub_inverse_limits[i])),
                    np.int32(rows_sub))
                out["subsampling_inv"].append(_split_inverse(
                    sub_inv, rows_sub,
                    None if sub_inverse_splits is None else sub_inverse_splits[i]))

    if neighbor_splits is not None:
        out["neighbors_split"] = [
            None if spec is None else build_split_tables(
                out["neighbors"][i], out["neighbors"][i].shape[0], spec[0], spec[1])
            for i, spec in enumerate(neighbor_splits)]
    if subsampling_splits is not None:
        # the support of subsampling[i] is stage i
        out["subsampling_split"] = [
            None if spec is None else build_split_tables(
                out["subsampling"][i], out["neighbors"][i].shape[0], spec[0], spec[1])
            for i, spec in enumerate(subsampling_splits[:num_stages - 1])]
    if union_cap is not None:
        rows0 = out["neighbors"][0].shape[0]
        out["union_rows0"], out["union_sel0"] = build_union_tables(
            out["neighbors"][0], rows0, tile=union_tile, union_cap=union_cap)

    out["features"] = _pad_rows(
        np.asarray(feats, dtype=np.float32), ref_lens[0], src_lens[0],
        _cloud_caps(stage_caps[0]), 0.0
    )
    if input_stream and out["features"].shape[1] == 1:
        out["input_stream"] = build_input_stream(
            out["points"][0], out["features"], out["neighbors"][0])
    out["transform"] = np.asarray(transform, dtype=np.float32)
    return out


def build_input_stream(points, feats, table):
    """Precomputed edge stream of the input conv (kernels.kpconv_stream_fused).

    Args:
        points: (T0, 3) padded stage-0 points.
        feats: (T0, 1) padded stage-0 features (c_in == 1 input layer).
        table: (T0, H) int32 stage-0 neighbor table, sentinel T0.

    Returns:
        (5, T0, H) float32 planes [off_x, off_y, off_z, posflag, feat]
        with zeros on invalid slots.
    """
    t0 = points.shape[0]
    valid = table < t0
    idx = np.where(valid, table, 0)
    s = points[idx]  # (T0, H, 3)
    off = np.where(valid[..., None], s - points[:, None, :], 0.0)
    feat_sum = np.sum(feats, axis=1)  # (T0,)
    flag = (valid & (feat_sum[idx] > 0.0)).astype(np.float32)
    featv = np.where(valid, feats[idx, 0], 0.0).astype(np.float32)
    return np.stack(
        [off[:, :, 0], off[:, :, 1], off[:, :, 2], flag, featv], axis=0
    ).astype(np.float32)


def caps_for_pyramid(pyramid, multiple=128, margin=1.0, per_cloud=False):
    """Per-stage capacities covering this pyramid: cloud sizes * margin
    rounded up to ``multiple``; symmetric (max over clouds) or, with
    ``per_cloud``, a (cap_ref, cap_src) pair per stage."""
    caps = []
    for lengths in pyramid["lengths"]:
        if per_cloud:
            caps.append(tuple(
                max(round_up(int(l) * margin, multiple), multiple)
                for l in lengths
            ))
        else:
            biggest = int(np.max(lengths)) * margin
            caps.append(max(round_up(biggest, multiple), multiple))
    return caps


def batch_to_torch(batch, device):
    """PairBatch of numpy arrays or tensors -> torch tensors on ``device``;
    dtypes are kept (float32 / int32 / bool). Per-stage lists stay lists,
    split tables stay tuples, and None entries (stages without a split) stay
    None."""
    def convert(value):
        if value is None:
            return None
        if isinstance(value, tuple):
            return tuple(convert(v) for v in value)
        if isinstance(value, list):
            return [convert(v) for v in value]
        if isinstance(value, torch.Tensor):
            return value.to(device)
        return torch.from_numpy(np.ascontiguousarray(value)).to(device)

    return {key: convert(value) for key, value in batch.items()}


def batch_to_float64(batch):
    """A torch batch with its floating tensors (in lists and tuples too) in
    float64, the others as they are: the input of a float64 model."""
    def convert(value):
        if isinstance(value, torch.Tensor):
            return value.double() if value.is_floating_point() else value
        if isinstance(value, (list, tuple)):
            return type(value)(convert(v) for v in value)
        return value

    return {key: convert(value) for key, value in batch.items()}
