r"""Data-driven static-shape calibration (host, numpy).

The port's copy of ``geotransformer_tpu/preprocess/calibrate.py``, which
cannot be imported without JAX: neighbor limits from the neighbor-count
histogram (reference `utils/data.py:192-217`), per-stage cloud capacities
and capacity buckets, split specs of the neighbor and subsampling tables,
inverse-table capacities, and the 27-cell populations that bound the
device search's candidate capacity. Each calibration iterates over samples,
dicts with ``ref_points`` / ``src_points`` (numpy (N, 3)).
"""

import numpy as np

from geotransformer_tpu_torch.preprocess.device import _GRID_MIN_SUPPORT
from geotransformer_tpu_torch.preprocess.pyramid import TABLE_ALIGN, build_pyramid, round_up


def _pyramids(sample_iter, num_samples, num_stages, voxel_size, search_radius, neighbor_limits):
    for n, sample in enumerate(sample_iter):
        if n >= num_samples:
            return
        points = np.concatenate([sample["ref_points"], sample["src_points"]], axis=0)
        lengths = np.asarray([len(sample["ref_points"]), len(sample["src_points"])])
        yield build_pyramid(points, lengths, num_stages, voxel_size, search_radius,
                            neighbor_limits)


def calibrate_neighbor_limits(sample_iter, num_stages, voxel_size, search_radius,
                              keep_ratio=0.8, sample_threshold=2000):
    """Per-stage neighbor limits covering ``keep_ratio`` of the neighbor-count
    histogram, sampled until every stage has ``sample_threshold`` counts."""
    hist_n = int(np.ceil(4 / 3 * np.pi * (search_radius / voxel_size + 1) ** 3))
    neighbor_hists = np.zeros((num_stages, hist_n), dtype=np.int64)
    max_limits = [hist_n] * num_stages
    for pyramid in _pyramids(sample_iter, np.inf, num_stages, voxel_size, search_radius,
                             max_limits):
        counts = [np.sum(nb < nb.shape[0], axis=1) for nb in pyramid["neighbors"]]
        neighbor_hists += np.vstack([np.bincount(c, minlength=hist_n)[:hist_n] for c in counts])
        if np.min(np.sum(neighbor_hists, axis=1)) > sample_threshold:
            break
    cum_sum = np.cumsum(neighbor_hists.T, axis=0)
    limits = np.sum(cum_sum < (keep_ratio * cum_sum[hist_n - 1, :]), axis=0)
    return [int(x) for x in limits]


def calibrate_stage_caps(sample_iter, num_stages, voxel_size, search_radius, neighbor_limits,
                         num_samples=64, quantile=1.0, multiple=256):
    """Per-stage per-cloud capacities (multiples of ``multiple``) covering the
    ``quantile`` of the larger cloud's size over the samples."""
    sizes = [[] for _ in range(num_stages)]
    for pyramid in _pyramids(sample_iter, num_samples, num_stages, voxel_size, search_radius,
                             neighbor_limits):
        for i, stage_lengths in enumerate(pyramid["lengths"]):
            sizes[i].append(int(np.max(stage_lengths)))
    caps = []
    for stage_sizes in sizes:
        target = float(np.quantile(np.asarray(stage_sizes), quantile))
        caps.append(max(round_up(target, multiple), multiple))
    return caps


def calibrate_stage_cap_buckets(sample_iter, num_stages, voxel_size, search_radius,
                                neighbor_limits, num_buckets=3, num_samples=64, multiple=256):
    """Ascending, nested per-stage capacity buckets: the samples split into
    ``num_buckets`` groups by stage-0 size, each bucket covering its group."""
    per_sample = [[int(np.max(l)) for l in pyramid["lengths"]]
                  for pyramid in _pyramids(sample_iter, num_samples, num_stages, voxel_size,
                                           search_radius, neighbor_limits)]
    per_sample.sort(key=lambda s: s[0])
    buckets = []
    for g in np.array_split(np.asarray(per_sample), num_buckets):
        if len(g) == 0:
            continue
        caps = tuple(max(round_up(int(m), multiple), multiple) for m in g.max(axis=0))
        if buckets and all(c <= p for c, p in zip(caps, buckets[-1])):
            continue  # a degenerate group, already covered
        if buckets:  # nested, so the first fit is the smallest
            caps = tuple(max(c, p) for c, p in zip(caps, buckets[-1]))
        buckets.append(caps)
    return buckets


def calibrate_split_specs(sample_iter, num_stages, voxel_size, search_radius, neighbor_limits,
                          num_samples=64, multiple=128, headroom=0.1, min_saving=0.08):
    """Split specs of the neighbor and subsampling tables (deep-column
    compaction, ``preprocess.build_split_tables``).

    For each table, every head width h1 (a multiple of 8) and the samples'
    largest M2(h1), the number of queries with more than h1 valid neighbors,
    the spec minimizing M h1 + m2_cap (W - h1) rows is kept (m2_cap = M2
    with ``headroom``, rounded up to ``multiple``); a table whose best split
    saves less than ``min_saving`` of its M W rows gets None.

    Returns:
        (neighbor_splits, subsampling_splits): per-stage (h1, m2_cap) or None.
    """
    nb_w = [round_up(int(l), TABLE_ALIGN) for l in neighbor_limits]
    nb_m2 = [dict() for _ in range(num_stages)]
    sub_m2 = [dict() for _ in range(max(num_stages - 1, 0))]
    nb_rows = [0] * num_stages
    sub_rows = [0] * max(num_stages - 1, 0)
    for pyramid in _pyramids(sample_iter, num_samples, num_stages, voxel_size, search_radius,
                             neighbor_limits):
        totals = [int(np.sum(l)) for l in pyramid["lengths"]]
        # the support of neighbors[i] and of subsampling[i] is stage i
        for tables, m2s, rows in ((pyramid["neighbors"], nb_m2, nb_rows),
                                  (pyramid["subsampling"], sub_m2, sub_rows)):
            for i, table in enumerate(tables):
                vc = np.sum(table < totals[i], axis=1)
                rows[i] = max(rows[i], len(vc))
                for h1 in range(TABLE_ALIGN, nb_w[i], TABLE_ALIGN):
                    m2s[i][h1] = max(m2s[i].get(h1, 0), int(np.sum(vc > h1)))

    def pick(m2_by_h1, m_rows, width):
        best_rows, best = m_rows * width, None
        for h1, m2 in m2_by_h1.items():
            m2_cap = min(max(round_up(int(m2 * (1 + headroom)), multiple), multiple), m_rows)
            rows = m_rows * h1 + m2_cap * (width - h1)
            if rows < best_rows:
                best_rows, best = rows, (h1, m2_cap)
        if best is None or best_rows > (1.0 - min_saving) * m_rows * width:
            return None
        return best

    return ([pick(nb_m2[i], nb_rows[i], nb_w[i]) for i in range(num_stages)],
            [pick(sub_m2[i], sub_rows[i], nb_w[i]) for i in range(num_stages - 1)])


def calibrate_inverse_limits(sample_iter, num_stages, voxel_size, search_radius, neighbor_limits,
                             num_samples=64, margin=8, multiple=8):
    """Inverse-table capacities: the samples' largest in-degree of each
    neighbor table and of each subsampling table, plus ``margin``, rounded
    up to ``multiple``. Returns (inverse_limits, sub_inverse_limits)."""
    nb_max = np.zeros(num_stages, dtype=np.int64)
    sub_max = np.zeros(max(num_stages - 1, 0), dtype=np.int64)
    for pyramid in _pyramids(sample_iter, num_samples, num_stages, voxel_size, search_radius,
                             neighbor_limits):
        totals = [int(np.sum(l)) for l in pyramid["lengths"]]
        for tables, maxima in ((pyramid["neighbors"], nb_max), (pyramid["subsampling"], sub_max)):
            for i, table in enumerate(tables):
                deg = np.bincount(table[table < totals[i]], minlength=totals[i])
                maxima[i] = max(maxima[i], int(deg.max(initial=0)))
    return ([round_up(int(m) + margin, multiple) for m in nb_max],
            [round_up(int(m) + margin, multiple) for m in sub_max])


def cell_populations(q_points, s_points, radius):
    """Each query's 27-cell population: the support points in the 3 x 3 x 3
    cells of edge ``radius`` around its cell, on the device search's grid
    (``preprocess.device._radius_search_cloud_grid``; float32 cell keys)."""
    q = np.asarray(q_points, np.float32)
    s = np.asarray(s_points, np.float32)
    if len(s) == 0 or len(q) == 0:
        return np.zeros(len(q), np.int64)
    edge = np.float32(radius)
    origin = np.floor(s.min(axis=0) / edge) * edge
    nx, ny, nz = (np.floor((s.max(axis=0) - origin) / edge).astype(np.int64) + 1).tolist()
    cell = np.floor((s - origin) / edge).astype(np.int64)
    flat = np.sort(cell[:, 0] + nx * (cell[:, 1] + ny * cell[:, 2]))
    cq = np.floor((q - origin) / edge).astype(np.int64)
    total = np.zeros(len(q), np.int64)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cy, cz = cq[:, 1] + dy, cq[:, 2] + dz
            row_ok = (cy >= 0) & (cy < ny) & (cz >= 0) & (cz < nz)
            x0 = np.clip(cq[:, 0] - 1, 0, nx)
            x1 = np.clip(cq[:, 0] + 2, x0, nx)
            base = nx * (cy + ny * cz)
            run = np.searchsorted(flat, base + x1) - np.searchsorted(flat, base + x0)
            total += np.where(row_ok, run, 0)
    return total


def largest_cell_population(pyramid, search_radius, stage_caps=None):
    """The largest 27-cell population of any query of a host pyramid's
    searches (neighbors, subsampling, upsampling; each cloud on its own);
    with ``stage_caps``, of the searches the device runs on its grid only
    (a support capacity of at least ``_GRID_MIN_SUPPORT`` rows)."""
    clouds = [np.split(p, np.cumsum(l)[:-1]) for p, l in
              zip(pyramid["points"], pyramid["lengths"])]
    largest, radius = 0, search_radius
    for i in range(len(clouds)):
        searches = [(i, i, radius)]
        if i < len(clouds) - 1:
            searches += [(i + 1, i, radius), (i, i + 1, 2 * radius)]
        for q_stage, s_stage, r in searches:
            if stage_caps is not None and int(stage_caps[s_stage]) < _GRID_MIN_SUPPORT:
                continue
            for q, s in zip(clouds[q_stage], clouds[s_stage]):
                largest = max(largest, int(cell_populations(q, s, r).max(initial=0)))
        radius *= 2
    return largest

