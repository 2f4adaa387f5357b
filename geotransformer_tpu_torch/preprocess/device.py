r"""Device-resident pyramid build: voxel subsample and radius KNN on the card
(``geotransformer_tpu/preprocess/device.py``).

The port's replacement for the host pyramid (:func:`..pyramid.build_pyramid`
and :func:`..pyramid.pad_registration_batch`) inside the train and eval
steps, with the JAX module's names:

  * the voxel subsample sorts each cloud by its (z, y, x) voxel key, marks
    each voxel's first row and averages the voxels' rows with the
    ``voxel_segment_mean`` kernel: the voxels come out in the host paths'
    order, so stage sizes and masks match row for row;
  * the fixed-K radius search bins the support into cells of edge radius,
    sorts it by cell and builds dense CSR starts (an integer
    ``scatter_add_`` and a cumsum; ``torch.bincount`` would read its
    maximum back to the host), then the ``grid_radius_search`` kernel takes
    each query's candidates from its 27 cells and keeps the K best by the
    lexicographic (d^2, index) key; supports under ``_GRID_MIN_SUPPORT``
    rows take every valid support row as a candidate (the same kernel's
    brute mode).

Both kernels live in :mod:`geotransformer_tpu_torch.kernels.pyramid`, with
their plain versions, which the CPU takes. Unlike the JAX brute search
(|q|^2 - 2 q.s + |s|^2, ``device.py:140-146``) every d^2 here is the
direct coordinate difference, so where distances tie the two order a row
differently. Voxel keys are float32 on the card, float64 on the host
(``voxel.py``): a point on a voxel boundary may fall in the next voxel.

Everything is fixed-capacity (the caps are Python ints) and nothing reads a
value back to the host: :func:`build_pyramid_device` returns the
``(num_stages,)`` overflow vector as a device tensor for the caller to read
once (the host pipeline's equivalent is the ValueError of
``pad_registration_batch``).
"""

import numpy as np
import torch

from geotransformer_tpu_torch.kernels.pyramid import grid_radius_search, voxel_segment_mean
from geotransformer_tpu_torch.preprocess.pyramid import (
    PAD_COORD,
    TABLE_ALIGN,
    build_pyramid,
    caps_for_pyramid,
    pad_registration_batch,
    table_align,
)

_INT_MAX = 2**31 - 1
# support capacity below which a search runs brute force (_pair_search)
_GRID_MIN_SUPPORT = 2048


def _scalar(value, device):
    """``value`` as a 0-dim float32 tensor on ``device``: divisions by it stay
    true divisions on the card (PyTorch divides by a Python scalar as a
    product with its reciprocal there)."""
    return torch.full((), float(np.float32(value)), dtype=torch.float32, device=device)


def _subsample_cloud(points, n, voxel_size, cap_out):
    """Voxel-mean subsample of B capacity-padded clouds.

    Args:
        points: (B, C, 3) float32; rows >= n are padding (any values).
        n: (B,) int32 valid counts.
        voxel_size: voxel edge.
        cap_out: output capacity.

    Returns:
        (out_points (B, cap_out, 3) float32, PAD_COORD beyond m;
         m (B,) int32 voxel counts;
         overflow (B,) bool, true where m exceeds cap_out).
    """
    bsz, cap, _ = points.shape
    dev = points.device
    valid = torch.arange(cap, device=dev)[None, :] < n[:, None]
    vox = _scalar(voxel_size, dev)
    masked = torch.where(valid[..., None], points, float("inf"))
    origin = torch.floor(masked.amin(dim=1) / vox) * vox
    cell = torch.floor((points - origin[:, None, :]) / vox).to(torch.int32)
    cell = torch.where(valid[..., None], cell, 0)
    n_x = torch.where(valid, cell[..., 0], -1).amax(dim=1) + 1
    # (z cell, y * nx + x) keys, as one int64 in their lexicographic order:
    # the host paths' emit order (ascending flat voxel id); padding last
    key_lo = torch.where(valid, cell[..., 0] + n_x[:, None] * cell[..., 1], _INT_MAX)
    key_hi = torch.where(valid, cell[..., 2], _INT_MAX)
    key = (key_hi.to(torch.int64) << 32) + (key_lo.to(torch.int64) + 2**31)
    key, perm = torch.sort(key, dim=1, stable=True)
    sorted_pts = torch.gather(points, 1, perm[..., None].expand(bsz, cap, 3)).contiguous()
    new_voxel = torch.cat([torch.ones((bsz, 1), dtype=torch.bool, device=dev),
                           key[:, 1:] != key[:, :-1]], dim=1) & valid
    m = new_voxel.sum(dim=1, dtype=torch.int32)
    seg = torch.where(valid, torch.cumsum(new_voxel, dim=1, dtype=torch.int32) - 1, -1)
    out, _ = voxel_segment_mean(sorted_pts, seg, m, cap_out)
    return out, m, m > cap_out


def _search_support(s_points, n_s, radius, grid_cap):
    """The cell-sorted support of B clouds: (support (B, C_s, 4) rows [x, y,
    z, original index], CSR starts (B, grid_cap + 1) int32 over the flat cell
    id, origins (B, 3), cells per axis (B, 3) int32, grid overflow (B,)
    bool). Empty clouds give a zero-size grid."""
    bsz, cap_s, _ = s_points.shape
    dev = s_points.device
    edge = _scalar(radius, dev)
    s_valid = torch.arange(cap_s, device=dev)[None, :] < n_s[:, None]
    s_masked = torch.where(s_valid[..., None], s_points, PAD_COORD)
    vmin = torch.where(s_valid[..., None], s_points, float("inf")).amin(dim=1)
    vmax = torch.where(s_valid[..., None], s_points, float("-inf")).amax(dim=1)
    has = (n_s > 0)[:, None]
    origin = torch.where(has, torch.floor(vmin / edge) * edge, 0.0)
    dims = torch.where(
        has, torch.floor((torch.where(has, vmax, 0.0) - origin) / edge).to(torch.int32) + 1, 0)
    nx, ny, nz = dims.unbind(dim=1)
    num_cells = nx * ny * nz  # int32, wraps on pathological extents
    grid_overflow = ((num_cells > grid_cap) | (num_cells < 0)
                     | (nx.float() * ny.float() * nz.float() > float(np.float32(2**31 - 1))))
    cell = torch.floor(
        (torch.where(s_valid[..., None], s_points, origin[:, None, :]) - origin[:, None, :])
        / edge).to(torch.int32)
    flat = cell[..., 0] + nx[:, None] * (cell[..., 1] + ny[:, None] * cell[..., 2])
    flat = torch.where(s_valid, flat, grid_cap)  # padding: one past the last cell
    _, perm = torch.sort(flat, dim=1, stable=True)  # a cell's rows keep their order
    # ids outside the grid go to the last bin, which the starts leave out
    bins = torch.where((flat >= 0) & (flat <= grid_cap), flat, grid_cap).long()
    counts = torch.zeros((bsz, grid_cap + 1), dtype=torch.int32, device=dev).scatter_add_(
        1, bins, torch.ones_like(flat))
    starts = torch.cat([torch.zeros((bsz, 1), dtype=torch.int32, device=dev),
                        torch.cumsum(counts[:, :grid_cap], dim=1, dtype=torch.int32)], dim=1)
    support = torch.cat([torch.gather(s_masked, 1, perm[..., None].expand(bsz, cap_s, 3)),
                         perm[..., None].to(torch.float32)], dim=2)
    return support, starts, origin, dims, grid_overflow


def _radius_search_cloud_grid(q_points, n_q, s_points, n_s, radius, k, cand_cap=512,
                              grid_cap=1 << 20):
    """Exact fixed-K radius KNN through a voxel grid, B capacity-padded
    clouds (the reference's grid-binned CPU search, `radius_neighbors_cpu.cpp`).

    Args:
        q_points: (B, C_q, 3) float32 (rows beyond n_q are fine).
        n_q: (B,) int32 valid query counts.
        s_points: (B, C_s, 3) float32; n_s: (B,) int32.
        radius: search radius (= cell edge); k: neighbor capacity.
        cand_cap: a query's candidate capacity (its 27-cell population
            bound: an overflow is reported, not silently truncated).
        grid_cap: dense cell-table capacity (a flat nx ny nz bound).

    Returns:
        ((B, C_q, k) int32 indices into [0, C_s), sentinel C_s; overflow (B,)
        bool: a query's candidates exceed ``cand_cap`` or the cloud needs more
        than ``grid_cap`` cells).
    """
    support, starts, origin, dims, grid_overflow = _search_support(s_points, n_s, radius,
                                                                   grid_cap)
    table, counts = grid_radius_search(q_points.contiguous(), n_q, support, n_s, starts, origin,
                                       dims, radius, k, cand_cap)
    return table, (counts > cand_cap).any(dim=1) | grid_overflow


def _radius_search_cloud(q_points, n_q, s_points, n_s, radius, k):
    """Exact fixed-K radius KNN over every valid support row, B clouds; the
    (B, C_q, k) int32 table, sentinel C_s, self first for q == s."""
    bsz, cap_s, _ = s_points.shape
    s_valid = torch.arange(cap_s, device=s_points.device)[None, :] < n_s[:, None]
    index = torch.arange(cap_s, device=s_points.device, dtype=torch.float32)
    support = torch.cat([torch.where(s_valid[..., None], s_points, PAD_COORD),
                         index[None, :, None].expand(bsz, cap_s, 1)], dim=2)
    table, _ = grid_radius_search(q_points.contiguous(), n_q, support, n_s, None, None, None,
                                  radius, k, 0)
    return table


def _to_pair_frame(idx, cap_s):
    """(2, C_q, k) per-cloud indices (sentinel cap_s) -> the padded pair frame
    (sentinel 2 cap_s)."""
    cloud = torch.arange(idx.shape[0], device=idx.device, dtype=torch.int32)[:, None, None]
    return torch.where(idx == cap_s, 2 * cap_s, cloud * cap_s + idx).to(torch.int32)


def _pad_cols(table, sentinel, multiple=TABLE_ALIGN):
    """Pad a table's columns to ``multiple`` with ``sentinel``
    (:func:`..pyramid._pad_cols`)."""
    k = table.shape[-1]
    k_pad = -(-k // multiple) * multiple
    if k_pad == k:
        return table
    return torch.cat([table, table.new_full((table.shape[0], k_pad - k), sentinel)], dim=1)


def _pair_search(points_a, lengths_a, points_b, lengths_b, cap_a, cap_b, radius, k,
                 cand_cap=512, align=TABLE_ALIGN):
    """Radius KNN for both clouds of a pair in the padded pair frame:
    ``points_a`` (2, cap_a, 3) queries, ``points_b`` supports. The grid
    search for supports of at least ``_GRID_MIN_SUPPORT`` rows, else the
    brute search (the grid's fixed costs, the cell sort and the CSR cumsum,
    dominate below it, and brute force has no candidate capacity to
    overflow). Returns (table (2 cap_a, K padded) int32, overflow bool
    0-dim tensor; always False on the brute path)."""
    if cap_b >= _GRID_MIN_SUPPORT:
        idx, ovf = _radius_search_cloud_grid(points_a, lengths_a, points_b, lengths_b, radius,
                                             k, cand_cap=cand_cap)
        ovf = ovf.any()
    else:
        idx = _radius_search_cloud(points_a, lengths_a, points_b, lengths_b, radius, k)
        ovf = torch.zeros((), dtype=torch.bool, device=points_a.device)
    idx = _to_pair_frame(idx, cap_b).reshape(2 * cap_a, k)
    return _pad_cols(idx, 2 * cap_b, align), ovf


def build_inverse_table_device(table, num_support, j_cap):
    """The inverse of a padded neighbor table on the device, scatter-free: a
    stable sort of the edges by support (so each row lists its queries in
    ascending order, as :func:`..pyramid.build_inverse_table`), a
    ``searchsorted`` for each support's segment and a gather.

    Args:
        table: (M, H) int32, values in [0, num_support), sentinel >= it.
        num_support: support row count (and sentinel base).
        j_cap: in-degree capacity J.

    Returns:
        (inv (num_support, j_cap) int32 with sentinel M, overflow bool 0-dim).
    """
    m_rows, h = table.shape
    dev = table.device
    v = table.reshape(-1).to(torch.int32)
    q = torch.arange(m_rows, device=dev, dtype=torch.int32).repeat_interleave(h)
    v = torch.where(v < num_support, v, _INT_MAX)
    v_sorted, order = torch.sort(v, stable=True)
    q_sorted = q[order]
    starts = torch.searchsorted(
        v_sorted, torch.arange(num_support + 1, device=dev, dtype=torch.int32))
    deg = starts[1:] - starts[:-1]
    slot = torch.arange(j_cap, device=dev)
    pos = torch.clamp(starts[:-1, None] + slot[None, :], max=max(v.shape[0] - 1, 0))
    inv = torch.where(slot[None, :] < deg[:, None], q_sorted[pos], m_rows).to(torch.int32)
    return inv, (deg > j_cap).any()


def input_stream_device(table, points, feats):
    """The input conv's (5, M, H) edge stream of stage 0's neighbor table
    (:func:`..pyramid.build_input_stream`): offsets xyz, the flag of a
    neighbor whose features sum above 0, its feature."""
    tvalid = table < points.shape[0]
    idx = torch.where(tvalid, table, 0).long()
    off = torch.where(tvalid[..., None], points[idx] - points[:, None, :], 0.0)
    fsum = feats.sum(dim=1)
    flag = (tvalid & (fsum[idx] > 0.0)).to(torch.float32)
    featv = torch.where(tvalid, feats[idx, 0], 0.0)
    return torch.stack([off[..., 0], off[..., 1], off[..., 2], flag, featv], dim=0)


def build_pyramid_device(points, lengths, feats, transform, num_stages, voxel_size, radius,
                         neighbor_limits, stage_caps, inverse_limits=None,
                         sub_inverse_limits=None, knn_cand_cap=512, align=TABLE_ALIGN):
    """The whole fixed-capacity pyramid on the device of ``points``.

    Mirrors the host ``build_pyramid`` + ``pad_registration_batch``
    (reference collate: `utils/data.py:13-77`): stage 0 is the input,
    stages 1..S-1 are voxel means at doubling voxel size, and every
    neighbor, subsampling and upsampling table is an exact radius KNN at
    doubling radius. No host sync: the caps fix every shape.

    Args:
        points: (2 C_0, 3) float32 stage-0 points in the padded pair layout
            (ref rows [0, C_0), src rows [C_0, 2 C_0); padding re-masked from
            ``lengths``).
        lengths: (2,) int32 [ref_len, src_len].
        feats: (2 C_0, F) float32 padded stage-0 features.
        transform: (4, 4) float32.
        num_stages, voxel_size, radius, neighbor_limits, stage_caps: the
            pyramid spec (symmetric integer caps).
        inverse_limits, sub_inverse_limits: optional in-degree capacities:
            adds ``neighbors_inv`` and ``subsampling_inv`` as
            ``pad_registration_batch`` does; their overflows join the vector.
        knn_cand_cap: the grid search's candidate capacity.
        align: the neighbor, subsampling and upsampling tables' column
            alignment (``pyramid.table_align`` of the model's precision
            point; the JAX device build pads all three to it).

    Returns:
        (batch, overflow): ``batch`` has ``pad_registration_batch``'s keys
        (points, masks, lengths, neighbors, subsampling, upsampling,
        features, transform, the inverse tables when asked for, the
        ``input_stream`` when the features have width 1); ``overflow`` a
        (num_stages,) bool tensor, true where a stage's voxels, a search's
        candidates or grid, or an inverse table's in-degree exceeded its
        capacity (stage 0's voxels are the input's).
    """
    if len(neighbor_limits) != num_stages or len(stage_caps) != num_stages:
        raise ValueError(f"{num_stages} stages but {len(neighbor_limits)} neighbor limits and "
                         f"{len(stage_caps)} caps")
    cap0 = int(stage_caps[0])
    if points.shape[0] != 2 * cap0:
        raise ValueError(f"points have {points.shape[0]} rows, expected 2 x {cap0}")
    dev = points.device
    pts = points.reshape(2, cap0, 3).to(torch.float32)
    lengths = lengths.to(device=dev, dtype=torch.int32)
    valid0 = torch.arange(cap0, device=dev)[None, :] < lengths[:, None]
    pts = torch.where(valid0[..., None], pts, PAD_COORD)

    stage_pts, stage_lens = [pts], [lengths]
    no_overflow = torch.zeros((), dtype=torch.bool, device=dev)
    overflow = [no_overflow]
    # build_pyramid doubles the voxel after every stage, stage 0 included,
    # so stage i's subsample runs at voxel_size 2^i
    v = float(voxel_size) * 2.0
    for i in range(1, num_stages):
        sub, m, ov = _subsample_cloud(stage_pts[-1], stage_lens[-1], v, int(stage_caps[i]))
        stage_pts.append(sub)
        stage_lens.append(m)
        overflow.append(ov.any())
        v *= 2.0

    out = {"points": [], "masks": [], "lengths": [], "neighbors": [], "subsampling": [],
           "upsampling": []}
    r = float(radius)
    for i in range(num_stages):
        cap = int(stage_caps[i])
        out["points"].append(stage_pts[i].reshape(2 * cap, 3))
        out["masks"].append(
            (torch.arange(cap, device=dev)[None, :] < stage_lens[i][:, None]).reshape(2 * cap))
        out["lengths"].append(stage_lens[i])
        nbrs, ov = _pair_search(stage_pts[i], stage_lens[i], stage_pts[i], stage_lens[i], cap,
                                cap, r, int(neighbor_limits[i]), cand_cap=knn_cand_cap,
                                align=align)
        out["neighbors"].append(nbrs)
        overflow[i] = overflow[i] | ov
        if i < num_stages - 1:
            cap_sub = int(stage_caps[i + 1])
            sub, ov = _pair_search(stage_pts[i + 1], stage_lens[i + 1], stage_pts[i],
                                   stage_lens[i], cap_sub, cap, r, int(neighbor_limits[i]),
                                   cand_cap=knn_cand_cap, align=align)
            out["subsampling"].append(sub)
            up, ov2 = _pair_search(stage_pts[i], stage_lens[i], stage_pts[i + 1],
                                   stage_lens[i + 1], cap, cap_sub, r * 2.0,
                                   int(neighbor_limits[i + 1]), cand_cap=knn_cand_cap,
                                   align=align)
            out["upsampling"].append(up)
            overflow[i] = overflow[i] | ov | ov2
        r *= 2.0

    if inverse_limits is not None:
        if sub_inverse_limits is None:
            sub_inverse_limits = tuple(max(16, int(l) // 4 + 8) for l in inverse_limits[:-1])
        out["neighbors_inv"], out["subsampling_inv"] = [], []
        for i in range(num_stages):
            rows = out["neighbors"][i].shape[0]
            inv, ov = build_inverse_table_device(out["neighbors"][i], rows,
                                                 int(inverse_limits[i]))
            out["neighbors_inv"].append(_pad_cols(inv, rows))
            overflow[i] = overflow[i] | ov
            if i < num_stages - 1:
                inv, ov = build_inverse_table_device(out["subsampling"][i], rows,
                                                     int(sub_inverse_limits[i]))
                out["subsampling_inv"].append(_pad_cols(inv, out["subsampling"][i].shape[0]))
                overflow[i] = overflow[i] | ov

    out["features"] = torch.where(valid0.reshape(2 * cap0)[:, None],
                                  feats.to(device=dev, dtype=torch.float32), 0.0)
    if out["features"].shape[1] == 1:
        out["input_stream"] = input_stream_device(out["neighbors"][0], out["points"][0],
                                                  out["features"])
    out["transform"] = transform.to(device=dev, dtype=torch.float32)
    return out, torch.stack(overflow)


class DevicePreprocessPlan:
    """The raw device-preprocess mode's plan: the static pyramid spec of each
    capacity bucket (ascending) and the overflow policy the trainer, the
    tester and the loader share. The loader only pads raw points
    (:func:`pad_stage0`, a copy) and the step builds the pyramid on the card
    (:func:`build_pyramid_device`), in place of the reference's in-worker CPU
    collate (`utils/data.py:13-77`).

    Args:
        cfg: GeoTransformerConfig (symmetric integer stage caps: the device
            build lays both clouds out at one capacity).
        buckets: optional ascending list of whole-pyramid cap tuples
            (``calibrate_stage_cap_buckets``); default [cfg caps]. Stage-0
            capacities must be strictly increasing, so that a raw batch's
            shape names its bucket.
        with_inverse: build the inverse neighbor tables (training batches).
        overflow_policy: 'raise' (the default), 'escalate' (retry the group
            at the next bucket; past the last bucket, raise) or 'host' (the
            host pyramid, which then does the kernels' work on the CPU: only
            when asked for by name).
    """

    def __init__(self, cfg, buckets=None, with_inverse=False, overflow_policy="raise"):
        if overflow_policy not in ("escalate", "host", "raise"):
            raise ValueError(f"unknown overflow_policy {overflow_policy!r}")
        if buckets is None:
            buckets = [tuple(cfg.caps.stage_caps)]
        for bucket in buckets:
            if any(isinstance(c, (tuple, list)) for c in bucket):
                raise ValueError(
                    f"device preprocessing requires symmetric integer stage caps (got {bucket}); "
                    "asymmetric (ref, src) caps are a host-pipeline feature")
        cap0s = [int(b[0]) for b in buckets]
        if sorted(set(cap0s)) != cap0s:
            raise ValueError(f"bucket stage-0 capacities must be strictly increasing (got "
                             f"{cap0s}): a raw batch's shape must identify its bucket")
        self.cfg = cfg
        self.buckets = [tuple(int(c) for c in b) for b in buckets]
        self.with_inverse = with_inverse
        self.overflow_policy = overflow_policy

    @property
    def num_stages(self):
        return self.cfg.backbone.num_stages

    def spec(self, bucket_index, with_inverse=None):
        """Keyword arguments of :func:`build_pyramid_device` at a bucket."""
        cfg = self.cfg
        if with_inverse is None:
            with_inverse = self.with_inverse
        return dict(
            num_stages=cfg.backbone.num_stages,
            voxel_size=cfg.backbone.init_voxel_size,
            radius=cfg.backbone.init_radius,
            neighbor_limits=tuple(cfg.caps.neighbor_limits),
            stage_caps=self.buckets[bucket_index],
            inverse_limits=tuple(cfg.caps.inverse_limits) if with_inverse else None,
        )

    def bucket_for_lengths(self, ref_len, src_len):
        """The smallest bucket whose stage-0 capacity holds both raw clouds
        (deeper stages overflow on the card and escalate)."""
        need = max(int(ref_len), int(src_len))
        for i, b in enumerate(self.buckets):
            if need <= b[0]:
                return i
        raise ValueError(f"cloud sizes ({ref_len}, {src_len}) exceed the largest bucket's "
                         f"stage-0 capacity {self.buckets[-1][0]}")

    def bucket_for_cap0(self, cap0):
        """The bucket of a raw batch's stage-0 capacity (its rows // 2)."""
        for i, b in enumerate(self.buckets):
            if b[0] == cap0:
                return i
        raise ValueError(f"no bucket with stage-0 capacity {cap0}")

    def next_bucket(self, bucket_index):
        """The next (larger) bucket, or None at the top."""
        return bucket_index + 1 if bucket_index + 1 < len(self.buckets) else None

    def run(self, group, bucket, run_bucket, run_host, warn=None):
        """A group of raw batches through ``run_bucket(bucket, group) ->
        (result, overflowed)`` from ``bucket`` on, by the overflow policy:
        the next bucket ('escalate'), ``run_host(host group)`` ('host'), or
        a RuntimeError ('raise', and 'escalate' past the last bucket). An
        overflowed try must have run nothing past the build, so a retry is
        exact. Returns (result, overflowed tries, whether the host ran it);
        ``warn`` takes a message a retry."""
        tries = 0
        while True:
            result, overflowed = run_bucket(bucket, group)
            if not overflowed:
                return result, tries, False
            tries += 1
            if self.overflow_policy == "host":
                break
            nxt = self.next_bucket(bucket) if self.overflow_policy == "escalate" else None
            if nxt is None:
                raise RuntimeError(
                    f"device pyramid stage-capacity overflow at bucket {bucket} of "
                    f"{len(self.buckets)} (overflow_policy={self.overflow_policy!r}); "
                    "recalibrate caps/buckets, or ask for overflow_policy='host'")
            if warn is not None:
                warn(f"device pyramid overflow at bucket {bucket}; escalating to bucket {nxt}")
            group = [self.repad_raw(b, nxt) for b in group]
            bucket = nxt
        if warn is not None:
            warn("device pyramid overflow: the host pyramid (overflow_policy='host'); "
                 "consider recalibrating the buckets")
        return run_host(self.host_group(group)), tries, True

    def repad_raw(self, raw_batch, bucket_index):
        """A raw batch laid into a larger bucket's stage-0 frame (a copy; for
        a group that overflowed)."""
        pts, feats, lengths = _unpad_raw(raw_batch)
        cap0 = self.buckets[bucket_index][0]
        out = dict(raw_batch)
        out["raw_points"], out["raw_lengths"], new_feats = pad_stage0(
            pts, lengths, cap0, feats.shape[1])
        ref_len = int(lengths[0])
        new_feats[:ref_len] = feats[:ref_len]
        new_feats[cap0:cap0 + int(lengths[1])] = feats[ref_len:]
        out["raw_feats"] = new_feats
        return out

    def host_group(self, raw_group, cap_multiple=256):
        """The host pyramid for a group of raw batches (policy 'host'). The device and host builds agree on
        the voxel counts, so a pair that overflowed the largest bucket on
        the card overflows it here too: the group pads to the elementwise
        max of the largest bucket and its pairs' sizes rounded up to
        ``cap_multiple``, one caps tuple for the whole group."""
        spec = self.spec(len(self.buckets) - 1)
        unpacked = []
        for raw_batch in raw_group:
            pts, feats, lengths = _unpad_raw(raw_batch)
            pyramid = build_pyramid(pts, lengths, spec["num_stages"], spec["voxel_size"],
                                    spec["radius"], list(spec["neighbor_limits"]))
            unpacked.append((raw_batch, pyramid, feats))
        caps = list(spec["stage_caps"])
        for _, pyramid, _ in unpacked:
            fit = caps_for_pyramid(pyramid, multiple=cap_multiple, per_cloud=False)
            caps = [max(a, int(b)) for a, b in zip(caps, fit)]
        out = []
        for raw_batch, pyramid, feats in unpacked:
            batch = pad_registration_batch(pyramid, feats, np.asarray(raw_batch["transform"]),
                                           tuple(caps), inverse_limits=spec["inverse_limits"],
                                           align=table_align(self.cfg.precision))
            if "meta" in raw_batch:
                batch["meta"] = raw_batch["meta"]
            out.append(batch)
        return out

    def host_batch(self, raw_batch, cap_multiple=256):
        """:meth:`host_group` of one pair."""
        return self.host_group([raw_batch], cap_multiple)[0]


def _unpad_raw(raw_batch):
    """(stacked points, stacked features, lengths) of a raw batch, as numpy."""
    raw_points = _numpy(raw_batch["raw_points"])
    raw_feats = _numpy(raw_batch["raw_feats"])
    lengths = _numpy(raw_batch["raw_lengths"])
    cap0 = raw_points.shape[0] // 2
    ref_len, src_len = int(lengths[0]), int(lengths[1])
    pts = np.concatenate([raw_points[:ref_len], raw_points[cap0:cap0 + src_len]], axis=0)
    feats = np.concatenate([raw_feats[:ref_len], raw_feats[cap0:cap0 + src_len]], axis=0)
    return pts, feats, lengths


def _numpy(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def prepare_raw_pair(sample, cap0, input_dim=1):
    """The loader's raw-mode prepare: a copy into the stage-0 frame, no
    pyramid work (that runs on the card inside the step). Scalar sample
    fields go to ``meta``."""
    ref_points = np.asarray(sample["ref_points"], np.float32)
    src_points = np.asarray(sample["src_points"], np.float32)
    points = np.concatenate([ref_points, src_points], axis=0)
    lengths = np.asarray([len(ref_points), len(src_points)])
    pts0, lens0, feats0 = pad_stage0(points, lengths, cap0, input_dim)
    if "ref_feats" in sample:
        feats0[:lengths[0]] = np.asarray(sample["ref_feats"], np.float32)
        feats0[cap0:cap0 + lengths[1]] = np.asarray(sample["src_feats"], np.float32)
    return {
        "raw_points": pts0,
        "raw_lengths": lens0,
        "raw_feats": feats0,
        "transform": np.asarray(sample.get("transform", np.eye(4)), np.float32),
        "meta": {k: v for k, v in sample.items() if isinstance(v, (str, int, float))},
    }


def pad_stage0(points, lengths, cap0, feat_dim=1):
    """Stacked ref + src points laid into the stage-0 frame of
    :func:`build_pyramid_device` (a copy, not preprocessing): (points
    (2 cap0, 3) PAD_COORD-padded, lengths (2,) int32, features (2 cap0,
    feat_dim) ones on valid rows)."""
    lengths = np.asarray(lengths)
    ref_len, src_len = int(lengths[0]), int(lengths[1])
    if max(ref_len, src_len) > cap0:
        raise ValueError(f"cloud sizes ({ref_len}, {src_len}) exceed stage-0 capacity {cap0}")
    out = np.full((2 * cap0, 3), PAD_COORD, np.float32)
    out[:ref_len] = points[:ref_len]
    out[cap0:cap0 + src_len] = points[ref_len:ref_len + src_len]
    feats = np.zeros((2 * cap0, feat_dim), np.float32)
    feats[:ref_len] = 1.0
    feats[cap0:cap0 + src_len] = 1.0
    return out, np.asarray([ref_len, src_len], np.int32), feats
