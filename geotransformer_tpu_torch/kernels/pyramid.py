r"""The on-device pyramid build's two hot loops: the CUDA kernels
(``csrc/pyramid.cu``) and their plain PyTorch versions.

Neither replaces a Pallas kernel. They replace the XLA loops of
``geotransformer_tpu/preprocess/device.py`` that dominate its cost
(its HONEST COST note, :29-36): the radius search's per-query candidate
gathers and exact (d^2, index) sorts, and the voxel subsample's segment
mean. :mod:`geotransformer_tpu_torch.preprocess.device` builds everything
around them with PyTorch operations.

``grid_radius_search`` takes a query row's candidates from the nine x-runs
of its 27 neighbouring cells in the cell-sorted support (``starts=None``:
every valid support row), keeps those within the radius and returns the K
best by the lexicographic (d^2, original index) key. d^2 is the direct
coordinate difference, each product and sum rounded on its own, on both
routes, so the two agree bit for bit. ``voxel_segment_mean`` averages the
rows of each voxel of points already sorted by voxel key; the kernel adds a
voxel's rows in sorted order (the plain version's ``index_add_`` does so on
the CPU, with atomics on the card).
"""

import collections
import ctypes

import numpy as np
import torch

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.kernels.sinkhorn import device_block_bytes

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "grid_radius_search_launch": [_P] * 10 + [_I] * 9 + [_F, _F, _P],
    "voxel_segment_mean_launch": [_P] * 5 + [_I] * 3 + [_F, _P],
}
PAD_COORD = 1.0e6
_KEY_NONE = torch.iinfo(torch.int64).max
_KEY_BYTES = 8
_SEARCH_CHUNK = 1024  # csrc/pyramid.cu's kSearchChunk

# The search's instance: ``warps`` warps a block, each holding its query's
# whole key list in shared memory (``chunk`` 0), or ``chunk`` keys of it at
# a time, merged into the K best in a device-memory workspace.
SearchRoute = collections.namedtuple("SearchRoute", "warps chunk")


def search_route(cand_cap, cs, brute, block_bytes):
    """The route ``csrc/pyramid.cu`` takes for a candidate capacity
    ``cand_cap`` (the brute search: ``cs`` support rows), as
    ``grid_radius_search_launch`` checks it: the most warps up to 4 whose
    whole key lists of 8-byte keys fit a block's ``block_bytes`` (every
    shipped bucket; up to ~29,000 candidates), else 4 warps of 1,024-key
    chunks."""
    keys = cs if brute else cand_cap
    warps = 4
    while warps > 1 and _KEY_BYTES * keys * warps > block_bytes:
        warps -= 1
    if _KEY_BYTES * keys * warps <= block_bytes:
        return SearchRoute(warps, 0)
    return SearchRoute(4, _SEARCH_CHUNK)


def _search_constants(radius, device):
    """The cell edge as a 0-dim float32 tensor on ``device`` (a divisor that
    is a tensor there: PyTorch turns a division by a Python scalar into a
    product with its reciprocal on the card) and r^2 = f32(r) f32(r)."""
    r = np.float32(radius)
    return torch.full((), float(r), dtype=torch.float32, device=device), float(r * r)


def _run_cells(q, origin, dims, grid_cap, edge):
    """The CSR starts entries (first, one past the last) of the nine x-runs
    of each query's 27 cells: (B, c, 9) int32 each, dz outer and dy inner
    (device.py:270-290); a run off the grid reads entry 0 twice."""
    cq = torch.floor((q - origin[:, None, :]) / edge).to(torch.int32)  # (B, c, 3)
    nx, ny, nz = (dims[:, i, None] for i in range(3))
    firsts, ends = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cy, cz = cq[..., 1] + dy, cq[..., 2] + dz
            row_ok = (cy >= 0) & (cy < ny) & (cz >= 0) & (cz < nz)
            x0 = torch.minimum(torch.clamp(cq[..., 0] - 1, min=0), nx)
            x1 = torch.minimum(torch.maximum(cq[..., 0] + 2, x0), nx)
            base = nx * (torch.where(row_ok, cy, 0) + ny * torch.where(row_ok, cz, 0))
            a = torch.clamp(torch.where(row_ok, base + x0, 0), 0, grid_cap)
            b = torch.minimum(torch.maximum(torch.where(row_ok, base + x1, 0), a),
                              torch.full_like(a, grid_cap))
            firsts.append(a)
            ends.append(b)
    return torch.stack(firsts, dim=-1), torch.stack(ends, dim=-1)


def _runs(q, origin, dims, starts, grid_cap, edge):
    """(first sorted row, length) of the nine x-runs of each query's 27
    cells: (B, c, 9) each, as :func:`_run_cells` orders them."""
    a, b = _run_cells(q, origin, dims, grid_cap, edge)
    lo = torch.gather(starts, 1, a.reshape(a.shape[0], -1).long()).view(a.shape)
    hi = torch.gather(starts, 1, b.reshape(b.shape[0], -1).long()).view(b.shape)
    return lo, hi - lo


def grid_radius_search_plain(queries, q_lengths, support, s_lengths, starts, origin, dims,
                             radius, k, cand_cap, chunk=1024):
    """Plain PyTorch version of :func:`grid_radius_search`, ``chunk`` query
    rows at a time (bounds the (B, chunk, cand_cap) candidate set)."""
    bsz, cq_rows, _ = queries.shape
    cs = support.shape[1]
    dev = queries.device
    edge, r2 = _search_constants(radius, dev)
    brute = starts is None
    n_s = torch.clamp(s_lengths.to(torch.int32), 0, cs)
    width = cs if brute else cand_cap
    k_eff = min(k, width)
    flat_support = support.reshape(-1, 4)
    tables, counts = [], []
    for c0 in range(0, cq_rows, chunk):
        q = queries[:, c0:c0 + chunk]
        c = q.shape[1]
        w = torch.arange(width, device=dev, dtype=torch.int32)
        if brute:
            total = n_s[:, None].expand(bsz, c)
            slot_ok = (w < n_s[:, None, None]).expand(bsz, c, width)
            cand = support[:, None, :, :]  # (B, 1, Cs, 4)
        else:
            lo9, len9 = _runs(q, origin, dims, starts, starts.shape[1] - 1, edge)
            offs = torch.cumsum(len9, dim=-1, dtype=torch.int32) - len9
            total = offs[..., -1] + len9[..., -1]
            pos = torch.zeros((bsz, c, width), dtype=torch.int32, device=dev)
            for j in range(9):
                off, ln, lo = offs[..., j:j + 1], len9[..., j:j + 1], lo9[..., j:j + 1]
                pos = torch.where((off <= w) & (w < off + ln), lo + (w - off), pos)
            slot_ok = w < total[..., None]
            pos = torch.clamp(torch.where(slot_ok, pos, 0), 0, cs - 1)
            rows = pos.long() + (torch.arange(bsz, device=dev) * cs)[:, None, None]
            cand = flat_support[rows.reshape(-1)].view(bsz, c, width, 4)
        d = cand[..., :3] - q[:, :, None, :]
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        keep = slot_ok & (d2 <= r2)
        key = (d2.view(torch.int32).to(torch.int64) << 32) | cand[..., 3].to(torch.int64)
        key = torch.where(keep, key, _KEY_NONE)
        best = torch.topk(key, k_eff, dim=-1, largest=False, sorted=True).values
        found = torch.where(best != _KEY_NONE, (best & 0xFFFFFFFF).to(torch.int32), cs)
        if k_eff < k:
            found = torch.cat([found, found.new_full((bsz, c, k - k_eff), cs)], dim=-1)
        tables.append(found)
        counts.append(total.to(torch.int32))
    if not tables:  # no query rows
        tables.append(torch.zeros((bsz, 0, k), dtype=torch.int32, device=dev))
        counts.append(torch.zeros((bsz, 0), dtype=torch.int32, device=dev))
    table, count = torch.cat(tables, dim=1), torch.cat(counts, dim=1)
    q_valid = torch.arange(cq_rows, device=dev)[None, :] < q_lengths[:, None]
    return torch.where(q_valid[..., None], table, cs).to(torch.int32), count.contiguous()


def grid_radius_search(queries, q_lengths, support, s_lengths, starts, origin, dims, radius, k,
                       cand_cap, force=None):
    """Exact fixed-K radius search of B clouds at once.

    Args:
        queries: (B, Cq, 3) float32 query rows; rows at or past
            ``q_lengths`` get the sentinel row.
        q_lengths: (B,) int32 valid query rows.
        support: (B, Cs, 4) float32 support rows [x, y, z, original index]:
            sorted by cell for the grid search, as they are (the index their
            row) with ``starts=None``.
        s_lengths: (B,) int32 valid support rows (the brute search's
            candidates: the first ``s_lengths`` rows).
        starts: (B, G + 1) int32 CSR starts of the cell-sorted support over
            the flat cell id, or None for the brute search.
        origin: (B, 3) float32 grid origins; dims: (B, 3) int32 cells per
            axis (both unused by the brute search).
        radius: search radius, the cell edge.
        k: neighbors a row.
        cand_cap: a query's candidate capacity (the grid search takes the
            first ``cand_cap`` slots of its runs). Any capacity: past a
            block's key lists the kernel keeps a running K best
            (:func:`search_route`).
        force: ``ModelConfig.force_pallas`` (see :func:`cuda.use_kernel`).

    Returns:
        table (B, Cq, k) int32 original indices, by (d^2, index), sentinel
        Cs; counts (B, Cq) int32 each query's 27-cell population (the
        brute search: the valid support rows).
    """
    if not cuda.use_kernel(queries, force):
        return grid_radius_search_plain(queries, q_lengths, support, s_lengths, starts, origin,
                                        dims, radius, k, cand_cap)
    dev = queries.device
    bsz, cq_rows, _ = queries.shape
    cs = support.shape[1]
    brute = starts is None
    cuda.require(queries, "queries", torch.float32, (bsz, cq_rows, 3), dev)
    cuda.require(q_lengths, "q_lengths", torch.int32, (bsz,), dev)
    cuda.require(support, "support", torch.float32, (bsz, cs, 4), dev)
    cuda.require(s_lengths, "s_lengths", torch.int32, (bsz,), dev)
    grid = 0
    if not brute:
        grid = starts.shape[1] - 1
        cuda.require(starts, "starts", torch.int32, (bsz, grid + 1), dev)
        cuda.require(origin, "origin", torch.float32, (bsz, 3), dev)
        cuda.require(dims, "dims", torch.int32, (bsz, 3), dev)
    edge = np.float32(radius)
    out = torch.empty((bsz, cq_rows, k), dtype=torch.int32, device=dev)
    counts = torch.empty((bsz, cq_rows), dtype=torch.int32, device=dev)
    route = search_route(cand_cap, cs, brute, device_block_bytes(dev))
    best = (torch.empty((bsz * cq_rows * 2 * k,), dtype=torch.int64, device=dev)
            if route.chunk else None)
    lib = cuda.library("pyramid", _SIGNATURES)
    code = lib.grid_radius_search_launch(
        cuda.ptr(queries), cuda.ptr(q_lengths), cuda.ptr(support), cuda.ptr(s_lengths),
        cuda.ptr(starts), cuda.ptr(origin), cuda.ptr(dims), cuda.ptr(out), cuda.ptr(counts),
        cuda.ptr(best), bsz, cq_rows, cs, grid, k, cand_cap, int(brute), route.warps, route.chunk,
        float(edge), float(edge * edge), cuda.stream_of(queries))
    cuda.check(lib, code, "grid_radius_search")
    cuda.launches["grid_radius_search"] += 1
    return out, counts


def voxel_segment_mean_plain(points, seg, voxels, cap_out):
    """Plain PyTorch version of :func:`voxel_segment_mean`."""
    bsz, c, _ = points.shape
    dev = points.device
    bins = cap_out + 1  # the last bin takes the padding rows and the voxels past the cap
    ok = (seg >= 0) & (seg < cap_out)
    flat = (torch.where(ok, seg, cap_out).long()
            + (torch.arange(bsz, device=dev) * bins)[:, None]).reshape(-1)
    sums = torch.zeros((bsz * bins, 3), dtype=torch.float32, device=dev).index_add_(
        0, flat, points.reshape(-1, 3))
    counts = torch.zeros(bsz * bins, dtype=torch.int32, device=dev).index_add_(
        0, flat, torch.ones(flat.shape[0], dtype=torch.int32, device=dev))
    sums = sums.view(bsz, bins, 3)[:, :cap_out]
    counts = counts.view(bsz, bins)[:, :cap_out]
    means = sums / torch.clamp(counts, min=1).to(torch.float32)[..., None]
    inside = torch.arange(cap_out, device=dev)[None, :] < voxels[:, None]
    return (torch.where(inside[..., None], means, PAD_COORD),
            torch.where(inside, counts, 0).to(torch.int32))


def voxel_segment_mean(points, seg, voxels, cap_out, force=None):
    """Mean of each voxel's rows of points sorted by voxel key, B clouds.

    Args:
        points: (B, C, 3) float32 points sorted by voxel key.
        seg: (B, C) int32 each row's voxel (0, 1, ... in row order; -1 on
            padding rows); voxels at or past ``cap_out`` are dropped.
        voxels: (B,) int32 voxel counts.
        cap_out: output rows a cloud.
        force: ``ModelConfig.force_pallas`` (see :func:`cuda.use_kernel`).

    Returns:
        means (B, cap_out, 3) float32, PAD_COORD past the voxel count;
        counts (B, cap_out) int32 rows a voxel, 0 past the voxel count.
    """
    if not cuda.use_kernel(points, force):
        return voxel_segment_mean_plain(points, seg, voxels, cap_out)
    dev = points.device
    bsz, c, _ = points.shape
    cuda.require(points, "points", torch.float32, (bsz, c, 3), dev)
    cuda.require(seg, "seg", torch.int32, (bsz, c), dev)
    cuda.require(voxels, "voxels", torch.int32, (bsz,), dev)
    out = torch.empty((bsz, cap_out, 3), dtype=torch.float32, device=dev)
    counts = torch.empty((bsz, cap_out), dtype=torch.int32, device=dev)
    lib = cuda.library("pyramid", _SIGNATURES)
    code = lib.voxel_segment_mean_launch(
        cuda.ptr(points), cuda.ptr(seg), cuda.ptr(voxels), cuda.ptr(out), cuda.ptr(counts), bsz,
        c, cap_out, PAD_COORD, cuda.stream_of(points))
    cuda.check(lib, code, "voxel_segment_mean")
    cuda.launches["voxel_segment_mean"] += 1
    return out, counts
