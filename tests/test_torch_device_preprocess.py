"""The port's device pyramid (``preprocess/device.py``) against the JAX
package's, on the CPU, where the two kernels (``kernels/pyramid.py``) run
their plain versions.

The same numpy inputs, made from a seed, go through both packages at the
JAX tests' small sizes (tests/test_device_preprocess.py). Tolerances:

  * voxel subsample: counts and masks exact, points within 1e-6 (the JAX
    sort of the voxel keys is not stable, so a voxel's points may be added
    in another order);
  * grid-binned radius search: bit for bit, with the overflow flag: both
    take d^2 from the direct coordinate difference and order by (d^2,
    index). In the jitted JAX build XLA turns the division by the cell
    edge into a product with its reciprocal, so there a neighbour within
    rounding of the radius may be missed by one side (under 0.2 % of rows);
  * brute search (supports under 2048 rows): the JAX path takes the
    expanded |q|^2 - 2 q.s + |s|^2, the port the direct difference, so rows
    are equal as sets where distances tie (at most 5 % of rows);
  * inverse tables exact (exact where the forward tables are);
  * against the port's host pyramid (float64 voxel means, cKDTree): points
    within 1e-4, tables equal except rows whose distances tie.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax.numpy as jnp

from geotransformer_tpu.preprocess import device as jax_device

from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.kernels import pyramid as kernels_pyramid
from geotransformer_tpu_torch.configs import make_3dmatch_config
from geotransformer_tpu_torch.preprocess import (
    DevicePreprocessPlan,
    build_pyramid,
    pad_registration_batch,
)
from geotransformer_tpu_torch.preprocess import device as port_device
from geotransformer_tpu_torch.preprocess.calibrate import cell_populations
from geotransformer_tpu_torch.preprocess.neighbors import radius_search
from geotransformer_tpu_torch.preprocess.voxel import grid_subsample_single
from torch_routes import numpy_pyramids  # noqa: F401  (both packages on numpy)

I32 = torch.int32


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the tier-1 run shares the cores among its
    workers, where more threads a worker only add to the total CPU time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def make_cloud(rng, n, lo=-2.0, hi=3.0):
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


def padded(points, cap):
    out = np.full((cap, 3), 1e6, np.float32)
    out[:len(points)] = points
    return out


def port_subsample(points, n, voxel, cap_out):
    out, m, ov = port_device._subsample_cloud(torch.from_numpy(points)[None],
                                              torch.tensor([n], dtype=I32), voxel, cap_out)
    return out[0].numpy(), int(m[0]), bool(ov[0])


def port_grid(q, n_q, s, n_s, radius, k, cand_cap):
    table, ovf = port_device._radius_search_cloud_grid(
        torch.from_numpy(q)[None], torch.tensor([n_q], dtype=I32), torch.from_numpy(s)[None],
        torch.tensor([n_s], dtype=I32), radius, k, cand_cap=cand_cap)
    return table[0].numpy(), bool(ovf[0])


def jax_grid(q, n_q, s, n_s, radius, k, cand_cap):
    table, ovf = jax_device._radius_search_cloud_grid(
        jnp.asarray(q), jnp.int32(n_q), jnp.asarray(s), jnp.int32(n_s), radius, k,
        cand_cap=cand_cap, block=128)
    return np.asarray(table), bool(ovf)


def tie_rows(got, want, q_points, s_points, sentinel, radius):
    """Rows where ``got`` and ``want`` differ; each must list the same
    neighbours up to distance ties: the same sorted distances within float32
    rounding, a neighbour missing on one side lying within rounding of the
    radius (of the K-th neighbour when the row is full). Returns the rows."""
    rows = np.nonzero(~np.all(got == want, axis=1))[0]
    for i in rows:
        def dists(row):
            idx = row[row != sentinel]
            return np.sort(np.sum((s_points[idx].astype(np.float64)
                                   - q_points[i].astype(np.float64)) ** 2, axis=1))
        a, b = dists(got[i]), dists(want[i])
        n = min(len(a), len(b))
        np.testing.assert_allclose(a[:n], b[:n], rtol=1e-5, atol=1e-9)
        extra = np.concatenate([a[n:], b[n:]])
        assert np.all(np.abs(extra - radius ** 2) <= 1e-5 * radius ** 2), (i, extra)
    return rows


def untied_supports(got, want, rows, num_supports):
    """The supports that no tied row of two forward tables names: their
    inverse-table rows must be equal."""
    named = np.unique(np.concatenate([got[rows].ravel(), want[rows].ravel()]))
    keep = np.ones(num_supports, bool)
    keep[named[named < num_supports]] = False
    return keep


class TestSubsample:
    def test_matches_jax_and_host(self, rng):
        pts = make_cloud(rng, 900)
        got, m, ov = port_subsample(padded(pts, 1024), 900, 0.3, 1024)
        want, m_j, ov_j = jax_device._subsample_cloud(jnp.asarray(padded(pts, 1024)),
                                                      jnp.int32(900), 0.3, 1024)
        assert (m, ov) == (int(m_j), bool(ov_j)) and not ov
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=0)
        assert np.all(got[m:] == 1e6)
        host = grid_subsample_single(pts, 0.3)  # the host's voxel order, float64 means
        assert m == host.shape[0]
        np.testing.assert_allclose(got[:m], host, atol=1e-4)

    def test_overflow_flag(self, rng):
        pts = padded(make_cloud(rng, 500), 512)
        _, m, ov = port_subsample(pts, 500, 0.05, 64)
        _, m_j, ov_j = jax_device._subsample_cloud(jnp.asarray(pts), jnp.int32(500), 0.05, 64)
        assert ov and bool(ov_j) and m == int(m_j) > 64

    def test_empty_cloud(self):
        got, m, ov = port_subsample(np.full((64, 3), 1e6, np.float32), 0, 0.3, 32)
        assert m == 0 and not ov and np.all(got == 1e6)

    def test_single_voxel(self):
        pts = np.full((64, 3), 1e6, np.float32)
        pts[:7] = 0.05
        got, m, ov = port_subsample(pts, 7, 0.2, 32)
        want, _, _ = jax_device._subsample_cloud(jnp.asarray(pts), jnp.int32(7), 0.2, 32)
        assert m == 1 and not ov
        np.testing.assert_allclose(got[0], [0.05] * 3, atol=1e-6)
        np.testing.assert_array_equal(got, np.asarray(want))

    def test_two_clouds_at_once_equal_each_alone(self, rng):
        a, b = padded(make_cloud(rng, 700), 768), padded(make_cloud(rng, 500, 0, 1), 768)
        out, m, ov = port_device._subsample_cloud(torch.from_numpy(np.stack([a, b])),
                                                  torch.tensor([700, 500], dtype=I32), 0.25, 512)
        for i, (pts, n) in enumerate(((a, 700), (b, 500))):
            alone, m_i, ov_i = port_subsample(pts, n, 0.25, 512)
            np.testing.assert_array_equal(out[i].numpy(), alone)
            assert (int(m[i]), bool(ov[i])) == (m_i, ov_i)

    def test_segment_mean_adds_each_voxel_in_row_order(self, rng):
        """The plain version's arithmetic is the kernel's: each voxel's rows
        summed in row order from 0 in float32, then one division."""
        pts = rng.normal(size=(1, 300, 3)).astype(np.float32) * 50
        seg = np.sort(rng.integers(0, 40, 300)).astype(np.int32)[None]
        seg[0, -20:] = -1
        voxels = np.asarray([int(seg.max()) + 1], np.int32)
        means, counts = kernels_pyramid.voxel_segment_mean(
            torch.from_numpy(pts), torch.from_numpy(seg), torch.from_numpy(voxels), 48)
        for v in range(48):
            rows = np.nonzero(seg[0] == v)[0]
            if v >= voxels[0]:
                assert np.all(means[0, v].numpy() == 1e6) and counts[0, v] == 0
                continue
            total = np.zeros(3, np.float32)
            for r in rows:
                total = (total + pts[0, r]).astype(np.float32)
            want = total / np.float32(max(len(rows), 1))
            np.testing.assert_array_equal(means[0, v].numpy(), want)
            assert counts[0, v] == len(rows)


class TestGridSearch:
    def test_matches_jax_bit_for_bit_and_host(self, rng):
        q, s = make_cloud(rng, 300, 0, 1), make_cloud(rng, 500, 0, 1)
        qp, sp = padded(q, 384), padded(s, 512)
        got, ovf = port_grid(qp, 300, sp, 500, 0.15, 16, 256)
        want, ovf_j = jax_grid(qp, 300, sp, 500, 0.15, 16, 256)
        assert not ovf and not ovf_j
        np.testing.assert_array_equal(got, want)
        host = radius_search(q, s, [300], [500], 0.15, 16)
        np.testing.assert_array_equal(got[:300], np.where(host == 500, 512, host))
        assert np.all(got[300:] == 512)

    def test_k_above_32_matches_jax(self, rng):
        """KITTI's K = 65 (a row's 65 best of up to ~100 in radius)."""
        pts = make_cloud(rng, 2000, 0, 1)
        pp = padded(pts, 2048)
        got, ovf = port_grid(pp, 2000, pp, 2000, 0.2, 65, 640)
        want, ovf_j = jax_grid(pp, 2000, pp, 2000, 0.2, 65, 640)
        assert not ovf and not ovf_j
        np.testing.assert_array_equal(got, want)
        assert (got[:2000] < 2048).sum(axis=1).max() == 65

    def test_self_first_and_empty(self, rng):
        pts = padded(make_cloud(rng, 200, 0, 1), 256)
        got, ovf = port_grid(pts, 200, pts, 200, 0.3, 8, 256)
        want, _ = jax_grid(pts, 200, pts, 200, 0.3, 8, 256)
        assert not ovf
        np.testing.assert_array_equal(got[:200, 0], np.arange(200))
        np.testing.assert_array_equal(got, want)
        got, ovf = port_grid(pts, 200, pts, 0, 0.3, 8, 64)  # an empty support cloud
        assert not ovf and np.all(got == 256)

    def test_candidate_overflow_flag(self, rng):
        pts = padded(rng.uniform(0, 0.09, (300, 3)).astype(np.float32), 320)
        got, ovf = port_grid(pts, 300, pts, 300, 0.1, 8, 64)
        want, ovf_j = jax_grid(pts, 300, pts, 300, 0.1, 8, 64)
        assert ovf and ovf_j
        np.testing.assert_array_equal(got, want)  # the first 64 candidates, as JAX

    def test_counts_are_the_host_cell_populations(self, rng):
        """The kernel's per-query counts equal the host calibration's 27-cell
        populations (calibrate.cell_populations)."""
        q, s = make_cloud(rng, 300, 0, 1), make_cloud(rng, 500, 0, 1)
        support, starts, origin, dims, _ = port_device._search_support(
            torch.from_numpy(padded(s, 512))[None], torch.tensor([500], dtype=I32), 0.15, 1 << 20)
        _, counts = kernels_pyramid.grid_radius_search(
            torch.from_numpy(padded(q, 384))[None], torch.tensor([300], dtype=I32), support,
            torch.tensor([500], dtype=I32), starts, origin, dims, 0.15, 16, 256)
        np.testing.assert_array_equal(counts[0, :300].numpy(), cell_populations(q, s, 0.15))


class TestBruteSearch:
    def test_matches_jax_as_sets_on_ties(self, rng):
        q, s = make_cloud(rng, 300, 0, 1), make_cloud(rng, 500, 0, 1)
        qp, sp = padded(q, 384), padded(s, 512)
        got = port_device._radius_search_cloud(
            torch.from_numpy(qp)[None], torch.tensor([300], dtype=I32),
            torch.from_numpy(sp)[None], torch.tensor([500], dtype=I32), 0.15, 16)[0].numpy()
        want = np.asarray(jax_device._radius_search_cloud(
            jnp.asarray(qp), jnp.int32(300), jnp.asarray(sp), jnp.int32(500), 0.15, 16,
            block=128))
        assert len(tie_rows(got, want, qp, sp, 512, 0.15)) <= 2
        assert np.all(got[300:] == 512)
        host = radius_search(q, s, [300], [500], 0.15, 16)
        assert len(tie_rows(got[:300], np.where(host == 500, 512, host), q, sp, 512, 0.15)) <= 2

    def test_self_first(self, rng):
        pts = padded(make_cloud(rng, 200, 0, 1), 256)
        got = port_device._radius_search_cloud(
            torch.from_numpy(pts)[None], torch.tensor([200], dtype=I32),
            torch.from_numpy(pts)[None], torch.tensor([200], dtype=I32), 0.3, 8)[0].numpy()
        np.testing.assert_array_equal(got[:200, 0], np.arange(200))


class TestInverseTables:
    def test_matches_jax(self):
        m, h, n, j = 200, 12, 150, 32
        table = np.stack([np.random.default_rng(r).choice(n + 1, h, replace=False)
                          for r in range(m)]).astype(np.int32)
        got, ov = port_device.build_inverse_table_device(torch.from_numpy(table), n, j)
        want, ov_j = jax_device.build_inverse_table_device(jnp.asarray(table), n, j)
        assert not bool(ov) and not bool(ov_j)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_overflow(self):
        table = np.zeros((40, 4), np.int32)  # every query lists support 0
        _, ov = port_device.build_inverse_table_device(torch.from_numpy(table), 8, 16)
        assert bool(ov)


def pair(seed, n_ref, n_src, hi):
    rng = np.random.default_rng(seed)
    ref, src = make_cloud(rng, n_ref, 0, hi), make_cloud(rng, n_src, 0, hi)
    return np.concatenate([ref, src], 0), np.asarray([n_ref, n_src])


def build_both(points, lengths, **spec):
    pts0, lens0, feats0 = port_device.pad_stage0(points, lengths, spec["stage_caps"][0])
    got, ov = port_device.build_pyramid_device(
        torch.from_numpy(pts0), torch.from_numpy(lens0), torch.from_numpy(feats0), torch.eye(4),
        **spec)
    want, ov_j = jax_device.build_pyramid_device(
        jnp.asarray(pts0), jnp.asarray(lens0), jnp.asarray(feats0), jnp.eye(4), **spec)
    return got, ov.numpy(), want, np.asarray(ov_j)


# (caps, voxel, radius, clouds): every search brute force (the JAX tests'
# sizes), and stages 0 and 1 on the grid (supports of 2048 rows)
PYRAMIDS = {
    "brute": dict(spec=dict(num_stages=3, voxel_size=0.25, radius=0.625,
                            neighbor_limits=(16, 16, 16), stage_caps=(768, 256, 64),
                            inverse_limits=(48, 48, 48)), clouds=(3, 700, 600, 1.5)),
    "grid": dict(spec=dict(num_stages=3, voxel_size=0.05, radius=0.125,
                           neighbor_limits=(16, 16, 16), stage_caps=(2048, 2048, 1024),
                           inverse_limits=(48, 48, 48)), clouds=(4, 2000, 1800, 1.5)),
}


@pytest.fixture(scope="module", params=sorted(PYRAMIDS))
def pyramids(request):
    case = PYRAMIDS[request.param]
    points, lengths = pair(*case["clouds"])
    got, ov, want, ov_j = build_both(points, lengths, **case["spec"])
    return request.param, case["spec"], points, lengths, got, ov, want, ov_j


def as_np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class TestPyramid:
    def test_matches_jax(self, pyramids):
        name, spec, _, _, got, ov, want, ov_j = pyramids
        np.testing.assert_array_equal(ov, ov_j)
        assert not ov.any()
        caps, stages = spec["stage_caps"], spec["num_stages"]
        for i in range(stages):
            np.testing.assert_array_equal(as_np(got["lengths"][i]), as_np(want["lengths"][i]))
            np.testing.assert_array_equal(as_np(got["masks"][i]), as_np(want["masks"][i]))
            np.testing.assert_allclose(as_np(got["points"][i]), as_np(want["points"][i]),
                                       atol=1e-6, rtol=0)
        r = spec["radius"]
        for key, q_of, s_of, radius_of in (
                ("neighbors", lambda i: i, lambda i: i, lambda i: r * 2 ** i),
                ("subsampling", lambda i: i + 1, lambda i: i, lambda i: r * 2 ** i),
                ("upsampling", lambda i: i, lambda i: i + 1, lambda i: r * 2 ** (i + 1))):
            for i, (g, w) in enumerate(zip(got[key], want[key])):
                g, w = as_np(g), as_np(w)
                assert g.shape == w.shape and g.dtype == w.dtype == np.int32
                s_cap = caps[s_of(i)]
                pts_q, pts_s = as_np(got["points"][q_of(i)]), as_np(got["points"][s_of(i)])
                rows = tie_rows(g, w, pts_q, pts_s, 2 * s_cap, radius_of(i))
                # the grid search: XLA divides by the jitted build's constant
                # cell edge as a product with its reciprocal, so a neighbour
                # within rounding of the radius may fall out of its window
                # on one side only; the brute search: distance ties
                assert len(rows) <= (0.002 if s_cap >= 2048 else 0.05) * len(g), (key, i, rows)
                inv_key = {"neighbors": "neighbors_inv", "subsampling": "subsampling_inv"}.get(key)
                if inv_key is not None:
                    g_inv, w_inv = as_np(got[inv_key][i]), as_np(want[inv_key][i])
                    assert g_inv.shape == w_inv.shape
                    keep = untied_supports(g, w, rows, g_inv.shape[0])
                    np.testing.assert_array_equal(g_inv[keep], w_inv[keep])
        np.testing.assert_array_equal(got["features"].numpy(), as_np(want["features"]))
        tie = ~np.all(got["neighbors"][0].numpy() == as_np(want["neighbors"][0]), axis=1)
        np.testing.assert_allclose(got["input_stream"].numpy()[:, ~tie],
                                   as_np(want["input_stream"])[:, ~tie], atol=1e-6)
        if name == "grid":
            np.testing.assert_array_equal(got["input_stream"].numpy(),
                                          as_np(want["input_stream"]))

    def test_matches_host_pipeline(self, pyramids):
        _, spec, points, lengths, got, _, _, _ = pyramids
        pyr = build_pyramid(points, lengths, spec["num_stages"], spec["voxel_size"],
                            spec["radius"], list(spec["neighbor_limits"]))
        want = pad_registration_batch(pyr, np.ones((len(points), 1), np.float32),
                                      np.eye(4, dtype=np.float32), spec["stage_caps"],
                                      inverse_limits=spec["inverse_limits"])
        assert set(got) == set(want)
        caps, r = spec["stage_caps"], spec["radius"]
        for i in range(spec["num_stages"]):
            np.testing.assert_array_equal(got["lengths"][i].numpy(), want["lengths"][i])
            np.testing.assert_array_equal(got["masks"][i].numpy(), want["masks"][i])
            np.testing.assert_allclose(got["points"][i].numpy(), want["points"][i], atol=1e-4)
        pts = [p.numpy() for p in got["points"]]
        for key, q_of, s_of, radius_of in (
                ("neighbors", lambda i: i, lambda i: i, lambda i: r * 2 ** i),
                ("subsampling", lambda i: i + 1, lambda i: i, lambda i: r * 2 ** i),
                ("upsampling", lambda i: i, lambda i: i + 1, lambda i: r * 2 ** (i + 1))):
            for i, (g, w) in enumerate(zip(got[key], want[key])):
                g = g.numpy()
                assert g.shape == w.shape
                rows = tie_rows(g, w, pts[q_of(i)], pts[s_of(i)], 2 * caps[s_of(i)],
                                radius_of(i))
                assert len(rows) <= 0.05 * len(g), (key, i, rows)
        np.testing.assert_array_equal(got["features"].numpy(), want["features"])
        np.testing.assert_array_equal(got["transform"].numpy(), want["transform"])

    def test_no_host_sync(self, monkeypatch):
        """No value of the build goes back to Python: every read a tensor
        offers raises during it."""
        points, lengths = pair(*PYRAMIDS["grid"]["clouds"])
        spec = PYRAMIDS["grid"]["spec"]
        pts0, lens0, feats0 = port_device.pad_stage0(points, lengths, spec["stage_caps"][0])
        args = (torch.from_numpy(pts0), torch.from_numpy(lens0), torch.from_numpy(feats0),
                torch.eye(4))

        def host_read(*_, **__):
            raise AssertionError("the device build read a value back to the host")

        for name in ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
                     "numpy", "nonzero", "unique"):
            monkeypatch.setattr(torch.Tensor, name, host_read)
        for name in ("nonzero", "unique", "bincount", "masked_select"):
            monkeypatch.setattr(torch, name, host_read)
        _, overflow = port_device.build_pyramid_device(*args, **spec)
        monkeypatch.undo()
        assert overflow.shape == (3,) and overflow.dtype == torch.bool

    def test_overflow_propagates(self):
        points, lengths = pair(3, 700, 600, 1.5)
        spec = dict(PYRAMIDS["brute"]["spec"], stage_caps=(768, 8, 8))
        got, ov, _, ov_j = build_both(points, lengths, **spec)
        assert ov[1] and ov_j[1]
        np.testing.assert_array_equal(ov, ov_j)

    def test_kernels_take_their_plain_version_on_the_cpu(self):
        cuda.launches.clear()
        points, lengths = pair(3, 700, 600, 1.5)
        build_both(points, lengths, **PYRAMIDS["brute"]["spec"])
        assert not cuda.launches


def small_cfg(stage_caps=(512, 128, 64, 32)):
    cfg = make_3dmatch_config()
    return cfg.with_caps(stage_caps=stage_caps)


class TestPlan:
    def test_buckets_and_spec_match_jax(self):
        cfg = small_cfg()
        buckets = [(256, 64, 32, 16), (512, 128, 64, 32)]
        got = DevicePreprocessPlan(cfg, buckets=buckets, with_inverse=True)
        want = jax_device.DevicePreprocessPlan(cfg, buckets=buckets, with_inverse=True)
        assert got.buckets == want.buckets
        for i in range(2):
            for inv in (None, False, True):
                assert got.spec(i, with_inverse=inv) == want.spec(i, with_inverse=inv)
        for lengths in ((200, 100), (256, 256), (300, 10), (512, 400)):
            assert got.bucket_for_lengths(*lengths) == want.bucket_for_lengths(*lengths)
        with pytest.raises(ValueError, match="exceed"):
            got.bucket_for_lengths(600, 10)
        assert [got.bucket_for_cap0(c) for c in (256, 512)] == [0, 1]
        assert [got.next_bucket(i) for i in (0, 1)] == [1, None]

    def test_validation(self):
        cfg = small_cfg()
        with pytest.raises(ValueError, match="symmetric"):
            DevicePreprocessPlan(cfg, buckets=[((256, 128), 64, 32, 16)])
        with pytest.raises(ValueError, match="strictly increasing"):
            DevicePreprocessPlan(cfg, buckets=[(512, 64, 32, 16), (512, 128, 64, 32)])
        with pytest.raises(ValueError, match="overflow_policy"):
            DevicePreprocessPlan(cfg, overflow_policy="bogus")

    def test_raw_pair_and_repad_match_jax(self, rng):
        cfg = small_cfg()
        buckets = [(256, 64, 32, 16), (512, 128, 64, 32)]
        sample = {"ref_points": make_cloud(rng, 200), "src_points": make_cloud(rng, 150),
                  "ref_feats": rng.uniform(size=(200, 1)).astype(np.float32),
                  "src_feats": rng.uniform(size=(150, 1)).astype(np.float32),
                  "transform": np.eye(4), "scene_name": "a", "index": 3}
        got = port_device.prepare_raw_pair(sample, 256)
        want = jax_device.prepare_raw_pair(sample, 256)
        assert set(got) == set(want) and got["meta"] == want["meta"]
        for key in ("raw_points", "raw_lengths", "raw_feats", "transform"):
            np.testing.assert_array_equal(got[key], want[key])
        got = DevicePreprocessPlan(cfg, buckets=buckets).repad_raw(got, 1)
        want = jax_device.DevicePreprocessPlan(cfg, buckets=buckets).repad_raw(want, 1)
        for key in ("raw_points", "raw_lengths", "raw_feats", "transform"):
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])

    def test_host_batch_is_the_host_pipeline(self, rng):
        cfg = small_cfg()
        plan = DevicePreprocessPlan(cfg, with_inverse=True)
        ref, src = make_cloud(rng, 400, 0, 1), make_cloud(rng, 300, 0, 1)
        raw = port_device.prepare_raw_pair({"ref_points": ref, "src_points": src}, 512)
        batch = plan.host_batch(raw)
        spec = plan.spec(0)
        pyr = build_pyramid(np.concatenate([ref, src]), [400, 300], spec["num_stages"],
                            spec["voxel_size"], spec["radius"], list(spec["neighbor_limits"]))
        caps = [p.shape[0] // 2 for p in batch["points"]]
        assert all(c >= b for c, b in zip(caps, plan.buckets[0]))
        want = pad_registration_batch(pyr, np.ones((700, 1), np.float32), np.eye(4), caps,
                                      inverse_limits=cfg.caps.inverse_limits)
        for key in ("points", "neighbors", "subsampling", "upsampling", "neighbors_inv"):
            for g, w in zip(batch[key], want[key]):
                np.testing.assert_array_equal(g, w)


def test_cell_populations_count_the_27_cells(rng):
    q, s = make_cloud(rng, 50, 0, 1), make_cloud(rng, 400, 0, 1)
    edge = np.float32(0.2)
    origin = np.floor(s.min(axis=0) / edge) * edge
    cs, cq = (np.floor((p - origin) / edge).astype(int) for p in (s, q))
    want = [int(np.sum(np.all(np.abs(cs - c) <= 1, axis=1))) for c in cq]
    np.testing.assert_array_equal(cell_populations(q, s, 0.2), want)
    tree = cKDTree(s)  # a cell population covers the radius ball
    inside = np.asarray([len(tree.query_ball_point(p, 0.2)) for p in q])
    assert np.all(cell_populations(q, s, 0.2) >= inside)
