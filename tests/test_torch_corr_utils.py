"""The port's correspondence utilities, point matching, quaternion Kabsch
and the mean-reduction / dustbin forward vs the JAX package.

  * every ``models/corr_utils.py`` function and ``point_matching`` on the
    same numpy inputs, with and without ``has_dustbin`` / ``use_dustbin``:
    index outputs compared as masked sets (``ROADMAP.md`` §3, "Ties in
    top-k"), their scores within 1e-6;
  * ``rotation_from_covariance_quat`` against the JAX quaternion Kabsch and
    against the SVD solution, rotations within 1e-5, a 180-degree rotation
    among them (a fixed start vector would be orthogonal to its answer);
    ``weighted_procrustes(method="quat")`` and LGR with
    ``procrustes_method="quat"`` likewise;
  * the narrow model forward of ``tests/test_torch_model.py`` with
    ``reduction_a="mean"`` and ``fine_matching.use_dustbin=True`` against
    the JAX forward, at that file's tolerances.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.models import corr_utils as jax_corr
from geotransformer_tpu.models import lgr as jax_lgr
from geotransformer_tpu.models.point_matching import point_matching as jax_point_matching
from geotransformer_tpu.models import procrustes as jax_procrustes
from geotransformer_tpu.utils.convert import torch_state_dict_to_variables

from geotransformer_tpu_torch.models import corr_utils as port_corr
from geotransformer_tpu_torch.models import lgr as port_lgr
from geotransformer_tpu_torch.models.point_matching import point_matching as port_point_matching
from geotransformer_tpu_torch.models import procrustes as port_procrustes
from geotransformer_tpu_torch.models import create_model as create_torch_model
from geotransformer_tpu_torch.preprocess import batch_to_torch
from test_torch_model import make_batch, narrow_config


def _both(jax_fn, port_fn, *args, **kwargs):
    """(JAX outputs, port outputs) as numpy tuples, on the same arrays (the
    JAX function jitted: op-by-op dispatch is slower on the CPU)."""
    want = jax.jit(functools.partial(jax_fn, **kwargs))(*[jnp.asarray(a) for a in args])
    got = port_fn(*[torch.from_numpy(np.asarray(a)) for a in args], **kwargs)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _entries(ref, src, scores, masks):
    return {(int(r), int(s)): float(v) for r, s, v, m in zip(ref, src, scores, masks) if m}


def _assert_same_entries(want, got, atol=1e-7, zeroed=True):
    """Equal (ref, src) sets, their values within 1e-6 relative (``atol``
    for values from expanded squared distances), masked slots 0 where the
    function zeroes them."""
    w, g = _entries(*want), _entries(*got)
    assert w, "nothing selected"
    assert sorted(w) == sorted(g)
    np.testing.assert_allclose([g[k] for k in sorted(g)], [w[k] for k in sorted(w)],
                               rtol=1e-6, atol=atol)
    for out in (want, got):
        assert not zeroed or not np.asarray(out[2])[~np.asarray(out[3])].any()


def _score_mat(seed, n, m):
    return (np.random.default_rng(seed).normal(size=(n, m)) - 2.0).astype(np.float32)


@pytest.mark.parametrize("has_dustbin", [False, True], ids=["plain", "dustbin"])
@pytest.mark.parametrize("mode", ["row", "mutual", "bilateral"])
def test_extract_from_scores(has_dustbin, mode):
    score_mat = _score_mat(0, 13, 11)
    kw = dict(mutual=mode == "mutual", bilateral=mode == "bilateral", has_dustbin=has_dustbin)
    _assert_same_entries(*_both(jax_corr.extract_correspondences_from_scores,
                                port_corr.extract_correspondences_from_scores,
                                score_mat, capacity=40, **kw))


@pytest.mark.parametrize("has_dustbin", [False, True], ids=["plain", "dustbin"])
def test_extract_from_scores_threshold_and_topk(has_dustbin):
    score_mat = _score_mat(1, 13, 11)
    _assert_same_entries(*_both(jax_corr.extract_correspondences_from_scores_threshold,
                                port_corr.extract_correspondences_from_scores_threshold,
                                score_mat, threshold=0.15, capacity=60, has_dustbin=has_dustbin))
    for largest in (True, False):
        want, got = _both(jax_corr.extract_correspondences_from_scores_topk,
                          port_corr.extract_correspondences_from_scores_topk,
                          score_mat, k=20, has_dustbin=has_dustbin, largest=largest)
        _assert_same_entries(want, got, zeroed=False)  # dustbin entries keep their scores
        if has_dustbin:
            assert not got[3].all()  # an entry on the dustbin row or column
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6)  # sorted scores


@pytest.mark.parametrize("mode", ["row", "mutual", "bilateral"])
def test_extract_from_feats(mode):
    rng = np.random.default_rng(2)
    ref_feats = rng.normal(size=(12, 8)).astype(np.float32)
    src_feats = rng.normal(size=(10, 8)).astype(np.float32)
    _assert_same_entries(*_both(jax_corr.extract_correspondences_from_feats,
                                port_corr.extract_correspondences_from_feats,
                                ref_feats, src_feats, capacity=30,
                                mutual=mode == "mutual", bilateral=mode == "bilateral"))


def _patch_case(seed):
    rng = np.random.default_rng(seed)
    ref_points = rng.uniform(0, 1, (60, 3)).astype(np.float32)
    src_points = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    ref_knn = rng.integers(0, 61, (8, 6))  # 60: the sentinel slot
    src_knn = rng.integers(0, 51, (7, 6))
    ref_pad = np.concatenate([ref_points, np.zeros((1, 3), np.float32)])
    src_pad = np.concatenate([src_points, np.zeros((1, 3), np.float32)])
    angle = 0.2
    transform = np.eye(4, dtype=np.float32)
    transform[:2, :2] = [[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]]
    transform[:3, 3] = [0.05, -0.02, 0.01]
    return dict(
        ref_points=ref_points, src_points=src_points,
        ref_nodes=ref_points[:8], src_nodes=src_points[:7],
        ref_knn_points=ref_pad[ref_knn], src_knn_points=src_pad[src_knn],
        ref_knn_indices=ref_knn, src_knn_indices=src_knn,
        ref_knn_masks=ref_knn < 60, src_knn_masks=src_knn < 50,
        node_corr_indices=np.stack([rng.integers(0, 8, 6), rng.integers(0, 7, 6)], 1),
        node_corr_masks=np.asarray([True, True, True, True, True, False]),
        transform=transform,
    )


def test_dense_to_node_correspondences():
    case = _patch_case(3)
    rng = np.random.default_rng(4)
    corr_indices = np.stack([rng.integers(0, 60, 80), rng.integers(0, 50, 80)], 1)
    corr_masks = rng.uniform(size=80) < 0.8
    for capacity in (12, 64):  # truncated, and padded
        want, got = _both(jax_corr.dense_correspondences_to_node_correspondences,
                          port_corr.dense_correspondences_to_node_correspondences,
                          case["ref_points"], case["src_points"], case["ref_nodes"],
                          case["src_nodes"], corr_indices, corr_masks, capacity=capacity)
        for name, g, w in zip(("node_corr", "counts", "scores", "masks"), got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)


def test_node_to_dense_and_overlap_ratios():
    c = _patch_case(5)
    args = [c[k] for k in ("ref_knn_points", "src_knn_points", "ref_knn_indices",
                           "src_knn_indices", "node_corr_indices", "transform")]
    masks = dict(ref_knn_masks=c["ref_knn_masks"], src_knn_masks=c["src_knn_masks"])
    want = jax.jit(functools.partial(jax_corr.node_correspondences_to_dense_correspondences,
                                     matching_radius=0.5, capacity=60))(
        *[jnp.asarray(a) for a in args], node_corr_masks=jnp.asarray(c["node_corr_masks"]),
        **{k: jnp.asarray(v) for k, v in masks.items()})
    got = port_corr.node_correspondences_to_dense_correspondences(
        *[torch.from_numpy(a) for a in args], 0.5, 60,
        node_corr_masks=torch.from_numpy(c["node_corr_masks"]),
        **{k: torch.from_numpy(v) for k, v in masks.items()})
    want, got = [np.asarray(w) for w in want], [g.numpy() for g in got]
    _assert_same_entries((want[0][:, 0], want[0][:, 1], want[1], want[2]),
                         (got[0][:, 0], got[0][:, 1], got[1], got[2]), atol=1e-5)

    for jax_fn, port_fn in ((jax_corr.get_node_overlap_ratios, port_corr.get_node_overlap_ratios),
                            (jax_corr.get_node_occlusion_ratios,
                             port_corr.get_node_occlusion_ratios)):
        ratio_args = [c["ref_points"], c["src_points"], *args[:5], c["transform"]]
        w = jax.jit(functools.partial(jax_fn, matching_radius=0.5))(
            *[jnp.asarray(a) for a in ratio_args], **{k: jnp.asarray(v) for k, v in masks.items()},
            node_corr_masks=jnp.asarray(c["node_corr_masks"]))
        g = port_fn(*[torch.from_numpy(a) for a in ratio_args], 0.5,
                    **{k: torch.from_numpy(v) for k, v in masks.items()},
                    node_corr_masks=torch.from_numpy(c["node_corr_masks"]))
        for gs, ws in zip(g, w):
            np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6, atol=1e-7)
            assert 0 < np.asarray(ws).max()


@pytest.mark.parametrize("use_dustbin", [False, True], ids=["plain", "dustbin"])
def test_point_matching(use_dustbin):
    rng = np.random.default_rng(6)
    p, k = 5, 6
    width = k + 1 if use_dustbin else k
    log_scores = (rng.normal(size=(p, width, width)) - 1.5).astype(np.float32)
    arrays = dict(
        ref_knn_points=rng.normal(size=(p, k, 3)).astype(np.float32),
        src_knn_points=rng.normal(size=(p, k, 3)).astype(np.float32),
        ref_knn_masks=rng.uniform(size=(p, k)) < 0.85,
        src_knn_masks=rng.uniform(size=(p, k)) < 0.85,
        ref_knn_indices=rng.integers(0, 100, (p, k)),
        src_knn_indices=rng.integers(0, 100, (p, k)),
        log_score_mat=log_scores,
    )
    for global_score, extra in ((False, dict()), (True, dict(
            patch_masks=np.arange(p) < 4,
            global_scores=rng.uniform(0.5, 1, p).astype(np.float32)))):
        kw = dict(k=2, mutual=True, confidence_threshold=0.02, use_dustbin=use_dustbin,
                  use_global_score=global_score, correspondence_limit=24)
        want = jax.jit(functools.partial(jax_point_matching, **kw))(
            **{n: jnp.asarray(a) for n, a in arrays.items()},
            **{n: jnp.asarray(a) for n, a in extra.items()})
        got = port_point_matching(**{n: torch.from_numpy(np.asarray(a))
                                        for n, a in arrays.items()},
                                     **{n: torch.from_numpy(np.asarray(a))
                                        for n, a in extra.items()}, **kw)
        keys = ("ref_corr_indices", "src_corr_indices", "corr_scores", "corr_masks")
        _assert_same_entries(tuple(np.asarray(want[n]) for n in keys),
                             tuple(got[n].numpy() for n in keys))
        masks = want["corr_masks"]
        for side in ("ref", "src"):  # points follow their indices
            order_w = np.lexsort((want["src_corr_indices"][masks], want["ref_corr_indices"][masks]))
            order_g = np.lexsort((got["src_corr_indices"][got["corr_masks"]].numpy(),
                                  got["ref_corr_indices"][got["corr_masks"]].numpy()))
            np.testing.assert_array_equal(
                got[f"{side}_corr_points"][got["corr_masks"]].numpy()[order_g],
                np.asarray(want[f"{side}_corr_points"])[masks][order_w])


def _rotation_error(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()


def test_quaternion_kabsch():
    rng = np.random.default_rng(7)
    batch, n = 12, 40
    src = rng.normal(size=(batch, n, 3)).astype(np.float32)
    angles = rng.uniform(-np.pi, np.pi, batch)
    axes = rng.normal(size=(batch, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles[0], axes[0] = np.pi, np.asarray([1.0, -1.0, 0.0]) / np.sqrt(2.0)  # w = 0, x+y+z = 0
    rots = []
    for angle, axis in zip(angles, axes):
        kx = np.asarray([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
        rots.append(np.eye(3) + np.sin(angle) * kx + (1 - np.cos(angle)) * kx @ kx)
    rots = np.asarray(rots, np.float32)
    ref = np.einsum("bij,bnj->bni", rots, src) + rng.normal(size=(batch, 1, 3)).astype(np.float32)
    ref = (ref + 0.01 * rng.normal(size=ref.shape)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, (batch, n)).astype(np.float32)

    want_t = np.asarray(jax.jit(functools.partial(
        jax_procrustes.weighted_procrustes, return_transform=True, method="quat"))(
        jnp.asarray(src), jnp.asarray(ref), jnp.asarray(weights)))
    args = [torch.from_numpy(a) for a in (src, ref, weights)]
    got_t = port_procrustes.weighted_procrustes(*args, return_transform=True, method="quat")
    svd_t = port_procrustes.weighted_procrustes(*args, return_transform=True, method="svd")
    assert _rotation_error(got_t[:, :3, :3], want_t[:, :3, :3]) < 1e-5
    assert _rotation_error(got_t[:, :3, :3], svd_t[:, :3, :3]) < 1e-5
    np.testing.assert_allclose(got_t.numpy(), want_t, atol=1e-4)
    det = np.linalg.det(got_t[:, :3, :3].numpy().astype(np.float64))
    np.testing.assert_allclose(det, 1.0, atol=1e-5)

    # the covariance route of LGR's hypotheses
    h = torch.einsum("bnc,bnd->bcd", args[0], args[1])
    want_r = np.asarray(jax.jit(jax_procrustes._rotation_from_covariance_quat)(
        jnp.asarray(h.numpy())))
    got_r = port_procrustes.rotation_from_covariance_quat(h)
    assert _rotation_error(got_r, want_r) < 1e-5
    assert _rotation_error(got_r, port_procrustes.rotation_from_covariance(h)) < 1e-5


def test_lgr_quat_and_dustbin():
    """LGR with the quaternion fits on dustbin scores (the default LGR is
    held by tests/test_torch_model.py)."""
    rng = np.random.default_rng(8)
    p, k = 6, 8
    width = k + 1
    src = rng.normal(size=(p, k, 3)).astype(np.float32)
    angle = 0.4
    rot = np.asarray([[np.cos(angle), -np.sin(angle), 0], [np.sin(angle), np.cos(angle), 0],
                      [0, 0, 1]], np.float32)
    ref = (src @ rot.T + np.asarray([0.1, 0.2, -0.1], np.float32)).astype(np.float32)
    log_scores = (rng.normal(size=(p, width, width)) - 3.0).astype(np.float32)
    diag = np.arange(k)
    log_scores[:, diag, diag] += 2.5  # the true pairs score highest
    arrays = [ref, src, rng.uniform(size=(p, k)) < 0.9, np.ones((p, k), bool), log_scores]
    kw = dict(k=2, acceptance_radius=0.1, use_dustbin=True, correspondence_limit=48,
              procrustes_method="quat")
    want = jax.jit(functools.partial(jax_lgr.local_to_global_registration, **kw))(
        *[jnp.asarray(a) for a in arrays])
    got = port_lgr.local_to_global_registration(*[torch.from_numpy(a) for a in arrays], **kw)
    keys = ("ref_corr_points", "src_corr_points", "corr_scores", "corr_masks")
    w = {tuple(r) + tuple(s): v for r, s, v, m in zip(*[np.asarray(want[n]) for n in keys]) if m}
    g = {tuple(r) + tuple(s): v for r, s, v, m in zip(*[got[n].numpy() for n in keys]) if m}
    assert w and sorted(w) == sorted(g)
    np.testing.assert_allclose(got["estimated_transform"].numpy(),
                               np.asarray(want["estimated_transform"]), atol=1e-5)
    est = got["estimated_transform"].numpy()
    np.testing.assert_allclose(est[:3, :3], rot, atol=1e-4)


@pytest.fixture(scope="module")
def mean_dustbin_forward():
    """The narrow forward of tests/test_torch_model.py with the mean angle
    reduction and the dustbin, in both packages on one set of weights."""
    from geotransformer_tpu.models import create_model as create_jax_model

    base = narrow_config()
    base = dataclasses.replace(
        base,
        geotransformer=dataclasses.replace(base.geotransformer, reduction_a="mean"),
        fine_matching=dataclasses.replace(base.fine_matching, use_dustbin=True))
    cfg, _, batch = make_batch(base, seed=11, per_cloud=True)
    batch_j = jax.tree.map(jnp.asarray, batch)
    jax_model = create_jax_model(cfg)
    # the port's seeded weights carried into the JAX tree: one compile (the
    # forward), where a jitted init would compile the forward twice
    port = create_torch_model(cfg, seed=0, device="cpu")
    template = jax.eval_shape(lambda r, b: jax_model.init(r, b, training=False, with_gt=False),
                              jax.random.PRNGKey(0), batch_j)
    template = jax.tree.map(lambda x: np.zeros(x.shape, x.dtype), template)
    variables, unused = torch_state_dict_to_variables(port.state_dict(), template)
    assert unused == []
    out_j = jax.tree.map(np.asarray, jax.jit(
        lambda v, b: jax_model.apply(v, b, training=False, with_gt=False))(variables, batch_j))
    out_t = {k: v.numpy() for k, v in port(batch_to_torch(batch, "cpu")).items()}
    return out_t, out_j


def test_mean_dustbin_coarse_features(mean_dustbin_forward):
    out_t, out_j = mean_dustbin_forward
    for side in ("ref", "src"):
        rows = np.asarray(out_j[f"{side}_masks_c"], bool)
        np.testing.assert_allclose(out_t[f"{side}_feats_c"][rows],
                                   out_j[f"{side}_feats_c"][rows], rtol=1e-3, atol=1e-4)


def test_mean_dustbin_registration(mean_dustbin_forward):
    out_t, out_j = mean_dustbin_forward

    def pairs(out):
        m = out["node_corr_masks"]
        return set(zip(out["ref_node_corr_indices"][m].tolist(),
                       out["src_node_corr_indices"][m].tolist()))

    assert pairs(out_j) and pairs(out_t) == pairs(out_j)
    got = out_t["estimated_transform"]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, out_j["estimated_transform"], atol=5e-4)
    np.testing.assert_array_equal(out_t["corr_masks"].sum(), out_j["corr_masks"].sum())
