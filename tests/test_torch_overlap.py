"""The port's GT patch overlaps (plain version of the overlap kernel) and its
``get_node_correspondences`` vs the JAX package, on the CPU.

Patch points lie on a 1/16 grid at small magnitude and the transform is a
grid translation, so the squared distances are exact in f32 under both the
port's direct |r - s|^2 and the JAX paths' expanded |r|^2 - 2 r.s + |s|^2:
the overlaps must be equal, not close. Covered:
  * ``patch_overlaps_plain`` vs JAX ``patch_overlaps(..., interpret=True)``
    (the Pallas kernel) on valid candidates, K = 16 and K = 32 > S, with
    empty patches and masked candidates (0 in the port, left to the caller
    in JAX), and out-of-range candidate indices (0, as on the card);
  * ``get_node_correspondences`` vs JAX with ``use_pallas=True`` and
    ``False``: candidate indices equal as masked sets per ref node, overlaps
    equal.
The CUDA kernel itself is checked on the card (``-m cuda``, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.kernels.overlap import patch_overlaps as jax_patch_overlaps
from geotransformer_tpu.models.matching import (
    get_node_correspondences as jax_get_node_correspondences,
)

from geotransformer_tpu_torch.kernels.overlap import patch_overlaps, patch_overlaps_plain
from geotransformer_tpu_torch.models.matching import get_node_correspondences

RADIUS = 0.25


def grid(rng, shape, low, high):
    """Points on a 1/16 grid in [low, high)."""
    return (rng.integers(int(low * 16), int(high * 16), size=shape) / 16.0).astype(np.float32)


def patches(rng, nodes, k, empty):
    """(n, K, 3) grid points within ~0.5 of each node, ~20 % slots masked,
    ``empty`` patches all masked."""
    pts = (np.round(nodes[:, None, :] * 16) / 16 + grid(rng, (len(nodes), k, 3), -0.5, 0.5))
    masks = rng.uniform(size=(len(nodes), k)) > 0.2
    masks[empty] = False
    return pts.astype(np.float32), masks


def overlap_case(seed, m, n, k, s):
    rng = np.random.default_rng(seed)
    ref_nodes = rng.uniform(0, 2, (m, 3)).astype(np.float32)
    src_nodes = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    ref_pts, ref_masks = patches(rng, ref_nodes, k, empty=[0])
    src_pts, src_masks = patches(rng, src_nodes, k, empty=[1, 2])
    cand = rng.integers(0, n, size=(m, s)).astype(np.int64)
    cand[:, 0] = 1  # an empty candidate patch for every ref node
    cand_masks = rng.uniform(size=(m, s)) > 0.25
    return ref_pts, ref_masks, src_pts, src_masks, cand, cand_masks


def t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("k, s", [(16, 8), (32, 8)], ids=["K16", "K32_gt_S"])
def test_plain_matches_jax_kernel_interpret(k, s):
    ref_pts, ref_masks, src_pts, src_masks, cand, cand_masks = overlap_case(0, 20, 30, k, s)
    want = np.asarray(jax_patch_overlaps(
        jnp.asarray(ref_pts), jnp.asarray(ref_masks), jnp.asarray(src_pts[cand]),
        jnp.asarray(src_masks[cand]), RADIUS, interpret=True))
    got = patch_overlaps_plain(t(ref_pts), t(ref_masks), t(src_pts), t(src_masks), t(cand),
                               t(cand_masks), RADIUS, chunk_size=7).numpy()
    assert 0.05 < (want[cand_masks] > 0).mean() < 0.95  # overlaps both ways
    np.testing.assert_array_equal(got[cand_masks], want[cand_masks])
    assert not got[~cand_masks].any()
    # empty patches cover nothing: the empty ref patch and every empty
    # candidate give 0 through the clamped totals
    assert not got[0].any() and not got[:, 0].any()


def test_wrapper_takes_the_plain_version_on_the_cpu():
    case = [t(x) for x in overlap_case(1, 9, 12, 16, 8)]
    np.testing.assert_array_equal(patch_overlaps(*case, RADIUS).numpy(),
                                  patch_overlaps_plain(*case, RADIUS).numpy())
    with pytest.raises(RuntimeError, match="CUDA"):
        patch_overlaps(*case, RADIUS, force=True)


def test_out_of_range_candidates_give_zero():
    """A candidate index outside [0, N), masked or not, gives 0 (as on the
    card); every other candidate keeps its overlap."""
    case = [t(x) for x in overlap_case(3, 11, 12, 16, 8)]
    want = patch_overlaps_plain(*case, RADIUS).numpy()
    wild = np.zeros(want.shape, bool)
    wild[tuple(np.argwhere(want > 0)[:4].T)] = True  # unmasked, overlapping
    wild[tuple(np.argwhere(~case[5].numpy())[0])] = True  # masked
    cand = case[4].clone()
    cand[t(wild)] = torch.tensor([-1, 12, 40, -7, 12])
    got = patch_overlaps_plain(*case[:4], cand, case[5], RADIUS, chunk_size=5).numpy()
    assert not got[wild].any()
    np.testing.assert_array_equal(got[~wild], want[~wild])


def node_case(seed, m=24, n=28, k=16):
    rng = np.random.default_rng(seed)
    ref_nodes = rng.uniform(0, 3, (m, 3)).astype(np.float32)
    src_nodes = rng.uniform(0, 3, (n, 3)).astype(np.float32)
    ref_pts, ref_knn_masks = patches(rng, ref_nodes, k, empty=[3])
    src_pts, src_knn_masks = patches(rng, src_nodes, k, empty=[4])
    ref_masks = np.ones(m, bool)
    ref_masks[-2:] = False
    src_masks = np.ones(n, bool)
    src_masks[-3:] = False
    transform = np.eye(4, dtype=np.float32)
    transform[:3, 3] = (0.25, -0.125, 0.0625)
    return (ref_nodes, src_nodes, ref_pts, src_pts, transform, ref_masks, src_masks,
            ref_knn_masks, src_knn_masks)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["jax_kernel", "jax_chunked"])
def test_node_correspondences_match_jax(use_pallas):
    case = node_case(2)
    args, masks = case[:5], case[5:]
    kw = dict(num_candidates=8, chunk_size=5)
    want = [np.asarray(x) for x in jax_get_node_correspondences(
        *[jnp.asarray(a) for a in args], RADIUS, *[jnp.asarray(a) for a in masks],
        use_pallas=use_pallas, **kw)]
    got = [x.numpy() for x in get_node_correspondences(*[t(a) for a in args], RADIUS,
                                                       *[t(a) for a in masks], **kw)]
    (gi, go, gm), (wi, wo, wm) = got, want
    assert wm.any() and not wm.all()
    np.testing.assert_array_equal(gm.sum(1), wm.sum(1))
    for row in range(wm.shape[0]):
        g = dict(zip(gi[row][gm[row]].tolist(), go[row][gm[row]].tolist()))
        w = dict(zip(wi[row][wm[row]].tolist(), wo[row][wm[row]].tolist()))
        assert g == w, f"ref node {row}"
    assert not go[~gm].any()
