"""The port's ops vs the JAX package's on the same numpy inputs: shadow-row
gathers, pairwise distances, the sinusoidal basis, SE(3) helpers and the
point-to-node partition (exact, on grid coordinates where both distance
forms are exact, so ties break the same way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.ops import embedding as jax_embedding
from geotransformer_tpu.ops import gather as jax_gather
from geotransformer_tpu.ops import partition as jax_partition
from geotransformer_tpu.ops import se3 as jax_se3
from geotransformer_tpu.ops.pairwise_distance import (
    pairwise_distance as jax_pairwise_distance,
)

from geotransformer_tpu_torch.ops import (
    apply_transform,
    gather_with_shadow,
    get_transform_from_rotation_translation,
    index_select,
    pairwise_distance,
    point_to_node_partition,
    sinusoidal_embedding,
)


def test_gather_with_shadow_and_index_select(rng):
    data = rng.normal(size=(10, 4)).astype(np.float32)
    idx = rng.integers(0, 11, size=(6, 3)).astype(np.int32)  # 10 = sentinel
    got = gather_with_shadow(torch.from_numpy(data), torch.from_numpy(idx), -2.0).numpy()
    want = np.asarray(jax_gather.gather_with_shadow(jnp.asarray(data), jnp.asarray(idx), -2.0))
    np.testing.assert_array_equal(got, want)
    got = index_select(torch.from_numpy(data), torch.from_numpy(idx), dim=0).numpy()
    want = np.asarray(jax_gather.index_select(jnp.asarray(data), jnp.asarray(idx), axis=0))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("normalized", [False, True])
def test_pairwise_distance(rng, normalized):
    x = rng.normal(size=(2, 30, 8)).astype(np.float32)
    y = rng.normal(size=(2, 20, 8)).astype(np.float32)
    if normalized:
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        y /= np.linalg.norm(y, axis=-1, keepdims=True)
    got = pairwise_distance(torch.from_numpy(x), torch.from_numpy(y), normalized).numpy()
    want = np.asarray(jax_pairwise_distance(jnp.asarray(x), jnp.asarray(y),
                                             normalized=normalized))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sinusoidal_embedding(rng):
    idx = rng.uniform(0, 12, size=(5, 7)).astype(np.float32)
    got = sinusoidal_embedding(torch.from_numpy(idx), 64).numpy()
    want = np.asarray(jax_embedding.sinusoidal_embedding(jnp.asarray(idx), 64))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_se3(rng):
    rot = np.array(jax_se3.rodrigues_rotation_matrix(
        jnp.asarray(rng.normal(size=3), jnp.float32), jnp.float32(0.7)))
    trans = rng.normal(size=3).astype(np.float32)
    points = rng.normal(size=(50, 3)).astype(np.float32)
    got_t = get_transform_from_rotation_translation(torch.from_numpy(rot), torch.from_numpy(trans))
    want_t = jax_se3.get_transform_from_rotation_translation(jnp.asarray(rot), jnp.asarray(trans))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    got = apply_transform(torch.from_numpy(points), got_t).numpy()
    want = np.asarray(jax_se3.apply_transform(jnp.asarray(points), want_t))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_point_to_node_partition(seed):
    rng = np.random.default_rng(seed)
    # multiples of 1/64: squared distances are exact in f32 in both
    # formulations, so ownership ties and patch order match exactly
    points = (rng.integers(0, 64, size=(300, 3)) / 64).astype(np.float32)
    nodes = (rng.integers(0, 64, size=(40, 3)) / 64).astype(np.float32)
    point_masks = np.arange(300) < 260
    node_masks = np.arange(40) < 33
    want = jax_partition.point_to_node_partition(
        jnp.asarray(points), jnp.asarray(nodes), 16, point_masks=jnp.asarray(point_masks),
        node_masks_in=jnp.asarray(node_masks))
    got = point_to_node_partition(
        torch.from_numpy(points), torch.from_numpy(nodes), 16,
        point_masks=torch.from_numpy(point_masks), node_masks_in=torch.from_numpy(node_masks))
    for name, g, w in zip(("point_to_node", "node_masks", "node_knn_indices", "node_knn_masks"),
                          got, want):
        w = np.asarray(w)
        g = g.numpy()
        if name == "point_to_node":
            g, w = g[point_masks], w[point_masks]  # junk for padded points
        np.testing.assert_array_equal(g, w, err_msg=name)
