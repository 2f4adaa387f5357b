"""The port's host pyramid vs the JAX package's numpy pyramid: the same
points give a byte-identical PairBatch, with symmetric and asymmetric caps."""

import numpy as np
import pytest
import torch

from geotransformer_tpu.preprocess import pyramid as jax_pyramid

from geotransformer_tpu_torch.preprocess import pyramid as port_pyramid

NEIGHBOR_LIMITS = [38, 36, 36, 38]


def make_points(seed, n=1200):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 1, (n, 2))
    z = 0.15 * np.sin(6 * xy[:, 0]) * np.cos(5 * xy[:, 1]) + 0.01 * rng.normal(size=n)
    ref = np.column_stack([xy, z]).astype(np.float32)
    keep = ref[:, 0] < 0.7
    src = (ref[keep] + 0.003 * rng.normal(size=(int(keep.sum()), 3))).astype(np.float32)
    return np.concatenate([ref, src], 0), np.asarray([len(ref), len(src)])


def assert_identical(got, want, name):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            assert_identical(g, w, f"{name}[{i}]")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, f"{name}: {got.dtype} vs {want.dtype}"
    assert got.shape == want.shape, f"{name}: {got.shape} vs {want.shape}"
    assert got.tobytes() == want.tobytes(), f"{name} differs"


@pytest.fixture()
def numpy_path(monkeypatch):
    # the JAX package's own numpy fallback, not its native library
    monkeypatch.setenv("GEOTRANSFORMER_TPU_NATIVE", "0")


@pytest.mark.parametrize("per_cloud", [False, True], ids=["symmetric", "asymmetric"])
@pytest.mark.parametrize("seed", [0, 5])
def test_pair_batch_is_byte_identical(numpy_path, seed, per_cloud):
    points, lengths = make_points(seed)
    args = (points, lengths, 4, 0.025, 0.0625, NEIGHBOR_LIMITS)
    want_pyr = jax_pyramid.build_pyramid(*args)
    got_pyr = port_pyramid.build_pyramid(*args)
    for key in want_pyr:
        assert_identical(got_pyr[key], want_pyr[key], key)

    want_caps = jax_pyramid.caps_for_pyramid(want_pyr, multiple=64, per_cloud=per_cloud)
    got_caps = port_pyramid.caps_for_pyramid(got_pyr, multiple=64, per_cloud=per_cloud)
    assert got_caps == want_caps
    feats = np.ones((points.shape[0], 1), np.float32)
    transform = np.eye(4, dtype=np.float32)
    want = jax_pyramid.pad_registration_batch(want_pyr, feats, transform, want_caps)
    got = port_pyramid.pad_registration_batch(got_pyr, feats, transform, got_caps)
    assert sorted(got) == sorted(want)
    for key in want:
        assert_identical(got[key], want[key], key)


def test_capacity_overflow_raises(numpy_path):
    points, lengths = make_points(1)
    pyr = port_pyramid.build_pyramid(points, lengths, 4, 0.025, 0.0625, NEIGHBOR_LIMITS)
    caps = port_pyramid.caps_for_pyramid(pyr, multiple=64)
    caps[1] = 64
    with pytest.raises(ValueError, match="exceed"):
        port_pyramid.pad_registration_batch(
            pyr, np.ones((points.shape[0], 1), np.float32), np.eye(4, dtype=np.float32), caps)


def test_batch_to_torch_keeps_dtypes(numpy_path):
    points, lengths = make_points(2, n=600)
    pyr = port_pyramid.build_pyramid(points, lengths, 4, 0.025, 0.0625, NEIGHBOR_LIMITS)
    caps = port_pyramid.caps_for_pyramid(pyr, multiple=64, per_cloud=True)
    batch = port_pyramid.pad_registration_batch(
        pyr, np.ones((points.shape[0], 1), np.float32), np.eye(4, dtype=np.float32), caps)
    tensors = port_pyramid.batch_to_torch(batch, "cpu")
    assert tensors["points"][0].dtype == torch.float32
    assert tensors["masks"][0].dtype == torch.bool
    assert tensors["neighbors"][0].dtype == torch.int32
    assert tensors["input_stream"].shape == batch["input_stream"].shape
    np.testing.assert_array_equal(tensors["subsampling"][2].numpy(), batch["subsampling"][2])
