"""The port's 3DMatch and KITTI pair datasets vs the JAX package's, on
metadata and point files written from a seed (the layouts of
tests/test_datasets.py): every sample byte-identical under the same
``np.random`` / ``random`` state, with augmentation on and off; and the
port's remaining point-cloud helpers and augmentations against the JAX
package's under the same state.
"""

import pickle
import random

import numpy as np
import pytest
import torch

from geotransformer_tpu.datasets import transforms as jax_transforms
from geotransformer_tpu.datasets.kitti import OdometryKittiPairDataset as JaxKitti
from geotransformer_tpu.datasets.threedmatch import ThreeDMatchPairDataset as JaxThreeDMatch
from geotransformer_tpu.utils import pointcloud as jax_pointcloud

from geotransformer_tpu_torch.datasets import OdometryKittiPairDataset, ThreeDMatchPairDataset
from geotransformer_tpu_torch.datasets import transforms as port_transforms
from geotransformer_tpu_torch.utils import pointcloud as port_pointcloud


def write_threedmatch(root, seed=0, pairs=3):
    """<root>/metadata/{train,val,3DMatch}.pkl and <root>/data/scene_a/*.pth
    (numpy arrays saved with torch.save), with a random GT rotation."""
    rng = np.random.default_rng(seed)
    (root / "metadata").mkdir(parents=True)
    (root / "data" / "scene_a").mkdir(parents=True)
    metadata = []
    for i in range(pairs):
        for name, n in ((f"cloud_{2 * i}.pth", 500), (f"cloud_{2 * i + 1}.pth", 450)):
            torch.save(rng.uniform(0, 2, (n, 3)).astype(np.float32),
                       root / "data" / "scene_a" / name)
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        metadata.append(dict(scene_name="scene_a", frag_id0=2 * i, frag_id1=2 * i + 1,
                             overlap=0.5 + 0.1 * i, rotation=q * np.sign(np.linalg.det(q)),
                             translation=rng.uniform(-1, 1, 3),
                             pcd0=f"scene_a/cloud_{2 * i}.pth",
                             pcd1=f"scene_a/cloud_{2 * i + 1}.pth"))
    for subset in ("train", "val", "3DMatch"):
        with open(root / "metadata" / f"{subset}.pkl", "wb") as f:
            pickle.dump(metadata, f)
    return str(root)


def write_kitti(root, seed=0, pairs=2):
    """<root>/metadata/{train,val,test}.pkl and <root>/scans/*.npy."""
    rng = np.random.default_rng(seed)
    (root / "metadata").mkdir(parents=True)
    (root / "scans").mkdir()
    metadata = []
    for i in range(pairs):
        for j, n in ((0, 800), (1, 700)):
            np.save(root / "scans" / f"{i}_{j}.npy",
                    rng.uniform(-10, 10, (n, 3)).astype(np.float32))
        transform = np.eye(4)
        transform[:3, 3] = rng.uniform(-2, 2, 3)
        metadata.append(dict(seq_id=8, frame0=i, frame1=i + 1, pcd0=f"scans/{i}_0.npy",
                             pcd1=f"scans/{i}_1.npy", transform=transform))
    for subset in ("train", "val", "test"):
        with open(root / "metadata" / f"{subset}.pkl", "wb") as f:
            pickle.dump(metadata, f)
    return str(root)


@pytest.fixture(scope="module")
def threedmatch_root(tmp_path_factory):
    return write_threedmatch(tmp_path_factory.mktemp("data") / "3DMatch")


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    return write_kitti(tmp_path_factory.mktemp("data") / "Kitti")


def assert_samples_identical(port_ds, jax_ds, seed):
    assert len(port_ds) == len(jax_ds) > 0
    for index in range(len(port_ds)):
        np.random.seed(seed + index)
        random.seed(seed + index)
        want = jax_ds[index]
        np.random.seed(seed + index)
        random.seed(seed + index)
        got = port_ds[index]
        assert sorted(got) == sorted(want)
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                assert got[key].dtype == value.dtype and got[key].tobytes() == value.tobytes(), key
            else:
                assert type(got[key]) is type(value) and got[key] == value, key


@pytest.mark.parametrize("settings", [
    dict(),
    dict(point_limit=100),
    dict(use_augmentation=True),
    dict(use_augmentation=True, point_limit=300, augmentation_noise=0.01,
         augmentation_rotation=2.0),
    dict(overlap_threshold=0.55),
    dict(rotated=True),
], ids=["plain", "point-limit", "augmentation", "augmentation-limit", "overlap", "rotated"])
@pytest.mark.parametrize("subset", ["train", "3DMatch"])
def test_threedmatch_samples_byte_identical(threedmatch_root, subset, settings):
    assert_samples_identical(ThreeDMatchPairDataset(threedmatch_root, subset, **settings),
                             JaxThreeDMatch(threedmatch_root, subset, **settings), seed=20)


@pytest.mark.parametrize("settings", [
    dict(),
    dict(point_limit=300),
    dict(use_augmentation=True),
    dict(use_augmentation=True, point_limit=500, augmentation_noise=0.01,
         augmentation_shift=1.0, augmentation_min_scale=0.9),
], ids=["plain", "point-limit", "augmentation", "augmentation-limit"])
@pytest.mark.parametrize("subset", ["train", "test"])
def test_kitti_samples_byte_identical(kitti_root, subset, settings):
    assert_samples_identical(OdometryKittiPairDataset(kitti_root, subset, **settings),
                             JaxKitti(kitti_root, subset, **settings), seed=40)


def test_augmented_transform_maps_src_onto_ref(threedmatch_root, kitti_root):
    """Without noise, the augmented transform still maps the src cloud to
    where the plain sample's transform puts it, in the augmented frame."""
    for make in (lambda **kw: ThreeDMatchPairDataset(threedmatch_root, "train", **kw),
                 lambda **kw: OdometryKittiPairDataset(kitti_root, "train", **kw)):
        base = make()[0]
        np.random.seed(3)
        aug = make(use_augmentation=True, augmentation_noise=0.0)[0]
        aligned0 = port_pointcloud.apply_transform(base["src_points"], base["transform"])
        aligned1 = port_pointcloud.apply_transform(aug["src_points"], aug["transform"])
        # the same rigid-plus-scale change took ref and the aligned src alike
        fit = np.linalg.lstsq(np.c_[base["ref_points"], np.ones(len(base["ref_points"]))],
                              aug["ref_points"], rcond=None)[0]
        moved = np.c_[aligned0, np.ones(len(aligned0))] @ fit
        np.testing.assert_allclose(moved, aligned1, atol=1e-3)


POINTCLOUD_CALLS = {
    "compose_transforms": lambda m, x: m.compose_transforms(
        [m.random_sample_transform(30.0, 0.5) for _ in range(3)]),
    "random_sample_rotation": lambda m, x: m.random_sample_rotation(2.0),
    "random_sample_rotation_v2": lambda m, x: m.random_sample_rotation_v2(),
    "regularize_normals": lambda m, x: (m.regularize_normals(x[0], x[1]),
                                        m.regularize_normals(x[0], x[1], positive=False)),
    "random_sample_keypoints": lambda m, x: m.random_sample_keypoints(x[0], x[1], 50),
    "sample_keypoints_with_scores": lambda m, x: m.sample_keypoints_with_scores(
        x[0], x[1], x[2], 50),
    "random_sample_keypoints_with_scores": lambda m, x: m.random_sample_keypoints_with_scores(
        x[0], x[1], x[2], 50),
    "sample_keypoints_with_nms": lambda m, x: m.sample_keypoints_with_nms(
        x[0], x[1], x[2], 50, 0.1),
    "convert_depth_mat_to_points": lambda m, x: m.convert_depth_mat_to_points(
        x[3], np.array([[500.0, 0, 16], [0, 500.0, 12], [0, 0, 1]])),
}

TRANSFORM_CALLS = {
    "sample_points": lambda m, x: m.sample_points(x[0], 50, normals=x[1]),
    "random_dropout_points": lambda m, x: m.random_dropout_points(x[0], 0.5),
    "random_scale_shift_points": lambda m, x: m.random_scale_shift_points(x[0], normals=x[1]),
    "random_rotate_points_along_up_axis": lambda m, x: m.random_rotate_points_along_up_axis(
        x[0], normals=x[1]),
    "random_rescale_points": lambda m, x: m.random_rescale_points(x[0]),
    "random_sample_points": lambda m, x: m.random_sample_points(x[0], 250),
    "random_jitter_points": lambda m, x: m.random_jitter_points(x[0], 0.01),
    "random_crop_point_cloud_with_plane": lambda m, x: m.random_crop_point_cloud_with_plane(
        x[0], normals=x[1]),
    "random_crop_point_cloud_with_point": lambda m, x: m.random_crop_point_cloud_with_point(
        x[0], normals=x[1]),
    "normalize_points": lambda m, x: m.normalize_points(x[0]),
}


def _inputs():
    rng = np.random.default_rng(9)
    depth = rng.integers(0, 8000, (24, 32)).astype(np.uint16)
    return (rng.uniform(-1, 1, (200, 3)), rng.normal(size=(200, 3)), rng.uniform(0.1, 1, 200),
            depth)


@pytest.mark.parametrize("name", sorted(POINTCLOUD_CALLS) + sorted(TRANSFORM_CALLS))
def test_helpers_identical_under_same_state(name):
    if name in POINTCLOUD_CALLS:
        call, port, jax_module = POINTCLOUD_CALLS[name], port_pointcloud, jax_pointcloud
    else:
        call, port, jax_module = TRANSFORM_CALLS[name], port_transforms, jax_transforms
    x = _inputs()
    np.random.seed(5)
    random.seed(5)
    want = call(jax_module, x)
    np.random.seed(5)
    random.seed(5)
    got = call(port, x)
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    for g, w in zip(got, want):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), name
