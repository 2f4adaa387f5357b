r"""3DMatch / 3DLoMatch pair dataset.

The port's copy of ``geotransformer_tpu/datasets/threedmatch.py``, the
behavioral equivalent of the reference
`datasets/registration/threedmatch/dataset.py:18-137`:
pickle metadata under ``<root>/metadata/{subset}.pkl``, fragment clouds as
torch ``.pth`` tensors under ``<root>/data``, optional random point-limit
subsampling, and train-time augmentation (random rotation applied to ref or
src by coin flip + uniform noise).
"""

import os.path as osp
import pickle
import random

import numpy as np
import torch

from geotransformer_tpu_torch.utils.pointcloud import (
    random_sample_rotation,
    random_sample_rotation_v2,
    get_transform_from_rotation_translation,
)


def _load_pth_points(path):
    points = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(points, "numpy"):
        points = points.numpy()
    return np.asarray(points)


class ThreeDMatchPairDataset:
    def __init__(
        self,
        dataset_root,
        subset,
        point_limit=None,
        use_augmentation=False,
        augmentation_noise=0.005,
        augmentation_rotation=1.0,
        overlap_threshold=None,
        rotated=False,
    ):
        self.dataset_root = dataset_root
        self.metadata_root = osp.join(dataset_root, "metadata")
        self.data_root = osp.join(dataset_root, "data")
        self.subset = subset
        self.point_limit = point_limit
        self.use_augmentation = use_augmentation
        self.aug_noise = augmentation_noise
        self.aug_rotation = augmentation_rotation
        self.overlap_threshold = overlap_threshold
        self.rotated = rotated

        with open(osp.join(self.metadata_root, f"{subset}.pkl"), "rb") as f:
            self.metadata_list = pickle.load(f)
        if self.overlap_threshold is not None:
            self.metadata_list = [
                x for x in self.metadata_list if x["overlap"] > self.overlap_threshold
            ]

    def __len__(self):
        return len(self.metadata_list)

    def _load_point_cloud(self, file_name):
        points = _load_pth_points(osp.join(self.data_root, file_name))
        if self.point_limit is not None and points.shape[0] > self.point_limit:
            indices = np.random.permutation(points.shape[0])[: self.point_limit]
            points = points[indices]
        return points

    def _augment(self, ref_points, src_points, rotation, translation):
        aug_rotation = random_sample_rotation(self.aug_rotation)
        if random.random() > 0.5:
            ref_points = ref_points @ aug_rotation.T
            rotation = aug_rotation @ rotation
            translation = aug_rotation @ translation
        else:
            src_points = src_points @ aug_rotation.T
            rotation = rotation @ aug_rotation.T
        ref_points = ref_points + (np.random.rand(*ref_points.shape) - 0.5) * self.aug_noise
        src_points = src_points + (np.random.rand(*src_points.shape) - 0.5) * self.aug_noise
        return ref_points, src_points, rotation, translation

    def __getitem__(self, index):
        metadata = self.metadata_list[index]
        rotation = metadata["rotation"]
        translation = metadata["translation"]

        ref_points = self._load_point_cloud(metadata["pcd0"])
        src_points = self._load_point_cloud(metadata["pcd1"])

        if self.use_augmentation:
            ref_points, src_points, rotation, translation = self._augment(
                ref_points, src_points, rotation, translation
            )
        if self.rotated:
            ref_rot = random_sample_rotation_v2()
            ref_points = ref_points @ ref_rot.T
            rotation = ref_rot @ rotation
            translation = ref_rot @ translation
            src_rot = random_sample_rotation_v2()
            src_points = src_points @ src_rot.T
            rotation = rotation @ src_rot.T

        transform = get_transform_from_rotation_translation(rotation, translation)
        return {
            "scene_name": metadata["scene_name"],
            "ref_frame": int(metadata["frag_id0"]),
            "src_frame": int(metadata["frag_id1"]),
            "overlap": float(metadata["overlap"]),
            "ref_points": ref_points.astype(np.float32),
            "src_points": src_points.astype(np.float32),
            "ref_feats": np.ones((ref_points.shape[0], 1), np.float32),
            "src_feats": np.ones((src_points.shape[0], 1), np.float32),
            "transform": transform.astype(np.float32),
        }
