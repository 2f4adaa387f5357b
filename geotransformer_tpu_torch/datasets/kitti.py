r"""KITTI odometry pair dataset.

The port's copy of ``geotransformer_tpu/datasets/kitti.py``, the
behavioral equivalent of the reference
`datasets/registration/kitti/dataset.py:16-122`:
npy downsampled scans, pickle metadata, augmentation with noise + random
rotation (ref-or-src coin flip) + random scale 0.8-1.2 + per-cloud shift ±2m.
"""

import os.path as osp
import pickle
import random

import numpy as np

from geotransformer_tpu_torch.utils.pointcloud import (
    random_sample_rotation,
    get_transform_from_rotation_translation,
    get_rotation_translation_from_transform,
)


class OdometryKittiPairDataset:
    DATA_SPLIT = {
        "train": ["00", "01", "02", "03", "04", "05"],
        "val": ["06", "07"],
        "test": ["08", "09", "10"],
    }

    def __init__(
        self,
        dataset_root,
        subset,
        point_limit=None,
        use_augmentation=False,
        augmentation_noise=0.005,
        augmentation_min_scale=0.8,
        augmentation_max_scale=1.2,
        augmentation_shift=2.0,
        augmentation_rotation=1.0,
    ):
        self.dataset_root = dataset_root
        self.subset = subset
        self.point_limit = point_limit
        self.use_augmentation = use_augmentation
        self.augmentation_noise = augmentation_noise
        self.augmentation_min_scale = augmentation_min_scale
        self.augmentation_max_scale = augmentation_max_scale
        self.augmentation_shift = augmentation_shift
        self.augmentation_rotation = augmentation_rotation

        with open(osp.join(dataset_root, "metadata", f"{subset}.pkl"), "rb") as f:
            self.metadata = pickle.load(f)

    def __len__(self):
        return len(self.metadata)

    def _load_point_cloud(self, file_name):
        points = np.load(file_name)
        if self.point_limit is not None and points.shape[0] > self.point_limit:
            indices = np.random.permutation(points.shape[0])[: self.point_limit]
            points = points[indices]
        return points

    def _augment(self, ref_points, src_points, transform):
        rotation, translation = get_rotation_translation_from_transform(transform)
        ref_points = ref_points + (np.random.rand(*ref_points.shape) - 0.5) * self.augmentation_noise
        src_points = src_points + (np.random.rand(*src_points.shape) - 0.5) * self.augmentation_noise
        aug_rotation = random_sample_rotation(self.augmentation_rotation)
        if random.random() > 0.5:
            ref_points = ref_points @ aug_rotation.T
            rotation = aug_rotation @ rotation
            translation = aug_rotation @ translation
        else:
            src_points = src_points @ aug_rotation.T
            rotation = rotation @ aug_rotation.T
        scale = self.augmentation_min_scale + (
            self.augmentation_max_scale - self.augmentation_min_scale
        ) * random.random()
        ref_points = ref_points * scale
        src_points = src_points * scale
        translation = translation * scale
        ref_shift = np.random.uniform(-self.augmentation_shift, self.augmentation_shift, 3)
        src_shift = np.random.uniform(-self.augmentation_shift, self.augmentation_shift, 3)
        ref_points = ref_points + ref_shift
        src_points = src_points + src_shift
        translation = -(src_shift[None, :] @ rotation.T)[0] + translation + ref_shift
        return ref_points, src_points, get_transform_from_rotation_translation(rotation, translation)

    def __getitem__(self, index):
        metadata = self.metadata[index]
        ref_points = self._load_point_cloud(osp.join(self.dataset_root, metadata["pcd0"]))
        src_points = self._load_point_cloud(osp.join(self.dataset_root, metadata["pcd1"]))
        transform = metadata["transform"]
        if self.use_augmentation:
            ref_points, src_points, transform = self._augment(ref_points, src_points, transform)
        return {
            "seq_id": int(metadata["seq_id"]),
            "ref_frame": int(metadata["frame0"]),
            "src_frame": int(metadata["frame1"]),
            "ref_points": ref_points.astype(np.float32),
            "src_points": src_points.astype(np.float32),
            "ref_feats": np.ones((ref_points.shape[0], 1), np.float32),
            "src_feats": np.ones((src_points.shape[0], 1), np.float32),
            "transform": np.asarray(transform, np.float32),
        }
