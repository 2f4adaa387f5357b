r"""ModelNet40 synthetic registration pair dataset: the port's copy of
``geotransformer_tpu/datasets/modelnet.py`` (reference
`datasets/registration/modelnet/dataset.py`).

Normalize the mesh cloud, apply a random SE(3) (rotation magnitude in
degrees / translation magnitude), crop both clouds (plane or viewpoint) with
an overlap-checked resampling loop, twice-sample to ``num_points``, jitter,
and shuffle. From the same pickle and ``np.random`` state it gives the JAX
class's samples byte for byte.
"""

import os.path as osp
import pickle

import numpy as np

from geotransformer_tpu_torch.utils.pointcloud import (
    apply_transform,
    inverse_transform,
    random_sample_transform,
    get_nearest_neighbor,
)
from geotransformer_tpu_torch.datasets.transforms import (
    normalize_points,
    random_sample_points,
    random_jitter_points,
    random_shuffle_points,
    random_crop_point_cloud_with_plane,
    random_crop_point_cloud_with_point,
    random_sample_viewpoint,
)

# fmt: off
ALL_CATEGORIES = [
    'airplane', 'bathtub', 'bed', 'bench', 'bookshelf', 'bottle', 'bowl', 'car', 'chair', 'cone', 'cup', 'curtain',
    'desk', 'door', 'dresser', 'flower_pot', 'glass_box', 'guitar', 'keyboard', 'lamp', 'laptop', 'mantel',
    'monitor', 'night_stand', 'person', 'piano', 'plant', 'radio', 'range_hood', 'sink', 'sofa', 'stairs', 'stool',
    'table', 'tent', 'toilet', 'tv_stand', 'vase', 'wardrobe', 'xbox'
]
ASYMMETRIC_INDICES = [
    0, 1, 2, 3, 4, 7, 8, 11, 12, 13, 14, 16, 17, 18, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 35, 36,
    38, 39
]
# fmt: on


def compute_overlap(ref_points, src_points, transform, positive_radius=0.1):
    """Fraction of src points with a ref neighbor within radius after alignment."""
    src_points = apply_transform(src_points, transform)
    dists = get_nearest_neighbor(src_points, ref_points)
    return float(np.mean(dists < positive_radius))


class ModelNetPairDataset:
    def __init__(
        self,
        dataset_root,
        subset,
        num_points=1024,
        rotation_magnitude=45.0,
        translation_magnitude=0.5,
        noise_magnitude=None,
        keep_ratio=0.7,
        crop_method="plane",
        asymmetric=True,
        class_indices="all",
        deterministic=False,
        twice_sample=False,
        twice_transform=False,
        min_overlap=None,
        max_overlap=None,
        overfitting_index=None,
    ):
        assert subset in ("train", "val", "test")
        assert crop_method in ("plane", "point")
        self.dataset_root = dataset_root
        self.subset = subset
        self.num_points = num_points
        self.rotation_magnitude = rotation_magnitude
        self.translation_magnitude = translation_magnitude
        self.noise_magnitude = noise_magnitude
        self.keep_ratio = keep_ratio
        self.crop_method = crop_method
        self.deterministic = deterministic
        self.twice_sample = twice_sample
        self.twice_transform = twice_transform
        self.min_overlap = min_overlap
        self.max_overlap = max_overlap
        self.check_overlap = min_overlap is not None or max_overlap is not None
        self.overfitting_index = overfitting_index
        self.class_indices = self._resolve_class_indices(class_indices, asymmetric)

        with open(osp.join(dataset_root, f"{subset}.pkl"), "rb") as f:
            data_list = pickle.load(f)
        data_list = [x for x in data_list if x["label"] in self.class_indices]
        if overfitting_index is not None and deterministic:
            data_list = [data_list[overfitting_index]]
        self.data_list = data_list

    @staticmethod
    def _resolve_class_indices(class_indices, asymmetric):
        if isinstance(class_indices, str):
            class_indices = {
                "all": list(range(40)),
                "seen": list(range(20)),
                "unseen": list(range(20, 40)),
            }[class_indices]
        if asymmetric:
            class_indices = [x for x in class_indices if x in ASYMMETRIC_INDICES]
        return class_indices

    def __len__(self):
        return len(self.data_list)

    def __getitem__(self, index):
        if self.overfitting_index is not None:
            index = self.overfitting_index
        entry = self.data_list[index]
        raw_points = np.asarray(entry["points"]).copy()
        label = entry["label"]

        if self.deterministic:
            np.random.seed(index)

        raw_points = normalize_points(raw_points)
        if not self.twice_sample:
            raw_points = random_sample_points(raw_points, self.num_points)

        ref_points = raw_points.copy()
        if self.twice_transform:
            transform = random_sample_transform(self.rotation_magnitude, self.translation_magnitude)
            ref_points = apply_transform(ref_points, transform)

        src_points = ref_points.copy()
        transform = random_sample_transform(self.rotation_magnitude, self.translation_magnitude)
        src_points = apply_transform(src_points, inverse_transform(transform))

        raw_ref, raw_src = ref_points, src_points
        while True:
            ref_points, src_points = raw_ref, raw_src
            if self.keep_ratio is not None:
                if self.crop_method == "plane":
                    ref_points = random_crop_point_cloud_with_plane(ref_points, keep_ratio=self.keep_ratio)
                    src_points = random_crop_point_cloud_with_plane(src_points, keep_ratio=self.keep_ratio)
                else:
                    viewpoint = random_sample_viewpoint()
                    ref_points = random_crop_point_cloud_with_point(
                        ref_points, viewpoint=viewpoint, keep_ratio=self.keep_ratio
                    )
                    src_points = random_crop_point_cloud_with_point(
                        src_points, viewpoint=viewpoint, keep_ratio=self.keep_ratio
                    )
            if self.check_overlap:
                overlap = compute_overlap(ref_points, src_points, transform, positive_radius=0.05)
                if self.min_overlap is not None and overlap < self.min_overlap:
                    continue
                if self.max_overlap is not None and overlap > self.max_overlap:
                    continue
            break

        if self.twice_sample:
            ref_points = random_sample_points(ref_points, self.num_points)
            src_points = random_sample_points(src_points, self.num_points)

        if self.noise_magnitude is not None:
            ref_points = random_jitter_points(ref_points, scale=0.01, noise_magnitude=self.noise_magnitude)
            src_points = random_jitter_points(src_points, scale=0.01, noise_magnitude=self.noise_magnitude)

        ref_points = random_shuffle_points(ref_points)
        src_points = random_shuffle_points(src_points)

        return {
            "raw_points": raw_points.astype(np.float32),
            "ref_points": ref_points.astype(np.float32),
            "src_points": src_points.astype(np.float32),
            "ref_feats": np.ones((ref_points.shape[0], 1), np.float32),
            "src_feats": np.ones((src_points.shape[0], 1), np.float32),
            "transform": np.asarray(transform, np.float32),
            "label": int(label),
            "index": int(index),
        }
