r"""Numpy registration metrics for offline evaluation: the port's copy of
``geotransformer_tpu/utils/registration.py`` (reference
`utils/registration.py:17-281`), host-side metrics over dumped features and
correspondences (the on-device versions are
:mod:`geotransformer_tpu_torch.losses.metrics`).
"""

import numpy as np
from scipy.spatial import cKDTree

from geotransformer_tpu_torch.utils.pointcloud import apply_transform, get_nearest_neighbor


def compute_relative_rotation_error(gt_rotation, est_rotation):
    """RRE (deg) = acos((trace(R_est^T R_gt) - 1) / 2)."""
    x = 0.5 * (np.trace(np.matmul(est_rotation.T, gt_rotation)) - 1.0)
    return 180.0 / np.pi * np.arccos(np.clip(x, -1.0, 1.0))


def compute_relative_translation_error(gt_translation, est_translation):
    return float(np.linalg.norm(gt_translation - est_translation))


def compute_registration_error(gt_transform, est_transform):
    rre = compute_relative_rotation_error(gt_transform[:3, :3], est_transform[:3, :3])
    rte = compute_relative_translation_error(gt_transform[:3, 3], est_transform[:3, 3])
    return rre, rte


def compute_rotation_mse_and_mae(gt_rotation, est_rotation):
    """Anisotropic rotation error over recovered Euler angles (degrees)."""
    from scipy.spatial.transform import Rotation

    gt_euler = Rotation.from_matrix(gt_rotation).as_euler("xyz", degrees=True)
    est_euler = Rotation.from_matrix(est_rotation).as_euler("xyz", degrees=True)
    mse = float(np.mean((gt_euler - est_euler) ** 2))
    mae = float(np.mean(np.abs(gt_euler - est_euler)))
    return mse, mae


def compute_translation_mse_and_mae(gt_translation, est_translation):
    mse = float(np.mean((gt_translation - est_translation) ** 2))
    mae = float(np.mean(np.abs(gt_translation - est_translation)))
    return mse, mae


def compute_transform_mse_and_mae(gt_transform, est_transform):
    r_mse, r_mae = compute_rotation_mse_and_mae(gt_transform[:3, :3], est_transform[:3, :3])
    t_mse, t_mae = compute_translation_mse_and_mae(gt_transform[:3, 3], est_transform[:3, 3])
    return r_mse, r_mae, t_mse, t_mae


def compute_registration_rmse(src_points, gt_transform, est_transform):
    """Mean residual of src points under gt vs estimated transforms."""
    gt_points = apply_transform(src_points, gt_transform)
    est_points = apply_transform(src_points, est_transform)
    return float(np.linalg.norm(gt_points - est_points, axis=1).mean())


def compute_modified_chamfer_distance(raw_points, ref_points, src_points, gt_transform, est_transform):
    """Modified Chamfer distance (RPMNet protocol)."""
    aligned_src_points = apply_transform(src_points, est_transform)
    chamfer_p_q = get_nearest_neighbor(aligned_src_points, raw_points).mean()
    composed = np.matmul(est_transform, np.linalg.inv(gt_transform))
    aligned_raw = apply_transform(raw_points, composed)
    chamfer_q_p = get_nearest_neighbor(ref_points, aligned_raw).mean()
    return float(chamfer_p_q + chamfer_q_p)


def compute_correspondence_residual(ref_corr_points, src_corr_points, transform):
    src_corr_points = apply_transform(src_corr_points, transform)
    return float(np.linalg.norm(ref_corr_points - src_corr_points, axis=1).mean())


def compute_inlier_ratio(ref_corr_points, src_corr_points, transform, positive_radius=0.1):
    src_corr_points = apply_transform(src_corr_points, transform)
    residuals = np.linalg.norm(ref_corr_points - src_corr_points, axis=1)
    return float(np.mean(residuals < positive_radius))


def compute_overlap(ref_points, src_points, transform=None, positive_radius=0.1):
    if transform is not None:
        src_points = apply_transform(src_points, transform)
    nn_distances = get_nearest_neighbor(ref_points, src_points)
    return float(np.mean(nn_distances < positive_radius))


def get_correspondences(ref_points, src_points, transform, matching_radius):
    """GT correspondence index pairs within `matching_radius` after alignment."""
    src_points = apply_transform(src_points, transform)
    src_tree = cKDTree(src_points)
    indices_list = src_tree.query_ball_point(ref_points, matching_radius)
    corr = [(i, j) for i, indices in enumerate(indices_list) for j in indices]
    return np.asarray(corr, dtype=np.int64).reshape(-1, 2)


def extract_corr_indices_from_feats(ref_feats, src_feats, mutual=False, bilateral=False):
    """Nearest-neighbor (optionally mutual) correspondences in feature space."""
    ref_tree = cKDTree(ref_feats)
    src_tree = cKDTree(src_feats)
    _, ref_nn = src_tree.query(ref_feats, k=1)  # ref -> nearest src
    if mutual or bilateral:
        _, src_nn = ref_tree.query(src_feats, k=1)  # src -> nearest ref
    if mutual:
        ref_indices = np.arange(ref_feats.shape[0])
        mutual_mask = src_nn[ref_nn] == ref_indices
        ref_corr = ref_indices[mutual_mask]
        src_corr = ref_nn[mutual_mask]
    elif bilateral:
        ref_corr = np.concatenate([np.arange(ref_feats.shape[0]), src_nn])
        src_corr = np.concatenate([ref_nn, np.arange(src_feats.shape[0])])
        flat = ref_corr * src_feats.shape[0] + src_corr
        flat = np.unique(flat)
        ref_corr, src_corr = flat // src_feats.shape[0], flat % src_feats.shape[0]
    else:
        ref_corr = np.arange(ref_feats.shape[0])
        src_corr = ref_nn
    return ref_corr, src_corr


def extract_correspondences_from_feats(
    ref_points, src_points, ref_feats, src_feats, mutual=False, return_feat_dist=False
):
    ref_corr, src_corr = extract_corr_indices_from_feats(ref_feats, src_feats, mutual=mutual)
    outputs = [ref_points[ref_corr], src_points[src_corr]]
    if return_feat_dist:
        outputs.append(np.linalg.norm(ref_feats[ref_corr] - src_feats[src_corr], axis=1))
    return outputs


def evaluate_correspondences(ref_points, src_points, transform, positive_radius=0.1):
    return {
        "overlap": compute_overlap(ref_points, src_points, transform, positive_radius),
        "inlier_ratio": compute_inlier_ratio(ref_points, src_points, transform, positive_radius),
        "residual": compute_correspondence_residual(ref_points, src_points, transform),
        "num_corr": ref_points.shape[0],
    }


def evaluate_sparse_correspondences(ref_points, src_points, ref_corr_indices, src_corr_indices, gt_corr_indices):
    """Coarse-level precision/recall/hit-ratio vs GT node correspondences."""
    gt_corr_mat = np.zeros((ref_points.shape[0], src_points.shape[0]))
    gt_corr_mat[gt_corr_indices[:, 0], gt_corr_indices[:, 1]] = 1.0
    pred_corr_mat = np.zeros_like(gt_corr_mat)
    pred_corr_mat[ref_corr_indices, src_corr_indices] = 1.0

    pos_corr_mat = gt_corr_mat * pred_corr_mat
    precision = pos_corr_mat.sum() / (pred_corr_mat.sum() + 1e-12)
    recall = pos_corr_mat.sum() / (gt_corr_mat.sum() + 1e-12)

    pos_corr_mat = pos_corr_mat > 0
    gt_bool = gt_corr_mat > 0
    ref_hit = np.any(pos_corr_mat, axis=1).sum() / (np.any(gt_bool, axis=1).sum() + 1e-12)
    src_hit = np.any(pos_corr_mat, axis=0).sum() / (np.any(gt_bool, axis=0).sum() + 1e-12)
    return {
        "precision": precision,
        "recall": recall,
        "hit_ratio": 0.5 * (ref_hit + src_hit),
    }
