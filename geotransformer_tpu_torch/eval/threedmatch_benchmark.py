r"""3DMatch/3DLoMatch registration-recall benchmark protocol: the port's copy
of ``geotransformer_tpu/eval/threedmatch_benchmark.py`` (reference
`datasets/registration/threedmatch/utils.py:15-228`): ``gt.log``/``gt.info``
parsing, the covariance-weighted transform error, per-scene precision and
recall with non-adjacent-pair gating, and ``est.log`` writing. Quaternions
are converted locally (the reference pulls in nibabel for one mat2quat).
"""

import os
import os.path as osp

import numpy as np

from geotransformer_tpu_torch.utils.pointcloud import get_rotation_translation_from_transform
from geotransformer_tpu_torch.utils.registration import compute_registration_error

SCENE_NUM_FRAGMENTS = {
    "7-scenes-redkitchen": 60,
    "sun3d-home_at-home_at_scan1_2013_jan_1": 60,
    "sun3d-home_md-home_md_scan9_2012_sep_30": 60,
    "sun3d-hotel_uc-scan3": 55,
    "sun3d-hotel_umd-maryland_hotel1": 57,
    "sun3d-hotel_umd-maryland_hotel3": 37,
    "sun3d-mit_76_studyroom-76-1studyroom2": 66,
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": 38,
}

SCENE_ABBREVIATIONS = {
    "7-scenes-redkitchen": "Kitchen",
    "sun3d-home_at-home_at_scan1_2013_jan_1": "Home_1",
    "sun3d-home_md-home_md_scan9_2012_sep_30": "Home_2",
    "sun3d-hotel_uc-scan3": "Hotel_1",
    "sun3d-hotel_umd-maryland_hotel1": "Hotel_2",
    "sun3d-hotel_umd-maryland_hotel3": "Hotel_3",
    "sun3d-mit_76_studyroom-76-1studyroom2": "Study",
    "sun3d-mit_lab_hj-lab_hj_tea_nov_2_2012_scan1_erika": "MIT_Lab",
}


def get_num_fragments(scene_name):
    if scene_name not in SCENE_NUM_FRAGMENTS:
        raise ValueError(f'Unsupported test scene name "{scene_name}".')
    return SCENE_NUM_FRAGMENTS[scene_name]


def get_scene_abbr(scene_name):
    return SCENE_ABBREVIATIONS.get(scene_name, scene_name)


def rotation_matrix_to_quaternion(matrix):
    """(w, x, y, z) quaternion from a rotation matrix (Shepperd's method)."""
    m = np.asarray(matrix, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.asarray([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q


def read_log_file(file_name):
    """Parse a 3DMatch-format .log: blocks of (pair header + 4x4 transform)."""
    with open(file_name) as f:
        lines = [line.strip() for line in f.readlines()]
    test_pairs = []
    for i in range(len(lines) // 5):
        line_id = i * 5
        split_line = lines[line_id].split()
        transform = np.asarray(
            [lines[line_id + j].split() for j in range(1, 5)], dtype=np.float32
        )
        test_pairs.append(
            dict(
                test_pair=[int(split_line[0]), int(split_line[1])],
                num_fragments=int(split_line[2]),
                transform=transform,
            )
        )
    return test_pairs


def read_info_file(file_name):
    """Parse gt.info: blocks of (pair header + 6x6 covariance)."""
    with open(file_name) as f:
        lines = [line.strip() for line in f.readlines()]
    test_pairs = []
    for i in range(len(lines) // 7):
        line_id = i * 7
        split_line = lines[line_id].split()
        covariance = np.asarray(
            [lines[line_id + j].split() for j in range(1, 7)], dtype=np.float32
        )
        test_pairs.append(
            dict(
                test_pair=[int(split_line[0]), int(split_line[1])],
                num_fragments=int(split_line[2]),
                covariance=covariance,
            )
        )
    return test_pairs


def write_log_file(file_name, test_pairs):
    os.makedirs(osp.dirname(file_name), exist_ok=True)
    lines = []
    for test_pair in test_pairs:
        frag_id0, frag_id1 = test_pair["test_pair"]
        lines.append(f"{frag_id0}\t{frag_id1}\t{test_pair['num_fragments']}\n")
        for row in np.asarray(test_pair["transform"]).tolist():
            lines.append("\t".join(str(x) for x in row) + "\n")
    with open(file_name, "w") as f:
        f.writelines(lines)


def get_gt_logs_and_infos(gt_root, num_fragments):
    gt_logs = read_log_file(osp.join(gt_root, "gt.log"))
    gt_infos = read_info_file(osp.join(gt_root, "gt.info"))
    gt_indices = -np.ones((num_fragments, num_fragments), dtype=np.int32)
    for i, gt_log in enumerate(gt_logs):
        frag_id0, frag_id1 = gt_log["test_pair"]
        if frag_id1 > frag_id0 + 1:  # exclude adjacent frames
            gt_indices[frag_id0, frag_id1] = i
    return gt_indices, gt_logs, gt_infos


def compute_transform_error(transform, covariance, estimated_transform):
    """Covariance-weighted squared error of the relative transform."""
    relative = np.matmul(np.linalg.inv(transform), estimated_transform)
    rotation, translation = get_rotation_translation_from_transform(relative)
    q = rotation_matrix_to_quaternion(rotation)
    er = np.concatenate([translation, q[1:]], axis=0)
    p = er.reshape(1, 6) @ covariance @ er.reshape(6, 1) / covariance[0, 0]
    return float(p.item())


def evaluate_registration_one_scene(gt_log_file, gt_info_file, result_file, positive_threshold=0.2):
    """Per-scene registration precision/recall (RMSE < threshold protocol)."""
    gt_logs = read_log_file(gt_log_file)
    gt_infos = read_info_file(gt_info_file)
    result_logs = read_log_file(result_file)

    num_fragments = gt_logs[0]["num_fragments"]
    gt_indices = -np.ones((num_fragments, num_fragments), dtype=np.int32)
    num_gt_pairs = 0
    for i, gt_log in enumerate(gt_logs):
        frag_id0, frag_id1 = gt_log["test_pair"]
        if frag_id1 > frag_id0 + 1:
            gt_indices[frag_id0, frag_id1] = i
            num_gt_pairs += 1

    num_pos_pairs = 0
    num_pred_pairs = 0
    rres, rtes, errors = [], [], []
    for result_log in result_logs:
        frag_id0, frag_id1 = result_log["test_pair"]
        if gt_indices[frag_id0, frag_id1] == -1:
            continue
        num_pred_pairs += 1
        gt_index = gt_indices[frag_id0, frag_id1]
        transform = gt_logs[gt_index]["transform"]
        covariance = gt_infos[gt_index]["covariance"]
        assert gt_infos[gt_index]["test_pair"] == [frag_id0, frag_id1]
        error = compute_transform_error(transform, covariance, result_log["transform"])
        errors.append({"id0": frag_id0, "id1": frag_id1, "error": error})
        if error <= positive_threshold**2:
            num_pos_pairs += 1
            rre, rte = compute_registration_error(transform, result_log["transform"])
            rres.append(rre)
            rtes.append(rte)

    return {
        "precision": num_pos_pairs / num_pred_pairs if num_pred_pairs > 0 else 0.0,
        "recall": num_pos_pairs / num_gt_pairs if num_gt_pairs > 0 else 0.0,
        "mean_rre": float(np.mean(rres)) if rres else 0.0,
        "mean_rte": float(np.mean(rtes)) if rtes else 0.0,
        "median_rre": float(np.median(rres)) if rres else 0.0,
        "median_rte": float(np.median(rtes)) if rtes else 0.0,
        "num_pos_pairs": num_pos_pairs,
        "num_pred_pairs": num_pred_pairs,
        "num_gt_pairs": num_gt_pairs,
        "errors": errors,
    }
