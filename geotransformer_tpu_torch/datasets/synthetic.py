r"""Synthetic multi-scene fragment benchmark: the port's copy of
``geotransformer_tpu/datasets/synthetic.py``, a stand-in for the real
3DMatch data with the same protocol files.

Generates procedural indoor-ish scenes (wavy floor + random wall/box
planes), carves depth-camera-like fragments from per-fragment viewpoints,
poses each fragment in its own local frame, and exports the full 3DMatch
evaluation protocol metadata: per-scene ``gt.log`` (relative poses of
non-adjacent overlapping pairs) and ``gt.info`` (6x6 registration
covariances), so ``scripts/eval.py --benchmark_root ...`` runs the
covariance-weighted RR protocol of the reference
(`datasets/registration/threedmatch/utils.py:117-136`) on synthetic data.
Every draw comes from ``np.random.default_rng`` of the given seed, so the
same seed gives the same scenes, pairs and files as the JAX package.

The covariance is built the way the 3DMatch benchmark builds it: for the
small-motion parameterization er = [t, q] (translation + vector quaternion),
a point p moves by ~ t + 2 q x p, so
    Cov = sum_p J_p^T J_p,   J_p = [I_3 | -2 [p]_x]
and ``compute_transform_error`` (er^T Cov er / Cov[0,0]) is then the mean
squared point displacement over the overlap region — i.e. RMSE^2, matching
the reference's ``rmse_threshold**2`` acceptance test.
"""

import os
import os.path as osp

import numpy as np


def random_rotation_matrix(rng):
    """Uniform random rotation (QR of a gaussian matrix, det fixed to +1)."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q *= np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def _skew(p):
    return np.array([
        [0.0, -p[2], p[1]],
        [p[2], 0.0, -p[0]],
        [-p[1], p[0], 0.0],
    ])


def pair_covariance(points):
    """3DMatch-style 6x6 registration covariance over overlap points."""
    points = np.asarray(points, dtype=np.float64)
    n = len(points)
    # J_p = [I | -2 [p]_x]; Cov = sum J^T J, assembled blockwise:
    #   [ n*I          -2 sum [p]_x       ]
    #   [ 2 sum [p]_x   4 sum [p]_x^T[p]_x ]
    s = np.zeros((3, 3))
    q = np.zeros((3, 3))
    for p in points:
        sk = _skew(p)
        s += sk
        q += sk.T @ sk
    cov = np.zeros((6, 6))
    cov[:3, :3] = n * np.eye(3)
    cov[:3, 3:] = -2.0 * s
    cov[3:, :3] = -2.0 * s.T
    cov[3:, 3:] = 4.0 * q
    return cov


def _scene_cloud(rng, num_points, extent):
    """Wavy floor + 2-4 random wall planes + a box, densely sampled."""
    parts = []
    n_floor = num_points // 2
    xy = rng.uniform(0, extent, (n_floor, 2))
    z = (0.25 * np.sin(2.1 * xy[:, 0] + rng.uniform(0, 6.28))
         + 0.2 * np.cos(1.7 * xy[:, 1] + rng.uniform(0, 6.28)))
    parts.append(np.column_stack([xy, z]))
    n_walls = rng.integers(2, 5)
    for _ in range(n_walls):
        n_w = num_points // (2 * n_walls)
        # vertical plane at random position/orientation
        theta = rng.uniform(0, np.pi)
        c = rng.uniform(0.2 * extent, 0.8 * extent, 2)
        length = rng.uniform(0.3 * extent, 0.8 * extent)
        tline = rng.uniform(-0.5, 0.5, n_w) * length
        h = rng.uniform(0.0, 1.6, n_w)
        x = c[0] + tline * np.cos(theta)
        y = c[1] + tline * np.sin(theta)
        # carve window/door holes so fragments overlap through structure
        keep = ~((h > 0.5) & (h < 1.1) & (np.abs(tline) < 0.15 * length))
        parts.append(np.column_stack([x, y, h])[keep])
    cloud = np.concatenate(parts, 0)
    cloud += rng.normal(0, 0.004, cloud.shape)
    return cloud.astype(np.float32)


def _carve_fragment(rng, cloud, extent):
    """Depth-camera-ish crop: points near a viewpoint, in a forward cone."""
    center = np.array([extent / 2, extent / 2, 0.5])
    view = np.concatenate([rng.uniform(0, extent, 2), [rng.uniform(0.8, 1.6)]])
    fwd = center - view + rng.normal(0, 0.35, 3)
    fwd /= np.linalg.norm(fwd) + 1e-9
    rel = cloud - view
    dist = np.linalg.norm(rel, axis=1)
    cosang = (rel @ fwd) / np.maximum(dist, 1e-9)
    keep = (dist < rng.uniform(0.6, 0.85) * extent) & (cosang > 0.45)
    return cloud[keep]


class SyntheticSceneBenchmark:
    """Procedural fragment-registration benchmark.

    Args:
        num_scenes: scenes to generate (each gets its own surface + seed).
        fragments_per_scene: fragments carved per scene.
        num_points: dense scene sample count (fragments are subsets).
        extent: scene side length in meters (3DMatch-roomish ~ 3-4 m).
        min_overlap: keep pairs with at least this overlap fraction.
        point_limit: per-fragment subsample cap.
        seed: base seed.

    Indexable as a pair dataset (Tester/PairLoader compatible): items carry
    scene_name/ref_frame/src_frame metadata keys and the GT transform
    mapping src -> ref (both fragments in their LOCAL frames).
    """

    def __init__(self, num_scenes=2, fragments_per_scene=6, num_points=60000,
                 extent=3.5, min_overlap=0.3, point_limit=12000, seed=0,
                 scene_prefix="synth-scene"):
        self.scenes = []
        self.pairs = []
        self.point_limit = point_limit
        for s in range(num_scenes):
            rng = np.random.default_rng(seed * 1000 + s)
            cloud = _scene_cloud(rng, num_points, extent)
            frags, poses = [], []
            for _ in range(fragments_per_scene):
                frag = _carve_fragment(rng, cloud, extent)
                while len(frag) < 2000:  # too-small crop: recarve
                    frag = _carve_fragment(rng, cloud, extent)
                if len(frag) > point_limit:
                    frag = frag[rng.permutation(len(frag))[:point_limit]]
                rot = random_rotation_matrix(rng)
                t = rng.uniform(-1.0, 1.0, 3)
                # local frame: p_local = R^T (p - t)
                local = (frag - t) @ rot
                frags.append(local.astype(np.float32))
                poses.append((rot, t))
            name = f"{scene_prefix}{s}"
            self.scenes.append(dict(name=name, fragments=frags, poses=poses))
            # non-adjacent overlapping pairs (the 3DMatch protocol skips
            # j == i+1, threedmatch/utils.py:117-128)
            from scipy.spatial import cKDTree

            for i in range(fragments_per_scene):
                tree = cKDTree(frags[i])
                for j in range(i + 2, fragments_per_scene):
                    transform = self.gt_transform(s, i, j)
                    src_in_ref = frags[j] @ transform[:3, :3].T + transform[:3, 3]
                    d, _ = tree.query(src_in_ref, k=1)
                    overlap = float((d < 0.0375).mean())
                    if overlap >= min_overlap:
                        self.pairs.append(dict(
                            scene=s, ref_frame=i, src_frame=j, overlap=overlap))

    def gt_transform(self, scene_idx, i, j):
        """4x4 mapping fragment j's local frame into fragment i's."""
        rot_i, t_i = self.scenes[scene_idx]["poses"][i]
        rot_j, t_j = self.scenes[scene_idx]["poses"][j]
        # p_i = R_i^T (R_j p_j + t_j - t_i)
        out = np.eye(4, dtype=np.float32)
        out[:3, :3] = rot_i.T @ rot_j
        out[:3, 3] = rot_i.T @ (t_j - t_i)
        return out

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, index):
        pair = self.pairs[index]
        scene = self.scenes[pair["scene"]]
        transform = self.gt_transform(pair["scene"], pair["ref_frame"], pair["src_frame"])
        return {
            "scene_name": scene["name"],
            "ref_frame": pair["ref_frame"],
            "src_frame": pair["src_frame"],
            "overlap": pair["overlap"],
            "ref_points": scene["fragments"][pair["ref_frame"]],
            "src_points": scene["fragments"][pair["src_frame"]],
            "transform": transform,
        }

    def write_benchmark(self, benchmark_root, cov_subsample=4000, seed=0):
        """Write per-scene gt.log + gt.info (3DMatch protocol files)."""
        rng = np.random.default_rng(seed)
        for s, scene in enumerate(self.scenes):
            n_frag = len(scene["fragments"])
            scene_dir = osp.join(benchmark_root, scene["name"])
            os.makedirs(scene_dir, exist_ok=True)
            log_lines, info_lines = [], []
            for pair in self.pairs:
                if pair["scene"] != s:
                    continue
                i, j = pair["ref_frame"], pair["src_frame"]
                transform = self.gt_transform(s, i, j)
                src = scene["fragments"][j]
                if len(src) > cov_subsample:
                    src = src[rng.permutation(len(src))[:cov_subsample]]
                overlap_pts = src @ transform[:3, :3].T + transform[:3, 3]
                cov = pair_covariance(overlap_pts)
                log_lines.append(f"{i}\t{j}\t{n_frag}\n")
                for row in transform.tolist():
                    log_lines.append("\t".join(f"{x:.8f}" for x in row) + "\n")
                info_lines.append(f"{i}\t{j}\t{n_frag}\n")
                for row in cov.tolist():
                    info_lines.append("\t".join(f"{x:.8f}" for x in row) + "\n")
            with open(osp.join(scene_dir, "gt.log"), "w") as f:
                f.writelines(log_lines)
            with open(osp.join(scene_dir, "gt.info"), "w") as f:
                f.writelines(info_lines)
