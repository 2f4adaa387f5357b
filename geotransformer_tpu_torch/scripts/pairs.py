r"""The synthetic pairs the profiling tools and ``chip_smoke.py`` run on, and
their batches.

No tool reads a dataset: each makes its pair from a seed.

* 3DMatch: :func:`make_3dmatch_pair`, a 1.3 m square wavy surface of
  19,000 points and its 80 % overlap (RGB-D fragment scale);
* KITTI: :func:`make_kitti_pair`, two LiDAR scans ray-cast from two poses
  (about 26,000 and 21,000 points after the 0.3 m voxel grid).

:func:`tool_batch` pads a pair as the chip cells do: 3DMatch caps fitted to
the pair per cloud (a multiple of 256); KITTI caps and split tables
calibrated over the pair. A training batch carries the inverse tables
(KITTI: split inverse tables too) and, for 3DMatch, its GT targets; a
KITTI step computes its GT overlaps itself. The tests shrink the tools
through :func:`tool_config` and :func:`make_tool_pair`.
"""

import numpy as np

from geotransformer_tpu_torch.configs import make_3dmatch_config, make_kitti_config
from geotransformer_tpu_torch.models import precompute_gt_targets
from geotransformer_tpu_torch.preprocess import (
    batch_to_torch,
    build_pyramid,
    calibrate_split_specs,
    calibrate_stage_caps,
    caps_for_pyramid,
    fit_split_for_table,
    pad_registration_batch,
)
from geotransformer_tpu_torch.preprocess.voxel import grid_subsample_single


def make_3dmatch_pair(seed, n_ref=19000, extent=1.3):
    """Wavy surface (z = 0.5 sin(25 x) cos(20 y)) over extent x extent m;
    src is the part with x < 0.8 extent, 4 mm noise, in its own frame.
    Returns (ref, src, transform) with ref = R src + t."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.0, extent, (n_ref, 2))
    z = 0.5 * np.sin(25.0 * xy[:, 0]) * np.cos(20.0 * xy[:, 1])
    ref = np.column_stack([xy, z]).astype(np.float32)
    keep = ref[:, 0] < 0.8 * extent
    world = ref[keep] + 0.004 * rng.normal(size=(int(keep.sum()), 3))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    angle = rng.uniform(0.2, 0.8)
    skew = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                     [-axis[1], axis[0], 0.0]])
    rot = np.eye(3) + np.sin(angle) * skew + (1.0 - np.cos(angle)) * skew @ skew
    trans = rng.uniform(-0.3, 0.3, 3)
    src = ((world - trans) @ rot).astype(np.float32)  # world = rot src + trans
    transform = np.eye(4, dtype=np.float32)
    transform[:3, :3], transform[:3, 3] = rot, trans
    return ref, src, transform


def make_kitti_pair(seed, n_rays=180000):
    """Synthetic LiDAR scan pair at KITTI scale (the JAX package's bench
    generator, bench.py:97-154): returns on the ground plane and on 40
    vertical facade planes, ray-cast from two sensor poses 1.7 m above the
    ground, 2 cm noise, each scan in its own sensor frame through a 0.3 m
    voxel grid (at most 30,000 points). The src sensor sits at (6, 2) with
    yaw 0.12, so ref = R_z(0.12) src + (6, 2, 0)."""
    rng = np.random.default_rng(seed)
    n_planes = 40
    c = rng.uniform(-50, 50, (n_planes, 2))
    theta = rng.uniform(0, np.pi, n_planes)
    nvec = np.stack([np.cos(theta), np.sin(theta)], 1)
    tvec = np.stack([-np.sin(theta), np.cos(theta)], 1)
    halfw = rng.uniform(3.0, 15.0, n_planes)
    height = rng.uniform(2.5, 10.0, n_planes)

    def scan(pos, yaw):
        az = rng.uniform(0, 2 * np.pi, n_rays)
        elev = np.deg2rad(rng.uniform(-24.0, 2.0, n_rays))
        ce, se = np.cos(elev), np.sin(elev)
        ca, sa = np.cos(az + yaw), np.sin(az + yaw)
        dirs = np.stack([ce * ca, ce * sa, se], 1)  # world-frame rays
        p = np.array([pos[0], pos[1], 1.7])
        d = np.where(dirs[:, 2] < -1e-4, -p[2] / np.minimum(dirs[:, 2], -1e-4), np.inf)
        for i in range(n_planes):
            denom = dirs[:, 0] * nvec[i, 0] + dirs[:, 1] * nvec[i, 1]
            denom = np.where(np.abs(denom) < 1e-6, 1e-6, denom)
            t = ((c[i, 0] - p[0]) * nvec[i, 0] + (c[i, 1] - p[1]) * nvec[i, 1]) / denom
            hz = p[2] + t * dirs[:, 2]
            u = ((p[0] + t * dirs[:, 0] - c[i, 0]) * tvec[i, 0]
                 + (p[1] + t * dirs[:, 1] - c[i, 1]) * tvec[i, 1])
            ok = (t > 1.0) & (t < d) & (np.abs(u) < halfw[i]) & (hz > 0.0) & (hz < height[i])
            d = np.where(ok, t, d)
        keep = d < 75.0
        d = d[keep]
        # sensor-frame coordinates (rotation about z: the local azimuth drops yaw)
        ca_l, sa_l = np.cos(az[keep]), np.sin(az[keep])
        pts = np.stack([d * ce[keep] * ca_l, d * ce[keep] * sa_l, d * se[keep]],
                       1).astype(np.float32)
        pts += rng.normal(0, 0.02, pts.shape).astype(np.float32)
        return grid_subsample_single(pts, 0.3)

    ref = scan((0.0, 0.0), 0.0)
    src = scan((6.0, 2.0), 0.12)
    limit = 30000
    if len(ref) > limit:
        ref = ref[rng.permutation(len(ref))[:limit]]
    if len(src) > limit:
        src = src[rng.permutation(len(src))[:limit]]
    transform = np.eye(4, dtype=np.float32)
    cos, sin = np.cos(0.12), np.sin(0.12)
    transform[:3, :3] = [[cos, -sin, 0.0], [sin, cos, 0.0], [0.0, 0.0, 1.0]]
    transform[:3, 3] = (6.0, 2.0, 0.0)
    return ref.astype(np.float32), src.astype(np.float32), transform


def tool_config(kitti):
    """The configuration a tool runs at: the full-width KITTI or 3DMatch one."""
    return make_kitti_config() if kitti else make_3dmatch_config()


def make_tool_pair(kitti, seed):
    return make_kitti_pair(seed) if kitti else make_3dmatch_pair(seed)


def tool_pyramid(cfg, pair):
    """The host pyramid of a (ref, src, transform) pair."""
    ref, src, _ = pair
    bb = cfg.backbone
    return build_pyramid(np.concatenate([ref, src], 0), np.asarray([len(ref), len(src)]),
                         bb.num_stages, bb.init_voxel_size, bb.init_radius,
                         list(cfg.caps.neighbor_limits))


def inverse_splits(batch):
    """The split specs of a padded batch's inverse tables, fitted to them:
    ``pad_registration_batch``'s ``inverse_splits`` and
    ``sub_inverse_splits``."""
    rows = [nb.shape[0] for nb in batch["neighbors"]]
    # the subsampling inverse's sentinel is the next stage's row count
    return dict(inverse_splits=[fit_split_for_table(inv, rows[i], align=8)
                                for i, inv in enumerate(batch["neighbors_inv"])],
                sub_inverse_splits=[fit_split_for_table(inv, rows[i + 1], align=8)
                                    for i, inv in enumerate(batch["subsampling_inv"])])


def tool_batch(cfg, pair, kitti, device, training=False):
    """(cfg with the batch's caps, the padded batch on ``device``) of one
    pair, as the chip cells pad theirs (module docstring)."""
    pyramid = tool_pyramid(cfg, pair)
    feats = np.ones((len(pair[0]) + len(pair[1]), 1), np.float32)
    transform = pair[2]
    inverse = dict(inverse_limits=cfg.caps.inverse_limits) if training else {}
    if kitti:
        bb = cfg.backbone
        sample = [{"ref_points": pair[0], "src_points": pair[1]}]
        args = (bb.num_stages, bb.init_voxel_size, bb.init_radius, list(cfg.caps.neighbor_limits))
        caps = tuple(calibrate_stage_caps(iter(sample), *args, num_samples=1))
        nb_splits, sub_splits = calibrate_split_specs(iter(sample), *args, num_samples=1)
        kw = dict(inverse, neighbor_splits=nb_splits, subsampling_splits=sub_splits)
        batch = pad_registration_batch(pyramid, feats, transform, caps, **kw)
        if training:
            batch = pad_registration_batch(pyramid, feats, transform, caps, **kw,
                                           **inverse_splits(batch))
    else:
        caps = tuple(caps_for_pyramid(pyramid, multiple=256, per_cloud=True))
        batch = pad_registration_batch(pyramid, feats, transform, caps, **inverse)
    cfg = cfg.with_caps(stage_caps=caps)
    batch = batch_to_torch(batch, device)
    if training and not kitti:
        batch.update(precompute_gt_targets(cfg, batch, device=device))
    return cfg, batch
