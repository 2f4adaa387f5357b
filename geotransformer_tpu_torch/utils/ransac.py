r"""Correspondence-based RANSAC registration (baseline estimator): the port's
copy of ``geotransformer_tpu/utils/ransac.py``, a vectorized numpy
replacement of the reference's open3d RANSAC glue
(`geotransformer/utils/open3d.py:133-198`): batched minimal-sample Kabsch
hypotheses, inlier counting and a final refit on the best consensus set,
drawn from ``np.random.default_rng(seed)``. The offline evaluator's
``ransac`` method (the LGR path never needs it).
"""

import numpy as np


def _kabsch(src, ref, weights=None):
    """Batched (or single) rigid fit src -> ref. src/ref: (..., N, 3)."""
    if weights is None:
        weights = np.ones(src.shape[:-1])
    w = weights / np.maximum(weights.sum(axis=-1, keepdims=True), 1e-12)
    w = w[..., None]
    src_c = (src * w).sum(axis=-2, keepdims=True)
    ref_c = (ref * w).sum(axis=-2, keepdims=True)
    src0 = src - src_c
    ref0 = ref - ref_c
    H = np.einsum("...nc,...nd->...cd", src0 * w, ref0)
    U, _, Vt = np.linalg.svd(H)
    V = np.swapaxes(Vt, -1, -2)
    Ut = np.swapaxes(U, -1, -2)
    det = np.linalg.det(V @ Ut)
    fix = np.tile(np.eye(3), H.shape[:-2] + (1, 1))
    fix[..., 2, 2] = np.sign(det)
    R = V @ fix @ Ut
    t = ref_c[..., 0, :] - np.einsum("...cd,...d->...c", R, src_c[..., 0, :])
    return R, t


def registration_with_ransac_from_featurematch(
    src_points,
    ref_points,
    src_feats,
    ref_feats,
    distance_threshold=0.05,
    ransac_n=3,
    num_iterations=50000,
    edge_length_ratio=0.9,
    mutual=False,
    seed=0,
):
    """RANSAC registration from descriptor matches (no given correspondences).

    Equivalent of the reference's open3d feature-matching RANSAC
    (reference `geotransformer/utils/open3d.py:133-168`): putative
    correspondences come from nearest-neighbor matching in feature space;
    each minimal sample must pass an edge-length compatibility check (both
    ratios > `edge_length_ratio`, mirroring o3d's
    CorrespondenceCheckerBasedOnEdgeLength) before its hypothesis competes
    on inlier count over the putative set.

    Args:
        src_points / ref_points: (M, 3) / (N, 3) dense points.
        src_feats / ref_feats: (M, C) / (N, C) descriptors.
        distance_threshold: inlier radius.
        ransac_n: minimal sample size.
        num_iterations: hypothesis count.
        edge_length_ratio: o3d edge-length checker threshold.
        mutual: restrict putative matches to mutual nearest neighbors.

    Returns:
        (4, 4) transform.
    """
    from geotransformer_tpu_torch.utils.registration import extract_corr_indices_from_feats

    ref_idx, src_idx = extract_corr_indices_from_feats(
        np.asarray(ref_feats), np.asarray(src_feats), mutual=mutual
    )
    src_corr = np.asarray(src_points, np.float64)[src_idx]
    ref_corr = np.asarray(ref_points, np.float64)[ref_idx]
    n = src_corr.shape[0]
    if n < ransac_n:
        R, t = _kabsch(src_corr, ref_corr)
        transform = np.eye(4)
        transform[:3, :3] = R
        transform[:3, 3] = t
        return transform.astype(np.float32)

    rng = np.random.default_rng(seed)
    ii, jj = np.triu_indices(ransac_n, k=1)
    best_count, best_R, best_t, best_inliers = -1, None, None, None
    # Chunked hypothesis evaluation: (chunk, N) residuals stay ~100 MB even
    # at o3d's default 50k iterations over dense putative match sets.
    chunk = max(1, min(num_iterations, (1 << 25) // max(n, 1)))
    for start in range(0, num_iterations, chunk):
        size = min(chunk, num_iterations - start)
        samples = rng.integers(0, n, size=(size, ransac_n))
        s_smp = src_corr[samples]  # (I, n, 3)
        r_smp = ref_corr[samples]
        # Edge-length compatibility (o3d checker): for every sample edge
        # (i, j), min(|e_src|, |e_ref|) > ratio * max(|e_src|, |e_ref|).
        es = np.linalg.norm(s_smp[:, ii] - s_smp[:, jj], axis=-1)  # (I, E)
        er = np.linalg.norm(r_smp[:, ii] - r_smp[:, jj], axis=-1)
        lo = np.minimum(es, er)
        hi = np.maximum(es, er)
        compatible = np.all(lo > edge_length_ratio * hi, axis=-1)  # (I,)

        R, t = _kabsch(s_smp, r_smp)  # (I, 3, 3), (I, 3)
        aligned = np.einsum("icd,nd->inc", R, src_corr) + t[:, None, :]
        residuals = np.linalg.norm(aligned - ref_corr[None], axis=-1)
        inliers = residuals < distance_threshold  # (I, N)
        counts = np.where(compatible, inliers.sum(axis=1), -1)
        arg = int(np.argmax(counts))
        if counts[arg] > best_count:
            best_count = int(counts[arg])
            best_R, best_t, best_inliers = R[arg], t[arg], inliers[arg]

    if best_count >= ransac_n:
        R_f, t_f = _kabsch(src_corr[best_inliers], ref_corr[best_inliers])
    else:
        R_f, t_f = best_R, best_t
    transform = np.eye(4)
    transform[:3, :3] = R_f
    transform[:3, 3] = t_f
    return transform.astype(np.float32)


def registration_with_ransac_from_correspondences(
    src_corr_points,
    ref_corr_points,
    distance_threshold=0.05,
    ransac_n=3,
    num_iterations=1000,
    seed=0,
):
    """Estimate the rigid transform src -> ref by RANSAC over correspondences.

    Args:
        src_corr_points / ref_corr_points: (N, 3) matched points.
        distance_threshold: inlier radius.
        ransac_n: minimal sample size.
        num_iterations: hypothesis count.

    Returns:
        (4, 4) transform.
    """
    src = np.asarray(src_corr_points, np.float64)
    ref = np.asarray(ref_corr_points, np.float64)
    n = src.shape[0]
    if n < ransac_n:
        R, t = _kabsch(src, ref)
        transform = np.eye(4)
        transform[:3, :3] = R
        transform[:3, 3] = t
        return transform.astype(np.float32)

    rng = np.random.default_rng(seed)
    samples = rng.integers(0, n, size=(num_iterations, ransac_n))
    R, t = _kabsch(src[samples], ref[samples])  # (I, 3, 3), (I, 3)
    aligned = np.einsum("icd,nd->inc", R, src) + t[:, None, :]  # (I, N, 3)
    residuals = np.linalg.norm(aligned - ref[None], axis=-1)
    inliers = residuals < distance_threshold  # (I, N)
    best = int(np.argmax(inliers.sum(axis=1)))
    best_inliers = inliers[best]
    if best_inliers.sum() >= ransac_n:
        R_f, t_f = _kabsch(src[best_inliers], ref[best_inliers])
    else:
        R_f, t_f = R[best], t[best]
    transform = np.eye(4)
    transform[:3, :3] = R_f
    transform[:3, 3] = t_f
    return transform.astype(np.float32)
