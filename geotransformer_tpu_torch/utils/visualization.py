r"""Optional visualization helpers (``geotransformer_tpu/utils/visualization.py``;
reference `utils/visualization.py`, `utils/open3d.py`).

The exports (npz, Wavefront .obj spheres and segments), the t-SNE / PCA
feature colouring and the point-to-node colouring are numpy. The drawing
functions need open3d, an optional dependency: without it they raise
ImportError, as the JAX ones do.
"""

import numpy as np


def _require_open3d():
    try:
        import open3d as o3d  # noqa: F401

        return o3d
    except ImportError as exc:  # pragma: no cover - environment-dependent
        raise ImportError(
            "open3d is required for visualization; install it or use the "
            "matplotlib-free data exports instead"
        ) from exc


def make_open3d_point_cloud(points, color=None):
    o3d = _require_open3d()
    pcd = o3d.geometry.PointCloud()
    pcd.points = o3d.utility.Vector3dVector(np.asarray(points, np.float64))
    if color is not None:
        pcd.paint_uniform_color(color)
    return pcd


def draw_registration(ref_points, src_points, transform=None):
    """Show ref (blue) / src (yellow) clouds, optionally aligned."""
    o3d = _require_open3d()
    from geotransformer_tpu_torch.utils.pointcloud import apply_transform

    if transform is not None:
        src_points = apply_transform(np.asarray(src_points), np.asarray(transform))
    ref_pcd = make_open3d_point_cloud(ref_points, color=[0.0, 0.4, 1.0])
    src_pcd = make_open3d_point_cloud(src_points, color=[1.0, 0.8, 0.0])
    o3d.visualization.draw_geometries([ref_pcd, src_pcd])


def correspondences_to_line_set(ref_corr_points, src_corr_points, inlier_masks=None):
    """LineSet connecting correspondences (green inliers / red outliers)."""
    o3d = _require_open3d()
    n = len(ref_corr_points)
    points = np.concatenate([ref_corr_points, src_corr_points], axis=0)
    lines = np.stack([np.arange(n), np.arange(n) + n], axis=1)
    colors = np.zeros((n, 3))
    if inlier_masks is None:
        colors[:] = [0, 1, 0]
    else:
        colors[np.asarray(inlier_masks)] = [0, 1, 0]
        colors[~np.asarray(inlier_masks)] = [1, 0, 0]
    line_set = o3d.geometry.LineSet()
    line_set.points = o3d.utility.Vector3dVector(points)
    line_set.lines = o3d.utility.Vector2iVector(lines)
    line_set.colors = o3d.utility.Vector3dVector(colors)
    return line_set


def export_registration_npz(path, ref_points, src_points, transform, estimated_transform):
    """Headless-friendly export for later visualization elsewhere."""
    np.savez_compressed(
        path,
        ref_points=np.asarray(ref_points),
        src_points=np.asarray(src_points),
        transform=np.asarray(transform),
        estimated_transform=np.asarray(estimated_transform),
    )


def get_colors_with_tsne(data, perplexity=30.0, seed=0):
    """Map high-dimensional features to RGB in [0, 1] via 1-D t-SNE
    (reference utils/visualization.py:65-78: TSNE to 1-D + jet colormap);
    falls back to a PCA projection when scikit-learn is unavailable."""
    data = np.asarray(data, np.float64)
    try:
        from sklearn.manifold import TSNE

        emb = TSNE(
            n_components=1, perplexity=min(perplexity, max(2.0, len(data) - 2)),
            random_state=seed, init="pca",
        ).fit_transform(data)[:, 0]
    except Exception:  # pragma: no cover - sklearn-optional fallback
        data = data - data.mean(0)
        _, _, vt = np.linalg.svd(data, full_matrices=False)
        emb = data @ vt[0]
    t = emb - emb.min()
    t = t / max(t.max(), 1e-12)
    # compact jet-like ramp (blue -> cyan -> yellow -> red)
    r = np.clip(1.5 - np.abs(4.0 * t - 3.0), 0.0, 1.0)
    g = np.clip(1.5 - np.abs(4.0 * t - 2.0), 0.0, 1.0)
    b = np.clip(1.5 - np.abs(4.0 * t - 1.0), 0.0, 1.0)
    return np.stack([r, g, b], axis=1)


def point_to_node_colors(num_nodes, point_to_node, node_colors=None):
    """(N, 3) colour of each point: its node's colour, random from seed 0
    unless ``node_colors`` (num_nodes, 3) is given."""
    if node_colors is None:
        node_colors = np.random.default_rng(0).uniform(0, 1, (num_nodes, 3))
    return np.asarray(node_colors)[np.asarray(point_to_node)]


def draw_point_to_node(points, nodes, point_to_node, node_colors=None):
    """Color each point by its assigned node and draw both clouds
    (reference utils/visualization.py:14-26)."""
    o3d = _require_open3d()
    points = np.asarray(points)
    nodes = np.asarray(nodes)
    point_colors = point_to_node_colors(nodes.shape[0], point_to_node, node_colors)
    pcd = make_open3d_point_cloud(points)
    pcd.colors = o3d.utility.Vector3dVector(point_colors)
    ncd = make_open3d_point_cloud(nodes, color=(0, 0, 0))
    o3d.visualization.draw_geometries([pcd, ncd])


def draw_node_correspondences(
    ref_points, ref_nodes, ref_point_to_node,
    src_points, src_nodes, src_point_to_node,
    node_correspondences, offset=(0.0, 2.0, 0.0),
):
    """Side-by-side clouds colored by node assignment with correspondence
    lines between matched nodes (reference utils/visualization.py:28-62)."""
    o3d = _require_open3d()
    offset = np.asarray(offset)
    rng = np.random.default_rng(0)
    ref_colors = rng.uniform(0, 1, (np.asarray(ref_nodes).shape[0], 3))
    src_colors = rng.uniform(0, 1, (np.asarray(src_nodes).shape[0], 3))
    ref_pcd = make_open3d_point_cloud(np.asarray(ref_points))
    ref_pcd.colors = o3d.utility.Vector3dVector(
        ref_colors[np.asarray(ref_point_to_node)])
    src_pcd = make_open3d_point_cloud(np.asarray(src_points) + offset)
    src_pcd.colors = o3d.utility.Vector3dVector(
        src_colors[np.asarray(src_point_to_node)])
    corr = np.asarray(node_correspondences)
    lines = correspondences_to_line_set(
        np.asarray(ref_nodes)[corr[:, 0]],
        np.asarray(src_nodes)[corr[:, 1]] + offset,
    )
    o3d.visualization.draw_geometries([ref_pcd, src_pcd, lines])


def _sphere_mesh(center, radius, resolution):
    """Pure-numpy UV-sphere (vertices, faces) — no open3d dependency."""
    u = np.linspace(0, np.pi, resolution + 1)
    v = np.linspace(0, 2 * np.pi, 2 * resolution, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = np.stack([
        np.sin(uu) * np.cos(vv), np.sin(uu) * np.sin(vv), np.cos(uu)
    ], axis=-1).reshape(-1, 3) * radius + np.asarray(center)
    faces = []
    w = 2 * resolution
    for i in range(resolution):
        for j in range(w):
            a = i * w + j
            b = i * w + (j + 1) % w
            c = (i + 1) * w + j
            d = (i + 1) * w + (j + 1) % w
            faces.append((a, b, d))
            faces.append((a, d, c))
    return verts, np.asarray(faces)


def write_points_to_obj(file_name, points, colors=None, radius=0.02, resolution=6):
    """Write points as small spheres to a Wavefront .obj
    (reference utils/visualization.py:80-107); pure numpy."""
    points = np.asarray(points)
    with open(file_name, "w") as f:
        base = 1
        for i, p in enumerate(points):
            verts, faces = _sphere_mesh(p, radius, resolution)
            for v in verts:
                if colors is not None:
                    c = np.asarray(colors)[i] if np.ndim(colors) == 2 else colors
                    f.write(f"v {v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
                else:
                    f.write(f"v {v[0]} {v[1]} {v[2]}\n")
            for a, b, c_ in faces:
                f.write(f"f {base + a} {base + b} {base + c_}\n")
            base += len(verts)


def write_correspondences_to_obj(file_name, ref_corr_points, src_corr_points):
    """Write correspondence segments as .obj lines
    (reference utils/visualization.py:136-149)."""
    ref = np.asarray(ref_corr_points)
    src = np.asarray(src_corr_points)
    with open(file_name, "w") as f:
        for p in ref:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        for p in src:
            f.write(f"v {p[0]} {p[1]} {p[2]}\n")
        n = len(ref)
        for i in range(n):
            f.write(f"l {i + 1} {n + i + 1}\n")
