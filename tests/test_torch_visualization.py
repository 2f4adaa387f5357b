"""The numpy parts of the port's ``utils/visualization.py`` vs the JAX
package's: the npz export, the .obj writers (byte-identical files), the
sphere mesh, the feature colouring's PCA route, and the
point-to-node colouring (read from the JAX drawing function through a
stand-in for open3d); without open3d both packages' drawing helpers raise
ImportError."""

import sys
import types

import numpy as np
import pytest

from geotransformer_tpu.utils import visualization as jax_vis

from geotransformer_tpu_torch.utils import visualization as port_vis


def _points(seed, n=12):
    return np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)


def test_exports_byte_identical(tmp_path):
    ref, src = _points(0), _points(1)
    transform = np.eye(4, dtype=np.float32)
    for name, module in (("jax", jax_vis), ("port", port_vis)):
        module.export_registration_npz(tmp_path / f"{name}.npz", ref, src, transform, transform)
        module.write_points_to_obj(str(tmp_path / f"{name}_pts.obj"), ref[:3],
                                   colors=np.eye(3), radius=0.05, resolution=3)
        module.write_correspondences_to_obj(str(tmp_path / f"{name}_corr.obj"), ref, src)
    for suffix in ("_pts.obj", "_corr.obj"):
        assert (tmp_path / f"jax{suffix}").read_bytes() == (tmp_path / f"port{suffix}").read_bytes()
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(want.files) == sorted(got.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])
    for got, want in zip(port_vis._sphere_mesh([1.0, 2.0, 3.0], 0.5, 4),
                         jax_vis._sphere_mesh([1.0, 2.0, 3.0], 0.5, 4)):
        np.testing.assert_array_equal(got, want)


def test_feature_colors(monkeypatch):
    """The PCA projection both packages take without scikit-learn (its
    t-SNE is one scikit-learn call, the same in both, and takes ~20 s on a
    CPU)."""
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    feats = np.random.default_rng(2).normal(size=(24, 6))
    got = port_vis.get_colors_with_tsne(feats, perplexity=5.0)
    np.testing.assert_array_equal(got, jax_vis.get_colors_with_tsne(feats, perplexity=5.0))
    assert got.shape == (24, 3) and got.min() >= 0.0 and got.max() <= 1.0


def test_point_to_node_colors(monkeypatch):
    points, nodes = _points(3, 30), _points(4, 5)
    point_to_node = np.random.default_rng(5).integers(0, 5, 30)
    drawn = []

    class PointCloud:
        def paint_uniform_color(self, color):
            self.colors = np.broadcast_to(np.asarray(color, np.float64), (len(self.points), 3))

    o3d = types.SimpleNamespace(
        geometry=types.SimpleNamespace(PointCloud=PointCloud),
        utility=types.SimpleNamespace(Vector3dVector=np.asarray),
        visualization=types.SimpleNamespace(draw_geometries=drawn.extend),
    )
    monkeypatch.setattr(jax_vis, "_require_open3d", lambda: o3d)
    jax_vis.draw_point_to_node(points, nodes, point_to_node)
    np.testing.assert_array_equal(port_vis.point_to_node_colors(5, point_to_node),
                                  drawn[0].colors)
    given = np.random.default_rng(6).uniform(size=(5, 3))
    np.testing.assert_array_equal(port_vis.point_to_node_colors(5, point_to_node, given),
                                  given[point_to_node])


def test_drawing_needs_open3d(monkeypatch):
    monkeypatch.setitem(sys.modules, "open3d", None)
    for module in (jax_vis, port_vis):
        with pytest.raises(ImportError, match="open3d"):
            module.make_open3d_point_cloud(_points(7))
        with pytest.raises(ImportError, match="open3d"):
            module.draw_registration(_points(7), _points(8))
