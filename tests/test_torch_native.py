"""The port's native host library (``geotransformer_tpu_torch/native``) vs
the JAX package's numpy path, under the rules of ``tests/test_native.py``.

  * ``geolib.cpp``: the port's copy equals the JAX source below its header
    comment, byte for byte, and builds with the same flags;
  * the binding: subsample lengths equal and points within 1e-5; neighbor
    sets equal, at most 2 rows ordered differently (exact distance ties),
    rows sorted by distance within the radius;
  * the pyramid dispatch: native by default, numpy under
    ``GEOTRANSFORMER_TPU_NATIVE=0`` (the variable the JAX package reads);
  * a failed build raises with the compiler's output, and nothing falls
    back to numpy;
  * three processes building into one empty directory at once each load
    the library and pass its self-test, and leave one library behind.

The test never skips: g++ is part of what the port needs on the host.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from geotransformer_tpu import native as jax_native
from geotransformer_tpu.preprocess import pyramid as jax_pyramid
from geotransformer_tpu.preprocess.neighbors import radius_search as jax_radius_search
from geotransformer_tpu.preprocess.voxel import grid_subsample as jax_grid_subsample

from geotransformer_tpu_torch import native
from geotransformer_tpu_torch.preprocess import pyramid as port_pyramid

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _code(path):
    """The source below its leading comment block."""
    with open(path, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    start = next(i for i, line in enumerate(lines) if not line.startswith(b"//"))
    return b"".join(lines[start:])


def test_source_is_the_jax_library():
    jax_src = os.path.join(os.path.dirname(jax_native.__file__), "geolib.cpp")
    assert _code(native.SOURCE) == _code(jax_src)
    assert list(native.FLAGS) == list(jax_native._FLAGS)


def test_grid_subsample_matches_numpy():
    rng = np.random.default_rng(0)
    points = rng.uniform(-3, 5, (5000, 3)).astype(np.float32)
    lengths = np.asarray([3000, 2000])
    got_pts, got_lens = native.grid_subsample(points, lengths, 0.3)
    want_pts, want_lens = jax_grid_subsample(points, lengths, 0.3)
    np.testing.assert_array_equal(got_lens, want_lens)
    np.testing.assert_allclose(got_pts, want_pts, atol=1e-5)
    one_pts, one_lens = native.grid_subsample(np.zeros((7, 3), np.float32) + 0.05, [7], 0.2)
    assert one_lens.tolist() == [1]
    np.testing.assert_allclose(one_pts[0], [0.05] * 3, atol=1e-6)


def test_radius_search_matches_numpy():
    rng = np.random.default_rng(1)
    q = rng.uniform(0, 1, (400, 3)).astype(np.float32)
    s = rng.uniform(0, 1, (600, 3)).astype(np.float32)
    q_lens, s_lens = np.asarray([250, 150]), np.asarray([350, 250])
    got = native.radius_search(q, s, q_lens, s_lens, 0.15, 20)
    want = jax_radius_search(q, s, q_lens, s_lens, 0.15, 20)
    assert got.shape == want.shape and got.dtype == np.int64
    tie_rows = 0
    for g, w in zip(got.tolist(), want.tolist()):
        if g != w:
            assert set(g) == set(w)
            tie_rows += 1
    assert tie_rows <= 2

    # rows sorted by distance, every neighbor within the radius
    idx = native.radius_search(q[:100], s[:300], [100], [300], 0.3, 12)
    for i in range(100):
        dists = [np.linalg.norm(q[i] - s[j]) for j in idx[i] if j < 300]
        assert dists == sorted(dists)
        assert all(d <= 0.3 + 1e-6 for d in dists)


def test_pyramid_dispatch(monkeypatch):
    rng = np.random.default_rng(2)
    points = rng.uniform(0, 1, (800, 3)).astype(np.float32)
    args = (points, np.asarray([500, 300]), 3, 0.05, 0.0625, [10, 10, 10])
    pyramids = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("GEOTRANSFORMER_TPU_NATIVE", flag)
        native.calls.clear()
        pyramids[flag] = port_pyramid.build_pyramid(*args)
        # 2 subsamples, 3 neighbor, 2 subsampling and 2 upsampling searches
        expected = {"grid_subsample": 2, "radius_search": 7} if flag == "1" else {}
        assert dict(native.calls) == expected
        want = jax_pyramid.build_pyramid(*args)  # the JAX package reads the same variable
        for key in ("points", "lengths"):
            for g, w in zip(pyramids[flag][key], want[key]):
                np.testing.assert_array_equal(g, w, err_msg=f"{key} under {flag}")
    for a, b in zip(pyramids["1"]["points"], pyramids["0"]["points"]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_failed_build_raises(monkeypatch, tmp_path):
    broken = tmp_path / "geolib.cpp"
    broken.write_text("extern \"C\" int gt_grid_subsample( { this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="error"):
        native.get_lib()
    assert not native.native_available()
    monkeypatch.setenv("GEOTRANSFORMER_TPU_NATIVE", "1")
    with pytest.raises(RuntimeError, match="failed"):  # the pyramid does not fall back
        port_pyramid.grid_subsample(np.zeros((4, 3), np.float32), [4], 0.1)
    assert sorted(os.listdir(tmp_path / "build")) == [os.path.basename(native.lib_path())
                                                     + ".lock"]


def test_concurrent_build(tmp_path):
    build_dir = str(tmp_path / "build")
    script = (
        "import sys\n"
        "import numpy as np\n"
        "from geotransformer_tpu_torch import native\n"
        "native.BUILD_DIR = sys.argv[1]\n"
        "native.get_lib()\n"
        "pts, lens = native.grid_subsample(np.eye(3, dtype=np.float32), [3], 0.5)\n"
        "assert lens.tolist() == [3], lens\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", script, build_dir], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for proc in procs:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0 and out.strip() == "ok", err[-2000:]
    names = sorted(os.listdir(build_dir))
    library = os.path.basename(native.lib_path())
    assert names == [library, library + ".lock"]
