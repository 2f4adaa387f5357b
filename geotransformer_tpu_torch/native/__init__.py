r"""ctypes binding of the native host preprocessing library (``geolib.cpp``).

``geolib.cpp`` is built with g++ on first use into ``native/build/``
(git-ignored), under a name keyed by a hash of the source and the compile
flags, so a stale or foreign binary is never loaded. The wrappers keep the
contracts of :mod:`geotransformer_tpu_torch.preprocess.voxel` and
``.neighbors``; :mod:`geotransformer_tpu_torch.preprocess.pyramid` routes to
them by default.

The build is atomic across processes: g++ writes a temporary file in the
build directory, which ``os.replace`` moves onto the final name while an
``fcntl.flock`` on a lock file beside it is held. Concurrent test workers,
spawned loader workers and distributed ranks therefore wait for one build
and never load a half-written library. A failed build or self-test raises
with the compiler's output; nothing falls back to numpy behind the caller's
back (``GEOTRANSFORMER_TPU_NATIVE=0`` asks for the numpy route by name).
"""

import collections
import ctypes
import fcntl
import hashlib
import os
import os.path as osp
import subprocess
import threading

import numpy as np

_DIR = osp.dirname(osp.abspath(__file__))
SOURCE = osp.join(_DIR, "geolib.cpp")
BUILD_DIR = osp.join(_DIR, "build")
COMPILER = "g++"
# No -march=native: a portable ISA plus the self-test below keeps a copied
# build directory from crashing at call time.
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# wrapper name -> calls into the library since the caller last cleared it
calls = collections.Counter()

_lock = threading.Lock()
_lib = None


def lib_path():
    """Where the library for the current source and flags lives."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return osp.join(BUILD_DIR, f"libgeolib-{digest}.so")


def _build(path):
    """Compile ``SOURCE`` into ``path`` unless another process already has."""
    os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if osp.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run([COMPILER, *FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True)
        except OSError as err:
            raise RuntimeError(f"cannot run {COMPILER} to build {SOURCE}: {err}") from err
        if proc.returncode != 0:
            if osp.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(
                f"building {SOURCE} failed ({COMPILER} exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)


def _load(path):
    lib = ctypes.CDLL(path)
    lib.gt_grid_subsample.restype = ctypes.c_int64
    lib.gt_grid_subsample.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_double, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.gt_radius_neighbors.restype = None
    lib.gt_radius_neighbors.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_double, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
    ]
    return lib


def get_lib():
    """The loaded library, built on first use; raises if it cannot be built
    or fails its self-test."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not osp.exists(path):
                _build(path)
            lib = _load(path)
            _self_test(lib)
            _lib = lib
        return _lib


def _self_test(lib):
    """Tiny end-to-end call so a broken binary fails here, not mid-pipeline."""
    pts = np.asarray([[0.0, 0.0, 0.0], [0.05, 0.0, 0.0], [1.0, 1.0, 1.0]], np.float32)
    lengths = np.asarray([3], np.int64)
    out_points = np.empty((3, 3), np.float32)
    out_lengths = np.empty(1, np.int64)
    total = lib.gt_grid_subsample(_fptr(pts), _iptr(lengths), 1, 0.2, _fptr(out_points), 3,
                                  _iptr(out_lengths))
    if total != 2 or out_lengths[0] != 2:
        raise RuntimeError(f"native geolib self-test failed (total={total})")


def _fptr(array):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(array):
    return array.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def native_available():
    """Whether the library builds and passes its self-test here."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def grid_subsample(points, lengths, voxel_size):
    """Native stack-mode voxel subsampling (contract of ``preprocess.voxel``)."""
    lib = get_lib()
    points = np.ascontiguousarray(points, dtype=np.float32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    capacity = points.shape[0]
    out_points = np.empty((capacity, 3), dtype=np.float32)
    out_lengths = np.empty(lengths.shape[0], dtype=np.int64)
    calls["grid_subsample"] += 1
    total = lib.gt_grid_subsample(
        _fptr(points), _iptr(lengths), lengths.shape[0], float(voxel_size),
        _fptr(out_points), capacity, _iptr(out_lengths),
    )
    if total < 0:
        # Capacity overflow: voxel subsampling never grows a cloud, but the C
        # contract allows it; the buffers are garbage, so take the numpy path.
        from geotransformer_tpu_torch.preprocess import voxel

        return voxel.grid_subsample(points, lengths, voxel_size)
    return out_points[:total].copy(), out_lengths


def radius_search(q_points, s_points, q_lengths, s_lengths, radius, neighbor_limit):
    """Native stack-mode fixed-K radius search (contract of ``preprocess.neighbors``)."""
    lib = get_lib()
    q_points = np.ascontiguousarray(q_points, dtype=np.float32)
    s_points = np.ascontiguousarray(s_points, dtype=np.float32)
    q_lengths = np.ascontiguousarray(q_lengths, dtype=np.int64)
    s_lengths = np.ascontiguousarray(s_lengths, dtype=np.int64)
    out = np.empty((q_points.shape[0], neighbor_limit), dtype=np.int64)
    calls["radius_search"] += 1
    lib.gt_radius_neighbors(
        _fptr(q_points), _fptr(s_points), _iptr(q_lengths), _iptr(s_lengths),
        q_lengths.shape[0], float(radius), int(neighbor_limit), _iptr(out),
    )
    return out
