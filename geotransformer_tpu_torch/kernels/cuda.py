r"""Build, load and dispatch of the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, keyed by a hash of the source, the
``csrc/*.cuh`` headers it includes and the flags (like
``geotransformer_tpu/native/__init__.py:31-42``), under ``kernels/build/``
(git-ignored), then loaded with ``ctypes``. Nothing is
compiled or loaded when a module is imported: the first launch builds its
library, and :func:`build` compiles several at once, one ``nvcc`` process
per source, all started together.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on anything but 0. A wrapper
adds one to ``launches[<kernel>]`` right after it launches its kernel, so a
run can show which kernels the main path went through.
"""

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

import torch

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
SOURCES = ("kpconv", "kpconv_bwd", "gse", "gse_bwd", "sinkhorn", "sinkhorn_train", "overlap",
           "attention", "pyramid")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# kernel name -> launches since the caller last cleared it
launches = collections.Counter()

_libraries = {}


def use_kernel(tensor, force=None):
    """Dispatch rule shared by every wrapper (``ModelConfig.force_pallas``).

    ``force=None``: the CUDA kernel iff ``tensor`` lies on a CUDA device;
    ``False``: the plain PyTorch version everywhere; ``True``: the kernel,
    and an error for a CPU tensor (the kernels have no CPU mode).
    """
    if force is False:
        return False
    if tensor.is_cuda:
        return True
    if force:
        raise RuntimeError(
            "force_pallas=True needs CUDA tensors: the CUDA kernels have no CPU mode")
    return False


def nvcc_path():
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_files(name):
    """``csrc/<name>.cu`` and every header of ``csrc/`` it includes, directly
    or through another header, in include order."""
    files, pending = [], [f"{name}.cu"]
    while pending:
        file = pending.pop(0)
        if file in files:
            continue
        files.append(file)
        with open(os.path.join(CSRC_DIR, file), "rb") as f:
            pending += [m.decode() for m in _INCLUDE.findall(f.read())]
    return files


def library_path(name):
    """The library's path, keyed by the source, the headers it includes and
    the flags, so an edit to a shared header rebuilds every user."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for file in source_files(name):
        with open(os.path.join(CSRC_DIR, file), "rb") as f:
            digest.update(file.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=SOURCES):
    """Compile the libraries of ``names`` that are not built yet, one nvcc
    process per source, started together. Returns the wall seconds."""
    start = time.perf_counter()
    pending = [(n, library_path(n)) for n in names if not os.path.exists(library_path(n))]
    if not pending:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, path in pending:
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failures = []
    for name, path, tmp, proc in procs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{output.decode()}")
        else:
            os.replace(tmp, path)  # atomic: concurrent builders race harmlessly
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - start


def library(name, signatures, restypes=None):
    """The loaded library of ``csrc/<name>.cu``, built on first use.
    ``signatures`` maps each C entry point to its ctypes argument types;
    every entry point returns an int error code, but those ``restypes``
    maps to another ctypes type."""
    lib = _libraries.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(library_path(name))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = (restypes or {}).get(fn, ctypes.c_int)
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libraries[name] = lib
    return lib


def check(lib, code, kernel):
    if code != 0:
        raise RuntimeError(f"{kernel}: CUDA error {code} ({lib.error_string(code).decode()})")


def stream_of(tensor):
    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


def ptr(tensor):
    return ctypes.c_void_p(tensor.data_ptr()) if tensor is not None else ctypes.c_void_p(0)


def round_to(x, dtype):
    """``x`` rounded to ``dtype`` (round to nearest even, as the JAX
    kernels' ``astype`` and the CUDA kernels' ``__float2bfloat16_rn``) and
    back to its own dtype; ``x`` itself at float32, so a float32 point
    computes what it computed before the precision knobs existed."""
    return x if dtype == torch.float32 else x.to(dtype).to(x.dtype)


def operand_dtype(dtype, knob):
    """1 for a bfloat16 ``dtype``, 0 for float32: the launchers' flag of
    precision knob ``knob``; raises on any other dtype."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{knob}: {dtype}, expected torch.float32 or torch.bfloat16")
    return int(dtype == torch.bfloat16)


def require(tensor, name, dtype, shape, device):
    """Raise unless ``tensor`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``."""
    if tensor.device != device:
        raise ValueError(f"{name} is on {tensor.device}, expected {device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name} has dtype {tensor.dtype}, expected {dtype}")
    if tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(tensor.shape)}, expected {tuple(shape)}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
