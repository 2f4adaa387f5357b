r"""Log-domain Sinkhorn iterations: CUDA kernel (``csrc/sinkhorn.cu``) and its
plain version. Replaces
``geotransformer_tpu/kernels/sinkhorn.py:sinkhorn_log_iterations``."""

import ctypes

import torch

from geotransformer_tpu_torch.kernels import cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {"sinkhorn_launch": [_P] * 4 + [_I] * 4 + [_P]}


def sinkhorn_log_iterations_plain(padded_scores, log_mu, log_nu, num_iterations):
    """Plain PyTorch version of :func:`sinkhorn_log_iterations` (the JAX
    ``"scan"`` backend, ``models/sinkhorn.py:110-120``)."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    for _ in range(num_iterations):
        u = log_mu - torch.logsumexp(padded_scores + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(padded_scores + u[:, :, None], dim=1)
    return padded_scores + u[:, :, None] + v[:, None, :]


def sinkhorn_log_iterations(padded_scores, log_mu, log_nu, num_iterations, force=None):
    """Masked log-Sinkhorn; returns scores + u[:, :, None] + v[:, None, :].

    Args:
        padded_scores: (P, M+1, N+1) scores, -1e12 at masked entries.
        log_mu: (P, M+1) log row marginals (-1e12 at masked rows).
        log_nu: (P, N+1) log column marginals.
        num_iterations: iteration count.
        force: ``ModelConfig.force_pallas``.

    Returns:
        (P, M+1, N+1) log transport (before the global norm shift).
    """
    if not cuda.use_kernel(padded_scores, force):
        return sinkhorn_log_iterations_plain(padded_scores, log_mu, log_nu, num_iterations)

    dev = padded_scores.device
    p, m1, n1 = padded_scores.shape
    f32 = torch.float32
    cuda.require(padded_scores, "padded_scores", f32, (p, m1, n1), dev)
    cuda.require(log_mu, "log_mu", f32, (p, m1), dev)
    cuda.require(log_nu, "log_nu", f32, (p, n1), dev)
    out = torch.empty_like(padded_scores)
    lib = cuda.library("sinkhorn", _SIGNATURES)
    code = lib.sinkhorn_launch(
        cuda.ptr(padded_scores), cuda.ptr(log_mu), cuda.ptr(log_nu), cuda.ptr(out),
        p, m1, n1, int(num_iterations), cuda.stream_of(padded_scores))
    cuda.check(lib, code, "sinkhorn_log_iterations")
    cuda.launches["sinkhorn_log_iterations"] += 1
    return out
