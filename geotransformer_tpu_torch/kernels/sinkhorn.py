r"""Log-domain Sinkhorn iterations: CUDA kernels (``csrc/sinkhorn.cu``, the
forward loop of inference and training; ``csrc/sinkhorn_train.cu``, the
training backward) and their plain versions.

``sinkhorn_log_iterations`` replaces
``geotransformer_tpu/kernels/sinkhorn.py:sinkhorn_log_iterations`` (inference);
``sinkhorn_fwd_train`` and ``sinkhorn_bwd_train`` replace ``_fwd_train`` and
``_bwd_train``, the two halves of the differentiable
:func:`sinkhorn_log_iterations_train`.
"""

import ctypes

import torch

from geotransformer_tpu_torch.kernels import cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sinkhorn_launch": [_P] * 4 + [_I] * 4 + [_P],
    "sinkhorn_fwd_train_launch": [_P] * 5 + [_I] * 4 + [_P],
}
_BWD_SIGNATURES = {"sinkhorn_bwd_train_launch": [_P] * 7 + [_I] * 4 + [_P]}


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


def sinkhorn_fwd_train_plain(padded_scores, log_mu, log_nu, num_iterations):
    """Plain PyTorch version of :func:`sinkhorn_fwd_train` (JAX
    ``_sinkhorn_fwd_train_kernel``, ``kernels/sinkhorn.py:127-143``)."""
    u = torch.zeros_like(log_mu)
    v = torch.zeros_like(log_nu)
    history = []
    for _ in range(num_iterations):
        history.append(v)
        u = log_mu - torch.logsumexp(padded_scores + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(padded_scores + u[:, :, None], dim=1)
    v_hist = (torch.stack(history, dim=1) if history
              else log_nu.new_zeros((log_nu.shape[0], 0, log_nu.shape[1])))
    return padded_scores + u[:, :, None] + v[:, None, :], v_hist


def sinkhorn_fwd_train(padded_scores, log_mu, log_nu, num_iterations, force=None):
    """:func:`sinkhorn_log_iterations` that also keeps the column potentials.

    Returns:
        out (P, M+1, N+1), bitwise the inference kernel's result, and
        v_hist (P, T, N+1), v before each of the T iterations (zeros first).
    """
    if not cuda.use_kernel(padded_scores, force):
        return sinkhorn_fwd_train_plain(padded_scores, log_mu, log_nu, num_iterations)

    dev = padded_scores.device
    p, m1, n1 = padded_scores.shape
    t = int(num_iterations)
    f32 = torch.float32
    cuda.require(padded_scores, "padded_scores", f32, (p, m1, n1), dev)
    cuda.require(log_mu, "log_mu", f32, (p, m1), dev)
    cuda.require(log_nu, "log_nu", f32, (p, n1), dev)
    out = torch.empty_like(padded_scores)
    v_hist = torch.empty((p, t, n1), dtype=f32, device=dev)
    lib = cuda.library("sinkhorn", _SIGNATURES)
    code = lib.sinkhorn_fwd_train_launch(
        cuda.ptr(padded_scores), cuda.ptr(log_mu), cuda.ptr(log_nu), cuda.ptr(out),
        cuda.ptr(v_hist), p, m1, n1, t, cuda.stream_of(padded_scores))
    cuda.check(lib, code, "sinkhorn_fwd_train")
    cuda.launches["sinkhorn_fwd_train"] += 1
    return out, v_hist


def sinkhorn_bwd_train_plain(padded_scores, log_mu, v_hist, dout):
    """Plain PyTorch version of :func:`sinkhorn_bwd_train`: the reverse sweep
    of JAX ``_sinkhorn_bwd_kernel`` (``kernels/sinkhorn.py:146-183``)."""
    ds = dout
    du = dout.sum(dim=2)
    dv = dout.sum(dim=1)
    dmu = torch.zeros_like(du)
    dnu = torch.zeros_like(dv)
    for k in range(v_hist.shape[1] - 1, -1, -1):
        v_prev = v_hist[:, k]
        lse_n = torch.logsumexp(padded_scores + v_prev[:, None, :], dim=2)  # (P, M1)
        u_k = log_mu - lse_n
        # backward of v_k = log_nu - LSE_m(S + u_k)
        dnu = dnu + dv
        su = padded_scores + u_k[:, :, None]
        a = torch.exp(su - torch.logsumexp(su, dim=1, keepdim=True))  # softmax over rows
        g = a * dv[:, None, :]
        ds = ds - g
        du = du - g.sum(dim=2)
        # backward of u_k = log_mu - LSE_n(S + v_{k-1})
        dmu = dmu + du
        b = torch.exp(padded_scores + v_prev[:, None, :] - lse_n[:, :, None])
        h = b * du[:, :, None]
        ds = ds - h
        dv = -h.sum(dim=1)
        du = torch.zeros_like(du)
    return ds, dmu, dnu


def sinkhorn_bwd_train(padded_scores, log_mu, v_hist, dout, force=None):
    """Reverse sweep of the T Sinkhorn iterations.

    Args:
        padded_scores: (P, M+1, N+1) forward scores; log_mu: (P, M+1).
        v_hist: (P, T, N+1) from :func:`sinkhorn_fwd_train`.
        dout: (P, M+1, N+1) gradient of the forward's output.

    Returns:
        d_scores (P, M+1, N+1), d_log_mu (P, M+1), d_log_nu (P, N+1).
    """
    if not cuda.use_kernel(padded_scores, force):
        return sinkhorn_bwd_train_plain(padded_scores, log_mu, v_hist, dout)

    dev = padded_scores.device
    p, m1, n1 = padded_scores.shape
    t = v_hist.shape[1]
    f32 = torch.float32
    cuda.require(padded_scores, "padded_scores", f32, (p, m1, n1), dev)
    cuda.require(log_mu, "log_mu", f32, (p, m1), dev)
    cuda.require(v_hist, "v_hist", f32, (p, t, n1), dev)
    cuda.require(dout, "dout", f32, (p, m1, n1), dev)
    d_scores = torch.empty_like(padded_scores)
    d_mu = torch.empty((p, m1), dtype=f32, device=dev)
    d_nu = torch.empty((p, n1), dtype=f32, device=dev)
    lib = cuda.library("sinkhorn_train", _BWD_SIGNATURES)
    code = lib.sinkhorn_bwd_train_launch(
        cuda.ptr(padded_scores), cuda.ptr(log_mu), cuda.ptr(v_hist), cuda.ptr(dout),
        cuda.ptr(d_scores), cuda.ptr(d_mu), cuda.ptr(d_nu), p, m1, n1, t,
        cuda.stream_of(padded_scores))
    cuda.check(lib, code, "sinkhorn_bwd_train")
    cuda.launches["sinkhorn_bwd_train"] += 1
    return d_scores, d_mu, d_nu


class _SinkhornTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, padded_scores, log_mu, log_nu, num_iterations, force):
        out, v_hist = sinkhorn_fwd_train(padded_scores, log_mu, log_nu, num_iterations,
                                         force=force)
        ctx.save_for_backward(padded_scores, log_mu, v_hist)
        ctx.force = force
        return out

    @staticmethod
    def backward(ctx, dout):
        padded_scores, log_mu, v_hist = ctx.saved_tensors
        d_scores, d_mu, d_nu = sinkhorn_bwd_train(padded_scores, log_mu, v_hist,
                                                  dout.contiguous(), force=ctx.force)
        return d_scores, d_mu, d_nu, None, None


def sinkhorn_log_iterations_train(padded_scores, log_mu, log_nu, num_iterations,
                                  force=None):
    """Differentiable :func:`sinkhorn_log_iterations` (JAX
    ``sinkhorn_log_iterations_train``): forward :func:`sinkhorn_fwd_train`,
    backward :func:`sinkhorn_bwd_train`; gradients reach the scores and both
    log marginals."""
    return _SinkhornTrain.apply(padded_scores, log_mu, log_nu, num_iterations, force)
