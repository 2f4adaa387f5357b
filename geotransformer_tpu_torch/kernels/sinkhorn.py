r"""Log-domain Sinkhorn iterations: CUDA kernels (``csrc/sinkhorn.cu``, the
forward loop of inference and training; ``csrc/sinkhorn_train.cu``, the
training backward) and their plain versions.

``sinkhorn_log_iterations`` replaces
``geotransformer_tpu/kernels/sinkhorn.py:sinkhorn_log_iterations`` (inference);
``sinkhorn_fwd_train`` and ``sinkhorn_bwd_train`` replace ``_fwd_train`` and
``_bwd_train``, the two halves of the differentiable
:func:`sinkhorn_log_iterations_train`.
"""

import collections
import ctypes

import torch

from geotransformer_tpu_torch.kernels import cuda

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "sinkhorn_launch": [_P] * 5 + [_I] * 8 + [_P],
    "sinkhorn_fwd_train_launch": [_P] * 6 + [_I] * 8 + [_P],
    "sinkhorn_block_bytes": [],
}
_BWD_SIGNATURES = {"sinkhorn_bwd_train_launch": [_P] * 8 + [_I] * 7 + [_P]}
_WARPS, _BWD_WARPS = 16, 32  # warps a patch of csrc/sinkhorn.cu and csrc/sinkhorn_train.cu
_FLOAT = 4

# The instance a call runs, picked here alone (the launchers only check that
# it fits): a register instance (general False) holding the column partials
# of all N1 columns (group 0) or of `group` columns at a time, or the
# general kernel with S (s_shared) and the column partials (part_shared) in
# shared memory or not; scratch: floats of global memory a patch for the
# partials where they are not.
Route = collections.namedtuple("Route", "general s_shared part_shared group scratch")


def _general_route(m1, n1, block_bytes, vectors, partials):
    """The general kernel's layout: S in shared memory first (read several
    times an iteration), then the partials, where they fit beside the
    ``vectors`` floats."""
    limit = block_bytes // _FLOAT
    area = m1 * n1
    s_shared = vectors + area <= limit
    part_shared = vectors + partials + (area if s_shared else 0) <= limit
    return Route(True, s_shared, part_shared, 0, 0 if part_shared else partials)


def forward_route(m1, n1, block_bytes):
    """The instance ``csrc/sinkhorn.cu`` runs for (M1, N1) patches on a card
    whose block takes ``block_bytes`` of shared memory: a register instance
    where M1, N1 <= 256 and S fits a block beside the column partials of all
    N1 columns, or (M1 = N1 = 225-239) of a group of at least 16; else the
    general kernel."""
    slots = -(-max(m1, n1) // 32)
    area = m1 * n1
    if slots <= 8:
        if _FLOAT * (area + (2 * _WARPS + 2) * n1 + m1) <= block_bytes:
            return Route(False, True, True, 0, 0)
        group = (block_bytes - _FLOAT * (area + n1)) // (_FLOAT * 2 * _WARPS) // 16 * 16
        if slots == 8 and group >= 16:
            return Route(False, True, True, group, 0)
    return _general_route(m1, n1, block_bytes, m1 + n1, 2 * _WARPS * n1)


def backward_route(m1, n1, block_bytes):
    """The instance ``csrc/sinkhorn_train.cu`` runs: a register instance
    where M1, N1 <= 160, else the general kernel."""
    if -(-max(m1, n1) // 32) <= 5:
        return Route(False, True, True, 0, 0)
    return _general_route(m1, n1, block_bytes, 3 * n1 + 5 * m1, 3 * _BWD_WARPS * n1)


_block_bytes = {}


def device_block_bytes(device):
    """A block's shared memory at most on the CUDA ``device``, in bytes (the
    CUDA runtime's opt-in limit, read once a device)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _block_bytes:
        with torch.cuda.device(index):
            _block_bytes[index] = cuda.library("sinkhorn", _SIGNATURES).sinkhorn_block_bytes()
    return _block_bytes[index]


def _route(route_of, p, m1, n1, device):
    """The launch arguments of the call's route (general, s_shared,
    part_shared and, for the forward, group) and its scratch (None where it
    needs none)."""
    route = route_of(m1, n1, device_block_bytes(device))
    scratch = (torch.empty((p * route.scratch,), dtype=torch.float32, device=device)
               if route.scratch else None)
    return tuple(int(x) for x in route[:4]), scratch


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
    route, scratch = _route(forward_route, p, m1, n1, dev)
    code = lib.sinkhorn_launch(
        cuda.ptr(padded_scores), cuda.ptr(log_mu), cuda.ptr(log_nu), cuda.ptr(out),
        cuda.ptr(scratch), p, m1, n1, int(num_iterations), *route, cuda.stream_of(padded_scores))
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
    route, scratch = _route(forward_route, p, m1, n1, dev)
    code = lib.sinkhorn_fwd_train_launch(
        cuda.ptr(padded_scores), cuda.ptr(log_mu), cuda.ptr(log_nu), cuda.ptr(out),
        cuda.ptr(v_hist), cuda.ptr(scratch), p, m1, n1, t, *route, cuda.stream_of(padded_scores))
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
    route, scratch = _route(backward_route, p, m1, n1, dev)
    code = lib.sinkhorn_bwd_train_launch(
        cuda.ptr(padded_scores), cuda.ptr(log_mu), cuda.ptr(v_hist), cuda.ptr(dout),
        cuda.ptr(d_scores), cuda.ptr(d_mu), cuda.ptr(d_nu), cuda.ptr(scratch), p, m1, n1, t,
        *route[:3], cuda.stream_of(padded_scores))
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
