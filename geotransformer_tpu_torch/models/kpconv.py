r"""Kernel Point Convolution and the backbone blocks
(``geotransformer_tpu/models/kpconv.py``; reference
`modules/kpconv/kpconv.py:79-122`, `modules/kpconv/modules.py`).

Every convolution goes through :mod:`geotransformer_tpu_torch.kernels.kpconv`:
the CUDA kernel on the card, its plain PyTorch version on the CPU. The
strided residual block's shortcut max-pool (reference functional.py:54-67,
zero shadow row, first ``pool_cols`` columns) happens inside the same call;
:func:`maxpool` is the same pool on its own, for callers outside the
backbone. The table a conv reads goes by the JAX
dispatch (``models/kpconv.py:127-196``): the input conv takes the edge
stream, else the per-tile unions, else the split table, else the neighbor
table; every other conv takes its split table where the batch has one. With
gradients enabled the convs take the autograd Functions of the training
path: the inverse-table backward where the batch has inverse tables, else
the scatter backward of the JAX XLA rules, and the weight-only backward for
the input conv. ``mxu_dtype`` (``PrecisionConfig.kpconv_mxu``) is every
conv's contraction point, on the kernel and the plain route; the training
path takes float32 only (a gradient at a bfloat16 point raises
``NotImplementedError``).
Parameter names are the reference torch ones (``KPConv.weights`` (K, C_in,
C_out), ``KPConv.bias``, the ``kernel_points`` buffer).
"""

import torch
from torch import nn
import torch.nn.functional as F

from geotransformer_tpu_torch.kernels.kpconv import (
    kpconv_fused,
    kpconv_fused_diff,
    kpconv_input_diff,
    kpconv_inv_fused_diff,
    kpconv_pool_fused_diff,
    kpconv_pool_inv_fused_diff,
    kpconv_split_diff,
    kpconv_split_fused,
    kpconv_split_input_diff,
    kpconv_split_pool_diff,
    kpconv_split_pool_scatter_diff,
    kpconv_split_scatter_diff,
    kpconv_stream_fused,
    kpconv_stream_input_diff,
    kpconv_union_input_fused,
    kpconv_union_input_fused_diff,
)
from geotransformer_tpu_torch.models.kernel_points import load_kernel_points
from geotransformer_tpu_torch.models.norms import GroupNorm
from geotransformer_tpu_torch.ops.gather import gather_with_shadow

# query rows per tile of the union tables (pad_registration_batch's
# union_tile default; the JAX input conv's kernel tile, models/kpconv.py:121)
UNION_TILE = 128


class KPConv(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma,
                 bias=False, force=None, mxu_dtype=torch.float32):
        super().__init__()
        self.sigma = sigma
        self.force = force
        self.mxu_dtype = mxu_dtype
        self.weights = nn.Parameter(torch.zeros(kernel_size, in_channels, out_channels))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        self.register_buffer(
            "kernel_points", torch.from_numpy(load_kernel_points(radius, kernel_size)))

    def forward(self, s_feats, q_points, s_points, neighbor_indices,
                pool_feats=None, pool_cols=None, stream=None, q_mask=None,
                inverse_table=None, union_tables=None, split_tables=None):
        """KPConv forward.

        Args:
            s_feats: (N, C_in) support features.
            q_points: (M, 3) query points.
            s_points: (N, 3) support points.
            neighbor_indices: (M, H) int32, sentinel N.
            pool_feats: optional (N, C_pool) features max-pooled over the
                first ``pool_cols`` columns of the same table.
            stream: optional (5, M, H) input-conv edge stream (c_in == 1).
            q_mask: optional (M,) bool query validity.
            inverse_table: optional inverse of ``neighbor_indices`` (N, J)
                sentinel M, or its split 4-tuple (training batches): with
                gradients enabled, the backward runs over it; without it,
                the backward scatters over the neighbor table.
            union_tables: optional (union_rows, union_sel) of the input conv
                (c_in == 1), built with tile ``UNION_TILE``.
            split_tables: optional (tail, tail_q, tail_rank) of
                ``neighbor_indices`` (``preprocess.build_split_tables``).

        Returns:
            (M, C_out) features, or (features, pooled) with ``pool_feats``.
        """
        grad = torch.is_grad_enabled()
        if grad and self.mxu_dtype != torch.float32:
            raise NotImplementedError(
                f"KPConv gradients at kpconv_mxu={self.mxu_dtype} are not ported (ROADMAP.md "
                "queue 1: training at the JAX precision point)")
        kp, w, sigma, bias, force = (self.kernel_points, self.weights, self.sigma, self.bias,
                                     self.force)
        point = {} if grad else dict(mxu_dtype=self.mxu_dtype)  # the *_diff forms take float32
        input_layer = w.shape[1] == 1 and pool_feats is None
        if input_layer and stream is not None:
            conv = kpconv_stream_input_diff if grad else kpconv_stream_fused
            return conv(stream, kp, w, sigma, bias, force=force, **point)
        if input_layer and union_tables is not None:
            conv = kpconv_union_input_fused_diff if grad else kpconv_union_input_fused
            return conv(s_feats, q_points, s_points, *union_tables, kp, w, sigma, bias,
                        tile=UNION_TILE, force=force, **point)
        pool = {} if pool_feats is None else dict(pool_feats=pool_feats, pool_cols=pool_cols)
        if split_tables is not None:
            h1 = neighbor_indices.shape[1] - split_tables[0].shape[1]
            head = neighbor_indices[:, :h1].contiguous()
            if input_layer and grad:
                return kpconv_split_input_diff(s_feats, q_points, s_points, head, split_tables,
                                               kp, w, sigma, bias, q_mask=q_mask, force=force)
            if grad and inverse_table is not None:
                if pool_feats is not None:
                    return kpconv_split_pool_diff(
                        s_feats, pool_feats, q_points, s_points, head, split_tables,
                        inverse_table, kp, w, sigma, bias, pool_cols=pool_cols, q_mask=q_mask,
                        force=force)
                return kpconv_split_diff(s_feats, q_points, s_points, head, split_tables,
                                         inverse_table, kp, w, sigma, bias, q_mask=q_mask,
                                         force=force)
            if grad:
                if pool_feats is not None:
                    return kpconv_split_pool_scatter_diff(
                        s_feats, pool_feats, q_points, s_points, head, split_tables, kp, w,
                        sigma, bias, pool_cols=pool_cols, q_mask=q_mask, force=force)
                return kpconv_split_scatter_diff(s_feats, q_points, s_points, head,
                                                 split_tables, kp, w, sigma, bias,
                                                 q_mask=q_mask, force=force)
            return kpconv_split_fused(s_feats, q_points, s_points, head, *split_tables, kp, w,
                                      sigma, bias, q_mask=q_mask, force=force, **point,
                                      **pool)
        if input_layer and grad:
            return kpconv_input_diff(s_feats, q_points, s_points, neighbor_indices, kp, w, sigma,
                                     bias, q_mask=q_mask, force=force)
        if grad and inverse_table is not None:
            if pool_feats is not None:
                return kpconv_pool_inv_fused_diff(
                    s_feats, pool_feats, q_points, s_points, neighbor_indices, inverse_table,
                    kp, w, sigma, bias, pool_cols=pool_cols, q_mask=q_mask, force=force)
            return kpconv_inv_fused_diff(s_feats, q_points, s_points, neighbor_indices,
                                         inverse_table, kp, w, sigma, bias, q_mask=q_mask,
                                         force=force)
        if grad:
            if pool_feats is not None:
                return kpconv_pool_fused_diff(s_feats, pool_feats, q_points, s_points,
                                              neighbor_indices, kp, w, sigma, bias,
                                              pool_cols=pool_cols, q_mask=q_mask, force=force)
            return kpconv_fused_diff(s_feats, q_points, s_points, neighbor_indices, kp, w, sigma,
                                     bias, q_mask=q_mask, force=force)
        return kpconv_fused(s_feats, q_points, s_points, neighbor_indices, kp, w, sigma, bias,
                            q_mask=q_mask, force=force, **point, **pool)


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=0.1)


def maxpool(s_feats, neighbor_indices, valid_cols=None):
    """Max over neighbor features with a zero shadow row (reference
    functional.py:54-67: the shadow clamps the max at 0).

    ``valid_cols`` restricts the pool to the first columns: a neighbor table
    may carry alignment sentinel columns past its neighbor limit, and the
    clamp at 0 must apply only to rows underfull within that limit.
    """
    if valid_cols is not None:
        neighbor_indices = neighbor_indices[:, :valid_cols]
    return gather_with_shadow(s_feats, neighbor_indices, 0.0).max(dim=1).values


def nearest_upsample(s_feats, upsample_indices):
    """Copy features of the nearest (first-column) coarse neighbor."""
    return gather_with_shadow(s_feats, upsample_indices[:, 0], 0.0)


def knn_interpolate(s_feats, q_points, s_points, neighbor_indices, k, eps=1e-8):
    """Inverse-distance weighted interpolation over the first k neighbors."""
    knn_indices = neighbor_indices[:, :k]
    knn_points = gather_with_shadow(s_points, knn_indices, 0.0)
    knn_feats = gather_with_shadow(s_feats, knn_indices, 0.0)
    sq_dists = torch.sum((q_points[:, None, :] - knn_points) ** 2, dim=-1)
    valid = (knn_indices < s_points.shape[0]).to(s_feats.dtype)
    weights = valid / (sq_dists + eps)
    weights = weights / (torch.sum(weights, dim=1, keepdim=True) + eps)
    return torch.sum(knn_feats * weights[:, :, None], dim=1)


def global_avgpool(feats, masks):
    """Masked mean over the point axis -> (C,) per cloud mask."""
    m = masks.to(feats.dtype)[:, None]
    return torch.sum(feats * m, dim=0) / torch.clamp(torch.sum(m), min=1.0)


class UnaryBlock(nn.Module):
    def __init__(self, in_channels, out_channels, group_norm, has_relu=True):
        super().__init__()
        self.mlp = nn.Linear(in_channels, out_channels)
        self.norm = GroupNorm(group_norm, out_channels)
        self.has_relu = has_relu

    def forward(self, x, mask=None):
        x = self.norm(self.mlp(x), mask)
        return leaky_relu(x) if self.has_relu else x


class LastUnaryBlock(nn.Module):
    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.mlp = nn.Linear(in_channels, out_channels)

    def forward(self, x):
        return self.mlp(x)


class ConvBlock(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma,
                 group_norm, force=None, mxu_dtype=torch.float32):
        super().__init__()
        self.KPConv = KPConv(in_channels, out_channels, kernel_size, radius, sigma,
                             bias=True, force=force, mxu_dtype=mxu_dtype)
        self.norm = GroupNorm(group_norm, out_channels)

    def forward(self, s_feats, q_points, s_points, neighbor_indices, q_mask=None,
                stream=None, inverse_table=None, union_tables=None, split_tables=None):
        x = self.KPConv(s_feats, q_points, s_points, neighbor_indices, stream=stream,
                        q_mask=q_mask, inverse_table=inverse_table, union_tables=union_tables,
                        split_tables=split_tables)
        return leaky_relu(self.norm(x, q_mask))


class ResidualBlock(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, radius, sigma,
                 group_norm, strided=False, pool_cols=None, force=None,
                 mxu_dtype=torch.float32):
        super().__init__()
        mid_channels = out_channels // 4
        self.strided = strided
        self.pool_cols = pool_cols  # true (pre-alignment) neighbor limit
        self.unary1 = (UnaryBlock(in_channels, mid_channels, group_norm)
                       if in_channels != mid_channels else None)
        self.KPConv = KPConv(mid_channels, mid_channels, kernel_size, radius, sigma,
                             bias=True, force=force, mxu_dtype=mxu_dtype)
        self.norm_conv = GroupNorm(group_norm, mid_channels)
        self.unary2 = UnaryBlock(mid_channels, out_channels, group_norm, has_relu=False)
        self.unary_shortcut = (UnaryBlock(in_channels, out_channels, group_norm, has_relu=False)
                               if in_channels != out_channels else None)

    def forward(self, s_feats, q_points, s_points, neighbor_indices, q_mask=None,
                s_mask=None, inverse_table=None, split_tables=None):
        x = self.unary1(s_feats, s_mask) if self.unary1 is not None else s_feats
        tables = dict(q_mask=q_mask, inverse_table=inverse_table, split_tables=split_tables)
        if self.strided:
            # one call serves the conv and the shortcut max-pool (same table)
            x, shortcut = self.KPConv(x, q_points, s_points, neighbor_indices,
                                      pool_feats=s_feats, pool_cols=self.pool_cols, **tables)
        else:
            x = self.KPConv(x, q_points, s_points, neighbor_indices, **tables)
            shortcut = s_feats
        x = leaky_relu(self.norm_conv(x, q_mask))
        x = self.unary2(x, q_mask)
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, q_mask)
        return leaky_relu(x + shortcut)
