r"""Shadow-row gathers (``geotransformer_tpu/ops/gather.py``).

An index table over a capacity-C array uses the sentinel index C for "no
element"; the gather appends a shadow row filled with ``shadow_value`` so the
sentinel fetches a defined value.
"""

import torch


def gather_with_shadow(data, indices, shadow_value=0.0):
    """Rows of ``data`` (N, ...) at ``indices`` (any shape, values in [0, N]);
    index N hits a shadow row of ``shadow_value``.

    Returns a tensor of shape indices.shape + data.shape[1:].
    """
    shadow = torch.full((1,) + tuple(data.shape[1:]), shadow_value,
                        dtype=data.dtype, device=data.device)
    padded = torch.cat([data, shadow], dim=0)
    idx = indices.long().clamp(0, data.shape[0])
    return padded[idx]


def index_select(data, indices, dim=0):
    """Multi-dimensional index select along ``dim`` (indices clipped like
    ``jnp.take(mode="clip")``)."""
    idx = indices.long().clamp(0, data.shape[dim] - 1)
    out = torch.index_select(data, dim, idx.reshape(-1))
    shape = data.shape[:dim] + idx.shape + data.shape[dim + 1:]
    return out.reshape(shape)
