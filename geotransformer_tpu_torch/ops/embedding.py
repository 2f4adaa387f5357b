r"""Continuous-index sinusoidal embedding (``geotransformer_tpu/ops/embedding.py``,
reference `modules/transformer/positional_embedding.py:8-34`)."""

import numpy as np
import torch


def div_term(d_model, device):
    """(d_model/2,) float32 frequencies 10000^(-2f/d_model), computed in numpy
    (float64) and rounded to float32, as the JAX package does."""
    if d_model % 2 != 0:
        raise ValueError(f"sinusoidal embedding needs even d_model, got {d_model}")
    div_indices = np.arange(0, d_model, 2, dtype=np.float32)
    freqs = np.exp(div_indices * (-np.log(10000.0) / d_model)).astype(np.float32)
    return torch.from_numpy(freqs).to(device)


def sinusoidal_embedding(emb_indices, d_model):
    """(*) real-valued indices -> (*, d_model), interleaved [sin0, cos0, sin1, ...]."""
    omegas = emb_indices[..., None] * div_term(d_model, emb_indices.device).to(emb_indices.dtype)
    emb = torch.stack([torch.sin(omegas), torch.cos(omegas)], dim=-1)
    return emb.reshape(emb_indices.shape + (d_model,))
