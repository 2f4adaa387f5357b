r"""Learnable log-domain Sinkhorn optimal transport
(``geotransformer_tpu/models/sinkhorn.py``; reference
`modules/sinkhorn/learnable_sinkhorn.py:5-66`). The iterations run in
:func:`geotransformer_tpu_torch.kernels.sinkhorn.sinkhorn_log_iterations`, or,
when training, in the differentiable ``sinkhorn_log_iterations_train`` (the
JAX ``"pallas_vjp"`` backend, ``models/sinkhorn.py:95-103``)."""

import torch
from torch import nn

from geotransformer_tpu_torch.kernels.sinkhorn import (
    sinkhorn_log_iterations,
    sinkhorn_log_iterations_train,
)

_INF = 1e12


class LearnableLogOptimalTransport(nn.Module):
    def __init__(self, num_iterations, force=None):
        super().__init__()
        self.num_iterations = num_iterations
        self.force = force
        self.alpha = nn.Parameter(torch.tensor(1.0))

    def forward(self, scores, row_masks=None, col_masks=None, training=False):
        """(B, M, N) scores [, (B, M) / (B, N) bool masks] -> (B, M+1, N+1)
        log transport plan with a dustbin row and column; ``training``
        selects the differentiable iterations."""
        batch_size, num_row, num_col = scores.shape
        device = scores.device
        if row_masks is None:
            row_masks = torch.ones((batch_size, num_row), dtype=torch.bool, device=device)
        if col_masks is None:
            col_masks = torch.ones((batch_size, num_col), dtype=torch.bool, device=device)
        no = torch.zeros((batch_size, 1), dtype=torch.bool, device=device)
        padded_row_masks = torch.cat([~row_masks, no], dim=1)  # True = masked out
        padded_col_masks = torch.cat([~col_masks, no], dim=1)
        padded_score_masks = padded_row_masks[:, :, None] | padded_col_masks[:, None, :]

        alpha = self.alpha.to(scores.dtype)
        padded_col = alpha.expand(batch_size, num_row, 1)
        padded_row = alpha.expand(batch_size, 1, num_col + 1)
        padded_scores = torch.cat([torch.cat([scores, padded_col], dim=-1), padded_row], dim=1)
        padded_scores = torch.where(padded_score_masks, -_INF, padded_scores)

        num_valid_row = row_masks.to(scores.dtype).sum(dim=1)
        num_valid_col = col_masks.to(scores.dtype).sum(dim=1)
        # clamped logs keep fully masked (empty) patches finite
        norm = -torch.log(torch.clamp(num_valid_row + num_valid_col, min=1.0))
        log_mu = torch.cat([norm[:, None].expand(batch_size, num_row),
                            (torch.log(torch.clamp(num_valid_col, min=1.0)) + norm)[:, None]], dim=1)
        log_mu = torch.where(padded_row_masks, -_INF, log_mu)
        log_nu = torch.cat([norm[:, None].expand(batch_size, num_col),
                            (torch.log(torch.clamp(num_valid_row, min=1.0)) + norm)[:, None]], dim=1)
        log_nu = torch.where(padded_col_masks, -_INF, log_nu)

        iterate = sinkhorn_log_iterations_train if training else sinkhorn_log_iterations
        outputs = iterate(padded_scores.contiguous(), log_mu.contiguous(), log_nu.contiguous(),
                          self.num_iterations, force=self.force)
        return outputs - norm[:, None, None]
