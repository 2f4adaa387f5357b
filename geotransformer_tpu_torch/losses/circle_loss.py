r"""Circle loss on feature distance matrices, masked
(``geotransformer_tpu/losses/circle_loss.py``; reference
`modules/loss/circle_loss.py:44-86`). Anchor masks keep padded rows and
columns out of the means."""

import torch
import torch.nn.functional as F


def _masked_mean(values, masks):
    m = masks.to(values.dtype)
    return torch.sum(values * m) / torch.clamp(torch.sum(m), min=1.0)


def weighted_circle_loss(pos_masks, neg_masks, feat_dists, pos_margin, neg_margin,
                         pos_optimal, neg_optimal, log_scale, pos_scales=None,
                         neg_scales=None):
    """Weighted circle loss over a (M, N) feature-distance matrix;
    ``pos_masks`` / ``neg_masks`` double as validity masks (padded entries
    False in both)."""
    row_masks = pos_masks.any(-1) & neg_masks.any(-1)
    col_masks = pos_masks.any(-2) & neg_masks.any(-2)

    with torch.no_grad():  # the weights are constants (reference: detach)
        pos_weights = feat_dists - 1e5 * (~pos_masks).to(feat_dists.dtype)
        pos_weights = torch.clamp(pos_weights - pos_optimal, min=0.0)
        if pos_scales is not None:
            pos_weights = pos_weights * pos_scales
        neg_weights = feat_dists + 1e5 * (~neg_masks).to(feat_dists.dtype)
        neg_weights = torch.clamp(neg_optimal - neg_weights, min=0.0)
        if neg_scales is not None:
            neg_weights = neg_weights * neg_scales

    pos_logits = log_scale * (feat_dists - pos_margin) * pos_weights
    neg_logits = log_scale * (neg_margin - feat_dists) * neg_weights
    loss_row = F.softplus(torch.logsumexp(pos_logits, dim=-1)
                          + torch.logsumexp(neg_logits, dim=-1)) / log_scale
    loss_col = F.softplus(torch.logsumexp(pos_logits, dim=-2)
                          + torch.logsumexp(neg_logits, dim=-2)) / log_scale
    return 0.5 * (_masked_mean(loss_row, row_masks) + _masked_mean(loss_col, col_masks))


def circle_loss(pos_masks, neg_masks, feat_dists, pos_margin, neg_margin, pos_optimal,
                neg_optimal, log_scale):
    """Unweighted circle loss (reference circle_loss.py:7-41)."""
    return weighted_circle_loss(pos_masks, neg_masks, feat_dists, pos_margin, neg_margin,
                                pos_optimal, neg_optimal, log_scale)
