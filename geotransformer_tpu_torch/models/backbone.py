r"""KPConv feature-pyramid backbone (``geotransformer_tpu/models/backbone.py``).

  encoder1  : ConvBlock(in, d) ; Residual(d, 2d)
  encoder i : Residual(2^{i-1} d, strided) ; Residual(-> 2^i d) ; Residual(=)
  decoder j : upsample + concat skip -> Unary(2^{j+1} d + 2^j d -> 2^j d)
              (the last decoder emits ``output_dim`` without norm/relu)

``encoder1_1`` reads, in this order of priority, the precomputed input
stream (the default PairBatch), the per-tile neighbor unions
(``union_rows0``, ``union_sel0``), the split stage-0 table, or the neighbor
table; every later conv reads its split table where the batch has one
(``neighbors_split``, and ``subsampling_split`` for the strided convs). The
strided blocks fuse their shortcut max-pool into the conv. Every conv takes
``mxu_dtype``, the contraction point (``PrecisionConfig.kpconv_mxu``). Training batches
carry the inverse neighbor tables (``neighbors_inv``, ``subsampling_inv``,
whole or split), which every conv but the input conv hands to its backward
(JAX ``models/backbone.py:63-123``). Returns ``feats_list`` finest-first.
"""

import torch
from torch import nn

from geotransformer_tpu_torch.models.kpconv import (
    ConvBlock,
    LastUnaryBlock,
    ResidualBlock,
    UnaryBlock,
    nearest_upsample,
)


class KPConvFPN(nn.Module):
    def __init__(self, input_dim, output_dim, init_dim, kernel_size, init_radius,
                 init_sigma, group_norm, num_stages=4, first_fine_stage=1,
                 neighbor_limits=(), force=None, mxu_dtype=torch.float32):
        super().__init__()
        self.input_dim = input_dim
        self.num_stages = num_stages
        self.first_fine_stage = first_fine_stage
        d, k = init_dim, kernel_size
        point = dict(force=force, mxu_dtype=mxu_dtype)
        for i in range(num_stages):
            radius = init_radius * (2**i)
            sigma = init_sigma * (2**i)
            cdim = d * (2**i)
            if i == 0:
                self.encoder1_1 = ConvBlock(input_dim, d, k, radius, sigma, group_norm, **point)
                self.encoder1_2 = ResidualBlock(d, 2 * d, k, radius, sigma, group_norm, **point)
            else:
                # the shortcut pool is bounded by the true neighbor limit,
                # not the sentinel-padded table width
                pool_cols = neighbor_limits[i - 1] if neighbor_limits else None
                setattr(self, f"encoder{i + 1}_1", ResidualBlock(
                    cdim, cdim, k, radius / 2, sigma / 2, group_norm, strided=True,
                    pool_cols=pool_cols, **point))
                setattr(self, f"encoder{i + 1}_2", ResidualBlock(
                    cdim, 2 * cdim, k, radius, sigma, group_norm, **point))
                setattr(self, f"encoder{i + 1}_3", ResidualBlock(
                    2 * cdim, 2 * cdim, k, radius, sigma, group_norm, **point))
        latent_dim = d * 2**num_stages
        for j in range(num_stages - 2, first_fine_stage - 1, -1):
            in_dim = latent_dim + d * 2 ** (j + 1)
            if j == first_fine_stage:
                latent_dim = output_dim
                block = LastUnaryBlock(in_dim, output_dim)
            else:
                latent_dim = d * 2 ** (j + 1)
                block = UnaryBlock(in_dim, latent_dim, group_norm)
            setattr(self, f"decoder{j + 1}", block)

    def forward(self, feats, batch):
        """Run the pyramid over a PairBatch (torch tensors).

        Returns:
            feats_list, finest-first (fine decoded feats .. coarsest feats).
        """
        points = batch["points"]
        masks = batch["masks"]
        neighbors = batch["neighbors"]
        subsampling = batch["subsampling"]
        upsampling = batch["upsampling"]
        nb_inv = batch.get("neighbors_inv", [None] * self.num_stages)
        sub_inv = batch.get("subsampling_inv", [None] * self.num_stages)
        nb_split = batch.get("neighbors_split", [None] * self.num_stages)
        sub_split = batch.get("subsampling_split", [None] * self.num_stages)

        stage_feats = []
        x = feats
        for i in range(self.num_stages):
            if i == 0:
                # input conv: edge stream > union gather > split table > table
                stream0 = batch.get("input_stream") if self.input_dim == 1 else None
                union0 = None
                if stream0 is None and "union_rows0" in batch:
                    union0 = (batch["union_rows0"], batch["union_sel0"])
                x = self.encoder1_1(
                    x, points[0], points[0], neighbors[0], masks[0], stream=stream0,
                    union_tables=union0,
                    split_tables=nb_split[0] if stream0 is None and union0 is None else None)
                x = self.encoder1_2(x, points[0], points[0], neighbors[0], masks[0], masks[0],
                                    inverse_table=nb_inv[0], split_tables=nb_split[0])
            else:
                x = getattr(self, f"encoder{i + 1}_1")(
                    x, points[i], points[i - 1], subsampling[i - 1], masks[i], masks[i - 1],
                    inverse_table=sub_inv[i - 1], split_tables=sub_split[i - 1])
                for block in (f"encoder{i + 1}_2", f"encoder{i + 1}_3"):
                    x = getattr(self, block)(
                        x, points[i], points[i], neighbors[i], masks[i], masks[i],
                        inverse_table=nb_inv[i], split_tables=nb_split[i])
            stage_feats.append(x)

        feats_list = [stage_feats[-1]]
        latent = stage_feats[-1]
        for j in range(self.num_stages - 2, self.first_fine_stage - 1, -1):
            latent = nearest_upsample(latent, upsampling[j])
            latent = torch.cat([latent, stage_feats[j]], dim=1)
            decoder = getattr(self, f"decoder{j + 1}")
            if j == self.first_fine_stage:
                latent = decoder(latent)
            else:
                latent = decoder(latent, masks[j])
            feats_list.append(latent)
        feats_list.reverse()
        return feats_list
