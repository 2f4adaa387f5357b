r"""GeoTransformer registration model, inference path
(``geotransformer_tpu/models/geotransformer.py``; reference
`experiments/geotransformer.3dmatch.../model.py:19-212`).

KPConv FPN -> geometric transformer over superpoints -> dual-normalized
superpoint matching -> learnable Sinkhorn over patch pairs -> local-to-global
registration, on one fixed-capacity PairBatch of torch tensors. Each
per-stage array stacks [ref | src], each padded to its cloud's capacity.
"""

import math

import torch
from torch import nn

from geotransformer_tpu_torch.configs import GeoTransformerConfig
from geotransformer_tpu_torch.models.backbone import KPConvFPN
from geotransformer_tpu_torch.models.kpconv import KPConv
from geotransformer_tpu_torch.models.lgr import local_to_global_registration
from geotransformer_tpu_torch.models.matching import superpoint_matching
from geotransformer_tpu_torch.models.sinkhorn import LearnableLogOptimalTransport
from geotransformer_tpu_torch.models.transformer import GeometricTransformer
from geotransformer_tpu_torch.ops.gather import gather_with_shadow
from geotransformer_tpu_torch.ops.partition import point_to_node_partition


def split_pair(array, ref_capacity):
    """Split a stacked [ref | src] tensor at the ref capacity."""
    return array[:ref_capacity], array[ref_capacity:]


def _ref_capacity(stage_caps, batch, stage):
    """Ref/src split row of a stage: from the config when the stage cap is an
    asymmetric (cap_ref, cap_src) pair, else half the stage's rows."""
    cap = stage_caps[stage] if stage < len(stage_caps) else None
    rows = batch["points"][stage].shape[0]
    if isinstance(cap, (tuple, list)):
        if int(cap[0]) + int(cap[1]) != rows:
            raise ValueError(f"stage {stage}: cfg caps {cap} do not match batch rows {rows}")
        return int(cap[0])
    return rows // 2


class GeoTransformer(nn.Module):
    def __init__(self, cfg: GeoTransformerConfig):
        super().__init__()
        self.cfg = cfg
        force = cfg.model.force_pallas
        bb = cfg.backbone
        self.backbone = KPConvFPN(
            bb.input_dim, bb.output_dim, bb.init_dim, bb.kernel_size, bb.init_radius,
            bb.init_sigma, bb.group_norm, num_stages=bb.num_stages,
            first_fine_stage=cfg.model.fine_level,
            neighbor_limits=tuple(cfg.caps.neighbor_limits), force=force)
        gt = cfg.geotransformer
        self.transformer = GeometricTransformer(
            gt.input_dim, gt.output_dim, gt.hidden_dim, gt.num_heads, gt.blocks,
            gt.sigma_d, gt.sigma_a, gt.angle_k, reduction_a=gt.reduction_a, force=force)
        self.optimal_transport = LearnableLogOptimalTransport(
            cfg.model.num_sinkhorn_iterations, force=force)

    def forward(self, batch, training=False, with_gt=False):
        """Register one padded pair.

        Args:
            batch: PairBatch of torch tensors
                (preprocess.pad_registration_batch + batch_to_torch).
            training, with_gt: must be False — training and GT targets need
                the overlap and backward kernels, which are not ported yet.

        Returns:
            dict of statically shaped outputs with validity masks.
        """
        if training or with_gt:
            raise NotImplementedError(
                "the port runs inference only: training=True / with_gt=True are not ported")
        if self.cfg.fine_matching.use_dustbin:
            raise NotImplementedError("fine_matching.use_dustbin is not ported")
        with torch.no_grad():
            return self._infer(batch)

    def _infer(self, batch):
        cfg = self.cfg
        fine = cfg.model.fine_level
        coarse = cfg.backbone.num_stages - 1
        cap_f = _ref_capacity(cfg.caps.stage_caps, batch, fine)
        cap_c = _ref_capacity(cfg.caps.stage_caps, batch, coarse)

        ref_points_c, src_points_c = split_pair(batch["points"][coarse], cap_c)
        ref_masks_c, src_masks_c = split_pair(batch["masks"][coarse], cap_c)
        ref_points_f, src_points_f = split_pair(batch["points"][fine], cap_f)
        ref_masks_f, src_masks_f = split_pair(batch["masks"][fine], cap_f)
        out = {
            "ref_points_c": ref_points_c, "src_points_c": src_points_c,
            "ref_points_f": ref_points_f, "src_points_f": src_points_f,
            "ref_masks_c": ref_masks_c, "src_masks_c": src_masks_c,
            "ref_masks_f": ref_masks_f, "src_masks_f": src_masks_f,
        }

        # 1. point-to-node partition
        k_patch = cfg.model.num_points_in_patch
        _, ref_node_masks, ref_node_knn_indices, ref_node_knn_masks = point_to_node_partition(
            ref_points_f, ref_points_c, k_patch, point_masks=ref_masks_f, node_masks_in=ref_masks_c)
        _, src_node_masks, src_node_knn_indices, src_node_knn_masks = point_to_node_partition(
            src_points_f, src_points_c, k_patch, point_masks=src_masks_f, node_masks_in=src_masks_c)
        ref_node_knn_points = gather_with_shadow(ref_points_f, ref_node_knn_indices, 0.0)
        src_node_knn_points = gather_with_shadow(src_points_f, src_node_knn_indices, 0.0)

        # 2. KPConv feature pyramid over the stacked pair
        feats_list = self.backbone(batch["features"], batch)
        feats_c = feats_list[-1]
        feats_f = feats_list[0]

        # 3. geometric transformer on superpoints
        ref_feats_c, src_feats_c = split_pair(feats_c, cap_c)
        ref_feats_c, src_feats_c = self.transformer(
            ref_points_c[None], src_points_c[None], ref_feats_c[None], src_feats_c[None],
            ref_masks=ref_masks_c[None], src_masks=src_masks_c[None])
        ref_feats_c = ref_feats_c[0]
        src_feats_c = src_feats_c[0]
        # rsqrt-form L2 normalize: padded rows are exactly zero
        ref_feats_c_norm = ref_feats_c * torch.rsqrt((ref_feats_c**2).sum(dim=1, keepdim=True) + 1e-24)
        src_feats_c_norm = src_feats_c * torch.rsqrt((src_feats_c**2).sum(dim=1, keepdim=True) + 1e-24)
        out["ref_feats_c"] = ref_feats_c_norm
        out["src_feats_c"] = src_feats_c_norm
        ref_feats_f, src_feats_f = split_pair(feats_f, cap_f)
        out["ref_feats_f"] = ref_feats_f
        out["src_feats_f"] = src_feats_f

        # 4. superpoint correspondences
        ref_node_corr_indices, src_node_corr_indices, node_corr_scores, node_corr_masks = (
            superpoint_matching(
                ref_feats_c_norm, src_feats_c_norm, cfg.coarse_matching.num_correspondences,
                ref_masks=ref_node_masks, src_masks=src_node_masks,
                dual_normalization=cfg.coarse_matching.dual_normalization))
        out["ref_node_corr_indices"] = ref_node_corr_indices
        out["src_node_corr_indices"] = src_node_corr_indices
        out["node_corr_masks"] = node_corr_masks

        # 5. patches of each node correspondence
        ref_corr_knn_indices = ref_node_knn_indices[ref_node_corr_indices]  # (P, K)
        src_corr_knn_indices = src_node_knn_indices[src_node_corr_indices]
        ref_corr_knn_masks = ref_node_knn_masks[ref_node_corr_indices] & node_corr_masks[:, None]
        src_corr_knn_masks = src_node_knn_masks[src_node_corr_indices] & node_corr_masks[:, None]
        ref_corr_knn_points = ref_node_knn_points[ref_node_corr_indices]
        src_corr_knn_points = src_node_knn_points[src_node_corr_indices]
        ref_corr_knn_feats = gather_with_shadow(ref_feats_f, ref_corr_knn_indices, 0.0)
        src_corr_knn_feats = gather_with_shadow(src_feats_f, src_corr_knn_indices, 0.0)
        out["ref_node_corr_knn_points"] = ref_corr_knn_points
        out["src_node_corr_knn_points"] = src_corr_knn_points
        out["ref_node_corr_knn_masks"] = ref_corr_knn_masks
        out["src_node_corr_knn_masks"] = src_corr_knn_masks

        # 6. optimal transport over patch-to-patch similarities
        matching_scores = torch.einsum(
            "pnd,pmd->pnm", ref_corr_knn_feats, src_corr_knn_feats) / math.sqrt(feats_f.shape[1])
        matching_scores = self.optimal_transport(
            matching_scores, ref_corr_knn_masks, src_corr_knn_masks)
        out["matching_scores"] = matching_scores

        # 7. local-to-global registration
        fm = cfg.fine_matching
        corr_capacity = (fm.correspondence_limit if fm.correspondence_limit is not None
                         else cfg.caps.correspondence_capacity)
        out.update(local_to_global_registration(
            ref_corr_knn_points, src_corr_knn_points, ref_corr_knn_masks, src_corr_knn_masks,
            matching_scores[:, :-1, :-1],
            k=fm.topk, acceptance_radius=fm.acceptance_radius,
            confidence_threshold=fm.confidence_threshold, mutual=fm.mutual,
            use_global_score=fm.use_global_score, global_scores=node_corr_scores,
            correspondence_threshold=fm.correspondence_threshold,
            correspondence_limit=corr_capacity,
            num_refinement_steps=fm.num_refinement_steps, patch_masks=node_corr_masks))
        return out


def init_parameters(model, generator):
    """Seeded random initialisation, flax's defaults in kind: Linear weights
    normal with std 1/sqrt(fan_in), biases 0, KPConv weights uniform(+-1/sqrt(C_in
    C_out)), norms 1/0, the Sinkhorn dustbin score 1."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                module.weight.normal_(0.0, 1.0 / math.sqrt(module.in_features), generator=generator)
                module.bias.zero_()
            elif isinstance(module, KPConv):
                _, c_in, c_out = module.weights.shape
                bound = 1.0 / math.sqrt(c_in * c_out)
                module.weights.uniform_(-bound, bound, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, (nn.GroupNorm, nn.LayerNorm)):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, LearnableLogOptimalTransport):
                module.alpha.fill_(1.0)


def create_model(cfg: GeoTransformerConfig, seed=None) -> GeoTransformer:
    """Model with parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` (default ``cfg.seed``), on the CPU; move it with ``.to(device)``."""
    model = GeoTransformer(cfg)
    generator = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    init_parameters(model, generator)
    return model.eval()
