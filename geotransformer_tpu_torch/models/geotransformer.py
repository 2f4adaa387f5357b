r"""GeoTransformer registration model
(``geotransformer_tpu/models/geotransformer.py``; reference
`experiments/geotransformer.3dmatch.../model.py:19-212`).

KPConv FPN -> geometric transformer over superpoints -> dual-normalized
superpoint matching -> learnable Sinkhorn over patch pairs -> local-to-global
registration, on one fixed-capacity PairBatch of torch tensors. Each
per-stage array stacks [ref | src], each padded to its cloud's capacity.

``with_gt`` adds the ground-truth node overlaps the losses need; ``training``
feeds the fine head sampled GT node pairs instead of the predicted ones and
keeps the autograd graph (the CUDA kernels' autograd Functions). As in the
JAX model, superpoint matching and LGR see no gradient, and a batch may
carry the partition and GT tables precomputed (:func:`precompute_gt_targets`).

``cfg.precision`` (:class:`~geotransformer_tpu_torch.configs.PrecisionConfig`)
goes down the module tree with the config, as ``force_pallas`` does: every
KPConv takes ``kpconv_mxu``, the GSE module ``gse_basis`` and ``gse_embed``,
and the RPE attention reads the embedding in its dtype. No process-wide
state is set. A bfloat16 point serves inference; ``kpconv_table="bfloat16"``
and gradients at a bfloat16 point raise ``NotImplementedError``.
"""

import math

import torch
from torch import nn

from geotransformer_tpu_torch.configs import GeoTransformerConfig, knob_dtype
from geotransformer_tpu_torch.models.backbone import KPConvFPN
from geotransformer_tpu_torch.models.kpconv import KPConv
from geotransformer_tpu_torch.models.lgr import local_to_global_registration
from geotransformer_tpu_torch.models.matching import (
    get_node_correspondences,
    superpoint_matching,
    superpoint_target_sample,
)
from geotransformer_tpu_torch.models.sinkhorn import LearnableLogOptimalTransport
from geotransformer_tpu_torch.models.transformer import GeometricTransformer
from geotransformer_tpu_torch.ops.gather import gather_with_shadow
from geotransformer_tpu_torch.ops.partition import point_to_node_partition
from geotransformer_tpu_torch.preprocess.pyramid import batch_to_torch


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


def _stage_pair(cfg, batch, stage, key):
    return split_pair(batch[key][stage], _ref_capacity(cfg.caps.stage_caps, batch, stage))


def _partition_pair(cfg, batch):
    """Point-to-node partition of both clouds (batch geometry, no gradient;
    JAX ``models/geotransformer.py:54-76``)."""
    fine, coarse = cfg.model.fine_level, cfg.backbone.num_stages - 1
    out = {}
    for side, points_f, masks_f, points_c, masks_c in zip(
            ("ref", "src"), _stage_pair(cfg, batch, fine, "points"),
            _stage_pair(cfg, batch, fine, "masks"), _stage_pair(cfg, batch, coarse, "points"),
            _stage_pair(cfg, batch, coarse, "masks")):
        (_, out[f"{side}_node_masks"], out[f"{side}_node_knn_indices"],
         out[f"{side}_node_knn_masks"]) = point_to_node_partition(
            points_f, points_c, cfg.model.num_points_in_patch, point_masks=masks_f,
            node_masks_in=masks_c)
    return out


def _gt_candidates(cfg, batch, part):
    """GT node overlaps, fixed candidates per ref node (the overlap kernel on
    the card, JAX ``models/geotransformer.py:187-202``)."""
    fine, coarse = cfg.model.fine_level, cfg.backbone.num_stages - 1
    ref_points_c, src_points_c = _stage_pair(cfg, batch, coarse, "points")
    ref_points_f, src_points_f = _stage_pair(cfg, batch, fine, "points")
    cand_indices, cand_overlaps, cand_masks = get_node_correspondences(
        ref_points_c, src_points_c,
        gather_with_shadow(ref_points_f, part["ref_node_knn_indices"], 0.0),
        gather_with_shadow(src_points_f, part["src_node_knn_indices"], 0.0),
        batch["transform"], cfg.model.ground_truth_matching_radius,
        ref_masks=part["ref_node_masks"], src_masks=part["src_node_masks"],
        ref_knn_masks=part["ref_node_knn_masks"], src_knn_masks=part["src_node_knn_masks"],
        num_candidates=cfg.caps.gt_candidates, chunk_size=cfg.caps.gt_chunk_size,
        force=cfg.model.force_pallas)
    return {"gt_cand_indices": cand_indices, "gt_cand_overlaps": cand_overlaps,
            "gt_cand_masks": cand_masks}


_PARTITION_KEYS = (
    "ref_node_masks", "ref_node_knn_indices", "ref_node_knn_masks",
    "src_node_masks", "src_node_knn_indices", "src_node_knn_masks",
)
_GT_KEYS = ("gt_cand_indices", "gt_cand_overlaps", "gt_cand_masks")


def precompute_gt_targets(cfg, batch, device="cuda"):
    """The parameter-free geometry of a training pair, computed once
    (JAX ``models/geotransformer.py:86-124``): the point-to-node partition
    and the GT overlap candidates, as new batch entries that
    :class:`GeoTransformer` consumes (``dict(batch, **targets)``).

    Args:
        batch: PairBatch of numpy arrays or torch tensors; moved to ``device``.
        device: where the targets are computed and returned.
    """
    batch = batch_to_torch(batch, device)
    with torch.no_grad():
        out = _partition_pair(cfg, batch)
        out.update(_gt_candidates(cfg, batch, out))
    return out


class GeoTransformer(nn.Module):
    def __init__(self, cfg: GeoTransformerConfig):
        super().__init__()
        self.cfg = cfg
        force = cfg.model.force_pallas
        precision = cfg.precision
        if knob_dtype(precision, "kpconv_table") != torch.float32:
            raise NotImplementedError(
                "kpconv_table='bfloat16' (bfloat16 gathered tables) is not ported (ROADMAP.md "
                "queue 1: training at the JAX precision point)")
        bb = cfg.backbone
        self.backbone = KPConvFPN(
            bb.input_dim, bb.output_dim, bb.init_dim, bb.kernel_size, bb.init_radius,
            bb.init_sigma, bb.group_norm, num_stages=bb.num_stages,
            first_fine_stage=cfg.model.fine_level,
            neighbor_limits=tuple(cfg.caps.neighbor_limits), force=force,
            mxu_dtype=knob_dtype(precision, "kpconv_mxu"))
        gt = cfg.geotransformer
        self.transformer = GeometricTransformer(
            gt.input_dim, gt.output_dim, gt.hidden_dim, gt.num_heads, gt.blocks,
            gt.sigma_d, gt.sigma_a, gt.angle_k, reduction_a=gt.reduction_a, force=force,
            basis_dtype=knob_dtype(precision, "gse_basis"),
            embed_dtype=knob_dtype(precision, "gse_embed"))
        self.optimal_transport = LearnableLogOptimalTransport(
            cfg.model.num_sinkhorn_iterations, force=force)

    def forward(self, batch, training=False, with_gt=False, generator=None):
        """Register one padded pair.

        Args:
            batch: PairBatch of torch tensors
                (preprocess.pad_registration_batch + batch_to_torch), with
                the inverse tables for training and, optionally, the
                precomputed partition and GT keys.
            training: feed the fine head sampled GT node pairs (needs
                ``with_gt``) and keep the autograd graph; otherwise the
                forward runs under ``torch.no_grad``.
            with_gt: compute (or take from the batch) the GT node overlaps
                (``gt_cand_*``) the losses and PIR need.
            generator: CPU ``torch.Generator`` of the target sampling keys.

        Returns:
            dict of statically shaped outputs with validity masks.
        """
        if training and not with_gt:
            raise ValueError("training=True requires with_gt=True")
        if training:
            return self._run(batch, training, with_gt, generator)
        with torch.no_grad():
            return self._run(batch, training, with_gt, generator)

    def _run(self, batch, training, with_gt, generator):
        cfg = self.cfg
        fine = cfg.model.fine_level
        coarse = cfg.backbone.num_stages - 1
        ref_points_c, src_points_c = _stage_pair(cfg, batch, coarse, "points")
        ref_masks_c, src_masks_c = _stage_pair(cfg, batch, coarse, "masks")
        ref_points_f, src_points_f = _stage_pair(cfg, batch, fine, "points")
        ref_masks_f, src_masks_f = _stage_pair(cfg, batch, fine, "masks")
        out = {
            "ref_points_c": ref_points_c, "src_points_c": src_points_c,
            "ref_points_f": ref_points_f, "src_points_f": src_points_f,
            "ref_masks_c": ref_masks_c, "src_masks_c": src_masks_c,
            "ref_masks_f": ref_masks_f, "src_masks_f": src_masks_f,
        }

        # 1. point-to-node partition and GT overlaps (batch geometry, no
        # gradient), precomputed or here
        with torch.no_grad():
            if "ref_node_knn_indices" in batch:
                part = {k: batch[k] for k in _PARTITION_KEYS}
            else:
                part = _partition_pair(cfg, batch)
            if with_gt:
                out.update({k: batch[k] for k in _GT_KEYS} if "gt_cand_indices" in batch
                           else _gt_candidates(cfg, batch, part))
        ref_node_knn_points = gather_with_shadow(ref_points_f, part["ref_node_knn_indices"], 0.0)
        src_node_knn_points = gather_with_shadow(src_points_f, part["src_node_knn_indices"], 0.0)

        # 2. KPConv feature pyramid over the stacked pair
        feats_list = self.backbone(batch["features"], batch)
        feats_c = feats_list[-1]
        feats_f = feats_list[0]

        # 3. geometric transformer on superpoints
        ref_feats_c, src_feats_c = split_pair(feats_c, ref_points_c.shape[0])
        ref_feats_c, src_feats_c = self.transformer(
            ref_points_c[None], src_points_c[None], ref_feats_c[None], src_feats_c[None],
            ref_masks=ref_masks_c[None], src_masks=src_masks_c[None])
        ref_feats_c = ref_feats_c[0]
        src_feats_c = src_feats_c[0]
        # rsqrt-form L2 normalize: padded rows are exactly zero, and the
        # backward stays finite there
        ref_feats_c_norm = ref_feats_c * torch.rsqrt((ref_feats_c**2).sum(dim=1, keepdim=True) + 1e-24)
        src_feats_c_norm = src_feats_c * torch.rsqrt((src_feats_c**2).sum(dim=1, keepdim=True) + 1e-24)
        out["ref_feats_c"] = ref_feats_c_norm
        out["src_feats_c"] = src_feats_c_norm
        ref_feats_f, src_feats_f = split_pair(feats_f, ref_points_f.shape[0])
        out["ref_feats_f"] = ref_feats_f
        out["src_feats_f"] = src_feats_f

        # 4. superpoint correspondences (no gradient)
        with torch.no_grad():
            ref_node_corr_indices, src_node_corr_indices, node_corr_scores, node_corr_masks = (
                superpoint_matching(
                    ref_feats_c_norm.detach(), src_feats_c_norm.detach(),
                    cfg.coarse_matching.num_correspondences,
                    ref_masks=part["ref_node_masks"], src_masks=part["src_node_masks"],
                    dual_normalization=cfg.coarse_matching.dual_normalization))
        out["ref_node_corr_indices"] = ref_node_corr_indices
        out["src_node_corr_indices"] = src_node_corr_indices
        out["node_corr_masks"] = node_corr_masks

        # 4.1 training: the fine head consumes sampled GT node pairs
        if training:
            flat_overlaps = torch.where(out["gt_cand_masks"], out["gt_cand_overlaps"],
                                        0.0).reshape(-1)
            sel, sel_masks = superpoint_target_sample(
                generator, flat_overlaps, cfg.coarse_matching.num_targets,
                cfg.coarse_matching.overlap_threshold)
            ref_node_corr_indices = sel // cfg.caps.gt_candidates
            src_node_corr_indices = out["gt_cand_indices"].reshape(-1)[sel]
            node_corr_scores = flat_overlaps[sel]
            node_corr_masks = sel_masks

        # 5. patches of each node correspondence
        ref_corr_knn_indices = part["ref_node_knn_indices"][ref_node_corr_indices]  # (P, K)
        src_corr_knn_indices = part["src_node_knn_indices"][src_node_corr_indices]
        ref_corr_knn_masks = (part["ref_node_knn_masks"][ref_node_corr_indices]
                              & node_corr_masks[:, None])
        src_corr_knn_masks = (part["src_node_knn_masks"][src_node_corr_indices]
                              & node_corr_masks[:, None])
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
            matching_scores, ref_corr_knn_masks, src_corr_knn_masks, training=training)
        out["matching_scores"] = matching_scores

        # 7. local-to-global registration (no gradient); with the dustbin
        # LGR takes the whole (P, K+1, K+1) scores and strips it after top-k
        fm = cfg.fine_matching
        corr_capacity = (fm.correspondence_limit if fm.correspondence_limit is not None
                         else cfg.caps.correspondence_capacity)
        lgr_scores = matching_scores.detach()
        if not fm.use_dustbin:
            lgr_scores = lgr_scores[:, :-1, :-1]
        with torch.no_grad():
            out.update(local_to_global_registration(
                ref_corr_knn_points, src_corr_knn_points, ref_corr_knn_masks,
                src_corr_knn_masks, lgr_scores,
                k=fm.topk, acceptance_radius=fm.acceptance_radius,
                confidence_threshold=fm.confidence_threshold, mutual=fm.mutual,
                use_dustbin=fm.use_dustbin,
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


def create_model(cfg: GeoTransformerConfig, seed=None, device="cuda") -> GeoTransformer:
    """Model with parameters drawn from a CPU ``torch.Generator`` seeded with
    ``seed`` (default ``cfg.seed``), returned on ``device``: the card unless
    the caller asks for another (without one, ``"cuda"`` raises)."""
    model = GeoTransformer(cfg)
    generator = torch.Generator().manual_seed(cfg.seed if seed is None else seed)
    init_parameters(model, generator)
    return model.to(device).eval()
