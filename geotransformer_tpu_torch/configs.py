r"""Experiment configuration (frozen dataclasses).

The port's own copy of ``geotransformer_tpu/configs.py``: the same classes,
field names, defaults and factories, so a config built here and one built
there compare equal field by field (``dataclasses.asdict``), with one
difference: :class:`PrecisionConfig` defaults to float32 everywhere, where
the JAX package defaults three of its four knobs to bfloat16.
``ModelConfig.force_pallas`` selects the port's kernels the way it selects
the Pallas kernels there (see
:func:`geotransformer_tpu_torch.kernels.cuda.use_kernel`).

The JAX package installs its precision point process-wide
(``apply_precision`` sets the kernel modules' dtype globals); the port has
no counterpart: :class:`GeoTransformer` hands ``cfg.precision`` down its
module tree, and each kernel wrapper takes its dtypes as arguments.
"""

from dataclasses import dataclass, field, fields, replace
from typing import Optional, Tuple


@dataclass(frozen=True)
class BackboneConfig:
    num_stages: int = 4
    init_voxel_size: float = 0.025
    kernel_size: int = 15
    base_radius: float = 2.5
    base_sigma: float = 2.0
    group_norm: int = 32
    input_dim: int = 1
    init_dim: int = 64
    output_dim: int = 256

    @property
    def init_radius(self):
        return self.base_radius * self.init_voxel_size

    @property
    def init_sigma(self):
        return self.base_sigma * self.init_voxel_size


@dataclass(frozen=True)
class ModelConfig:
    ground_truth_matching_radius: float = 0.05
    num_points_in_patch: int = 64
    num_sinkhorn_iterations: int = 100
    fine_level: int = 1  # pyramid stage of the fine features (0 for ModelNet)
    # None: the CUDA kernels for CUDA tensors, the plain PyTorch versions for
    # CPU tensors; False: plain everywhere; True: kernels (CPU raises)
    force_pallas: "bool | None" = None


@dataclass(frozen=True)
class CoarseMatchingConfig:
    num_targets: int = 128
    overlap_threshold: float = 0.1
    num_correspondences: int = 256
    dual_normalization: bool = True


@dataclass(frozen=True)
class GeoTransformerModuleConfig:
    input_dim: int = 1024
    hidden_dim: int = 256
    output_dim: int = 256
    num_heads: int = 4
    blocks: Tuple[str, ...] = ("self", "cross", "self", "cross", "self", "cross")
    sigma_d: float = 0.2
    sigma_a: float = 15.0
    angle_k: int = 3
    reduction_a: str = "max"


@dataclass(frozen=True)
class FineMatchingConfig:
    topk: int = 3
    acceptance_radius: float = 0.1
    mutual: bool = True
    confidence_threshold: float = 0.05
    use_dustbin: bool = False
    use_global_score: bool = False
    correspondence_threshold: int = 3
    correspondence_limit: Optional[int] = None  # see caps.correspondence_capacity
    num_refinement_steps: int = 5


@dataclass(frozen=True)
class CoarseLossConfig:
    positive_margin: float = 0.1
    negative_margin: float = 1.4
    positive_optimal: float = 0.1
    negative_optimal: float = 1.4
    log_scale: float = 24.0
    positive_overlap: float = 0.1


@dataclass(frozen=True)
class FineLossConfig:
    positive_radius: float = 0.05


@dataclass(frozen=True)
class LossConfig:
    weight_coarse_loss: float = 1.0
    weight_fine_loss: float = 1.0


@dataclass(frozen=True)
class EvalConfig:
    acceptance_overlap: float = 0.0
    acceptance_radius: float = 0.1
    inlier_ratio_threshold: float = 0.05
    rmse_threshold: float = 0.2
    rre_threshold: float = 15.0
    rte_threshold: float = 0.3


@dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-4
    lr_decay: float = 0.95
    lr_decay_steps: int = 1
    weight_decay: float = 1e-6
    max_epoch: int = 40
    grad_acc_steps: int = 1
    # iteration-based (ModelNet) schedule:
    warmup_steps: int = 0
    eta_init: float = 0.1
    eta_min: float = 0.1
    max_iteration: int = 0
    snapshot_steps: int = 0


@dataclass(frozen=True)
class CapsConfig:
    """Static-shape capacities (no reference equivalent)."""

    stage_caps: Tuple[int, ...] = (20480, 5632, 1664, 640)  # per-cloud, per-stage
    neighbor_limits: Tuple[int, ...] = (38, 36, 36, 38)
    # in-degree capacities of the inverse neighbor tables that feed the
    # KPConv backward (training batches only)
    inverse_limits: Tuple[int, ...] = (80, 80, 80, 80)
    gt_candidates: int = 64          # S: src candidates per ref node for GT overlaps
    gt_chunk_size: int = 32          # ref nodes per chunk of the overlap computation
    correspondence_capacity: int = 4096  # C: LGR verification-set capacity
    # split-table specs, per stage (h1, m2_cap) or None, for
    # pad_registration_batch (preprocess.calibrate_split_specs,
    # fit_split_for_table); the model reads the tables from the batch
    neighbor_splits: Optional[Tuple[Optional[Tuple[int, int]], ...]] = None
    subsampling_splits: Optional[Tuple[Optional[Tuple[int, int]], ...]] = None
    inverse_splits: Optional[Tuple[Optional[Tuple[int, int]], ...]] = None
    sub_inverse_splits: Optional[Tuple[Optional[Tuple[int, int]], ...]] = None


DTYPE_NAMES = ("float32", "bfloat16")


@dataclass(frozen=True)
class PrecisionConfig:
    """The kernels' numeric point (JAX ``configs.PrecisionConfig``: the same
    fields and value names, each a dtype name, "float32" or "bfloat16").

    kpconv_table: storage of the gathered KPConv neighbor tables.
    kpconv_mxu: the KPConv contraction operands: at C_in > 1 the influences
        and the neighbor features before the neighbor sum, at C_in = 1 the
        influence sums t1 and the weights before t1 W.
    gse_basis: the GSE sin/cos bases and projection weights.
    gse_embed: the stored (N, N, C) GSE embedding, which every RPE layer
        reads.

    The port defaults to float32 throughout: the accuracy of its kernels
    (3xTF32), at which every card check is set. The JAX package's defaults
    (:data:`JAX_PRECISION`) round the last three to bfloat16 (round to
    nearest even). Both the kernels and their plain versions honour the
    point, on the card and on the CPU, forward and backward: the model
    trains at every point the JAX package computes. A batch for a
    ``kpconv_table="bfloat16"`` model pads its forward tables to
    ``preprocess.table_align(precision)`` columns, as the JAX host batch
    does.
    """

    kpconv_table: str = "float32"
    kpconv_mxu: str = "float32"
    gse_basis: str = "float32"
    gse_embed: str = "float32"

    def __post_init__(self):
        for name in PRECISION_KNOBS:
            knob_dtype(self, name)


PRECISION_KNOBS = tuple(f.name for f in fields(PrecisionConfig))


def knob_dtype(precision, name):
    """The torch dtype of knob ``name`` of ``precision`` (read by field name,
    so a configuration of the same shape from the JAX package is read the
    same way); raises ``ValueError`` on a dtype name other than "float32"
    or "bfloat16"."""
    import torch

    value = getattr(precision, name)
    if value not in DTYPE_NAMES:
        raise ValueError(f"precision.{name} = {value!r}: one of {DTYPE_NAMES}")
    return torch.float32 if value == "float32" else torch.bfloat16


# the JAX package's default point (geotransformer_tpu/configs.py:181-184)
JAX_PRECISION = PrecisionConfig(kpconv_mxu="bfloat16", gse_basis="bfloat16",
                                gse_embed="bfloat16")


@dataclass(frozen=True)
class GeoTransformerConfig:
    seed: int = 7351
    dataset: str = "3dmatch"
    backbone: BackboneConfig = field(default_factory=BackboneConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    coarse_matching: CoarseMatchingConfig = field(default_factory=CoarseMatchingConfig)
    geotransformer: GeoTransformerModuleConfig = field(default_factory=GeoTransformerModuleConfig)
    fine_matching: FineMatchingConfig = field(default_factory=FineMatchingConfig)
    coarse_loss: CoarseLossConfig = field(default_factory=CoarseLossConfig)
    fine_loss: FineLossConfig = field(default_factory=FineLossConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    caps: CapsConfig = field(default_factory=CapsConfig)
    precision: PrecisionConfig = field(default_factory=PrecisionConfig)

    @property
    def first_fine_stage(self):
        return self.model.fine_level

    def with_caps(self, **kwargs):
        return replace(self, caps=replace(self.caps, **kwargs))

    def with_model(self, **kwargs):
        return replace(self, model=replace(self.model, **kwargs))


def make_3dmatch_config():
    """3DMatch/3DLoMatch (reference `...3dmatch.../config.py`)."""
    return GeoTransformerConfig()


def make_kitti_config():
    """KITTI odometry, 5-stage backbone (reference `...kitti.../config.py`)."""
    return GeoTransformerConfig(
        dataset="kitti",
        backbone=BackboneConfig(num_stages=5, init_voxel_size=0.3, base_radius=4.25),
        model=ModelConfig(
            ground_truth_matching_radius=0.6, num_points_in_patch=128, fine_level=1
        ),
        geotransformer=GeoTransformerModuleConfig(
            input_dim=2048, hidden_dim=128, sigma_d=4.8
        ),
        fine_matching=FineMatchingConfig(topk=2, acceptance_radius=0.6),
        coarse_loss=CoarseLossConfig(log_scale=40.0),
        fine_loss=FineLossConfig(positive_radius=0.6),
        eval=EvalConfig(acceptance_radius=1.0, rre_threshold=5.0, rte_threshold=2.0),
        optim=OptimConfig(lr_decay_steps=4, max_epoch=160),
        caps=CapsConfig(
            stage_caps=(30720, 8192, 2048, 768, 256),
            neighbor_limits=(65, 65, 65, 65, 65),
            inverse_limits=(136, 136, 136, 136, 136),
            correspondence_capacity=8192,
        ),
    )


def make_modelnet_config():
    """ModelNet synthetic pairs, 3-stage backbone decoding to full resolution
    (reference `...modelnet.../config.py`)."""
    return GeoTransformerConfig(
        dataset="modelnet",
        backbone=BackboneConfig(num_stages=3, init_voxel_size=0.05),
        model=ModelConfig(
            ground_truth_matching_radius=0.05, num_points_in_patch=128, fine_level=0
        ),
        coarse_matching=CoarseMatchingConfig(num_correspondences=128),
        geotransformer=GeoTransformerModuleConfig(input_dim=512, hidden_dim=256),
        eval=EvalConfig(rre_threshold=1.0, rte_threshold=0.1),
        optim=OptimConfig(
            warmup_steps=10000, max_iteration=400000, snapshot_steps=10000
        ),
        caps=CapsConfig(
            stage_caps=(768, 384, 192),
            neighbor_limits=(34, 34, 34),
            inverse_limits=(72, 72, 72),
            correspondence_capacity=4096,
        ),
    )



CONFIG_FACTORIES = {
    "3dmatch": make_3dmatch_config,
    "kitti": make_kitti_config,
    "modelnet": make_modelnet_config,
}


def make_config(name):
    """The configuration of dataset ``name`` (3dmatch, kitti or modelnet)."""
    return CONFIG_FACTORIES[name]()
