#!/usr/bin/env python3
r"""Drive the PyTorch port's 3DMatch, KITTI and ModelNet inference, training
and eval paths, its device pyramid and its training engine, on one CUDA
card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's exception is caught). Every
counted run clears the kernels' launch counts just before it and reads them
just after; each count must equal what the batch's tables and the
transformer's blocks imply (``expected_launches``: one launch a conv, whole
or split table, counted as kpconv_fused or kpconv_split_fused; one
kpconv_bwd_fused launch a conv's backward, whole or split inverse table;
each forward launches rpe_pair_scores twice a "self" block and
fused_masked_attention twice a block).
  1. build   — nvcc compiles the CUDA kernels of geotransformer_tpu_torch/
               kernels/csrc for sm_90a, one process per source, in parallel;
  2. batch   — three synthetic 3DMatch-scale pairs (19,000-point wavy
               surface, 80 % overlap, 4 mm noise, known rigid transform)
               through the port's host pyramid, caps as scripts/demo.py picks
               them (multiple 256, per cloud), with the inverse neighbor
               tables of training batches;
  3. forward — the full-width make_3dmatch_config() model, seeded random
               weights, registers the three pairs, counted; per-pair time
               from CUDA events;
  4. kernel vs plain — each inference kernel on the inputs it got in a
               forward, held against its plain PyTorch version (KPConv rtol
               1e-4 and atol 1e-5 x max|plain|; GSE atol 1e-3 on the valid
               rectangle; RPE pair scores 1e-5 x max|plain|; attention 1e-5 x
               max|plain| on valid rows, exact zeros on padded rows; Sinkhorn
               1e-4 on valid entries), both timed (CUDA events around the
               calls, host dispatch included), the kernel also on the device
               alone (device_ms: the calls captured in one CUDA graph, the
               capture counting each kernel launch once, and the graph
               replayed between two CUDA events), and the attention kernels
               also against one PyTorch call (library_ms: torch.bmm, SDPA),
               timed both ways (library_device_ms); the KPConv rows
               (kpconv_fused, kpconv_split_fused, kpconv_bwd_fused), the
               GSE rows (gse_embedding_full, gse_full_bwd) and the Sinkhorn
               rows (sinkhorn_log_iterations, sinkhorn_fwd_train,
               sinkhorn_bwd_train) also each call alone from its own graph,
               with its shape and bound (by_call); and the whole model
               with force_pallas=False, whose ref/src_feats_c must agree with
               the kernel run to 1e-3 of their largest magnitude;
  5. union   — the same pairs with per-tile neighbor unions and no edge
               stream (union_cap 1536 or the next multiple of 512 that
               holds, tile 128): one counted forward each through the
               union-gather input conv, ref/src_feats_c within 1e-3 of
               phase 3's; the union kernel vs its plain version;
  6. train   — 8 training steps (Adam at the config's lr; pairs 0, 1, 2 in
               turn; GT targets precomputed on the card), each counted; every
               loss finite, no step skipped by the finite-gradient guard, and
               the seed-0 loss after the steps below its first; per-step time
               (CUDA events) and peak device memory;
  7. backward kernels vs plain — each training kernel on the inputs it got
               in one step, against its plain version (KPConv backward as the
               forward; the input conv's training call, which also writes the
               weight gradient's residuals t1 and count, as its own entry
               "kpconv_stream_fused (residuals)": out and t1 as KPConv, the
               count bit for bit; GSE gradients atol 1e-4 x the largest plain one, and
               the share of its (pair, channel) entries whose angle argmax
               the kernel settled in float64; Sinkhorn 1e-4), timed both
               ways, as phase 4; and the whole step:
               every parameter gradient of the kernel model against the
               exact step, the force_pallas=False model's in float64 from
               the same weights, batch and GT targets (the k-NN patches and
               GT candidate overlaps computed once in float32) along every
               discrete choice of the kernel step (``witness``: its ReLU
               branches, sampled GT node pairs, coarse loss labels, fine
               GT matches within the positive radius, max-pool routes and
               tie counts, conv divisors):
               the whole step's and each tensor's within 1e-3 (relative
               norm) plus twice the float32 plain step's distance of the
               float64 step along its own choices, the vanishing ones under
               the noise floor (proj_p.bias exactly 0 on the kernel route,
               which drops q . b_p); the ReLU branch flips between the
               routes counted on valid rows (the stage masks) and padded
               rows apart, and none on a valid row whose float64 input lies
               outside the f32 rounding band of 0; the distances along the
               ReLU branches alone printed beside; a violation fails the
               run at its end;
  8. profile — torch.profiler over two more training steps: device time by
               kernel (chiprun_out/train_profile.txt) and the device's busy
               share of phase 6's median step;
  9. KITTI batch — three synthetic LiDAR pairs (seeds 0-2: ray-cast ground
               and facades, ~30k points a scan after the 0.3 m voxel grid,
               src sensor at (6, 2) with yaw 0.12 so ref = R_z(0.12) src +
               (6, 2, 0)), per-cloud stage capacities (multiple 256) and
               neighbor and subsampling split specs calibrated over the three
               pairs, inverse tables with splits fitted to each pair;
 10. KITTI forward — the full-width make_kitti_config() model registers the
               three pairs, counted, timed; each inference kernel of the KITTI
               forward (kpconv_split_fused among them) vs its plain version on
               the inputs it got there, as phase 4, and kpconv_split_fused
               also vs the unsplit plain conv on the whole table, and on the
               device (graph replay) against the unsplit kpconv_fused on the
               whole tables; the force_pallas=False model agrees on
               ref/src_feats_c to 1e-3;
 11. KITTI train — 6 steps (pairs 0, 1, 2 in turn) without precomputed
               targets, so every step runs patch_overlaps; counted, finite
               losses, no skip, falling seed-0 loss, step median, peak
               memory; each training kernel of one KITTI step (the split
               branch of kpconv_bwd_fused, Sinkhorn at 129 x 129, GSE at
               C = 128) and patch_overlaps (bit-equal on every valid
               candidate) vs its plain version; whole-step gradients vs the
               plain model's; one eval step per pair (no precomputed
               targets), counted, finite metrics, and patch_overlaps of the
               first vs its plain version (path "kitti_eval"); a profile of
               two more steps (chiprun_out/kitti_train_profile.txt).
 11p. precision (runs after phase 11) — the JAX package's default point
               (configs.JAX_PRECISION: bfloat16 KPConv operands, GSE bases
               and embedding) on the 3DMatch cell's pair 0 (its edge-stream
               batch and its union batch) and the KITTI cell's pair 0, at
               full width with the phases' trained weights, and the KITTI
               pair with the cell's untrained seeded weights: one forward
               each, counted (paths *_precision_inference), checked as
               phase 3, its coarse features nearer the force_pallas=False
               model's at the same point than that model is to its
               float32 twin, and on the trained weights within 1e-3 of
               them; the float32 kernel forward's distance from its plain
               twin printed beside, the distances in relative norm too,
               with each bfloat16 row plain in turn, and the bfloat16
               forward's from the float32 kernel forward (coarse-feature
               relative norm, rotation degrees, translation mm: reported,
               not bounded);
               each bfloat16 kernel call (rows 1, 2, 3, 5, 7, 12)
               against its plain version at the same point (every entry
               within the row's bound plus 2^-7 of its largest |plain|, 99 %
               within the bound: a value within an ulp of a bfloat16
               rounding boundary may round the other way on the two), the
               kernel nearer its plain version than a quarter of the
               bfloat16-against-float32 distance on the rows that round
               (rounding_witness), and each row's calls replayed from a CUDA
               graph beside the same calls at float32 (paths
               precision_3dmatch, precision_3dmatch_union, precision_kitti,
               precision_kitti_untrained; "precision" in the kernels line).
 11t. precision training (after 11p) — training at the JAX point on the
               phases' trained weights: the 3DMatch cell's pair 0 with its
               inverse tables (path precision_3dmatch_train) and the KITTI
               cell's pair 0 with its split inverse tables (path
               precision_kitti_train), two make_train_step steps each,
               counted (paths *_precision_train), finite, none skipped; and
               all four knobs bfloat16 (kpconv_table too) on the 3DMatch
               pair padded at the table point's 16 columns: one counted
               forward and one step (path precision_table). Every bfloat16
               call of a step's training kernels (rows 6 and 8, the input
               conv's residuals, Sinkhorn) and of the table point's forward
               against its plain version at the same point (the bfloat16
               rule above), rounding_witness below 0.25 on rows 6 and 8
               and the table instances, each row's calls beside the same
               calls at float32 (graph); the kernel step's gradients
               nearer the plain step at the same point than that step is to
               the float32 plain step (relative norm, whole step; each
               tensor reported).
 12. ModelNet batch — a synthetic ModelNet pickle written from a seed into a
               temporary directory (4 entries of 2048 points with normals on
               random boxes and cylinders, asymmetric labels), read by the
               port's ModelNetPairDataset at the reference settings (717
               points, noise 0.05, keep 0.7, twice sampled, 45 deg, 0.5);
               the config's caps (768, 384, 192) if every pair fits them,
               else caps calibrated over the pairs (printed);
 13. ModelNet forward — the full-width make_modelnet_config() model (3
               stages, fine level 0, 128-point patches) registers three
               pairs, counted, timed; each inference kernel of the path vs
               its plain version, as phase 4; the force_pallas=False model
               agrees on ref/src_feats_c to 1e-3;
 14. ModelNet train — Trainer.run_iterations over a PairLoader (2 spawned
               workers, GT targets precomputed there) for 8 iterations with a
               4-step warmup (a cut of the config's 400000 / 10000), every
               step counted, finite losses, no skip, each step's learning
               rate on the warmup-cosine schedule, step median and peak
               memory; the checkpoint of step 4 restored into a fresh model,
               whose steps 5-8 repeat the run's losses to 1e-3; each training
               kernel of one step vs its plain version and whole-step
               gradients vs the plain model's; one eval step a pair, and
               patch_overlaps of the first vs its plain version (path
               "modelnet_eval").
 15. limits — each kernel at shapes its CUDA kernel once refused, at the
               former limit and past it (limit_calls: the input convs at
               K = 16, 20, 32; the Sinkhorn forwards at 256 x 256, 257 x 257,
               400 x 300 and the backward at 160, 161, 257; the RPE pair
               scores at C = 130, 640, 1024 and H = 12, 16; the attention at
               head widths 24, 48, 96, 128; both with misaligned operands;
               the GSE forward and backward at C = 48, 96, 160, 192, 224,
               512 with A = 3 and C = 256 with A = 4 and 5, the backward
               also at C = 96 and 160 with tied reference vectors; KPConv
               rows 1 and 6 at K = 16, 20, 32, row 5 at K = 20, row 1 at
               C_in = 1,028; launch_limit_calls, each on its general route:
               the stream input conv at H = 512 and K D = 61,440, the union
               input conv at a ~14,000-row union and K D = 61,440, rows 1,
               5 and 6 with the pool over 1,024 columns at C = 4 (pooled,
               count and ties bit for bit), row 11 at K = 2,048, row 13 at
               dh = 4,096, row 8 at A = 255 and 300, the search at cand_cap
               32,768 and brute over 40,000 rows, the last two bit for bit;
               precision_limit_calls: one bfloat16 call of each route family
               of the bfloat16 instances):
               each call launches its kernel once, agrees
               with its plain version within its row's tolerance, and is
               timed alone from its own graph with its shape and bound
               (by_call, path "limits"; kept out of the paths' sums).
               The widths path (runs after phase 20): the 3DMatch cell's
               pair 0 at full width with geotransformer.hidden_dim = 192
               and angle_k = 4, seeded weights: one forward counted and
               checked as phase 3, within 1e-3 of the force_pallas=False
               model's coarse features; one make_train_step step counted,
               finite and not skipped, its loss within 1e-3 of the plain
               route's; the forward's and a step's kernel calls against
               their plain versions (path "widths").
 16. synthetic workflow — scripts/synthetic_benchmark.py at full width:
               SyntheticSceneBenchmark's 78 training pairs (4 scenes of 8
               fragments, seed 0) and 20 test pairs (2 of 6, seed 777), the
               test scenes' gt.log/gt.info, caps calibrated over 32 training
               pairs and every test pair, one epoch (a cut of the script's
               2000 steps) through Trainer.run over a PairLoader with 2
               spawned workers, every step counted (the input conv's
               training call over the neighbor table, kpconv_fused with t1,
               counted apart as "kpconv_fused (input residuals)"), finite
               losses, no skip; the Tester on the 20 test pairs, each
               forward counted, every R a rotation; scripts.eval in a
               process of its own (its RR/IR/FMR table printed); the test
               fragments written in the 3DMatch layout and scripts.test run
               on them from the training's checkpoint (which also gives the
               caps and the input route, no edge stream, the model was
               trained with), its transforms within 1e-5 of the Tester's,
               then scripts.eval on its dumps; the training kernels vs their
               plain versions on one step (path "synthetic_train": the input
               conv's training call, out and t1 as KPConv, the count bit for
               bit; patch_overlaps at 64-point patches bit for bit) and the
               forward kernels on one Tester forward ("synthetic_test").
 17. device pyramid — (a) on the 3DMatch and KITTI cells' three pairs each,
               at symmetric caps (each stage's largest cloud over the pairs,
               a multiple of 256) and a candidate capacity calibrated on the
               host (the largest 27-cell population of the grid searches,
               rounded up to 64): build_pyramid_device on the card against
               the host pyramid at the same caps (lengths and masks exact,
               points within 1e-4, each table row for row but distance ties,
               at most 5 % of its rows, the inverse tables and the edge
               stream off the tied rows; a stage whose float32 voxel count
               differs from the host's float64 one is printed with the point
               that moved, and only the stages below it compared); every
               grid_radius_search call bit for bit and every
               voxel_segment_mean call (the means within 1e-6 x
               max|coordinate|, the counts bit for bit) against its plain
               version, pair 0's calls timed (events, graph replay, plain,
               index_reduce_ "mean" for the segment mean, by_call, paths
               device_pyramid_3dmatch and device_pyramid_kitti); the whole
               build's events and graph time per pair against the host
               pyramid's seconds, and pair 0's build profiled by kernel in
               a fresh process (chip_smoke.py --profile-builds, which must
               lose no event; chiprun_out/<path>_profile.txt); (b) the raw mode at full width on the
               synthetic workflow's configuration with a deliberately small
               first bucket (stage-1 cap 256) that every pair takes,
               overflows and escalates from: 8 steps through PairLoader (2
               spawned workers fetching samples) and Trainer(device_plan=...),
               each try counted (the pyramid kernels' launches, then the
               step's), finite losses, no skipped step, an overflowed try a
               step, no host fallback; the Tester on the 20 test pairs, each
               pair counted, every R a rotation, the wall time and each
               pair's card time; scripts.test --device_preprocess from the
               checkpoint (its buckets; the default candidate capacity,
               512, as in training) under --overflow_policy escalate, its
               transforms within 1e-5 of the Tester's; the pyramid kernels'
               calls of the first training step's two tries against their
               plain versions and timed (path device_raw_train, the raw
               mode's caps and candidate capacity).
 18. training engine (runs after phase 11, on its pairs and models) —
               (a) 4 mini-steps of an accumulation of 2 (grad_acc_steps,
               MultiSteps) through make_train_step on the 3DMatch pairs at
               the phase-6 weights and a NaN-hooked mini-step between them:
               2 updates, a scheduler count of 2, the accumulated mean
               within 1e-6 (relative norm) of the two mini-steps' gradients
               taken one by one, the NaN-hooked one leaving the accumulator
               as it was; its mini-step median beside the k = 1 step's;
               (b) one 3DMatch and one KITTI step without inverse tables
               (the scatter backward; no kpconv_bwd_fused launch): each
               tensor within 1e-3 plus twice the float32 plain step's
               distance of the inverse-table route (row 6) and of the
               float64 witness along the kernel step's choices, as phase 7,
               bit-equal on a repeat, timed against the inverse-table step;
               (c) two ranks on this card over Gloo (``chip_smoke.py
               --rank-worker`` subprocesses, killed past 300 s), 3 steps
               each through the Trainer on their shards of six pairs:
               parameters bit-equal between the ranks, the lr twice the
               config's, the first step's gradients within 1e-5 of one
               process accumulating the same pairs (k = 2, each pair with
               its rank's generator) and the parameters within the updates'
               reach of it; rank 0's profile_steps trace holding a device
               kernel of every KERNELS entry the step launches; one rank over
               NCCL bit-equal to the step without a process group;
               debug_nans raising on a NaN injected into a backward; the
               TensorBoard writer on or off; the medians and the phase's
               seconds beside the card's name and power limit.
 19. native library and model extras (runs after phase 17, on the earlier
               phases' pairs, model and files) — (a) every host pyramid of
               phases 2-18 came from the native library (its calls
               counted); on the 3DMatch and KITTI cells' three pairs each
               the native pyramid equals the phases' and the numpy route's
               in lengths and points bit for bit and in each table but for
               rows that differ by distance ties within float32 rounding
               (counted and printed), both routes' build_pyramid seconds a
               pair on the card's host; (b) the vanilla, PE and LRPE
               conditional transformers at the 3DMatch config's width on
               the default forward's superpoints and masks (seeded weights,
               PE embeddings, LRPE distance bins), each kernel-route
               forward counted (fused_masked_attention twice a block,
               path "variants") and within 1e-4 of its einsum route, row
               13's calls against its plain version; (c) full-width 3DMatch
               forwards with reduction_a="mean" (no GSE launch) and with
               the Sinkhorn dustbin in LGR, counted and checked as phase 3,
               against their force_pallas=False models; the quaternion
               Kabsch against SVD on the default forward's LGR covariances
               (proper, card against CPU within 1e-4; the rotation
               difference and the objective short of SVD's printed beside
               Horn's eigengap; both timed) and LGR with each; (d) point_matching on the default forward's
               Sinkhorn output, with and without the dustbin, the card's
               correspondences equal to the CPU's; (e) scripts.calibrate on
               phase 12's ModelNet pickle by both routes (the same caps)
               and scripts.eval_dgr on phase 16's Tester dumps with lgr,
               ransac and svd (on the card).
 20. tools (runs after phase 19) — (a) two torch.profiler sessions
               (utils.timing.top_device_ops) around the same 3DMatch
               forward count the hand-written kernels' events by name, in
               a fresh process (chip_smoke.py --profiler-sessions: one event
               a launch in both, nothing reported lost) and in this one
               (each kernel's events equal to its launches or reported lost
               by top_device_ops; what a long process's sessions lose
               recorded); (b)
               TransformerEncoder and TransformerDecoder (3 layers each) at
               the 3DMatch width on a forward's superpoints, seeded
               weights, counted (path "encoder_decoder") and within 1e-4 of
               their einsum route, row 13's calls against its plain
               version; (c) each in a process of its own under a timeout:
               profile_stages, profile_forward, profile_train (3DMatch and
               --kitti), profile_ops, profile_kpconv, profile_device,
               profile_batch, train_smoke, one after another; then
               probe_kernels all, drift (20 training steps, then
               drift_attrib on its weights, with its sweep of the precision
               knobs), eval.sh on phase 16's layout (its dumps equal to the
               Tester's within 1e-5) and the convergence suite (small
               scale, 4 steps; its four runs at once, JOBS=4) at once. A tool that
               fails or times out fails the run; each tool's key numbers
               are printed and go to chip_smoke.json ("tools").
Then it prints the {"kernels": [...]} line (each kernel's numbers summed over
the paths it was compared on, with each path's own under "by_path" and the
calls of the KPConv, GSE, Sinkhorn and overlap rows, and phase 15's, one by
one under "by_call"),
the card's name and power limit, and, last,
{"ok": true, "device": {...}}.
Details go to chiprun_out/chip_smoke.json.

    python3 chip_smoke.py --ranks-across-cards N

runs instead, on a host with N cards, N NCCL ranks a card each, 6 Trainer
steps on the phase-2 pairs with seeded weights, held as phase 18c holds its
two ranks (chiprun_out/across_cards.json), and ends with the same last line.
"""

import collections
import contextlib
import copy
import dataclasses
import datetime
import functools
import json
import os
import pickle
import re
import shlex
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from geotransformer_tpu_torch.configs import (
    JAX_PRECISION,
    make_3dmatch_config,
    make_kitti_config,
    make_modelnet_config,
)
from geotransformer_tpu_torch import native
from geotransformer_tpu_torch.datasets import ASYMMETRIC_INDICES, ModelNetPairDataset
from geotransformer_tpu_torch.engine import Tester, Trainer
from geotransformer_tpu_torch.kernels import attention as kernels_attention
from geotransformer_tpu_torch.kernels import cuda
from geotransformer_tpu_torch.kernels import gse as kernels_gse
from geotransformer_tpu_torch.kernels import kpconv as kernels_kpconv
from geotransformer_tpu_torch.kernels import overlap as kernels_overlap
from geotransformer_tpu_torch.kernels import pyramid as kernels_pyramid
from geotransformer_tpu_torch.kernels import sinkhorn as kernels_sinkhorn
from geotransformer_tpu_torch.losses import overall as losses_overall
from geotransformer_tpu_torch.losses import overall_loss
from geotransformer_tpu_torch.models import create_model, precompute_gt_targets
from geotransformer_tpu_torch.models import geotransformer as models_geotransformer
from geotransformer_tpu_torch.models import kpconv as models_kpconv
from geotransformer_tpu_torch.models import matching as models_matching
from geotransformer_tpu_torch.models import procrustes as models_procrustes
from geotransformer_tpu_torch.models import sinkhorn as models_sinkhorn
from geotransformer_tpu_torch.models import transformer as models_transformer
from geotransformer_tpu_torch.models import transformer_variants as models_variants
from geotransformer_tpu_torch.models.lgr import local_to_global_registration
from geotransformer_tpu_torch.models.point_matching import point_matching
from geotransformer_tpu_torch.ops.gather import gather_with_shadow
from geotransformer_tpu_torch.parallel import (
    MultiSteps,
    barrier,
    destroy_process_group,
    init_process_group,
    make_eval_step,
    make_lr_schedule,
    make_optimizer,
    make_train_step,
    world_size,
)
from geotransformer_tpu_torch.parallel import rank as mesh_rank
from geotransformer_tpu_torch.preprocess import (
    batch_to_float64,
    batch_to_torch,
    build_inverse_table,
    build_pyramid,
    build_split_tables,
    build_union_tables,
    calibrate_split_specs,
    calibrate_stage_caps,
    caps_for_pyramid,
    pad_registration_batch,
    round_up,
    table_align,
)
from geotransformer_tpu_torch.preprocess import device as preprocess_device
from geotransformer_tpu_torch.preprocess.calibrate import largest_cell_population
from geotransformer_tpu_torch.preprocess.device import (
    DevicePreprocessPlan,
    build_pyramid_device,
    pad_stage0,
)
from geotransformer_tpu_torch.preprocess.loader import PairLoader, prepare_pair
from geotransformer_tpu_torch.scripts import calibrate as calibrate_script
from geotransformer_tpu_torch.scripts import eval_dgr
from geotransformer_tpu_torch.scripts.drift import plain_wrappers
from geotransformer_tpu_torch.scripts.pairs import inverse_splits as fitted_inverse_splits
from geotransformer_tpu_torch.scripts.pairs import make_3dmatch_pair, make_kitti_pair
from geotransformer_tpu_torch.utils.timing import (
    KERNEL_SYMBOLS,
    card,
    graph_ms,
    time_ms,
    top_device_ops,
)
from geotransformer_tpu_torch.scripts import synthetic_benchmark as synthetic

ROOT = os.path.dirname(os.path.abspath(__file__))
SEEDS = (0, 1, 2)
TRAIN_STEPS = 8
KITTI_TRAIN_STEPS = 6
# ModelNet training: a cut of the config's 400000 iterations / 10000 warmup
MODELNET_ITERATIONS, MODELNET_WARMUP, MODELNET_SNAPSHOT = 8, 4, 4
# synthetic pickle: entries, points each, and the seed (its pairs fit the
# config's caps (768, 384, 192): at most 717, 379 and 136 points a stage)
MODELNET_ENTRIES, MODELNET_POINTS, MODELNET_SEED = 4, 2048, 1
UNION_CAP, UNION_TILE = 1536, 128
# the synthetic workflow at full scale (scripts/synthetic_benchmark.py): its
# training and test pairs; one epoch of training on the first
# SYNTHETIC_EPOCH_PAIRS of them (the script's default is 2000 steps, 26
# epochs of the 78)
SYNTHETIC_TRAIN_PAIRS, SYNTHETIC_TEST_PAIRS, SYNTHETIC_EPOCH_PAIRS = 78, 20, 39
# phase 17: raw-mode training steps on the synthetic workflow's configuration
DEVICE_TRAIN_STEPS = 8
# phase 19: the LRPE bank's rows (relative distance bins of sigma_d) and the
# seed of the variants' weights and PE embeddings
VARIANT_EMBEDDINGS, VARIANT_SEED = 64, 19
# phase 15's widths path: the 3DMatch cell's GeoTransformer at a width and
# an angle count the shipped configurations do not use, and its weights' seed
WIDTHS_HIDDEN, WIDTHS_ANGLES, WIDTHS_SEED = 192, 4, 15
PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
# H100 SXM, bfloat16 on the tensor cores, dense: the rate a bound counts the
# products of bfloat16 operands at (the bfloat16 points), whatever pipe the
# kernel runs them on
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# exponentials, logarithms (and the fast sines and cosines): 16 results a
# clock an SM on compute capability 9.0, the special function units' rate in
# the CUDA C++ Programming Guide's table of arithmetic instruction
# throughput; taken at the card's maximum SM clock (peak_sfu)
SFU_PER_CLOCK_SM = 16
DEVICE = "cuda"


# --- each kernel's tolerance against its plain version -------------------
# tolerance(i, got, want, args, plain) -> (got, want, bound) for output i of
# one call (plain: all the plain outputs), after restricting both sides to
# the entries the rule covers.

def tol_kpconv(i, got, want, args, plain):
    # a conv with the pool and its residuals (out, pooled, count, ties): the
    # pooled max, the count and the tie counts bit for bit
    if len(plain) == 4 and i > 0:
        expect(torch.equal(got, want), f"KPConv output {i} differs from its plain version")
        return got, want, torch.zeros_like(want)
    return got, want, 1e-4 * want.abs() + 1e-5 * want.abs().max()


def tol_kpconv_residuals(i, got, want, args, plain):
    # out, t1 and count: the count is a sum of 0/1 flags, exact in any order
    if i == 2:
        expect(torch.equal(got, want), "kpconv_stream_fused: count differs from its plain version")
        return got, want, torch.zeros_like(want)
    return tol_kpconv(i, got, want, args, plain)


def tol_kpconv_input_residuals(i, got, want, args, plain):
    # out, count and t1 of the input conv's training call over the neighbor
    # table: the count bit for bit, out and t1 as KPConv
    if i == 1:
        expect(torch.equal(got, want), "kpconv_fused: count differs from its plain version")
        return got, want, torch.zeros_like(want)
    return tol_kpconv(i, got, want, args, plain)


def tol_gse_embedding(i, got, want, args, plain):
    nv = int(args[8])  # the valid rectangle
    return got[:nv, :nv], want[:nv, :nv], torch.full_like(want[:nv, :nv], 1e-3)


def tol_sinkhorn_scores(i, got, want, args, plain):
    # output 0 is the scores: masked slots (-1e12) are left out; v_hist is whole
    if i == 0:
        valid = args[0] > -1e11
        got, want = got[valid], want[valid]
    return got, want, 1e-4 + 1e-4 * want.abs()


def tol_sinkhorn_bwd(i, got, want, args, plain):
    return got, want, 1e-4 + 1e-4 * want.abs()


def tol_gse_bwd(i, got, want, args, plain):
    # the scale of the call's weight gradients (outputs 0 and 2): db vanishes
    # in exact arithmetic (a bias under the attention softmax), both sides
    # hold rounding noise there
    scale = max(w.abs().max().item() for w in plain[0::2])
    return got, want, torch.full_like(want, 1e-4 * scale)


def tol_overlaps(i, got, want, args, plain):
    # valid candidates: bit-equal (both round the same direct distance term
    # by term, so every cover flag and count agrees)
    valid = args[5]
    return got[valid], want[valid], torch.zeros_like(want[valid])


def tol_pair_scores(i, got, want, args, plain):
    # both sides are exact zeros outside the valid rectangle
    return got, want, torch.full_like(want, 1e-5 * want.abs().max().item())


def tol_attention(i, got, want, args, plain):
    # valid rows within 1e-5 x max|plain|; padded rows exact zeros
    nv = got.shape[0] if args[4] is None else int(args[4])
    expect(bool((got[nv:] == 0).all()), "fused_masked_attention: a padded row is not zero")
    got, want = got[:nv], want[:nv]
    return got, want, torch.full_like(want, 1e-5 * want.abs().max().item())


def tol_exact(i, got, want, args, plain):
    # grid_radius_search: the table and the counts bit for bit
    return got, want, torch.zeros_like(want)


def tol_segment_mean(i, got, want, args, plain):
    # the means within 1e-6 x max|coordinate| of the voxels (the plain
    # version's float atomics add in another order), PAD_COORD rows and the
    # counts bit for bit
    if i == 1:
        return got, want, torch.zeros_like(want)
    voxel = plain[1] > 0
    scale = want[voxel].abs().max().item() if bool(voxel.any()) else 0.0
    return got, want, torch.where(voxel[..., None], 1e-6 * scale, 0.0).expand_as(want)


Kernel = collections.namedtuple(
    "Kernel", "module plain replaces source tolerance wrapper runs select",
    defaults=(None, None, None))
# module: the module attribute the caller reaches the wrapper through;
# wrapper: the wrapper's name (its launch counter) where the entry is not
# named after it; runs: the suffixes of the counted runs whose launches the
# entry reports (None: every run). The input conv's two entries share one
# counter: the forward one reports the forward runs, the residuals one the
# training runs, where every launch is the residuals call. select: a test on
# a call's keywords for an entry that takes only some of its wrapper's calls
# (captured and counted apart: count_input_residuals).
KERNELS = {
    "kpconv_stream_fused": Kernel(models_kpconv, kernels_kpconv.kpconv_stream_fused_plain,
                                  "geotransformer_tpu/kernels/kpconv.py:1679",
                                  "geotransformer_tpu_torch/kernels/csrc/kpconv.cu", tol_kpconv,
                                  runs=("_inference", "_union", "_eval")),
    # the training call: reached through kpconv_stream_input_diff, with the
    # weight gradient's residuals t1 and count
    "kpconv_stream_fused (residuals)": Kernel(
        kernels_kpconv, kernels_kpconv.kpconv_stream_fused_plain,
        "geotransformer_tpu/kernels/kpconv.py:1679",
        "geotransformer_tpu_torch/kernels/csrc/kpconv.cu", tol_kpconv_residuals,
        wrapper="kpconv_stream_fused", runs=("_train",)),
    "kpconv_fused": Kernel(models_kpconv, kernels_kpconv.kpconv_fused_plain,
                           "geotransformer_tpu/kernels/kpconv.py:286",
                           "geotransformer_tpu_torch/kernels/csrc/kpconv.cu", tol_kpconv),
    # the input conv's training call over the neighbor table (no edge
    # stream): reached through kpconv_input_diff, with t1 and the count
    "kpconv_fused (input residuals)": Kernel(
        kernels_kpconv, kernels_kpconv.kpconv_fused_plain,
        "geotransformer_tpu/kernels/kpconv.py:286",
        "geotransformer_tpu_torch/kernels/csrc/kpconv.cu", tol_kpconv_input_residuals,
        wrapper="kpconv_fused", runs=("_train",),
        select=lambda kwargs: bool(kwargs.get("return_t1"))),
    "gse_embedding_full": Kernel(models_transformer, kernels_gse.gse_embedding_full_plain,
                                 "geotransformer_tpu/kernels/gse.py:222",
                                 "geotransformer_tpu_torch/kernels/csrc/gse.cu",
                                 tol_gse_embedding),
    "sinkhorn_log_iterations": Kernel(models_sinkhorn,
                                      kernels_sinkhorn.sinkhorn_log_iterations_plain,
                                      "geotransformer_tpu/kernels/sinkhorn.py:53",
                                      "geotransformer_tpu_torch/kernels/csrc/sinkhorn.cu",
                                      tol_sinkhorn_scores),
    "kpconv_split_fused": Kernel(models_kpconv, kernels_kpconv.kpconv_split_fused_plain,
                                 "geotransformer_tpu/kernels/kpconv.py:1288",
                                 "geotransformer_tpu_torch/kernels/csrc/kpconv.cu", tol_kpconv),
    "kpconv_bwd_fused": Kernel(kernels_kpconv, kernels_kpconv.kpconv_bwd_fused_plain,
                               "geotransformer_tpu/kernels/kpconv.py:744",
                               "geotransformer_tpu_torch/kernels/csrc/kpconv_bwd.cu", tol_kpconv),
    "kpconv_union_input_fused": Kernel(models_kpconv,
                                       kernels_kpconv.kpconv_union_input_fused_plain,
                                       "geotransformer_tpu/kernels/kpconv.py:1135",
                                       "geotransformer_tpu_torch/kernels/csrc/kpconv.cu",
                                       tol_kpconv),
    "gse_full_bwd": Kernel(kernels_gse, kernels_gse.gse_full_bwd_plain,
                           "geotransformer_tpu/kernels/gse.py:378",
                           "geotransformer_tpu_torch/kernels/csrc/gse_bwd.cu", tol_gse_bwd),
    "sinkhorn_fwd_train": Kernel(kernels_sinkhorn, kernels_sinkhorn.sinkhorn_fwd_train_plain,
                                 "geotransformer_tpu/kernels/sinkhorn.py:205",
                                 "geotransformer_tpu_torch/kernels/csrc/sinkhorn.cu",
                                 tol_sinkhorn_scores),
    "sinkhorn_bwd_train": Kernel(kernels_sinkhorn, kernels_sinkhorn.sinkhorn_bwd_train_plain,
                                 "geotransformer_tpu/kernels/sinkhorn.py:234",
                                 "geotransformer_tpu_torch/kernels/csrc/sinkhorn_train.cu",
                                 tol_sinkhorn_bwd),
    "patch_overlaps": Kernel(models_matching, kernels_overlap.patch_overlaps_plain,
                             "geotransformer_tpu/kernels/overlap.py:89",
                             "geotransformer_tpu_torch/kernels/csrc/overlap.cu", tol_overlaps),
    "rpe_pair_scores": Kernel(models_transformer, kernels_attention.rpe_pair_scores_plain,
                              "geotransformer_tpu/kernels/attention.py:117",
                              "geotransformer_tpu_torch/kernels/csrc/attention.cu",
                              tol_pair_scores),
    "fused_masked_attention": Kernel(models_transformer,
                                     kernels_attention.fused_masked_attention_plain,
                                     "geotransformer_tpu/kernels/attention.py:291",
                                     "geotransformer_tpu_torch/kernels/csrc/attention.cu",
                                     tol_attention),
    # the device pyramid's two hot loops: they replace XLA code of the JAX
    # package's preprocess/device.py, no pallas_call
    "grid_radius_search": Kernel(preprocess_device, kernels_pyramid.grid_radius_search_plain,
                                 "geotransformer_tpu/preprocess/device.py:180",
                                 "geotransformer_tpu_torch/kernels/csrc/pyramid.cu", tol_exact),
    "voxel_segment_mean": Kernel(preprocess_device, kernels_pyramid.voxel_segment_mean_plain,
                                 "geotransformer_tpu/preprocess/device.py:98",
                                 "geotransformer_tpu_torch/kernels/csrc/pyramid.cu",
                                 tol_segment_mean),
}
PYRAMID = ["grid_radius_search", "voxel_segment_mean"]
INFERENCE = ["kpconv_stream_fused", "kpconv_fused", "gse_embedding_full", "rpe_pair_scores",
             "fused_masked_attention", "sinkhorn_log_iterations"]
TRAINING = ["kpconv_stream_fused (residuals)", "kpconv_bwd_fused", "gse_full_bwd",
            "sinkhorn_fwd_train", "sinkhorn_bwd_train"]


def wrapper_of(name):
    """The wrapper (and launch counter) of a KERNELS entry."""
    return KERNELS[name].wrapper or name


def launch_key(name):
    """The key of a KERNELS entry's launches in ``cuda.launches``: its
    wrapper's, or its own for an entry counted apart (``select``)."""
    return name if KERNELS[name].select else wrapper_of(name)


@contextlib.contextmanager
def count_input_residuals():
    """Within the block, count the input conv's training calls over the
    neighbor table (kpconv_fused with t1, reached through
    kpconv_input_diff) under their own entry too: the kernel's launches in
    those calls, read off the wrapper's counter, which counts them with
    every other conv."""
    wrapper = kernels_kpconv.kpconv_fused

    def counting(*args, **kwargs):
        before = cuda.launches["kpconv_fused"]
        out = wrapper(*args, **kwargs)
        if KERNELS["kpconv_fused (input residuals)"].select(kwargs):
            cuda.launches["kpconv_fused (input residuals)"] += cuda.launches["kpconv_fused"] - before
        return out

    kernels_kpconv.kpconv_fused = counting
    try:
        yield
    finally:
        kernels_kpconv.kpconv_fused = wrapper


def expected_launches(batch, mode, blocks, gse=True):
    """Kernel launches of one forward (``mode`` "inference" or "eval") or one
    training step ("train") on ``batch``, from the tables it carries and the
    transformer's ``blocks`` (each layer attends for both clouds; the
    attention backward is the plain version's); ``gse=False``: the mean
    angle reduction, which has no GSE kernel."""
    n = len(batch["points"])
    nb_split = batch.get("neighbors_split", [None] * n)
    sub_split = batch.get("subsampling_split", [None] * n)
    counts = collections.Counter()

    def conv(split):
        counts["kpconv_fused" if split is None else "kpconv_split_fused"] += 1

    if "input_stream" in batch:
        counts["kpconv_stream_fused"] += 1
    elif "union_rows0" in batch:
        counts["kpconv_union_input_fused"] += 1
    else:
        conv(nb_split[0])
        if mode == "train" and nb_split[0] is None:
            # the training call with t1, counted under its own entry too
            counts["kpconv_fused (input residuals)"] += 1
    # every later conv, and in a training step on a batch with inverse tables
    # its backward (one launch over a whole or a split inverse table; without
    # them the scatter backward is PyTorch's)
    splits = [nb_split[0]]
    for s in range(1, n):
        splits += [sub_split[s - 1], nb_split[s], nb_split[s]]
    for split in splits:
        conv(split)
    if mode == "train" and "neighbors_inv" in batch:
        counts["kpconv_bwd_fused"] += len(splits)
    counts["gse_embedding_full"] += 2 if gse else 0
    counts["rpe_pair_scores"] += 2 * sum(block == "self" for block in blocks)
    counts["fused_masked_attention"] += 2 * len(blocks)
    if mode == "train":
        counts.update(gse_full_bwd=2, sinkhorn_fwd_train=1, sinkhorn_bwd_train=1)
    else:
        counts["sinkhorn_log_iterations"] += 1
    if mode != "inference" and "gt_cand_indices" not in batch:
        counts["patch_overlaps"] += 1
    return counts


def expect_launches(got, batches, mode, what, blocks, gse=True):
    want = collections.Counter()
    for batch in batches:
        want.update(expected_launches(batch, mode, blocks, gse))
    for name in KERNELS:
        expect(got.get(name, 0) == want.get(name, 0),
               f"{what}: {name} launched {got.get(name, 0)} times, expected {want.get(name, 0)}")


def build_pyramids(cfg, pairs):
    bb = cfg.backbone
    return [(build_pyramid(np.concatenate([ref, src], 0), [len(ref), len(src)], bb.num_stages,
                           bb.init_voxel_size, bb.init_radius, list(cfg.caps.neighbor_limits)),
             len(ref) + len(src), transform) for ref, src, transform in pairs]


def stage_sizes(pyramids):
    return [[[int(v) for v in l] for l in p["lengths"]] for p, _, _ in pyramids]


# what phase 17 reuses of the earlier phases: each path's host pyramids, and
# the synthetic workflow's configuration, sets and 3DMatch-layout fragments
SHARED = {}


def build_batches(cfg, seeds):
    pyramids = build_pyramids(cfg, [make_3dmatch_pair(seed) for seed in seeds])
    SHARED["3dmatch"] = pyramids
    # one capacity per stage and cloud covering every pair, as scripts/demo.py picks them
    per_pair = [caps_for_pyramid(p, multiple=256, per_cloud=True) for p, _, _ in pyramids]
    caps = tuple(tuple(max(c[s][i] for c in per_pair) for i in range(2))
                 for s in range(cfg.backbone.num_stages))
    batches = [pad_registration_batch(p, np.ones((n, 1), np.float32), t, caps,
                                      inverse_limits=cfg.caps.inverse_limits)
               for p, n, t in pyramids]
    return caps, pyramids, batches, stage_sizes(pyramids)


def union_capacity(batches, tile):
    """UNION_CAP, or the next multiple of 512 holding every tile's union."""
    largest = 0
    for batch in batches:
        table = batch["neighbors"][0]
        for t in range(0, table.shape[0], tile):
            block = table[t:t + tile]
            largest = max(largest, np.unique(block[block < table.shape[0]]).size)
    return max(UNION_CAP, round_up(largest, 512)), largest


def build_kitti_batches(cfg, seeds):
    """Three KITTI batches at capacities and splits calibrated over them, with
    pair-fitted split inverse tables; host seconds per step."""
    host = {}
    start = time.perf_counter()
    pairs = [make_kitti_pair(seed) for seed in seeds]
    host["pairs"] = time.perf_counter() - start
    start = time.perf_counter()
    pyramids = build_pyramids(cfg, pairs)
    host["pyramid"] = time.perf_counter() - start
    SHARED["kitti"] = pyramids
    bb = cfg.backbone
    start = time.perf_counter()
    # capacities and splits over the three pairs the smoke registers (the
    # synthetic scans outgrow the config's caps from stage 1 on)
    samples = [{"ref_points": r, "src_points": s} for r, s, _ in pairs]
    args = (bb.num_stages, bb.init_voxel_size, bb.init_radius, list(cfg.caps.neighbor_limits))
    caps = tuple(calibrate_stage_caps(iter(samples), *args, num_samples=len(pairs)))
    nb_splits, sub_splits = calibrate_split_specs(iter(samples), *args, num_samples=len(pairs))
    host["calibration"] = time.perf_counter() - start
    start = time.perf_counter()
    batches, inverse_splits = [], []
    for p, n, t in pyramids:
        args = (p, np.ones((n, 1), np.float32), t, caps)
        kw = dict(inverse_limits=cfg.caps.inverse_limits, neighbor_splits=nb_splits,
                  subsampling_splits=sub_splits)
        kw.update(fitted_inverse_splits(pad_registration_batch(*args, **kw)))
        inverse_splits.append((kw["inverse_splits"], kw["sub_inverse_splits"]))
        batches.append(pad_registration_batch(*args, **kw))
    host["tables"] = time.perf_counter() - start
    return caps, batches, stage_sizes(pyramids), (nb_splits, sub_splits), inverse_splits, host


@contextlib.contextmanager
def capture_kernel_calls(names):
    """Record the arguments of every call of the named kernel wrappers."""
    records = collections.defaultdict(list)
    saved = []
    for name in names:
        module, wrapper = KERNELS[name].module, wrapper_of(name)
        fn = getattr(module, wrapper)
        saved.append((module, wrapper, fn))

        def recorder(*args, _fn=fn, _name=name, **kwargs):
            select = KERNELS[_name].select
            if select is None or select(kwargs):
                records[_name].append((args, kwargs))
            return _fn(*args, **kwargs)

        setattr(module, wrapper, recorder)
    try:
        yield records
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def expect(ok, message):
    if not ok:
        raise RuntimeError(message)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _plain_kwargs(kwargs):
    return {k: v for k, v in kwargs.items() if k != "force"}


# the wrappers' precision keywords (PrecisionConfig's kpconv_mxu,
# kpconv_table, gse_basis, gse_embed)
DTYPE_KEYS = ("mxu_dtype", "table_dtype", "basis_dtype", "embed_dtype")


def bf16_call(args, kwargs):
    """A call at a bfloat16 point: a bfloat16 precision keyword, or a
    bfloat16 operand (row 12's embedding)."""
    return (any(kwargs.get(key) == torch.bfloat16 for key in DTYPE_KEYS)
            or any(isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 for a in args))


def at_float32(args, kwargs):
    """The same call at the float32 point: its precision keywords float32, a
    bfloat16 operand widened (exactly)."""
    return (tuple(a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a
                  for a in args),
            {k: torch.float32 if k in DTYPE_KEYS else v for k, v in kwargs.items()})


def check_call(name, kernel_out, plain_out, args, kwargs=None):
    """Max |kernel - plain| of one call, after checking its tolerance. At a
    bfloat16 point both sides round the same float32 values to bfloat16,
    but a value within an ulp of a rounding boundary may round the other
    way on the two (their float32 sums run in another order), which moves
    one term by a bfloat16 ulp: every entry within the row's float32 bound
    plus 2^-7 of the call's largest |plain| entry, and at least 99 % within
    the float32 bound itself."""
    def widened(x):  # a bfloat16 output (the GSE embedding) compares in f32
        return x.float() if x.dtype == torch.bfloat16 else x

    tolerance, plain = KERNELS[name].tolerance, tuple(map(widened, _as_tuple(plain_out)))
    bf16 = kwargs is not None and bf16_call(args, kwargs)
    worst = 0.0
    for i, (got, want) in enumerate(zip(_as_tuple(kernel_out), _as_tuple(plain_out))):
        expect(got.shape == want.shape, f"{name}: shape {got.shape} vs plain {want.shape}")
        expect(not bf16 or got.dtype == want.dtype,
               f"{name}: dtype {got.dtype} vs plain {want.dtype}")
        expect(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
        got, want, bound = tolerance(i, widened(got), widened(want), args, plain)
        diff = (got - want).abs()
        flip = 2.0**-7 * want.abs().max() if bf16 and want.numel() else 0.0
        expect(bool((diff <= bound + flip).all()),
               f"{name}: kernel disagrees with its plain version, max |diff| {diff.max().item()}")
        if bf16 and diff.numel():
            share = (diff <= bound).float().mean().item()
            expect(share >= 0.99, f"{name}: {share:.4f} of the entries within the float32 bound")
        worst = max(worst, diff.max().item() if diff.numel() else 0.0)
    return worst


# --- the least time the card could take for each call (bound_ms) --------
# bytes: each input read once, each output written once; operations: what
# these inputs need (valid edges, active queries, the valid GSE rectangle,
# valid point pairs of valid candidates), against 67 TFLOP/s f32 (the
# attention's 3xTF32 products against 495 TFLOP/s TF32) and 3.35 TB/s. A
# cost function returns (bytes, operations) or, for a kernel whose work is
# part f32 and part TF32 (the KPConv edge pass and its 3xTF32 contraction),
# (bytes, f32 operations, TF32 operations), the two times adding; the
# Sinkhorn rows add a fourth, their exponentials and logarithms, whose time
# at the SFU rate (peak_sfu) is a bound of its own: the bound is the
# largest of the bytes', the operations' and the SFU's times.

def _nbytes(*tensors):
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += _nbytes(*t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def _whole_table(head, tail, rank, sentinel):
    """The unsplit table of a split one: the head columns, then each row's
    tail row brought back by rank (all sentinels where it has none)."""
    tail = torch.cat([tail, torch.full_like(tail[:1], sentinel)])
    return torch.cat([head, tail[rank.long()]], dim=1).contiguous()


def _contraction(ops, c, d):
    """(f32, TF32) operations of a KPConv contraction of ``ops`` f32
    operations between widths c and d: on the tensor cores (both widths at
    least 8 and multiples of 4, csrc/kpconv_common.cuh) three TF32 products
    each (3xTF32), else f32 on the CUDA cores."""
    on_tensor_cores = c >= 8 and d >= 8 and c % 4 == 0 and d % 4 == 0
    return (0, 3 * ops) if on_tensor_cores else (ops, 0)


def _conv_ops(nbr, n, q_mask, k, c, d, pool, bf16=False):
    """(f32, TF32, bfloat16) operations of a conv. At the bfloat16 point
    (``bf16``) the products of rounded operands count as bfloat16: the
    edge pass's where c > 1, the contraction's (t1 and W) where c = 1."""
    valid = nbr < n
    if q_mask is not None:
        valid &= q_mask[:, None]
    edges = int(valid.sum())
    active = int(valid.any(dim=1).sum())
    f32, tf32 = _contraction(2 * active * k * c * d, c, d)
    edge, low = 2 * edges * k * c, 0
    if bf16 and c == 1:
        f32, low = 0, f32
    elif bf16:
        edge, low = 0, edge
    f32 += 10 * edges * k + edge  # the edge pass
    return f32 + (edges * pool.shape[1] if pool is not None else 0), tf32, low


def _mxu_bf16(kwargs):
    return kwargs.get("mxu_dtype") == torch.bfloat16


def cost_kpconv_fused(args, kwargs, out):
    s_feats, _, _, nbr, _, weights = args[:6]
    k, c, d = weights.shape
    ops, tf32, low = _conv_ops(nbr, s_feats.shape[0], kwargs.get("q_mask"), k, c, d,
                               kwargs.get("pool_feats"), _mxu_bf16(kwargs))
    return _nbytes(*args[:6], *kwargs.values(), out), ops, tf32, 0, low


def cost_kpconv_split_fused(args, kwargs, out):
    # the edges of head and tail, the weight contraction once per active
    # query: the unsplit conv's operations on the whole table
    s_feats, _, _, head, tail, _, rank = args[:7]
    k, c, d = args[8].shape
    n = s_feats.shape[0]
    ops, tf32, low = _conv_ops(_whole_table(head, tail, rank, n), n, kwargs.get("q_mask"), k, c,
                               d, kwargs.get("pool_feats"), _mxu_bf16(kwargs))
    return _nbytes(*args[:9], *kwargs.values(), out), ops, tf32, 0, low


def _input_conv_ops(edges, active, k, d, bf16):
    """(f32, bfloat16) operations of an input conv: the edge pass, and the
    t1 W products (bfloat16 at the bfloat16 point, t1 and W rounded)."""
    product = 2 * active * k * d
    return (12 * edges * k, product) if bf16 else (12 * edges * k + product, 0)


def cost_kpconv_stream_fused(args, kwargs, out):
    # operations over the valid slots (flag or feature non-zero; the kernel
    # skips the others, whose terms are exactly 0) and the queries with one
    stream, kp, weights = args[:3]
    k, _, d = weights.shape
    valid = (stream[3] != 0) | (stream[4] != 0)
    slots, active = int(valid.sum()), int(valid.any(dim=1).sum())
    ops, low = _input_conv_ops(slots, active, k, d, _mxu_bf16(kwargs))
    return _nbytes(*args[:3], out), ops, 0, 0, low


def cost_kpconv_union_input_fused(args, kwargs, out):
    union_rows, union_sel, _, weights = args[3:7]
    k, _, d = weights.shape
    valid = union_sel < union_rows.shape[1]
    edges, active = int(valid.sum()), int(valid.any(dim=1).sum())
    ops, low = _input_conv_ops(edges, active, k, d, _mxu_bf16(kwargs))
    return _nbytes(*args[:7], out), ops, 0, 0, low


def cost_gse_embedding_full(args, kwargs, out):
    # per valid pair: the A + 1 basis projections, 2 C^2 flops each, on the
    # tensor cores as three TF32 products (3xTF32, csrc/gse.cu); at the
    # bfloat16 basis point the products of bfloat16 operands, counted at the
    # bfloat16 rate (the kernel runs them as one TF32 pass); in f32 the
    # (A + 1) C / 2 sincosf of the bases and the A atan2f of the angles (20
    # operations each: the CUDA math library's argument reduction and
    # polynomials on the FMA pipe), the rest of the geometry (10 + 20 A) and
    # the max and the sums of the epilogue ((A + 1) C)
    points, ref_vectors, w_d = args[:3]
    nv, c, a = int(args[8]), w_d.shape[0], ref_vectors.shape[1]
    pairs = nv * nv
    f32 = pairs * ((a + 1) * (c // 2) * 20 + 40 * a + 10 + (a + 1) * c)
    products = pairs * 2 * c * c * (a + 1)
    if kwargs.get("basis_dtype") == torch.bfloat16:
        return _nbytes(*args[:6], out), f32, 0, 0, products
    return _nbytes(*args[:6], out), f32, 3 * products


def _sinkhorn_work(scores, iterations, exps, ops):
    """(f32 operations, SFU operations) of ``iterations`` Sinkhorn
    iterations over (P, M1, N1) scores: ``ops`` f32 operations and ``exps``
    exponentials an element and iteration, and a logarithm a row and a
    column (each row and column log-sum-exp) an iteration."""
    p, m1, n1 = scores.shape
    t = int(iterations)
    return ops * scores.numel() * t, exps * scores.numel() * t + p * (m1 + n1) * t


def cost_sinkhorn_log_iterations(args, kwargs, out):
    # per element and iteration, two half-steps of add, max, add, sub, exp,
    # add; the exponentials and logarithms at the SFU rate
    ops, sfu = _sinkhorn_work(args[0], args[3], 2, 12)
    return _nbytes(*args[:3], out), ops, 0, sfu


def cost_sinkhorn_fwd_train(args, kwargs, out):
    ops, sfu = _sinkhorn_work(args[0], args[3], 2, 12)
    return _nbytes(*args[:3], *out), ops, 0, sfu


def cost_sinkhorn_bwd_train(args, kwargs, out):
    # per element and iteration: two log-sum-exp passes (12) and the two
    # softmax-weighted updates of dS and the marginal gradients (16); four
    # exponentials (the two log-sum-exps, g and h)
    scores, _, v_hist = args[:3]
    ops, sfu = _sinkhorn_work(scores, v_hist.shape[1], 4, 28)
    return _nbytes(*args[:4], *out), ops, 0, sfu


def cost_kpconv_bwd_fused(args, kwargs, out):
    s_feats, _, q_points, gdiv, inv, kp, weights = args[:7]
    c = s_feats.shape[1]
    m, d = gdiv.shape
    k = weights.shape[0]
    # a split table: the edges of head and tail, d_s and dW once per active
    # support row, as on the whole table
    if isinstance(inv, (tuple, list)):
        inv = _whole_table(inv[0], inv[1], inv[3], m)
    split = isinstance(inv, (tuple, list))
    if split:
        inv = _whole_table(inv[0], inv[1], inv[3], m)
    valid = inv < m
    edges = int(valid.sum())
    active = int(valid.any(dim=1).sum())
    product = 2 * active * k * d * c  # d_s, and dW
    u_pass = 2 * edges * k * d
    if _mxu_bf16(kwargs):
        # the bfloat16 point: the u pass's and dW's products of rounded
        # operands (a split table's u is a sum of two rounded parts: dW's
        # other operand rounded only) at the bfloat16 rate; d_s of rounded u
        # and f32 W two TF32 products (three on the split route)
        tensor_cores = c >= 8 and d >= 8 and c % 4 == 0 and d % 4 == 0
        ops, tf32, low = 10 * edges * k, 0, u_pass
        if not tensor_cores:
            ops += product + (product if split else 0)
            low += 0 if split else product
        else:
            tf32 = (3 if split else 2) * product + (2 * product if split else 0)
            low += 0 if split else product
    else:
        ops, tf32 = _contraction(2 * product, c, d)  # d_s, dW
        ops += 10 * edges * k + u_pass  # the u pass
        low = 0
    pool = kwargs.get("pool_feats")
    if pool is not None:
        ops += 2 * edges * pool.shape[1]
    return _nbytes(*args[:7], *kwargs.values(), *out), ops, tf32, 0, low


def cost_gse_full_bwd(args, kwargs, out):
    # the minimum work: (A + 2) C^2 multiply-adds a valid pair (A projections,
    # dW_d and dW_a once each), on the tensor cores as three TF32 products
    # each (3xTF32, csrc/gse_bwd.cu); the kernel's A-fold masked dW_a
    # products are not counted
    points, ref_vectors, w_a = args[:3]
    de = args[5]
    nv = int(args[6]) if len(args) > 6 and args[6] is not None else points.shape[0]
    c, a = w_a.shape[0], ref_vectors.shape[1]
    products = nv * nv * 2 * c * c * (a + 2)
    if kwargs.get("basis_dtype") == torch.bfloat16:
        # the bfloat16 basis point: bases, W_a and de rounded, every
        # product of bfloat16 operands (one TF32 pass in the kernel)
        return _nbytes(points, ref_vectors, w_a, de, *out[:3]), 0, 0, 0, products
    return _nbytes(points, ref_vectors, w_a, de, *out[:3]), 0, 3 * products


def cost_patch_overlaps(args, kwargs, out):
    # per valid point pair of a valid candidate: 3 sub, 3 mul, 2 add, 1 compare
    ref_pts, ref_mask, _, src_mask, cand, cand_mask = args[:6]
    ref_valid = ref_mask.sum(dim=1).float()[:, None]
    src_valid = src_mask.sum(dim=1).float()[cand.long()]
    pairs = (ref_valid * src_valid)[cand_mask].sum().item()
    return _nbytes(*args[:6], out), 9 * pairs


def starts_read(queries, q_lengths, starts, origin, dims, radius):
    """The entries of the CSR starts that the grid search needs: the distinct
    first and end entries of the valid query rows' 27-cell runs, over the
    clouds (the (B, grid_cap + 1) tensor's bins past a cloud's cells are
    never read)."""
    edge, _ = kernels_pyramid._search_constants(radius, queries.device)
    first, end = kernels_pyramid._run_cells(queries, origin, dims, starts.shape[1] - 1, edge)
    valid = torch.arange(queries.shape[1], device=queries.device)[None, :] < q_lengths[:, None]
    cloud = torch.arange(queries.shape[0], device=queries.device)[:, None, None]
    read = torch.zeros(starts.shape, dtype=torch.bool, device=starts.device)
    for entries in (first, end):
        read[cloud.expand_as(entries)[valid], entries[valid].long()] = True
    return int(read.sum())


def cost_grid_radius_search(args, kwargs, out):
    # bytes: the inputs and outputs, but of the CSR starts only the entries
    # the runs of the valid query rows read (starts_read); operations: per
    # candidate slot of a valid query row (its first cand_cap; the brute
    # search: every valid support row): 3 sub, 3 mul, 2 add, 1 compare
    queries, q_lengths, support, s_lengths, starts, origin, dims, radius = args[:8]
    cand_cap = args[9]
    counts = out[1]
    rows = torch.arange(counts.shape[1], device=counts.device)[None, :] < q_lengths[:, None]
    slots = counts if starts is None else torch.clamp(counts, max=cand_cap)
    nbytes = _nbytes(queries, q_lengths, support, s_lengths, origin, dims, out)
    if starts is not None:
        nbytes += starts.element_size() * starts_read(queries, q_lengths, starts, origin, dims,
                                                      radius)
    return nbytes, 9 * int((slots.long() * rows).sum())


def cost_voxel_segment_mean(args, kwargs, out):
    # an add a coordinate of a valid row, a division a coordinate of a voxel
    points, seg, voxels, cap_out = args[:4]
    voxel_rows = int(torch.clamp(voxels, max=cap_out).sum())
    return _nbytes(points, seg, voxels, out), 3 * int((seg >= 0).sum()) + 3 * voxel_rows


def _valid(n_valid, full):
    return full if n_valid is None else int(n_valid)


def cost_rpe_pair_scores(args, kwargs, out):
    # the valid rectangle of the embedding (f32 or bfloat16) and the valid
    # rows of qw read, the whole output written; H dot products of C per
    # valid pair
    embed, qw = args[:2]
    n, m, c = embed.shape
    h = qw.shape[1]
    nv_q, nv_k = _valid(args[2], n), _valid(args[3], m)
    return (embed.element_size() * nv_q * nv_k * c + 4 * nv_q * h * c + _nbytes(out),
            2 * nv_q * nv_k * c * h)


def cost_fused_masked_attention(args, kwargs, out):
    # the valid rows of q, the valid keys of k and v, the valid rectangle of
    # the bias read, the output written; two products of dh per valid pair,
    # each on the tensor cores as three TF32 products (3xTF32)
    q, k, v, bias = args[:4]
    h, n, dh = q.shape
    m = k.shape[1]
    nv_q, nv_k = _valid(args[4], n), _valid(args[5], m)
    nbytes = 4 * (h * nv_q * dh + 2 * h * nv_k * dh) + _nbytes(args[7], out)
    if bias is not None:
        nbytes += 4 * nv_q * h * nv_k
    return nbytes, 3 * 4 * nv_q * nv_k * h * dh


# the peak rate of each kernel's operations where it is not f32 on the CUDA cores
PEAK_FLOPS = {"fused_masked_attention": PEAK_TF32_FLOPS}


COSTS = {name: globals()[f"cost_{wrapper_of(name)}"] for name in KERNELS}


# --- one PyTorch call that computes the same function (library_ms) ------
# timed on the captured inputs, never called by the port; the inputs it
# needs beyond the kernel's (the SDPA mask) are built outside the timing

def library_rpe_pair_scores(args, kwargs):
    # none for a bfloat16 embedding: torch.bmm takes one dtype
    embed, qw = args[:2]
    if embed.dtype != qw.dtype:
        return None
    embed_t = embed.transpose(1, 2)
    return lambda: torch.bmm(qw, embed_t)


def library_fused_masked_attention(args, kwargs):
    q, k, v, bias, _, nv_k, scale, key_masks = args[:8]
    h, n, _ = q.shape
    m = k.shape[1]
    keep = torch.arange(m, device=q.device) < _valid(nv_k, m)
    if key_masks is not None:
        keep &= key_masks
    mask = (torch.zeros((h, n, m), device=q.device) if bias is None
            else (bias.transpose(0, 1) * scale).contiguous())
    mask = mask.masked_fill(~keep, -torch.inf)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale)


def library_voxel_segment_mean(args, kwargs):
    points, seg, voxels, cap_out = args[:4]
    bsz, bins = points.shape[0], cap_out + 1
    flat = (torch.where((seg >= 0) & (seg < cap_out), seg, cap_out).long()
            + (torch.arange(bsz, device=points.device) * bins)[:, None]).reshape(-1)
    src = points.reshape(-1, 3)
    out = torch.zeros((bsz * bins, 3), device=points.device)
    return lambda: out.index_reduce_(0, flat, src, "mean", include_self=False)


LIBRARY = {"rpe_pair_scores": library_rpe_pair_scores,
           "fused_masked_attention": library_fused_masked_attention,
           "voxel_segment_mean": library_voxel_segment_mean}


def call_shape(name, args, kwargs, stage_of):
    """The shape of one KPConv call for its by_call entry: the stage (the
    support stage and the query stage of a strided conv), the query rows M
    (the support rows N of a backward), the table width H (J; head + tail
    of a split table), K, C_in, C_out, the pool width and whether the table
    is split."""
    if name == "kpconv_bwd_fused":
        s_feats, s_points, q_points, _, table, _, weights = args[:7]
        rows, pool = s_points.shape[0], kwargs.get("pool_feats")
        split = isinstance(table, (tuple, list))
        width = table[0].shape[1] + table[1].shape[1] if split else table.shape[1]
    else:
        s_feats, q_points, s_points = args[:3]
        split = name == "kpconv_split_fused"
        table = args[3]
        width = table.shape[1] + (args[4].shape[1] if split else 0)
        weights = args[8] if split else args[5]
        rows, pool = q_points.shape[0], kwargs.get("pool_feats")
    k, c, d = weights.shape
    s, q = stage_of.get(s_points.shape[0], "?"), stage_of.get(q_points.shape[0], "?")
    return {"stage": str(q) if s == q else f"{s}->{q}", "rows": rows, "width": width, "K": k,
            "C": c, "D": d, "pool": 0 if pool is None else pool.shape[1], "split": split}


def gse_bwd_shape(name, args, kwargs, stage_of):
    """One gse_full_bwd call: rows N, valid rows, channels C, angles A."""
    points, ref_vectors, w_a = args[:3]
    return {"rows": points.shape[0], "n_valid": _valid(args[6], points.shape[0]),
            "C": w_a.shape[0], "A": ref_vectors.shape[1]}


def gse_shape(name, args, kwargs, stage_of):
    """One gse_embedding_full call: rows N, valid rows, channels C, angles A."""
    points, ref_vectors, w_d = args[:3]
    return {"rows": points.shape[0], "n_valid": _valid(args[8], points.shape[0]),
            "C": w_d.shape[0], "A": ref_vectors.shape[1]}


def sinkhorn_shape(name, args, kwargs, stage_of):
    """One Sinkhorn call (forward or backward): patches P, rows M1, columns
    N1, iterations."""
    scores = args[0]
    p, m1, n1 = scores.shape
    iterations = args[2].shape[1] if name == "sinkhorn_bwd_train" else int(args[3])
    return {"P": p, "M1": m1, "N1": n1, "iterations": iterations}


def overlap_shape(name, args, kwargs, stage_of):
    """One patch_overlaps call: ref nodes M, candidates S, patch points K,
    valid candidates and their valid point pairs, the route."""
    ref_pts, ref_mask, _, src_mask, cand, cand_mask = args[:6]
    pairs = (ref_mask.sum(dim=1)[:, None] * src_mask.sum(dim=1)[cand.long()])[cand_mask]
    budget = kernels_sinkhorn.device_block_bytes(ref_pts.device)
    return {"M": ref_pts.shape[0], "S": cand.shape[1], "K": ref_pts.shape[1],
            "valid_candidates": int(cand_mask.sum()), "valid_pairs": int(pairs.sum()),
            "route": kernels_overlap.overlap_route(ref_pts.shape[1], budget)}


def input_conv_shape(name, args, kwargs, stage_of):
    """One input conv call: rows M, table width H (the union conv: its
    union's rows U too), K, D, its instance and route."""
    budget = kernels_sinkhorn.device_block_bytes(args[0].device)
    if name.startswith("kpconv_stream"):
        (m, h), (k, _, d) = args[0].shape[1:], args[2].shape
        shape = {"M": m, "H": h, "route": kernels_kpconv.stream_route(h, k, d, budget)}
    else:
        (m, h), u, (k, _, d) = args[4].shape, args[3].shape[1], args[6].shape
        shape = {"M": m, "H": h, "U": u, "route": kernels_kpconv.union_route(u, h, k, d, budget)}
    return dict(shape, K=k, D=d, instance=kernels_kpconv.input_conv_variant(k))


def limit_sinkhorn_shape(name, args, kwargs, stage_of):
    """sinkhorn_shape and the instance (general or a register one)."""
    entry = sinkhorn_shape(name, args, kwargs, stage_of)
    route = (kernels_sinkhorn.backward_route if name == "sinkhorn_bwd_train"
             else kernels_sinkhorn.forward_route)
    entry["general"] = route(entry["M1"], entry["N1"],
                             kernels_sinkhorn.device_block_bytes(args[0].device)).general
    return entry


def pair_shape(name, args, kwargs, stage_of):
    embed, qw = args[:2]
    n, m, c = embed.shape
    h = qw.shape[1]
    aligned = embed.data_ptr() % 16 == 0 and qw.data_ptr() % 16 == 0
    return {"N": n, "M": m, "C": c, "H": h, "aligned": aligned,
            "route": kernels_attention.pair_scores_route(c, h, aligned)}


def attention_shape(name, args, kwargs, stage_of):
    q, k, v = args[:3]
    h, n, dh = q.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return {"H": h, "N": n, "M": k.shape[1], "dh": dh, "aligned": aligned,
            "route": kernels_attention.attention_route(dh, aligned, k.shape[1])}


def search_shape(name, args, kwargs, stage_of):
    """One grid_radius_search call: clouds B, query rows Cq (valid ones),
    support rows Cs, K, the candidate capacity, brute or grid, and the keys
    a warp's list holds at a time (0: all of them, search_route)."""
    queries, q_lengths, support, s_lengths, starts = args[:5]
    chunk = kernels_pyramid.search_route(args[9], support.shape[1], starts is None,
                                         kernels_sinkhorn.device_block_bytes(queries.device)).chunk
    return {"B": queries.shape[0], "Cq": queries.shape[1], "valid_queries": int(q_lengths.sum()),
            "Cs": support.shape[1], "K": args[8], "cand_cap": args[9],
            "route": "brute" if starts is None else "grid", "chunk": chunk}


def segment_shape(name, args, kwargs, stage_of):
    """One voxel_segment_mean call: clouds B, rows C, output rows, voxels."""
    points, seg, voxels, cap_out = args[:4]
    return {"B": points.shape[0], "C": points.shape[1], "cap_out": cap_out,
            "voxels": [int(v) for v in voxels]}


# the rows whose calls are also timed one by one (by_call), with their shape
BY_CALL = {"grid_radius_search": search_shape, "voxel_segment_mean": segment_shape,
           "kpconv_fused": call_shape, "kpconv_split_fused": call_shape,
           "kpconv_fused (input residuals)": call_shape,
           "kpconv_bwd_fused": call_shape, "gse_embedding_full": gse_shape,
           "gse_full_bwd": gse_bwd_shape, "sinkhorn_log_iterations": sinkhorn_shape,
           "sinkhorn_fwd_train": sinkhorn_shape, "sinkhorn_bwd_train": sinkhorn_shape,
           "patch_overlaps": overlap_shape}
# phase 15 times every call alone, with these shapes
LIMIT_SHAPES = {"kpconv_fused": call_shape, "kpconv_split_fused": call_shape,
                "kpconv_bwd_fused": call_shape,
                "kpconv_stream_fused (residuals)": input_conv_shape,
                "kpconv_union_input_fused": input_conv_shape,
                "sinkhorn_log_iterations": limit_sinkhorn_shape,
                "sinkhorn_fwd_train": limit_sinkhorn_shape,
                "sinkhorn_bwd_train": limit_sinkhorn_shape,
                "rpe_pair_scores": pair_shape, "fused_masked_attention": attention_shape,
                "gse_embedding_full": gse_shape, "gse_full_bwd": gse_bwd_shape,
                "patch_overlaps": overlap_shape, "grid_radius_search": search_shape}


def call_cost(name, args, kwargs, out):
    """(bytes, f32 operations, TF32 operations, SFU operations, bfloat16
    operations) of one call."""
    return (COSTS[name](args, kwargs, out) + (0, 0, 0))[:5]


def call_bound(name, args, kwargs, out):
    """One call's bound (``with_bound``'s dict)."""
    nbytes, ops, tf32, sfu, bf16 = call_cost(name, args, kwargs, out)
    return with_bound(dict(bytes=nbytes, operations=ops, tf32_operations=tf32,
                           sfu_operations=sfu, bf16_operations=bf16,
                           peak_flops=PEAK_FLOPS.get(name, PEAK_F32_FLOPS)))


def compare_kernels(records, names, reps, stage_of=None, shapes=None):
    """Each kernel vs its plain version on the captured calls: the largest
    difference, the CUDA-event ms of the calls (host dispatch included),
    their device ms replayed from a CUDA graph, and the same two times of
    one PyTorch call of the same function where there is one. The rows of
    ``BY_CALL`` also time each call alone from its own graph, beside its
    shape, bound and largest difference (``by_call``; ``stage_of`` maps a
    row count to a KPConv stage; ``shapes`` replaces BY_CALL); gse_full_bwd
    also counts the entries it settled in float64."""
    shapes = BY_CALL if shapes is None else shapes
    results = {}
    for name in names:
        module, plain, counter = KERNELS[name].module, KERNELS[name].plain, wrapper_of(name)
        calls = records[name]
        kernel = getattr(module, counter)
        expect(calls, f"{name}: no call captured")
        worst, total_bytes, total_ops, total_tf32, total_sfu, total_bf16, by_call, launches = (
            0.0, 0, 0, 0, 0, 0, [], 0)
        settled = entries = 0
        for args, kwargs in calls:
            start = cuda.launches[counter]
            out = kernel(*args, **kwargs)
            per_call = cuda.launches[counter] - start
            launches += per_call
            if name == "gse_full_bwd":  # entries whose angle argmax went to float64
                settled += int(kernels_gse.last_settled)
                entries += _valid(args[6], args[0].shape[0]) ** 2 * args[2].shape[0]
            call_worst = check_call(name, out, plain(*args, **_plain_kwargs(kwargs)), args,
                                    kwargs)
            worst = max(worst, call_worst)
            nbytes, ops, tf32, sfu, bf16 = call_cost(name, args, kwargs, out)
            total_bytes += nbytes
            total_ops += ops
            total_tf32 += tf32
            total_sfu += sfu
            total_bf16 += bf16
            if name in shapes:
                entry = shapes[name](name, args, kwargs, stage_of or {})
                entry["device_ms"] = graph_ms(lambda: kernel(*args, **kwargs), counter, per_call)
                entry["bound_ms"] = call_bound(name, args, kwargs, out)["bound_ms"]
                entry["max_abs_err"] = call_worst
                if bf16_call(args, kwargs):
                    entry["point"] = "bfloat16"
                by_call.append(entry)

        def run_kernel():
            for args, kwargs in calls:
                kernel(*args, **kwargs)

        def run_plain():
            for args, kwargs in calls:
                plain(*args, **_plain_kwargs(kwargs))

        library_ms = library_device_ms = None
        library = [LIBRARY[name](args, kwargs) for args, kwargs in calls] if name in LIBRARY else []
        if library and all(library):

            def run_library():
                for call in library:
                    call()

            library_ms = time_ms(run_library, reps)
            library_device_ms = graph_ms(run_library)
        results[name] = with_bound({
            "calls": len(calls),
            "max_abs_err": worst,
            "ms": time_ms(run_kernel, reps),
            "plain_ms": time_ms(run_plain, max(1, reps // 2)),
            "device_ms": graph_ms(run_kernel, counter, launches),
            "bytes": total_bytes,
            "operations": total_ops,
            "tf32_operations": total_tf32,
            "sfu_operations": total_sfu,
            "bf16_operations": total_bf16,
            "peak_flops": PEAK_FLOPS.get(name, PEAK_F32_FLOPS),
            # one PyTorch call computes only the attention kernels' functions
            "library_ms": library_ms,
            "library_device_ms": library_device_ms,
            "by_call": by_call,
            "settled": (settled, entries) if name == "gse_full_bwd" else None,
        })
    return results


@functools.lru_cache(maxsize=None)
def peak_sfu():
    """SFU results a second: SFU_PER_CLOCK_SM on every SM at the maximum SM
    clock nvidia-smi reports."""
    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                                "--format=csv,noheader,nounits"], capture_output=True,
                               text=True, check=True).stdout.split()[0])
    return SFU_PER_CLOCK_SM * torch.cuda.get_device_properties(0).multi_processor_count * mhz * 1e6


def with_bound(r):
    bytes_ms = r["bytes"] / PEAK_BYTES * 1e3
    ops_ms = (r["operations"] / r["peak_flops"]
              + r.get("tf32_operations", 0) / PEAK_TF32_FLOPS
              + r.get("bf16_operations", 0) / PEAK_BF16_FLOPS) * 1e3
    if r.get("sfu_operations", 0):
        ops_ms = max(ops_ms, r["sfu_operations"] / peak_sfu() * 1e3)
    r["bound_ms"] = max(bytes_ms, ops_ms)
    r["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    return r


def merge_paths(by_path):
    """{path: {kernel: result}} -> {kernel: result}: calls, times (device
    times too), bytes and operations summed over the paths the kernel was compared on (the bound
    recomputed from the sums), the largest error, and each path's own."""
    merged = {}
    for path, results in by_path.items():
        for name, r in results.items():
            m = merged.setdefault(name, {"calls": 0, "max_abs_err": 0.0, "ms": 0.0,
                                         "plain_ms": 0.0, "device_ms": 0.0, "bytes": 0,
                                         "operations": 0, "tf32_operations": 0,
                                         "sfu_operations": 0, "bf16_operations": 0,
                                         "peak_flops": r["peak_flops"],
                                         "library_ms": None, "library_device_ms": None,
                                         "by_path": {}, "by_call": []})
            for key in ("calls", "ms", "plain_ms", "device_ms", "bytes", "operations",
                        "tf32_operations", "sfu_operations", "bf16_operations"):
                m[key] += r[key]
            for key in ("library_ms", "library_device_ms"):
                if r[key] is not None:
                    m[key] = (m[key] or 0.0) + r[key]
            m["max_abs_err"] = max(m["max_abs_err"], r["max_abs_err"])
            m["by_call"] += [dict(path=path, **entry) for entry in r["by_call"]]
            m["by_path"][path] = {key: r[key] for key in (
                "calls", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms", "settled")}
    return {name: with_bound(m) for name, m in merged.items()}


def stages_of(batch):
    """Row count -> stage of a batch's stacked points (the caps differ from
    stage to stage)."""
    return {p.shape[0]: s for s, p in enumerate(batch["points"])}


def check_split_against_unsplit(records):
    """Every captured split conv against the plain conv on its whole table
    (head columns, then the tail rows brought back by rank); and the device
    time of the split convs beside that of the unsplit kernel on the whole
    tables (each from a CUDA-graph replay), which the split replaces."""
    worst, whole = 0.0, []
    for args, kwargs in records["kpconv_split_fused"]:
        s_feats, q_points, s_points, head, tail, _, rank = args[:7]
        table = _whole_table(head, tail, rank, s_feats.shape[0])
        unsplit = (s_feats, q_points, s_points, table) + tuple(args[7:])
        got = kernels_kpconv.kpconv_split_fused(*args, **kwargs)
        want = kernels_kpconv.kpconv_fused_plain(*unsplit, **_plain_kwargs(kwargs))
        worst = max(worst, check_call("kpconv_split_fused", got, want, args))
        whole.append((unsplit, kwargs))

    def run_unsplit():
        for unsplit, kwargs in whole:
            kernels_kpconv.kpconv_fused(*unsplit, **kwargs)

    def run_split():
        for args, kwargs in records["kpconv_split_fused"]:
            kernels_kpconv.kpconv_split_fused(*args, **kwargs)

    before = cuda.launches["kpconv_split_fused"]
    run_split()
    split_launches = cuda.launches["kpconv_split_fused"] - before
    return worst, {"split_device_ms": graph_ms(run_split, "kpconv_split_fused", split_launches),
                   "unsplit_device_ms": graph_ms(run_unsplit, "kpconv_fused", len(whole)),
                   "unsplit_ms": time_ms(run_unsplit, 5)}


def counted(fn):
    """fn()'s result and the kernel launches it made."""
    torch.cuda.synchronize()
    cuda.launches.clear()
    result = fn()
    torch.cuda.synchronize()
    counts = dict(cuda.launches)
    cuda.launches.clear()
    return result, counts


def forward_ms(model, batch):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = model(batch)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def check_output(out, cfg, caps):
    est = out["estimated_transform"]
    expect(est.shape == (4, 4) and bool(torch.isfinite(est).all()), "non-finite transform")
    rot = est[:3, :3].double()
    ortho = (rot @ rot.T - torch.eye(3, dtype=torch.float64, device=rot.device)).abs().max().item()
    expect(ortho < 1e-3, f"R R^T deviates from I by {ortho}")
    expect(abs(torch.linalg.det(rot).item() - 1.0) < 1e-3, "det(R) is not 1")
    p, k = cfg.coarse_matching.num_correspondences, cfg.model.num_points_in_patch
    expect(out["matching_scores"].shape == (p, k + 1, k + 1), "matching_scores shape")
    expect(out["ref_corr_points"].shape == (cfg.caps.correspondence_capacity, 3),
           "ref_corr_points shape")
    cap = caps[-1][0] if isinstance(caps[-1], (tuple, list)) else caps[-1]
    expect(out["ref_feats_c"].shape == (cap, cfg.geotransformer.output_dim), "ref_feats_c shape")
    for key in ("ref_feats_c", "src_feats_c", "ref_feats_f", "src_feats_f", "matching_scores"):
        expect(bool(torch.isfinite(out[key]).all()), f"non-finite {key}")
    expect(bool(out["node_corr_masks"].any()), "no superpoint correspondence")
    return ortho


def registration_error(est, gt):
    est, gt = est.double().cpu().numpy(), gt.astype(np.float64)
    cos = (np.trace(est[:3, :3].T @ gt[:3, :3]) - 1.0) / 2.0
    rre = float(np.degrees(np.arccos(np.clip(cos, -1.0, 1.0))))
    return rre, float(np.linalg.norm(est[:3, 3] - gt[:3, 3]))


def compare_coarse_features(got, want, what, bar=1e-3):
    """ref/src_feats_c of two runs on their valid rows, relative to the
    largest magnitude; at most ``bar``."""
    rels = {}
    for side in ("ref", "src"):
        rows = want[f"{side}_masks_c"]
        g, w = got[f"{side}_feats_c"][rows], want[f"{side}_feats_c"][rows]
        rel = ((g - w).abs().max() / w.abs().max()).item()
        expect(rel <= bar, f"{side}_feats_c: {what} {rel:.2e} > {bar:.0e}")
        print(f"{what}: {side}_feats_c max rel diff {rel:.2e}", flush=True)
        rels[side] = rel
    return rels


def register_pairs(model, cfg, caps, batches, batches_np, seeds, what):
    """One counted, timed forward per pair; the outputs checked (no GSE
    launch for the mean angle reduction)."""
    forward_ms(model, batches[0])  # warm-up (cuBLAS, caching allocator)
    times, outs, counts = [], [], collections.Counter()
    for batch in batches:
        (ms, out), c = counted(lambda: forward_ms(model, batch))
        times.append(ms)
        outs.append(out)
        counts.update(c)
    expect_launches(counts, batches, "inference", f"{what} forward", cfg.geotransformer.blocks,
                    gse=cfg.geotransformer.reduction_a == "max")
    for out, batch_np, seed in zip(outs, batches_np, seeds):
        ortho = check_output(out, cfg, caps)
        rre, rte = registration_error(out["estimated_transform"], batch_np["transform"])
        print(f"{what} pair {seed}: |R R^T - I| = {ortho:.2e}; random weights: RRE {rre:.2f} deg, "
              f"RTE {rte:.3f} m", flush=True)
    median = statistics.median(times)
    print(f"{what} forward: {median:.3f} ms per pair (median of {times}, CUDA events)",
          flush=True)
    return outs, times, dict(counts)


def target_generator(seed):
    return torch.Generator().manual_seed(seed)


def step_gradients(model, cfg, batch, seed):
    """Loss and parameter gradients (float64 copies) of one training
    forward/backward, no update. Every parameter has a gradient (the kernel
    route's proj_p.bias an exact 0)."""
    model.zero_grad(set_to_none=True)
    out = model(batch, training=True, with_gt=True, generator=target_generator(seed))
    loss, _ = overall_loss(cfg, out, batch["transform"])
    loss.backward()
    return loss.item(), {k: p.grad.detach().double() for k, p in model.named_parameters()}


def relative_errors(got, exact):
    """|got - exact| / |exact| of the whole step (every gradient
    concatenated) and of each tensor."""
    diffs = {k: (got[k] - w).norm().item() for k, w in exact.items()}
    norms = {k: w.norm().item() for k, w in exact.items()}
    whole = (sum(d * d for d in diffs.values()) / sum(n * n for n in norms.values())) ** 0.5
    return whole, {k: diffs[k] / norms[k] if norms[k] else diffs[k] for k in exact}


# --- the float64 witness: a float32 step's discrete choices -------------
# A float64 step taken along every discrete choice a float32 step made is the
# exact gradient of the function that float32 step computed. The partition
# (k-NN patches) and the GT candidate overlaps come in the batch, computed
# once in float32 for every route; `witness` records the rest in call order
# and replays them.
CHOICES = ("relu", "targets", "coarse", "fine", "pool", "ties", "count")
# The rounding band of 0 on a ReLU input tensor: twice the float32 plain
# step's largest distance from float64 on its valid rows, the factor the
# gradient check allows the kernel step over the plain one (readings: PERF.md).
BAND_FACTOR = 2


def _site(frame):
    """The module (its class name) whose forward made a call."""
    owner = frame.f_locals.get("self")
    return type(owner).__name__ if owner is not None else frame.f_code.co_name


def pool_routes(pool_feats, pooled, table):
    """The support rows each pooled value's gradient goes to (its argmax and
    ties), per pass of the inverse-table backward (whole table, or the head
    and the tail of a split one), as ``_bwd_pass_plain`` takes them."""
    m = pooled.shape[0]

    def routes(feats, inv):
        inv = inv.long()
        return (feats[:, None, :] == gather_with_shadow(pooled, inv, 0.0)) & (inv < m)[..., None]

    if isinstance(table, (tuple, list)):
        head, tail, tail_s, _ = table
        return [routes(pool_feats, head), routes(pool_feats[tail_s.long()], tail)]
    return [routes(pool_feats, table)]


@contextlib.contextmanager
def witness(record, replay=(), inputs=False):
    """Record into ``record`` (a dict of lists, in call order) the discrete
    choices of one forward and backward, or impose recorded ones (the kinds
    in ``replay``):
      relu: the branch (x > 0) of each backbone leaky ReLU and each ReLU of
        the transformer's feed-forward, beside its site (the calling module)
        and, with ``inputs``, its input x;
      targets: the GT node pairs a training step samples (the overlap
        threshold);
      coarse: the coarse loss's positive and negative node pairs (its
        overlap thresholds);
      fine: the fine loss's GT point matches (the positive radius);
      pool: the support rows each strided shortcut max-pool's gradient goes
        to (its argmax, ties included);
      ties: how many columns tie at each pooled maximum (two values equal in
        float32 may differ in float64), the pooled gradient's divisor;
      count: each conv's divisor, the neighbours whose feature sum is
        positive (a sum within rounding of 0 may count either way): the
        replay divides the conv's sums by the recorded divisor.
    A replaying run records nothing."""
    position = collections.Counter()
    recording = not replay

    def next_of(kind):
        position[kind] += 1
        return record[kind][position[kind] - 1]

    def kink(x, slope, site):
        if "relu" in replay:
            keep = next_of("relu")
        else:
            keep = x > 0
        if recording:
            record.setdefault("relu", []).append(keep)
            record.setdefault("relu_site", []).append(site)
            if inputs:
                record.setdefault("relu_x", []).append(x.detach().clone())
        return torch.where(keep, x, slope * x)

    def leaky_relu(x):
        return kink(x, 0.1, _site(sys._getframe(1)))

    def feed_forward(self, input_states):  # AttentionOutput.forward
        hidden = self.squeeze(kink(self.expand(input_states), 0.0, "AttentionOutput"))
        return self.norm(input_states + hidden)

    def target_sample(*args):
        if "targets" in replay:
            return next_of("targets")
        out = saved["targets"](*args)
        if recording:
            record.setdefault("targets", []).append(out)
        return out

    def coarse_labels(*args):
        if "coarse" in replay:
            return next_of("coarse")
        out = saved["coarse"](*args)
        if recording:
            record.setdefault("coarse", []).append(out)
        return out

    def fine_labels(*args):
        if "fine" in replay:
            return next_of("fine")
        out = saved["fine"](*args)
        if recording:
            record.setdefault("fine", []).append(out)
        return out

    def conv_forward(ctx, s_feats, weights, pool_feats, conv, *rest):  # _KPConvInv.forward
        at = 1 if pool_feats is None else 2  # the divisor's place in conv's result
        count = next_of("count") if "count" in replay else None
        ties = next_of("ties") if "ties" in replay and pool_feats is not None else None

        def conv(sf, w, pf, _conv=conv):
            res = list(_conv(sf, w, pf))
            if recording:
                record.setdefault("count", []).append(res[at])
                if pf is not None:
                    record.setdefault("ties", []).append(res[3])
            if count is not None:
                res[0] = res[0] * (res[at] / count)[:, None]
                res[at] = count
            if ties is not None:
                res[3] = ties
            return tuple(res)
        out = saved["conv_forward"](ctx, s_feats, weights, pool_feats, conv, *rest)
        if pool_feats is not None and recording:
            record.setdefault("pool", []).append(pool_routes(pool_feats, out[1], ctx.inverse_table))
        return out

    pending = []

    def bwd_pass(s_feats, s_points, q_points, gdiv, inverse_table, kernel_points, weights, sigma,
                 pool_feats=None, pooled=None, dpool_over_ties=None, **point):  # _bwd_pass_plain
        if pool_feats is None or "pool" not in replay:
            return saved["bwd_pass"](s_feats, s_points, q_points, gdiv, inverse_table,
                                     kernel_points, weights, sigma, pool_feats, pooled,
                                     dpool_over_ties, **point)
        # the backward walks the convs in reverse, each conv's passes in order
        if not pending:
            position["pool"] += 1
            pending.extend(record["pool"][len(record["pool"]) - position["pool"]])
        is_max = pending.pop(0)
        d_s_feats, d_weights = saved["bwd_pass"](s_feats, s_points, q_points, gdiv,
                                                 inverse_table, kernel_points, weights, sigma,
                                                 **point)
        d_pool = torch.sum(is_max.to(gdiv.dtype)
                           * gather_with_shadow(dpool_over_ties, inverse_table.long(), 0.0), dim=1)
        return d_s_feats, d_weights, d_pool

    saved = {"leaky_relu": models_kpconv.leaky_relu,
             "feed_forward": models_transformer.AttentionOutput.forward,
             "targets": models_geotransformer.superpoint_target_sample,
             "coarse": losses_overall.coarse_labels, "fine": losses_overall.fine_labels,
             "conv_forward": kernels_kpconv._KPConvInv.forward,
             "bwd_pass": kernels_kpconv._bwd_pass_plain}
    models_kpconv.leaky_relu = leaky_relu
    models_transformer.AttentionOutput.forward = feed_forward
    models_geotransformer.superpoint_target_sample = target_sample
    losses_overall.coarse_labels, losses_overall.fine_labels = coarse_labels, fine_labels
    kernels_kpconv._KPConvInv.forward = staticmethod(conv_forward)
    kernels_kpconv._bwd_pass_plain = bwd_pass
    try:
        yield
    finally:
        models_kpconv.leaky_relu = saved["leaky_relu"]
        models_transformer.AttentionOutput.forward = saved["feed_forward"]
        models_geotransformer.superpoint_target_sample = saved["targets"]
        losses_overall.coarse_labels, losses_overall.fine_labels = saved["coarse"], saved["fine"]
        kernels_kpconv._KPConvInv.forward = staticmethod(saved["conv_forward"])
        kernels_kpconv._bwd_pass_plain = saved["bwd_pass"]
    expect(not pending, f"witness: {len(pending)} pool routes of a conv not replayed")
    for kind in replay:
        expect(position[kind] == len(record.get(kind, [])),
               f"witness: {position[kind]} of {len(record.get(kind, []))} recorded {kind} "
               f"choices replayed")


def relu_rows(cfg, batch, record):
    """Each recorded ReLU's valid rows, broadcastable to its input: a
    backbone call's rows are a stage's points (the stage masks, matched by
    row count), the feed-forward's the ref or the src superpoints (the
    self and cross blocks take ref, then src)."""
    by_rows = {}
    for mask in batch["masks"]:
        prior = by_rows.setdefault(mask.shape[0], mask)
        expect(torch.equal(prior, mask), "relu_rows: two stages of one size with other masks")
    coarse = models_geotransformer._stage_pair(cfg, batch, cfg.backbone.num_stages - 1, "masks")
    rows, ffn = [], 0
    for keep, site in zip(record["relu"], record["relu_site"]):
        if site == "AttentionOutput":
            rows.append(coarse[ffn % 2][None, :, None])
            ffn += 1
        else:
            rows.append(by_rows[keep.shape[0]][:, None])
    return rows


def branch_flips(a, b, rows, exact=None, plain=None):
    """ReLU inputs whose branch (x > 0) differs between recordings a and b:
    on valid rows, on padded rows (and the sites with the most), and, given
    the float64 step's inputs (``exact``) and the float32 plain step's
    (``plain``), the valid-row flips whose float64 input lies outside the
    f32 rounding band of 0 (BAND_FACTOR times the plain step's largest
    distance from float64 on that tensor's valid rows, at least 2^-20 of
    its largest |x|), with the largest |x| / band among the valid flips."""
    expect(len(a["relu"]) == len(b["relu"]), f"witness: {len(a['relu'])} against "
                                             f"{len(b['relu'])} ReLUs")
    valid = padded = outside = 0
    worst = 0.0
    sites = collections.Counter()
    for i, (x, y, r) in enumerate(zip(a["relu"], b["relu"], rows)):
        flip = x != y
        on_valid = flip & r
        valid += int(on_valid.sum())
        n_padded = int((flip & ~r).sum())
        padded += n_padded
        if n_padded:
            sites[f"{i}:{a['relu_site'][i]}"] += n_padded
        if exact is not None and bool(on_valid.any()):
            x64 = exact["relu_x"][i]
            err = torch.where(r, (plain["relu_x"][i].double() - x64).abs(), 0.0).max()
            band = max(BAND_FACTOR * err.item(),
                       2.0**-20 * torch.where(r, x64.abs(), 0.0).max().item())
            ratio = x64.abs()[on_valid] / band
            outside += int((ratio > 1.0).sum())
            worst = max(worst, ratio.max().item())
    return {"valid": valid, "padded": padded, "padded_sites": sites.most_common(5),
            **({"valid_outside_band": outside, "worst_valid_over_band": worst}
               if exact is not None else {})}


def compare_step_gradients(kernel, plain, exact_kernel, exact_plain):
    """The kernel step's gradients against the exact step along its own
    ReLU branches (the plain, force_pallas=False, step in float64 on the
    same weights and batch), beside the float32 plain step's distance from
    the exact step along the plain step's branches. The two routes take the
    same step in float64 (tests/test_torch_modelnet.py), so in float32 they
    differ by rounding, and by the branch a ReLU takes where its input lies
    within rounding of 0, which moves a gradient by up to ~1e-3. The whole
    step and each tensor must stand within 1e-3 (relative norm) plus twice
    the float32 plain step's distance of the exact step; a wrong kernel
    gradient stands off both. Gradients that vanish in exact arithmetic
    (biases under a softmax row shift, a one-channel GroupNorm group; the
    exact norm under 1e-6 of the largest) must stay under that floor, and
    proj_p.bias, whose term the kernel route drops, must be exactly 0.
    Returns the readings and the violations."""
    floor = 1e-6 * max(w.norm().item() for w in exact_kernel.values())
    whole_k, per_k = relative_errors(kernel, exact_kernel)
    whole_p, per_p = relative_errors(plain, exact_plain)
    whole_kp, per_kp = relative_errors(kernel, plain)
    worst, vanishing, violations = (0.0, None, 0.0), [], []
    for name, w in exact_kernel.items():
        if name.endswith("proj_p.bias") and kernel[name].any():
            violations.append(f"{name}: kernel-route gradient is not exactly 0")
        if w.norm().item() <= floor:
            if kernel[name].norm().item() > floor:
                violations.append(f"{name}: kernel gradient above the noise floor")
            vanishing.append(name)
            continue
        if per_k[name] > 1e-3 + 2 * per_p[name]:
            violations.append(f"{name}: kernel step {per_k[name]:.2e} from the float64 step, "
                              f"float32 plain {per_p[name]:.2e}")
        if per_k[name] >= worst[0]:
            worst = (per_k[name], name, per_p[name])
    if whole_k > 1e-3 + 2 * whole_p:
        violations.append(f"whole step: kernel {whole_k:.2e} from the float64 step, float32 "
                          f"plain {whole_p:.2e}")
    tensors = {name: (per_k[name], per_p[name], per_kp[name]) for name in exact_kernel
               if name not in vanishing}
    return dict(whole_kernel=whole_k, whole_plain=whole_p, whole_kernel_vs_plain=whole_kp,
                worst=worst, vanishing=vanishing, violations=violations,
                above_1e3=sorted((v for v in tensors.items() if max(v[1][:2]) > 1e-3),
                                 key=lambda v: -v[1][0]),
                tensors=tensors)


def whole_step_vs_plain(model, plain_model, cfg, batch, what, report):
    """One step's gradients on the kernel route and the float32 plain route,
    and the float64 plain step free and along each float32 step's discrete
    choices (``witness``), from the same weights, batch and GT targets
    (computed once, so no route rounds its own). The check reads the
    witness along every choice; the one along the ReLU branches alone (the
    witness before it replayed the other choices) is printed beside it. A
    violation fails the run at its end, after every path has been read."""
    if "gt_cand_indices" not in batch:
        batch = dict(batch, **precompute_gt_targets(cfg, batch, device=DEVICE))
    kernel_rec, plain_rec, exact_rec = {}, {}, {}
    with witness(kernel_rec):
        loss_kernel, grads_kernel = step_gradients(model, cfg, batch, 0)
    plain_model.load_state_dict(model.state_dict())
    with witness(plain_rec, inputs=True):
        loss_plain, grads_plain = step_gradients(plain_model, cfg, batch, 0)
    exact_model = copy.deepcopy(plain_model).double()
    batch64 = batch_to_float64(batch)
    with witness(exact_rec, inputs=True):
        loss_exact, grads_exact = step_gradients(exact_model, cfg, batch64, 0)
    exact = {}
    for route, rec in (("kernel", kernel_rec), ("plain", plain_rec)):
        for replay in (("relu",), CHOICES):
            with witness(rec, replay=replay):
                exact[route, replay] = step_gradients(exact_model, cfg, batch64, 0)[1]
    del exact_model
    rows = relu_rows(cfg, batch, kernel_rec)
    flips = {"kernel_vs_plain": branch_flips(kernel_rec, plain_rec, rows, exact_rec, plain_rec),
             "kernel_vs_float64": branch_flips(kernel_rec, exact_rec, rows, exact_rec, plain_rec),
             "plain_vs_float64": branch_flips(plain_rec, exact_rec, rows)}
    choices = {kind: sum(int((x != y).sum()) for x, y in zip(
                   _flat(kernel_rec.get(kind, [])), _flat(plain_rec.get(kind, []))))
               for kind in CHOICES[1:]}
    r = compare_step_gradients(grads_kernel, grads_plain, exact["kernel", CHOICES],
                               exact["plain", CHOICES])
    relu_only = {"kernel": relative_errors(grads_kernel, exact["kernel", ("relu",)])[0],
                 "plain": relative_errors(grads_plain, exact["plain", ("relu",)])[0]}
    free = {"kernel": relative_errors(grads_kernel, grads_exact)[0],
            "plain": relative_errors(grads_plain, grads_exact)[0]}
    above = [(name, f"kernel {k:.2e}", f"plain {p:.2e}") for name, (k, p, _) in r["above_1e3"]]
    for pair in ("kernel_vs_plain", "kernel_vs_float64"):
        if flips[pair]["valid_outside_band"]:
            r["violations"].append(f"{pair}: {flips[pair]['valid_outside_band']} valid-row ReLU "
                                   f"flips outside the f32 rounding band of 0")
    print(f"{what} whole step: loss kernel {loss_kernel:.6f}, plain {loss_plain:.6f}, float64 "
          f"{loss_exact:.6f}; ReLU branch flips over {len(kernel_rec['relu'])} ReLUs {flips}; "
          f"kernel vs plain choices that differ (targets, coarse labels, fine matches, pool "
          f"routes, pool ties, conv divisors) {choices}; gradient rel diff from the float64 step along each route's "
          f"choices: kernel {r['whole_kernel']:.2e}, float32 plain {r['whole_plain']:.2e} (along "
          f"the ReLU branches alone: kernel {relu_only['kernel']:.2e}, plain "
          f"{relu_only['plain']:.2e}; free float64 step: kernel {free['kernel']:.2e}, plain "
          f"{free['plain']:.2e}; kernel vs plain {r['whole_kernel_vs_plain']:.2e}); worst tensor "
          f"{r['worst'][0]:.2e} ({r['worst'][1]}; plain {r['worst'][2]:.2e}) over "
          f"{len(grads_exact)} tensors; above 1e-3 on either route: {above}; "
          f"{len(r['vanishing'])} vanishing biases at the noise floor; violations: "
          f"{r['violations']}", flush=True)
    report[what] = dict(step_loss_kernel=loss_kernel, step_loss_plain=loss_plain,
                        step_loss_float64=loss_exact, relu_flips=flips, choices_differ=choices,
                        relu_only_float64=relu_only, free_float64=free, **r)
    report.setdefault("violations", []).extend(f"{what}: {v}" for v in r["violations"])


def _flat(choices):
    """The tensors of recorded choices, in order (pool routes per pass)."""
    for c in choices:
        yield from (_flat(c) if isinstance(c, (tuple, list)) else (c,))


def train_phase(cfg, model, batches, steps, what, report):
    """``steps`` steps over the pairs in turn, each counted."""
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=len(batches))
    step = make_train_step(model, cfg, optimizer, scheduler, device=DEVICE)
    with torch.no_grad():
        first = overall_loss(cfg, model(batches[0], training=True, with_gt=True,
                                        generator=target_generator(0)),
                             batches[0]["transform"])[0].item()
    torch.cuda.reset_peak_memory_stats()
    losses, times, total = [], [], collections.Counter()
    for i in range(steps):
        seed = SEEDS[i % len(SEEDS)]
        batch = batches[i % len(batches)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

        def run():
            start.record()
            metrics = step(batch, target_generator(seed))
            end.record()
            return metrics

        metrics, counts = counted(run)
        times.append(start.elapsed_time(end))
        total.update(counts)
        expect_launches(counts, [batch], "train", f"{what} train step {i}",
                        cfg.geotransformer.blocks)
        expect(metrics["grad_finite"].item() == 1.0, f"{what} train step {i} skipped by the guard")
        loss = metrics["loss"].item()
        expect(np.isfinite(loss), f"{what} train step {i}: loss {loss}")
        losses.append((seed, loss))
    peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        last = overall_loss(cfg, model(batches[0], training=True, with_gt=True,
                                       generator=target_generator(0)),
                            batches[0]["transform"])[0].item()
    expect(last < first, f"{what}: seed-0 loss did not fall: {first} -> {last}")
    median = statistics.median(times)
    print(f"{what} train: {steps} steps, losses {[round(l, 4) for _, l in losses]}; seed-0 loss "
          f"{first:.4f} -> {last:.4f}; {median:.3f} ms per step (median of "
          f"{[round(t, 2) for t in times]}, CUDA events); peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    report[what] = dict(train_losses=losses, train_step_ms=times, train_step_median_ms=median,
                        train_peak_bytes=peak, seed0_loss=[first, last])
    return dict(total)


def write_profile(filename, header, ops):
    """``ops`` (DeviceOp lists, largest first) into chiprun_out/<filename>."""
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", filename), "w") as f:
        f.write(header + "\n")
        for what, items in ops.items():
            f.write(f"{what}:\n")
            for op in items:
                f.write(f"{op.ms:10.3f} ms {op.count:7.1f}x  {op.name}\n")


def profile_train(cfg, model, batches, what, filename, report):
    """torch.profiler over two training steps: device time by kernel and by
    operator (chiprun_out/<filename>) and the device's busy share of an
    unprofiled step (the train phase's median), the profiler's own host
    cost left out."""
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=len(batches))
    step = make_train_step(model, cfg, optimizer, scheduler, device=DEVICE)
    seeds = iter((0, 0, 1))  # a warm-up step, then the two profiled ones

    def run():
        seed = next(seeds)
        return step(batches[seed], target_generator(seed))

    kernels, operators = top_device_ops(run, runs=2)
    # kernel events only, as the table's "Self CUDA time total": an
    # operator's self device time repeats its kernels' time
    device_ms = sum(op.ms for op in kernels)
    step_ms = report[what]["train_step_median_ms"]
    write_profile(filename, f"a training step (two profiled); device time {device_ms:.3f} ms per "
                            f"step against a {step_ms:.3f} ms unprofiled step",
                  {"kernels": kernels[:40], "operators": operators[:40]})
    busy = device_ms / step_ms
    print(f"{what} profile: device time {device_ms:.3f} ms per training step against a "
          f"{step_ms:.3f} ms step: busy {100 * busy:.1f} %, idle {100 * (1 - busy):.1f} %",
          flush=True)
    report[f"{what}_train_profile"] = {"device_ms_per_step": device_ms, "step_ms": step_ms}


def print_results(path, results):
    for name, r in results.items():
        library = ("" if r["library_ms"] is None else
                   f"; library {r['library_ms']:.3f} ms (CUDA events), "
                   f"{r['library_device_ms']:.3f} ms on the device (graph)")
        print(f"{path} {name}: {r['calls']} calls, max|kernel - plain| {r['max_abs_err']:.3e}, "
              f"kernel {r['ms']:.3f} ms (CUDA events), {r['device_ms']:.3f} ms on the device "
              f"(graph) vs plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}){library}", flush=True)
        if r["settled"] is not None:
            settled, entries = r["settled"]
            print(f"{path} {name}: {settled} of {entries} (pair, channel) entries settled in "
                  f"float64 ({settled / max(entries, 1):.3e})", flush=True)


def threedmatch_phases(device, launches, report):
    """Phases 2-8: the 3DMatch forward, union variant, training and profile.
    Returns each kernel's comparison with its plain version on this path."""
    cfg = make_3dmatch_config()
    start = time.perf_counter()
    caps, pyramids, batches_np, stages = build_batches(cfg, SEEDS)
    print(f"batch: {len(batches_np)} pairs in {time.perf_counter() - start:.1f} s; "
          f"stages {stages}; caps {caps}; inverse limits {cfg.caps.inverse_limits}", flush=True)
    report["3dmatch_batches"] = dict(stages=stages, caps=caps)
    cfg = cfg.with_caps(stage_caps=caps)
    batches = [batch_to_torch(b, device) for b in batches_np]

    # 3. forward: the inference path, counted
    model = create_model(cfg, device=device)
    outs, times, launches["3dmatch_inference"] = register_pairs(
        model, cfg, caps, batches, batches_np, SEEDS, "3dmatch")
    report["3dmatch_forward_ms"] = times

    # 4. inference kernels vs plain, on the inputs of a forward
    with capture_kernel_calls(INFERENCE) as records:
        model(batches[0])
    results = compare_kernels(records, INFERENCE, reps=10, stage_of=stages_of(batches[0]))
    plain_model = create_model(cfg.with_model(force_pallas=False), device=device)
    plain_model.load_state_dict(model.state_dict())
    forward_ms(plain_model, batches[0])
    plain_times = [forward_ms(plain_model, batch)[0] for batch in batches]
    compare_coarse_features(outs[-1], plain_model(batches[-1]),
                            "3dmatch whole model vs force_pallas=False")
    print(f"3dmatch plain forward: {statistics.median(plain_times):.3f} ms per pair (median of "
          f"{plain_times})", flush=True)
    report["3dmatch_plain_forward_ms"] = plain_times

    # 5. the union-gather input conv on the same pairs, no edge stream
    union_cap, largest = union_capacity(batches_np, UNION_TILE)
    union_np = [pad_registration_batch(p, np.ones((n, 1), np.float32), t, caps,
                                       input_stream=False, union_cap=union_cap,
                                       union_tile=UNION_TILE) for p, n, t in pyramids]
    union = [batch_to_torch(b, device) for b in union_np]
    print(f"union: cap {union_cap} (largest tile union {largest}), tile {UNION_TILE}", flush=True)
    union_outs, union_times, launches["3dmatch_union"] = register_pairs(
        model, cfg, caps, union, union_np, SEEDS, "3dmatch union")
    for got, want in zip(union_outs, outs):
        compare_coarse_features(got, want, "3dmatch union vs stream forward")
    with capture_kernel_calls(["kpconv_union_input_fused"]) as records:
        model(union[0])
    results.update(compare_kernels(records, ["kpconv_union_input_fused"], reps=10))
    SHARED["3dmatch_union"] = union[0]
    report["3dmatch_union"] = dict(cap=union_cap, largest=largest, forward_ms=union_times)

    # 6. train: the training path, counted step by step
    for batch in batches:
        batch.update(precompute_gt_targets(cfg, batch, device=device))
    launches["3dmatch_train"] = train_phase(cfg, model, batches, TRAIN_STEPS, "3dmatch", report)

    # 7. training kernels vs plain, on the inputs of one step; the whole step
    with capture_kernel_calls(TRAINING) as records:
        step_gradients(model, cfg, batches[0], 0)
    results.update(compare_kernels(records, TRAINING, reps=5, stage_of=stages_of(batches[0])))
    whole_step_vs_plain(model, plain_model, cfg, batches[0], "3dmatch_step_vs_plain", report)

    # 8. profile two more training steps
    profile_train(cfg, model, batches, "3dmatch", "train_profile.txt", report)
    SHARED["3dmatch_train"] = (cfg, model, batches)
    return results


def kitti_phases(device, launches, report):
    """Phases 9-11: the KITTI batches, forward, training and eval steps.
    Returns each kernel's comparison with its plain version on this path
    ("kitti": a forward's and a training step's calls) and patch_overlaps'
    on an eval step ("kitti_eval")."""
    cfg = make_kitti_config()
    caps, batches_np, stages, splits, inverse_splits, host = build_kitti_batches(cfg, SEEDS)
    cfg = cfg.with_caps(stage_caps=caps)
    per_pair = {k: round(v / len(SEEDS), 2) for k, v in host.items()}
    print(f"kitti batch: host seconds a pair {per_pair}; stages {stages}; caps {caps}; "
          f"neighbor splits {splits[0]}; subsampling splits {splits[1]}; inverse splits "
          f"{inverse_splits}", flush=True)
    report["kitti_batches"] = dict(stages=stages, caps=caps, splits=splits,
                                   inverse_splits=inverse_splits, host_s=host)
    batches = [batch_to_torch(b, device) for b in batches_np]

    # 10. forward
    model = create_model(cfg, device=device)
    outs, times, launches["kitti_inference"] = register_pairs(
        model, cfg, caps, batches, batches_np, SEEDS, "kitti")
    report["kitti_forward_ms"] = times
    # every inference kernel the KITTI forward reaches (its tables decide which)
    forward = [name for name in INFERENCE + ["kpconv_split_fused"]
               if expected_launches(batches[0], "inference", cfg.geotransformer.blocks)[name]]
    with capture_kernel_calls(forward) as records:
        model(batches[0])
    results = compare_kernels(records, forward, reps=5, stage_of=stages_of(batches[0]))
    worst, unsplit = check_split_against_unsplit(records)
    print(f"kpconv_split_fused vs the unsplit plain conv on the whole table: "
          f"max |diff| {worst:.3e} over {len(records['kpconv_split_fused'])} convs; on the "
          f"device the split convs take {unsplit['split_device_ms']:.3f} ms, the unsplit "
          f"kpconv_fused on the whole tables {unsplit['unsplit_device_ms']:.3f} ms (CUDA-graph "
          f"replay; CUDA events {unsplit['unsplit_ms']:.3f} ms)", flush=True)
    report["kitti_split_vs_unsplit"] = dict(max_abs=worst, **unsplit)
    plain_model = create_model(cfg.with_model(force_pallas=False), device=device)
    plain_model.load_state_dict(model.state_dict())
    forward_ms(plain_model, batches[0])
    plain_times = [forward_ms(plain_model, batch)[0] for batch in batches]
    compare_coarse_features(outs[-1], plain_model(batches[-1]),
                            "kitti whole model vs force_pallas=False")
    print(f"kitti plain forward: {statistics.median(plain_times):.3f} ms per pair (median of "
          f"{plain_times})", flush=True)
    report["kitti_plain_forward_ms"] = plain_times

    # 11. training without precomputed targets: the in-step GT overlaps
    launches["kitti_train"] = train_phase(cfg, model, batches, KITTI_TRAIN_STEPS, "kitti", report)
    with capture_kernel_calls(TRAINING + ["patch_overlaps"]) as records:
        step_gradients(model, cfg, batches[0], 0)
    results.update(compare_kernels(records, TRAINING + ["patch_overlaps"], reps=5,
                                   stage_of=stages_of(batches[0])))
    whole_step_vs_plain(model, plain_model, cfg, batches[0], "kitti_step_vs_plain", report)
    evaluate = make_eval_step(model, cfg, device=DEVICE)
    counts, metrics = collections.Counter(), []
    for batch, seed in zip(batches, SEEDS):
        m, c = counted(lambda: evaluate(batch))
        counts.update(c)
        expect(all(bool(torch.isfinite(v)) for v in m.values()), f"kitti eval {seed}: {m}")
        metrics.append({k: float(v) for k, v in m.items()})
    expect_launches(counts, batches, "eval", "kitti eval", cfg.geotransformer.blocks)
    launches["kitti_eval"] = dict(counts)
    print(f"kitti eval: {[{k: round(v, 4) for k, v in m.items()} for m in metrics]}", flush=True)
    report["kitti_eval"] = metrics
    with capture_kernel_calls(["patch_overlaps"]) as records:
        evaluate(batches[0])
    eval_results = compare_kernels(records, ["patch_overlaps"], reps=5)
    profile_train(cfg, model, batches, "kitti", "kitti_train_profile.txt", report)
    SHARED["kitti_train"] = (cfg, model, batches)
    return {"kitti": results, "kitti_eval": eval_results}


# the rows whose bfloat16 instance rounds inside the kernel (row 12 reads a
# bfloat16 embedding and rounds nothing)
ROUNDING_ROWS = ("kpconv_fused", "kpconv_split_fused", "kpconv_stream_fused",
                 "kpconv_union_input_fused", "gse_embedding_full", "kpconv_bwd_fused",
                 "gse_full_bwd")
BF16_ROWS = ROUNDING_ROWS + ("rpe_pair_scores",)
# the precision path's whole-forward bar on the phases' trained weights, the
# float32 path's: two forwards at a bfloat16 point whose float32 sums differ
# in their last bits round some values the other way, and the network
# carries the difference. With the KITTI cell's untrained seeded weights it
# carries it further, so that run is held only to the second rule, which
# every run keeps: the kernel forward nearer its plain twin than that twin
# is to float32
PRECISION_FEATURE_BAR = 1e-3


def coarse_norm_distance(got, want):
    """||got - want|| / ||want|| of ref/src_feats_c over want's valid rows."""
    distance = {}
    for side in ("ref", "src"):
        rows = want[f"{side}_masks_c"]
        a, b = got[f"{side}_feats_c"][rows], want[f"{side}_feats_c"][rows]
        distance[f"{side}_feats_c"] = ((a - b).norm() / b.norm()).item()
    return distance


@torch.no_grad()
def rounding_witness(records, names):
    """Per row, ||kernel - plain|| / ||plain at float32 - plain|| over its
    calls at a bfloat16 point (output 0, the entries its tolerance covers):
    far below 1 when the kernel rounds where its plain version does, about 1
    if it rounded nowhere."""
    ratios = {}
    for name in names:
        if name not in ROUNDING_ROWS or not records[name]:
            continue
        module, plain = KERNELS[name].module, KERNELS[name].plain
        kernel = getattr(module, wrapper_of(name))
        near = far = 0.0
        for args, kwargs in records[name]:
            got = _as_tuple(kernel(*args, **kwargs))[0].float()
            want = _as_tuple(plain(*args, **_plain_kwargs(kwargs)))[0].float()
            f32 = _as_tuple(plain(*at_float32(args, _plain_kwargs(kwargs))[0],
                                  **at_float32(args, _plain_kwargs(kwargs))[1]))[0].float()
            tolerance = KERNELS[name].tolerance
            got, want_r, _ = tolerance(0, got, want, args, (want,))
            f32, _, _ = tolerance(0, f32, want, args, (want,))
            near += float(((got - want_r) ** 2).sum())
            far += float(((f32 - want_r) ** 2).sum())
        ratios[name] = (near / far) ** 0.5 if far else float("inf")
    return ratios


@torch.no_grad()
def float32_beside(records, names):
    """Each row's calls at a bfloat16 point and the same calls at float32
    (the row's float32 instance), each replayed from its own CUDA graph on
    this card: {row: (bf16 device ms, f32 device ms)}."""
    beside = {}
    for name in names:
        counter = wrapper_of(name)
        kernel = getattr(KERNELS[name].module, counter)
        calls = records[name]
        f32_calls = [at_float32(args, kwargs) for args, kwargs in calls]

        def run(batch):
            def go():
                for args, kwargs in batch:
                    kernel(*args, **kwargs)
            return go

        before = cuda.launches[counter]
        run(calls)()
        launches = cuda.launches[counter] - before
        beside[name] = (graph_ms(run(calls), counter, launches),
                        graph_ms(run(f32_calls), counter, launches))
    return beside


def precision_phase(device, launches, report):
    """The precision path (after phase 11): the 3DMatch cell's pair 0 (its
    edge-stream batch and its union batch) and the KITTI cell's pair 0, at
    full width with the phases' trained weights, and the KITTI pair again
    with the cell's untrained seeded weights (create_model's), one forward
    each at the JAX package's default point (JAX_PRECISION: bfloat16 KPConv
    operands, GSE bases and embedding), counted against what the batch
    implies, checked as phase 3 checks a forward and held to the
    force_pallas=False model at the same point (coarse features nearer that
    model than it is to its float32 twin, and on the trained weights within
    PRECISION_FEATURE_BAR of their magnitude); the float32 kernel forward's
    distance from its force_pallas=False twin printed beside them, the
    distances also in relative norm, that norm again with each bfloat16
    row's wrapper plain in turn (where the forwards part), and the
    bfloat16 forward's from the float32 kernel forward (coarse-feature
    relative norm, rotation degrees, translation mm: reported, not bounded);
    each bfloat16 kernel call against its plain version at the same point
    (check_call's bfloat16 rule), with rounding_witness below 0.25 on the
    rows that round, and each row's calls replayed from a CUDA graph beside
    the same calls at float32. Returns the comparisons as paths
    precision_3dmatch, precision_3dmatch_union, precision_kitti and
    precision_kitti_untrained."""
    start = time.perf_counter()
    results, summary = {}, {}
    cfg3, model3, batches3 = SHARED["3dmatch_train"]
    cfgk, modelk, batchesk = SHARED["kitti_train"]
    bar = PRECISION_FEATURE_BAR
    runs = (("3dmatch", cfg3, model3, batches3[0], bar),
            ("3dmatch_union", cfg3, model3, SHARED["3dmatch_union"], bar),
            ("kitti", cfgk, modelk, batchesk[0], bar),
            ("kitti_untrained", cfgk, create_model(cfgk, device=device), batchesk[0], None))
    for path, cfg, f32_model, batch, bar in runs:
        point = dataclasses.replace(cfg, precision=JAX_PRECISION)
        model = create_model(point, device=device)
        model.load_state_dict(f32_model.state_dict())
        plain_model = create_model(point.with_model(force_pallas=False), device=device)
        plain_model.load_state_dict(f32_model.state_dict())
        plain_f32 = create_model(cfg.with_model(force_pallas=False), device=device)
        plain_f32.load_state_dict(f32_model.state_dict())
        blocks = cfg.geotransformer.blocks
        with torch.no_grad():
            forward_ms(model, batch)  # warm-up
            (ms, out), counts = counted(lambda: forward_ms(model, batch))
            expect_launches(counts, [batch], "inference", f"precision {path} forward", blocks)
            launches[f"{path}_precision_inference"] = counts
            check_output(out, cfg, cfg.caps.stage_caps)
            plain_out, plain_f32_out = plain_model(batch), plain_f32(batch)
            rels = compare_coarse_features(out, plain_out, f"precision {path}: the JAX point, "
                                           "kernels vs force_pallas=False",
                                           bar=1.0 if bar is None else bar)
            effect = compare_coarse_features(plain_out, plain_f32_out, f"precision {path}: "
                                             "force_pallas=False, the JAX point vs float32",
                                             bar=1.0)
            for side in rels:
                expect(rels[side] <= effect[side],
                       f"precision {path}: {side}_feats_c {rels[side]:.2e} from the plain "
                       f"route at the JAX point, farther than that route from float32 "
                       f"({effect[side]:.2e})")
            f32_out = f32_model(batch)
            f32_rels = compare_coarse_features(f32_out, plain_f32_out, f"precision {path}: "
                                               "float32, kernels vs force_pallas=False",
                                               bar=1.0)
            # the same two distances in relative norm: a value rounded the
            # other way moves single entries, the point moves every entry
            norms = {"kernels_vs_plain": coarse_norm_distance(out, plain_out),
                     "plain_vs_float32": coarse_norm_distance(plain_out, plain_f32_out)}
            names = [n for n in INFERENCE + ["kpconv_split_fused", "kpconv_union_input_fused"]
                     if expected_launches(batch, "inference", blocks)[n]]
            with capture_kernel_calls(names) as records:
                model(batch)
            # where the kernel and plain forwards part: each bfloat16 row's
            # wrapper plain in turn, the rest kernels, against the plain
            # forward (relative norm)
            one_plain = {}
            for name in sorted(set(names) & set(BF16_ROWS)):
                with plain_wrappers([wrapper_of(name)]):
                    one_plain[name] = coarse_norm_distance(model(batch), plain_out)
        distance = coarse_norm_distance(out, f32_out)
        est, est32 = out["estimated_transform"].double(), f32_out["estimated_transform"].double()
        cos = ((torch.trace(est[:3, :3].T @ est32[:3, :3]) - 1.0) / 2.0).clamp(-1.0, 1.0)
        distance["rotation_deg"] = float(torch.rad2deg(torch.arccos(cos)))
        distance["translation_mm"] = float((est[:3, 3] - est32[:3, 3]).norm() * 1e3)
        for name in set(names) & set(BF16_ROWS):
            expect(all(bf16_call(args, kwargs) for args, kwargs in records[name]),
                   f"precision {path}: a {name} call at the float32 point")
        results[f"precision_{path}"] = compare_kernels(records, names, reps=3,
                                                       stage_of=stages_of(batch))
        witness = rounding_witness(records, names)
        for name, ratio in witness.items():
            expect(ratio <= 0.25, f"precision {path} {name}: |kernel - plain| is {ratio:.3f} of "
                                  "|plain at float32 - plain|: the kernel does not round "
                                  "where its plain version does")
        beside = float32_beside(records, [n for n in names if n in BF16_ROWS])
        print(f"precision {path}: forward {ms:.3f} ms (CUDA events); relative norms at the JAX "
              f"point {json.dumps(norms)}, kernels vs plain with one row plain "
              f"{json.dumps(one_plain)}; bfloat16 vs the float32 "
              f"kernel forward {json.dumps(distance)}; rounding witness "
              f"{json.dumps({k: round(v, 5) for k, v in witness.items()})}; device ms "
              f"bfloat16 / float32 (graph) "
              f"{json.dumps({k: [round(v[0], 4), round(v[1], 4)] for k, v in beside.items()})}",
              flush=True)
        summary[path] = dict(forward_ms=ms, vs_plain=rels, plain_effect=effect,
                             float32_vs_plain=f32_rels, norms=norms, one_plain=one_plain,
                             vs_float32=distance,
                             witness=witness, beside=beside)
    seconds = time.perf_counter() - start
    print(f"precision path: {seconds:.1f} s", flush=True)
    report["precision"] = dict(summary, seconds=seconds)
    return results


# every knob bfloat16: the JAX point and the bfloat16 gathered table
TABLE_POINT = dataclasses.replace(JAX_PRECISION, kpconv_table="bfloat16")
PRECISION_TRAIN_STEPS = 2


def precision_train_phase(device, launches, report):
    """Training at the JAX point (after the precision path): the 3DMatch
    cell's pair 0 with its inverse tables and the KITTI cell's pair 0 with
    its split inverse tables at JAX_PRECISION, and the 3DMatch pair again at
    TABLE_POINT (kpconv_table too; the pair padded at the point's 16
    columns, one forward first), each on the phases' trained weights:
    PRECISION_TRAIN_STEPS make_train_step steps counted against what the
    batch implies (finite losses, no step skipped); each training kernel's
    calls of one step (and the table point's forward kernels) against
    their plain versions at the same point, rounding_witness below 0.25 on
    the rows that round, each row's bfloat16 calls replayed beside the same
    calls at float32; the kernel step's gradients nearer the
    force_pallas=False step at the same point than that step is to the
    float32 plain step (relative norm; each tensor reported). Returns
    paths precision_3dmatch_train, precision_kitti_train and
    precision_table."""
    start = time.perf_counter()
    results, summary = {}, {}
    cfg3, model3, batches3 = SHARED["3dmatch_train"]
    cfgk, modelk, batchesk = SHARED["kitti_train"]
    pyramid, n, transform = SHARED["3dmatch"][0]
    table_batch = batch_to_torch(pad_registration_batch(
        pyramid, np.ones((n, 1), np.float32), transform, cfg3.caps.stage_caps,
        inverse_limits=cfg3.caps.inverse_limits, align=table_align(TABLE_POINT)), device)
    table_batch.update(precompute_gt_targets(cfg3, table_batch, device=device))
    runs = (("3dmatch_train", cfg3, JAX_PRECISION, model3, batches3[0]),
            ("kitti_train", cfgk, JAX_PRECISION, modelk, batchesk[0]),
            ("table", cfg3, TABLE_POINT, model3, table_batch))
    for path, cfg, precision, trained, batch in runs:
        point = dataclasses.replace(cfg, precision=precision)
        blocks = cfg.geotransformer.blocks
        models = {}
        for route, model_cfg in (("kernel", point), ("plain", point.with_model(force_pallas=False)),
                                 ("plain_f32", cfg.with_model(force_pallas=False))):
            models[route] = create_model(model_cfg, device=device)
            models[route].load_state_dict(trained.state_dict())
        model = models["kernel"]
        # without precomputed targets (KITTI) every route takes its GT
        # overlaps from row 11, which is exact: the same targets
        names = list(TRAINING) + (["patch_overlaps"] if "gt_cand_indices" not in batch else [])
        step_names = list(names)
        records = {}
        if path == "table":
            # the table point's forward instances (rows 1 and 5 round the
            # gathered features and pool values), counted
            forward = [name for name in INFERENCE + ["kpconv_split_fused"]
                       if expected_launches(batch, "inference", blocks)[name]]
            with torch.no_grad():
                (ms, out), counts = counted(lambda: forward_ms(model, batch))
                expect_launches(counts, [batch], "inference", "precision table forward", blocks)
                launches["table_precision_inference"] = counts
                check_output(out, cfg, cfg.caps.stage_caps)
                compare_coarse_features(out, models["plain"](batch), "precision table: the "
                                        "table point, kernels vs force_pallas=False")
                with capture_kernel_calls(forward) as forward_records:
                    model(batch)
            records.update(forward_records)
            names = forward + names
        with capture_kernel_calls(step_names) as step_records:
            loss, grads = step_gradients(model, point, batch, 0)
        records.update(step_records)
        _, grads_plain = step_gradients(models["plain"], point, batch, 0)
        _, grads_f32 = step_gradients(models["plain_f32"], cfg, batch, 0)
        near, per_near = relative_errors(grads, grads_plain)
        far, per_far = relative_errors(grads_plain, grads_f32)
        expect(near <= far, f"precision {path}: the kernel step is {near:.2e} from the plain "
                            f"step at its point, farther than that step from float32 "
                            f"({far:.2e})")
        optimizer, scheduler = make_optimizer(model, point, steps_per_epoch=1)
        step = make_train_step(model, point, optimizer, scheduler, device=DEVICE)
        losses, total = [], collections.Counter()
        for i in range(PRECISION_TRAIN_STEPS):
            metrics, counts = counted(lambda: step(batch, target_generator(SEEDS[i])))
            total.update(counts)
            expect_launches(counts, [batch], "train", f"precision {path} step {i}", blocks)
            expect(metrics["grad_finite"].item() == 1.0,
                   f"precision {path} step {i} skipped by the guard")
            losses.append(metrics["loss"].item())
            expect(np.isfinite(losses[-1]), f"precision {path} step {i}: loss {losses[-1]}")
        launches[f"{path.removesuffix('_train')}_precision_train"] = dict(total)
        results[f"precision_{path}"] = compare_kernels(records, names, reps=3,
                                                       stage_of=stages_of(batch))
        witness = rounding_witness(records, names)
        for name, ratio in witness.items():
            expect(ratio <= 0.25, f"precision {path} {name}: |kernel - plain| is {ratio:.3f} of "
                                  "|plain at float32 - plain|: the kernel does not round "
                                  "where its plain version does")
        beside = float32_beside(records, [n for n in names if any(
            bf16_call(args, kwargs) for args, kwargs in records[n])])
        worst = sorted(per_near, key=lambda k: -per_near[k] / max(per_far[k], 1e-30))[:5]
        print(f"precision {path}: loss {loss:.6f}, steps {[round(x, 6) for x in losses]}; "
              f"gradients kernel vs plain at the point {near:.3e}, plain at the point vs "
              f"float32 {far:.3e} (relative norm, whole step); the five tensors nearest their "
              f"plain-vs-float32 distance (kernel vs plain, plain vs float32; every tensor "
              f"in chip_smoke.json) "
              f"{json.dumps({k: [float(f'{per_near[k]:.3e}'), float(f'{per_far[k]:.3e}')] for k in worst})}; "
              f"rounding witness {json.dumps({k: round(v, 5) for k, v in witness.items()})}; "
              f"device ms bfloat16 / float32 (graph) "
              f"{json.dumps({k: [round(v[0], 4), round(v[1], 4)] for k, v in beside.items()})}",
              flush=True)
        summary[path] = dict(loss=loss, step_losses=losses, kernel_vs_plain=near,
                             plain_vs_float32=far,
                             per_tensor={k: (per_near[k], per_far[k]) for k in per_near},
                             witness=witness, beside=beside)
        del models, model, step, optimizer
    seconds = time.perf_counter() - start
    print(f"precision training: {seconds:.1f} s", flush=True)
    report["precision"].update(summary)
    report["precision"]["train_seconds"] = seconds
    return results


def make_modelnet_entry(rng, num_points=MODELNET_POINTS):
    """A ModelNet-style pickle entry: ``num_points`` points with normals on
    the surfaces of two to four random boxes and z-axis cylinders, a label
    from the asymmetric classes."""
    points, normals = [], []
    for _ in range(int(rng.integers(2, 5))):
        center, size, n = rng.uniform(-0.5, 0.5, 3), rng.uniform(0.2, 0.8, 3), num_points
        if rng.uniform() < 0.5:  # box: a face per point, uniform on it
            face, side = rng.integers(0, 3, n), rng.choice([-1.0, 1.0], n)
            p = rng.uniform(-0.5, 0.5, (n, 3)) * size
            p[np.arange(n), face] = 0.5 * side * size[face]
            q = np.zeros((n, 3))
            q[np.arange(n), face] = side
        else:  # cylinder: the wall and the two caps
            radius, height = 0.5 * size[0], size[2]
            theta = rng.uniform(0.0, 2 * np.pi, n)
            wall = rng.uniform(size=n) < 0.7
            r = np.where(wall, radius, radius * np.sqrt(rng.uniform(size=n)))
            z = np.where(wall, rng.uniform(-0.5, 0.5, n), rng.choice([-0.5, 0.5], n)) * height
            p = np.stack([r * np.cos(theta), r * np.sin(theta), z], 1)
            radial = np.stack([np.cos(theta), np.sin(theta), np.zeros(n)], 1)
            axial = np.stack([np.zeros(n), np.zeros(n), np.sign(z)], 1)
            q = np.where(wall[:, None], radial, axial)
        points.append(p + center)
        normals.append(q)
    points, normals = np.concatenate(points), np.concatenate(normals)
    sel = rng.choice(len(points), num_points, replace=False)
    return dict(points=points[sel].astype(np.float32), normals=normals[sel].astype(np.float32),
                label=int(rng.choice(ASYMMETRIC_INDICES)))


def write_modelnet_pickle(root, seed=MODELNET_SEED):
    rng = np.random.default_rng(seed)
    data = [make_modelnet_entry(rng) for _ in range(MODELNET_ENTRIES)]
    os.makedirs(root, exist_ok=True)
    for subset in ("train", "val", "test"):
        with open(os.path.join(root, f"{subset}.pkl"), "wb") as f:
            pickle.dump(data, f)


def modelnet_dataset_and_caps(cfg, tmp):
    """Phase 12: the synthetic pickle read by ModelNetPairDataset at the
    reference settings; the config's caps if every pair fits them, else
    capacities calibrated over the pairs."""
    root = os.path.join(tmp, "ModelNet")
    write_modelnet_pickle(root)
    SHARED["modelnet_root"] = root
    dataset = ModelNetPairDataset(root, "train", num_points=717, rotation_magnitude=45.0,
                                  translation_magnitude=0.5, noise_magnitude=0.05,
                                  keep_ratio=0.7, twice_sample=True, deterministic=True)
    samples = [dataset[i] for i in range(len(dataset))]
    bb = cfg.backbone
    args = (bb.num_stages, bb.init_voxel_size, bb.init_radius, list(cfg.caps.neighbor_limits))
    stages = stage_sizes(build_pyramids(
        cfg, [(s["ref_points"], s["src_points"], s["transform"]) for s in samples]))
    caps = tuple(cfg.caps.stage_caps)
    fits = all(max(pair[i]) <= caps[i] for pair in stages for i in range(len(caps)))
    if not fits:
        calibrated = tuple(calibrate_stage_caps(iter(samples), *args, num_samples=len(samples)))
        print(f"modelnet: the pairs outgrow the config's caps {caps}: calibrated {calibrated}",
              flush=True)
        caps = calibrated
    print(f"modelnet batch: {len(samples)} pairs of 717 points (labels "
          f"{[s['label'] for s in samples]}); stages {stages}; caps {caps} "
          f"({'the config' if fits else 'calibrated'})", flush=True)
    return dataset, samples, caps, stages, fits


def counting_step(step, cfg, what, counts):
    """``step`` with each call's launches counted and checked."""
    def run(batch, generator=None):
        metrics, c = counted(lambda: step(batch, generator))
        expect_launches(c, [batch], "train", f"{what} step", cfg.geotransformer.blocks)
        counts.update(c)
        return metrics
    return run


def modelnet_phases(device, launches, report, tmp):
    """Phases 12-14: the ModelNet dataset, forward, iteration training with
    a checkpoint restored, and eval. Returns each kernel's comparison with
    its plain version on this path ("modelnet") and patch_overlaps' on an
    eval step ("modelnet_eval")."""
    cfg = make_modelnet_config()
    dataset, samples, caps, stages, fits = modelnet_dataset_and_caps(cfg, tmp)
    cfg = cfg.with_caps(stage_caps=caps)
    bb = cfg.backbone
    pipeline = dict(num_stages=bb.num_stages, voxel_size=bb.init_voxel_size,
                    search_radius=bb.init_radius, neighbor_limits=cfg.caps.neighbor_limits,
                    stage_caps=caps, input_dim=bb.input_dim)
    report["modelnet_batches"] = dict(stages=stages, caps=caps, config_caps=fits)

    # 13. forward through the dataset's pairs
    batches_np = []
    for seed in SEEDS:
        batch = prepare_pair(samples[seed], **pipeline)
        batch.pop("meta")
        batches_np.append(batch)
    batches = [batch_to_torch(b, device) for b in batches_np]
    model = create_model(cfg, device=device)
    outs, times, launches["modelnet_inference"] = register_pairs(
        model, cfg, caps, batches, batches_np, SEEDS, "modelnet")
    report["modelnet_forward_ms"] = times
    blocks = cfg.geotransformer.blocks
    forward = [name for name in INFERENCE
               if expected_launches(batches[0], "inference", blocks)[name]]
    with capture_kernel_calls(forward) as records:
        model(batches[0])
    results = compare_kernels(records, forward, reps=10, stage_of=stages_of(batches[0]))
    plain_model = create_model(cfg.with_model(force_pallas=False), device=device)
    plain_model.load_state_dict(model.state_dict())
    forward_ms(plain_model, batches[0])
    plain_times = [forward_ms(plain_model, batch)[0] for batch in batches]
    compare_coarse_features(outs[-1], plain_model(batches[-1]),
                            "modelnet whole model vs force_pallas=False")
    print(f"modelnet plain forward: {statistics.median(plain_times):.3f} ms per pair (median of "
          f"{plain_times})", flush=True)
    report["modelnet_plain_forward_ms"] = plain_times

    # 14. Trainer.run_iterations over a PairLoader (2 workers, targets
    # precomputed there), a checkpoint at step MODELNET_SNAPSHOT restored
    train_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, max_iteration=MODELNET_ITERATIONS, warmup_steps=MODELNET_WARMUP,
        snapshot_steps=MODELNET_SNAPSHOT))
    train_pipeline = dict(pipeline, inverse_limits=cfg.caps.inverse_limits,
                          precompute_targets=True, model_cfg=train_cfg)
    loader = PairLoader(dataset, train_pipeline, shuffle=True, num_workers=2, seed=0)
    run_dir = os.path.join(tmp, "modelnet_run")
    schedule = make_lr_schedule(train_cfg, steps_per_epoch=len(loader))
    try:
        trainer = Trainer(train_cfg, model, loader, output_dir=run_dir, log_steps=4,
                          device=DEVICE)
        counts = collections.Counter()
        trainer.train_step = counting_step(trainer.train_step, train_cfg, "modelnet train",
                                           counts)
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        trainer.run_iterations()
        wall = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated()
        history = trainer.history
        expect([h["step"] for h in history] == list(range(1, MODELNET_ITERATIONS + 1)),
               f"modelnet train: steps {[h['step'] for h in history]}")
        for i, h in enumerate(history):
            expect(h["grad_finite"] == 1.0, f"modelnet train step {h['step']} skipped")
            expect(np.isfinite(h["loss"]), f"modelnet train step {h['step']}: loss {h['loss']}")
            expect(abs(h["lr"] - schedule(i)) <= 1e-12 * schedule(i),
                   f"modelnet train step {h['step']}: lr {h['lr']}, schedule {schedule(i)}")
        expect(trainer.checkpoints.all_steps() == [MODELNET_SNAPSHOT, MODELNET_ITERATIONS],
               f"modelnet checkpoints {trainer.checkpoints.all_steps()}")
        step_ms = [1e3 * h["process_s"] for h in history]
        median = statistics.median(step_ms)
        print(f"modelnet train: {MODELNET_ITERATIONS} iterations (warmup {MODELNET_WARMUP}), "
              f"losses {[round(h['loss'], 4) for h in history]}, lr "
              f"{[round(h['lr'], 9) for h in history]}; {median:.3f} ms per step (median "
              f"of {[round(t, 2) for t in step_ms]}, CUDA events); {wall:.1f} s wall with the "
              f"loader; peak memory {peak / 2**30:.2f} GiB", flush=True)

        # the checkpoint at MODELNET_SNAPSHOT restored into a fresh model
        restored = Trainer(train_cfg, create_model(train_cfg, seed=train_cfg.seed + 1,
                                                   device=device),
                           loader, output_dir=run_dir, log_steps=4, device=DEVICE)
        restored.train_step = counting_step(restored.train_step, train_cfg,
                                            "modelnet resumed train", counts)
        expect(restored.resume(step=MODELNET_SNAPSHOT), "modelnet: no checkpoint to restore")
        lr = restored.scheduler.get_last_lr()[0]
        expect(restored.step == MODELNET_SNAPSHOT and restored.epoch == 1
               and abs(lr - schedule(MODELNET_SNAPSHOT)) <= 1e-12 * lr,
               f"modelnet restore: step {restored.step}, epoch {restored.epoch}, lr {lr}")
        restored.run_iterations()
        again = restored.history
        rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                  for a, b in zip(again, history[MODELNET_SNAPSHOT:]))
        expect(len(again) == MODELNET_ITERATIONS - MODELNET_SNAPSHOT and rel <= 1e-3,
               f"modelnet restore: steps {[h['step'] for h in again]}, loss rel diff {rel}")
        print(f"modelnet restore: checkpoint {MODELNET_SNAPSHOT} into a fresh model, steps "
              f"{[h['step'] for h in again]} repeat the run's losses to {rel:.2e}", flush=True)
        launches["modelnet_train"] = dict(counts)
        report["modelnet_train"] = dict(
            losses=[h["loss"] for h in history], lr=[h["lr"] for h in history],
            step_ms=step_ms, step_median_ms=median, peak_bytes=peak, wall_s=wall,
            restored_losses=[h["loss"] for h in again], restored_loss_rel=rel)

        # training kernels of one step vs plain; the whole step
        batch = prepare_pair(samples[0], **train_pipeline)
        batch.pop("meta")
        batch = batch_to_torch(batch, device)
        with capture_kernel_calls(TRAINING) as records:
            step_gradients(trainer.model, train_cfg, batch, 0)
        results.update(compare_kernels(records, TRAINING, reps=5, stage_of=stages_of(batch)))
        whole_step_vs_plain(trainer.model, plain_model, train_cfg, batch,
                            "modelnet_step_vs_plain", report)
    finally:
        loader.close()

    # one eval step a pair (GT overlaps in the step: patch_overlaps)
    evaluate = make_eval_step(trainer.model, cfg, device=DEVICE)
    counts, metrics = collections.Counter(), []
    for batch, seed in zip(batches, SEEDS):
        m, c = counted(lambda: evaluate(batch))
        counts.update(c)
        expect(all(bool(torch.isfinite(v)) for v in m.values()), f"modelnet eval {seed}: {m}")
        metrics.append({k: float(v) for k, v in m.items()})
    expect_launches(counts, batches, "eval", "modelnet eval", blocks)
    launches["modelnet_eval"] = dict(counts)
    print(f"modelnet eval: {[{k: round(v, 4) for k, v in m.items()} for m in metrics]}",
          flush=True)
    report["modelnet_eval"] = metrics
    with capture_kernel_calls(["patch_overlaps"]) as records:
        evaluate(batches[0])
    return {"modelnet": results,
            "modelnet_eval": compare_kernels(records, ["patch_overlaps"], reps=5)}

# --- phase 16: the synthetic 3DMatch-protocol workflow -------------------
SYNTHETIC_TRAIN_KERNELS = ["kpconv_fused (input residuals)", "kpconv_bwd_fused", "gse_full_bwd",
                           "sinkhorn_fwd_train", "sinkhorn_bwd_train", "patch_overlaps"]
SYNTHETIC_TEST_KERNELS = ["kpconv_fused", "gse_embedding_full", "rpe_pair_scores",
                          "fused_masked_attention", "sinkhorn_log_iterations", "patch_overlaps"]


def write_threedmatch_layout(root, test_set, benchmark="3DMatch"):
    """The test set's fragments in the 3DMatch layout ThreeDMatchPairDataset
    reads: data/<scene>/cloud_<i>.pth (numpy arrays saved with torch.save)
    and metadata/<benchmark>.pkl, an entry a pair with its GT rotation and
    translation."""
    for scene in test_set.scenes:
        os.makedirs(os.path.join(root, "data", scene["name"]), exist_ok=True)
        for i, fragment in enumerate(scene["fragments"]):
            torch.save(fragment, os.path.join(root, "data", scene["name"], f"cloud_{i}.pth"))
    metadata = []
    for pair in test_set.pairs:
        name = test_set.scenes[pair["scene"]]["name"]
        i, j = pair["ref_frame"], pair["src_frame"]
        transform = test_set.gt_transform(pair["scene"], i, j)
        metadata.append(dict(scene_name=name, frag_id0=i, frag_id1=j, overlap=pair["overlap"],
                             rotation=transform[:3, :3], translation=transform[:3, 3],
                             pcd0=f"{name}/cloud_{i}.pth", pcd1=f"{name}/cloud_{j}.pth"))
    os.makedirs(os.path.join(root, "metadata"), exist_ok=True)
    with open(os.path.join(root, "metadata", f"{benchmark}.pkl"), "wb") as f:
        pickle.dump(metadata, f)


def counting_forward(forward, blocks, counts, stamps):
    """A Tester's ``_forward`` with each pair's launches counted and checked
    (an eval forward: GT overlaps in the forward, patch_overlaps), and the
    wall clock at each call in ``stamps``."""
    def run(batch):
        stamps.append(time.perf_counter())
        result, c = counted(lambda: forward(batch))
        expect_launches(c, [batch], "eval", "synthetic test pair", blocks)
        counts.update(c)
        return result
    return run


def run_script(cmd, env, what):
    """Run one of the port's scripts in a process of its own; its output."""
    start = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=600)
    expect(res.returncode == 0, f"{what}: exit {res.returncode}\n{res.stdout[-2000:]}\n"
                                f"{res.stderr[-4000:]}")
    return res.stdout, time.perf_counter() - start


def dumped_transforms(feature_dir):
    """{(scene, file): estimated_transform} of a Tester's npz dumps."""
    out = {}
    for scene in sorted(os.listdir(feature_dir)):
        for name in sorted(os.listdir(os.path.join(feature_dir, scene))):
            with np.load(os.path.join(feature_dir, scene, name)) as data:
                out[(scene, name)] = data["estimated_transform"]
    return out


def synthetic_phases(device, launches, report, tmp):
    """Phase 16: the synthetic 3DMatch-protocol workflow of
    scripts/synthetic_benchmark.py at full scale: the scenes and protocol
    files, the calibrated caps, one epoch through Trainer.run over a
    PairLoader (2 spawned workers), the Tester on the test pairs, the
    evaluator in a process of its own, then the test fragments in the
    3DMatch layout (eval.sh runs scripts.test and scripts.eval on them in
    phase 20c). Returns each kernel's
    comparison with its plain version on the inputs of one training step
    ("synthetic_train") and one Tester forward ("synthetic_test")."""
    phase_start = time.perf_counter()
    out = os.path.join(tmp, "synthetic")
    start = time.perf_counter()
    cfg, train_set, test_set = synthetic.build_sets("full")
    expect(len(train_set) == SYNTHETIC_TRAIN_PAIRS and len(test_set) == SYNTHETIC_TEST_PAIRS,
           f"synthetic: {len(train_set)} training and {len(test_set)} test pairs")
    scenes_s = time.perf_counter() - start
    benchmark_root = os.path.join(out, "benchmark")
    test_set.write_benchmark(benchmark_root)
    start = time.perf_counter()
    cfg = synthetic.calibrate(cfg, train_set, test_set)
    calibrate_s = time.perf_counter() - start
    caps = cfg.caps.stage_caps
    train_pipeline, test_pipeline = synthetic.pipelines(cfg)
    SHARED["synthetic"] = dict(cfg=cfg, train_set=train_set, test_set=test_set,
                               train_pipeline=train_pipeline, test_pipeline=test_pipeline)
    # the one cut: one epoch of the first SYNTHETIC_EPOCH_PAIRS pairs
    epoch_set = torch.utils.data.Subset(train_set, range(SYNTHETIC_EPOCH_PAIRS))
    cfg = synthetic.training_config(cfg, steps=len(epoch_set), train_pairs=len(epoch_set))
    blocks = cfg.geotransformer.blocks
    print(f"synthetic: {len(train_set)} training and {len(test_set)} test pairs in "
          f"{scenes_s:.1f} s; caps {caps} calibrated over "
          f"{synthetic.CALIBRATION_TRAIN_PAIRS} training pairs and every test pair in "
          f"{calibrate_s:.1f} s; one epoch of {len(epoch_set)} steps at lr {cfg.optim.lr}",
          flush=True)

    model = create_model(cfg, device=device)
    loader = PairLoader(epoch_set, train_pipeline, shuffle=True, num_workers=2, seed=cfg.seed)
    test_loader = PairLoader(test_set, test_pipeline, num_workers=2)
    feature_dir = os.path.join(out, "features")
    try:
        # 2. one epoch through Trainer.run, every step counted
        trainer = Trainer(cfg, model, loader, output_dir=os.path.join(out, "train"),
                          log_steps=26, device=DEVICE)
        counts = collections.Counter()
        trainer.train_step = counting_step(trainer.train_step, cfg, "synthetic train", counts)
        trainer.initialize()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with count_input_residuals():
            trainer.run()
        train_wall = time.perf_counter() - start
        peak = torch.cuda.max_memory_allocated()
        history = trainer.history
        expect([h["step"] for h in history] == list(range(1, len(epoch_set) + 1)),
               f"synthetic train: steps {[h['step'] for h in history]}")
        for h in history:
            expect(h["grad_finite"] == 1.0, f"synthetic train step {h['step']} skipped")
            expect(np.isfinite(h["loss"]), f"synthetic train step {h['step']}: loss {h['loss']}")
        expect(trainer.checkpoints.all_steps() == [1],
               f"synthetic checkpoints {trainer.checkpoints.all_steps()}")
        launches["synthetic_train"] = dict(counts)
        step_ms = [1e3 * h["process_s"] for h in history]
        losses = [h["loss"] for h in history]
        print(f"synthetic train: {len(history)} steps, loss {losses[0]:.4f} -> {losses[-1]:.4f} "
              f"(mean of the last 26 {statistics.mean(losses[-26:]):.4f}); "
              f"{statistics.median(step_ms):.3f} ms per step (median, CUDA events; min "
              f"{min(step_ms):.3f}, max {max(step_ms):.3f}); {train_wall:.1f} s wall with the "
              f"loader; peak memory {peak / 2**30:.2f} GiB", flush=True)

        # 3. the Tester on the test pairs with the trained weights
        tester = Tester(cfg, model, test_loader, output_dir=os.path.join(out, "test"),
                        feature_dir=feature_dir, device=DEVICE)
        test_counts = collections.Counter()
        stamps = []
        tester._forward = counting_forward(tester._forward, blocks, test_counts, stamps)
        start = time.perf_counter()
        summary, results = tester.run()
        test_wall = time.perf_counter() - start
        pair_ms = [1e3 * t for t in tester.timer.process_times()]
    finally:
        loader.close()
        test_loader.close()
    expect(len(results) == len(test_set), f"synthetic test: {len(results)} pairs")
    expect(all(np.isfinite(v) for v in summary.values()), f"synthetic test: {summary}")
    launches["synthetic_test"] = dict(test_counts)
    transforms = dumped_transforms(feature_dir)
    expect(len(transforms) == len(test_set), f"synthetic test: {len(transforms)} dumps")
    worst_ortho = 0.0
    for key, est in transforms.items():
        rot = est[:3, :3].astype(np.float64)
        ortho = float(np.abs(rot @ rot.T - np.eye(3)).max())
        expect(np.isfinite(est).all() and ortho < 1e-3 and abs(np.linalg.det(rot) - 1) < 1e-3,
               f"synthetic test {key}: the estimated R is not a rotation ({est})")
        worst_ortho = max(worst_ortho, ortho)
    print(f"synthetic test: {len(results)} pairs, "
          f"{ {k: round(v, 4) for k, v in summary.items()} }; "
          f"{statistics.median(pair_ms):.3f} ms a pair (median, CUDA events; min "
          f"{min(pair_ms):.3f}, max {max(pair_ms):.3f}); {test_wall:.1f} s wall with the loader "
          f"({stamps[0] - start:.1f} s to the first pair: the 2 workers' start and its pyramid; "
          f"{test_wall - stamps[0] + start:.1f} s for the {len(test_set)} pairs); every R a "
          f"rotation (|R R^T - I| <= {worst_ortho:.1e})", flush=True)

    # 4. the evaluator in a process of its own
    cmd, env = synthetic.eval_command(feature_dir, benchmark_root,
                                      os.path.join(out, "registration"), DEVICE)
    table, eval_s = run_script(cmd, env, "scripts.eval")
    print(f"synthetic eval (scripts.eval --method lgr, {eval_s:.1f} s; weights after "
          f"{len(history)} steps: an RR of the pipeline, not of a trained model):\n"
          f"{table.rstrip()}", flush=True)

    # 5. the fragments in the 3DMatch layout, for scripts.test: eval.sh runs
    # it and scripts.eval on them in phase 20c, held to the Tester's dumps
    data_root = os.path.join(out, "3DMatch")
    write_threedmatch_layout(data_root, test_set)
    SHARED["synthetic"].update(data_root=data_root, benchmark_root=benchmark_root,
                               feature_dir=feature_dir, eval_table=table)

    # 6. kernels vs plain on one training step and one Tester forward
    results = synthetic_kernels(model, cfg, train_set[0], test_set[0], train_pipeline,
                                test_pipeline, device)
    wall = time.perf_counter() - phase_start
    print(f"synthetic workflow: {wall:.1f} s wall", flush=True)
    report["synthetic"] = dict(
        pairs=[len(train_set), len(test_set)], caps=caps, scenes_s=scenes_s,
        calibrate_s=calibrate_s, train_losses=losses, train_step_ms=step_ms,
        train_wall_s=train_wall, train_peak_bytes=peak, test_summary=summary,
        test_pair_ms=pair_ms, test_wall_s=test_wall, eval_table=table, wall_s=wall)
    return results


def synthetic_kernels(model, cfg, train_sample, test_sample, train_pipeline, test_pipeline,
                      device):
    """Each kernel of the workflow vs its plain version: the training ones
    on the inputs of one training step ("synthetic_train": the input conv's
    training call, the backward kernels, the training Sinkhorn and the
    in-step GT overlaps), the forward ones on one Tester forward
    ("synthetic_test")."""
    results = {}
    for path, sample, pipeline, names in (
            ("synthetic_train", train_sample, train_pipeline, SYNTHETIC_TRAIN_KERNELS),
            ("synthetic_test", test_sample, test_pipeline, SYNTHETIC_TEST_KERNELS)):
        batch = prepare_pair(sample, **pipeline)
        batch.pop("meta")
        batch = batch_to_torch(batch, device)
        with capture_kernel_calls(names) as records:
            if path == "synthetic_train":
                step_gradients(model, cfg, batch, 0)
            else:
                model.eval()
                with torch.no_grad():
                    model(batch, training=False, with_gt=True)
        results[path] = compare_kernels(records, names, reps=5, stage_of=stages_of(batch))
    return results


# --- phase 17: the device pyramid -----------------------------------------

def pyramid_spec(cfg, caps, knn_cand_cap):
    """build_pyramid_device's keywords for ``cfg`` at symmetric ``caps``, with
    the training batches' inverse tables."""
    bb = cfg.backbone
    return dict(num_stages=bb.num_stages, voxel_size=bb.init_voxel_size, radius=bb.init_radius,
                neighbor_limits=tuple(cfg.caps.neighbor_limits), stage_caps=tuple(caps),
                inverse_limits=tuple(cfg.caps.inverse_limits), knn_cand_cap=knn_cand_cap)


def raw_inputs(pyramid, transform, cap0, device):
    """A host pyramid's stage 0 (the raw pair) laid into the stage-0 frame, on
    ``device``."""
    pts, lens, feats = pad_stage0(pyramid["points"][0], pyramid["lengths"][0], cap0)
    return [torch.from_numpy(a).to(device) for a in (pts, lens, feats, transform)]


def pyramid_launches(num_stages, builds=1):
    """The pyramid kernels' launches of ``builds`` device builds: a subsample a
    stage past 0, a search for each neighbor, subsampling and upsampling
    table (both clouds in one launch each)."""
    return collections.Counter(voxel_segment_mean=builds * (num_stages - 1),
                               grid_radius_search=builds * (3 * num_stages - 2))


def expect_raw_launches(got, cfg, mode, what, builds, ran):
    """A raw-mode run's launches: ``builds`` device builds, then, when the
    last was not an overflow (``ran``), one forward ("eval") or training step
    ("train") on the built batch (an edge stream, inverse tables, no split
    tables, no precomputed targets)."""
    want = pyramid_launches(cfg.backbone.num_stages, builds)
    if ran:
        stub = {"points": [None] * cfg.backbone.num_stages, "input_stream": True,
                "neighbors_inv": True}
        want.update(expected_launches(stub, mode, cfg.geotransformer.blocks))
    for name in KERNELS:
        expect(got.get(name, 0) == want.get(name, 0),
               f"{what}: {name} launched {got.get(name, 0)} times, expected {want.get(name, 0)}")


def table_ties(got, want, q_points, s_points, sentinel, radius, atol):
    """The rows where two (rows, K) tables differ, each held to be a tie: the
    sorted distances of its entries (from ``s_points``, in float64) agree
    within ``atol``, and an entry on one side only lies within ``atol`` of the
    radius. Returns the rows."""
    rows = np.nonzero(~np.all(got == want, axis=1))[0]
    for i in rows:
        dists = []
        for table in (got, want):
            idx = table[i][table[i] != sentinel]
            dists.append(np.sort(np.linalg.norm(s_points[idx].astype(np.float64)
                                                - q_points[i].astype(np.float64), axis=1)))
        n = min(len(dists[0]), len(dists[1]))
        extra = np.concatenate([dists[0][n:], dists[1][n:]])
        expect(np.all(np.abs(dists[0][:n] - dists[1][:n]) <= atol)
               and np.all(np.abs(extra - radius) <= atol),
               f"row {i}: {got[i].tolist()} vs {want[i].tolist()} is not a distance tie "
               f"(distances {dists[0].tolist()} vs {dists[1].tolist()}, radius {radius})")
    return rows


def compare_with_host(path, built, host, spec):
    """The device pyramid against the host's at the same caps: lengths and
    masks exact; points within 1e-4; each table row for row but distance
    ties (at most 5 % of a table's rows); the inverse tables row for
    row but the supports a tied forward row names; the edge stream on the
    rows whose stage-0 row is not tied. A stage whose float32 voxel count
    differs from the host's float64 one (a point on a voxel boundary) is
    printed with the first point that moved, and only the stages below it
    are compared. Returns (stages compared, tie rows by table)."""
    stages = spec["num_stages"]
    caps, radius = spec["stage_caps"], spec["radius"]
    lengths = [l.cpu().numpy() for l in built["lengths"]]
    good = stages
    for i in range(stages):
        if not np.array_equal(lengths[i], host["lengths"][i]):
            good = i
            got, want = built["points"][i].cpu().numpy(), host["points"][i]
            moved = np.nonzero(np.abs(got - want).max(axis=1) > 1e-4)[0]
            row = int(moved[0]) if len(moved) else -1
            print(f"{path}: stage {i} voxel count {lengths[i].tolist()} on the card vs "
                  f"{host['lengths'][i].tolist()} on the host (float32 vs float64 voxel keys); "
                  f"first moved point row {row}: {got[row].tolist()} vs {want[row].tolist()}; "
                  f"stages {i}-{stages - 1} not compared", flush=True)
            break
    points = [p.cpu().numpy() for p in built["points"]]
    scale = max(float(np.abs(p[m]).max()) for p, m in zip(points, host["masks"]) if m.any())
    ties = {}
    for i in range(good):
        expect(np.array_equal(built["masks"][i].cpu().numpy(), host["masks"][i]),
               f"{path}: stage {i} masks differ")
        diff = np.abs(points[i] - host["points"][i]).max()
        expect(diff <= 1e-4, f"{path}: stage {i} points differ by {diff}")
    for key, q_of, s_of, r_of in (
            ("neighbors", lambda i: i, lambda i: i, lambda i: radius * 2 ** i),
            ("subsampling", lambda i: i + 1, lambda i: i, lambda i: radius * 2 ** i),
            ("upsampling", lambda i: i, lambda i: i + 1, lambda i: radius * 2 ** (i + 1))):
        for i in range(len(host[key])):
            if max(q_of(i), s_of(i)) >= good:
                continue
            got, want = built[key][i].cpu().numpy(), host[key][i]
            expect(got.shape == want.shape, f"{path}: {key}[{i}] {got.shape} vs {want.shape}")
            # distances within twice a coordinate's float32 rounding of the
            # host's float64 voxel means, and a few ulp of the radius
            atol = 8 * np.finfo(np.float32).eps * (scale + r_of(i))
            rows = table_ties(got, want, points[q_of(i)], points[s_of(i)], 2 * caps[s_of(i)],
                              r_of(i), atol)
            # at most 5 % of the table's rows, as the JAX package's test
            # (tests/test_device_preprocess.py:197-205)
            expect(len(rows) <= 0.05 * got.shape[0],
                   f"{path}: {key}[{i}] {len(rows)} tie rows of {got.shape[0]}")
            ties[f"{key}[{i}]"] = len(rows)
            inv_key = {"neighbors": "neighbors_inv", "subsampling": "subsampling_inv"}.get(key)
            if inv_key is not None:
                named = np.unique(np.concatenate([got[rows].ravel(), want[rows].ravel()]))
                keep = np.ones(host[inv_key][i].shape[0], bool)
                keep[named[named < keep.shape[0]]] = False
                expect(np.array_equal(built[inv_key][i].cpu().numpy()[keep],
                                      host[inv_key][i][keep]),
                       f"{path}: {inv_key}[{i}] differs off the tied rows")
            if key == "neighbors" and i == 0:
                untied = np.ones(got.shape[0], bool)
                untied[rows] = False
                expect(np.array_equal(built["input_stream"].cpu().numpy()[:, untied],
                                      host["input_stream"][:, untied]),
                       f"{path}: input_stream differs off the tied rows")
    return good, ties


def profile_build(path, raw, spec):
    """torch.profiler over one device build: its device time by kernel into
    chiprun_out/<path>_profile.txt. Returns the five largest items, in ms."""
    kernels, _ = top_device_ops(lambda: build_pyramid_device(*raw, **spec))
    total = sum(op.ms for op in kernels)
    write_profile(f"{path}_profile.txt", f"one device build: {total:.3f} ms of kernel time",
                  {"kernels": kernels})
    return [(op.name[:60], round(op.ms, 3), op.count) for op in kernels[:5]]


def profile_builds_worker(inputs, out):
    """``chip_smoke.py --profile-builds INPUTS OUT``: :func:`profile_build`
    in a fresh process (a long process's profiler sessions lose events,
    PERF.md §7) for each {path: (raw, spec)} of the torch file INPUTS; each
    path's five largest items into the JSON file OUT."""
    top = {path: profile_build(path, [t.to(DEVICE) for t in raw], spec)
           for path, (raw, spec) in torch.load(inputs).items()}
    with open(out, "w") as f:
        json.dump(top, f)


def profile_builds_phase(builds, report, tmp):
    """Phase 17 (a)'s profiles: ``builds``, {path: (raw, spec)}, profiled by
    ``--profile-builds`` in one process of its own; each path's largest
    items printed and recorded (report[path]["top"])."""
    inputs, out = os.path.join(tmp, "profile_builds.pt"), os.path.join(tmp, "profile_builds.json")
    torch.save({path: ([t.cpu() for t in raw], spec) for path, (raw, spec) in builds.items()},
               inputs)
    run_script([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--profile-builds", inputs,
                out], dict(os.environ), "chip_smoke.py --profile-builds")
    with open(out) as f:
        top = json.load(f)
    for path in builds:
        print(f"{path}: the build's largest device items (torch.profiler, a process of its own, "
              f"ms): {top[path]}", flush=True)
        report[path]["top"] = top[path]


def device_build(cfg, pyramids):
    """The device build of a path's host pyramids: symmetric caps (each
    stage's largest cloud over the pairs, a multiple of 256), the largest
    27-cell population on the host, the candidate capacity it calibrates
    and build_pyramid_device's keywords."""
    caps = tuple(max(c) for c in zip(*(caps_for_pyramid(p, multiple=256) for p, _, _ in
                                       pyramids)))
    largest = max(largest_cell_population(p, cfg.backbone.init_radius, caps)
                  for p, _, _ in pyramids)
    knn_cand_cap = max(round_up(largest, 64), 64)
    return caps, largest, knn_cand_cap, pyramid_spec(cfg, caps, knn_cand_cap)


def device_pyramid_path(path, cfg, pyramids, device, report):
    """Phase 17 (a) on one path's three host pyramids: the device pyramid at
    symmetric caps (each stage's largest cloud over the pairs, a multiple of
    256) with the candidate capacity calibrated on the host, against the
    host pyramid at the same caps; each kernel call against its plain
    version (bit for bit; the segment means within 1e-6 x max|coordinate|),
    timed on pair 0's build; the whole build's time against the host's.
    Returns the comparisons and pair 0's (raw, spec) for its profile."""
    caps, largest, knn_cand_cap, spec = device_build(cfg, pyramids)
    print(f"{path}: caps {caps}, knn_cand_cap {knn_cand_cap} (the largest 27-cell population "
          f"{largest}, calibrated on the host over the {len(pyramids)} pairs)", flush=True)
    records, compared, all_ties = [], [], []
    for p, n, transform in pyramids:
        raw = raw_inputs(p, transform, caps[0], device)
        with capture_kernel_calls(PYRAMID) as calls:
            built, overflow = build_pyramid_device(*raw, **spec)
        expect(not bool(overflow.any()), f"{path}: the device build overflowed {overflow}")
        records.append(calls)
        host = pad_registration_batch(p, np.ones((n, 1), np.float32), transform, caps,
                                      inverse_limits=spec["inverse_limits"])
        good, ties = compare_with_host(path, built, host, spec)
        compared.append(good)
        all_ties.append(ties)
    # pairs 1, 2: every call against its plain version; pair 0's calls also timed
    worst = collections.defaultdict(float)
    for calls in records[1:]:
        for name in PYRAMID:
            kernel, plain = getattr(preprocess_device, name), KERNELS[name].plain
            for args, kwargs in calls[name]:
                worst[name] = max(worst[name], check_call(name, kernel(*args, **kwargs),
                                                          plain(*args, **kwargs), args))
    results = compare_kernels(records[0], PYRAMID, reps=5)
    for name, r in results.items():
        r["max_abs_err"] = max(r["max_abs_err"], worst[name])
    raw = raw_inputs(pyramids[0][0], pyramids[0][2], caps[0], device)
    build_ms = time_ms(lambda: build_pyramid_device(*raw, **spec), 5)
    build_device_ms = graph_ms(lambda: build_pyramid_device(*raw, **spec))
    p, n, transform = pyramids[0]
    start = time.perf_counter()
    bb = cfg.backbone
    host_pyramid = build_pyramid(p["points"][0], p["lengths"][0], bb.num_stages,
                                 bb.init_voxel_size, bb.init_radius, list(cfg.caps.neighbor_limits))
    pad_registration_batch(host_pyramid, np.ones((n, 1), np.float32), transform, caps,
                           inverse_limits=spec["inverse_limits"])
    host_s = time.perf_counter() - start
    skipped = sum(bb.num_stages - g for g in compared)
    print(f"{path}: device build {build_ms:.3f} ms a pair (CUDA events, host dispatch "
          f"included), {build_device_ms:.3f} ms on the device (graph) vs the host pyramid "
          f"{host_s:.3f} s a pair (pair 0: build_pyramid + pad_registration_batch); stages "
          f"compared {compared} of {bb.num_stages} ({skipped} left out on a float32 voxel "
          f"boundary); tie rows {all_ties}", flush=True)
    report[path] = dict(caps=caps, knn_cand_cap=knn_cand_cap, largest_population=largest,
                        build_ms=build_ms, build_device_ms=build_device_ms, host_s=host_s,
                        stages_compared=compared, ties=all_ties)
    return results, (raw, spec)


def device_pyramid_phases(device, launches, report, tmp):
    """Phase 17: the device pyramid. (a) the kernels and the build on the
    3DMatch and KITTI cells' pairs against the host pyramid and their plain
    versions; (b) the raw mode at full width on the synthetic workflow's
    configuration, with a deliberately small first bucket that every pair
    takes, overflows and escalates from: 8 steps through PairLoader and
    Trainer(device_plan=...), the Tester on the 20 test pairs, then scripts.test
    --device_preprocess from the checkpoint (its buckets too). Returns the kernels' comparisons
    ("device_pyramid_3dmatch", "device_pyramid_kitti")."""
    phase_start = time.perf_counter()
    results, builds = {}, {}
    for path, cfg, key in (("device_pyramid_3dmatch", make_3dmatch_config(), "3dmatch"),
                           ("device_pyramid_kitti", make_kitti_config(), "kitti")):
        results[path], builds[path] = device_pyramid_path(path, cfg, SHARED[key], device, report)
    profile_builds_phase(builds, report, tmp)

    shared = SHARED["synthetic"]
    cfg, train_set, test_set = shared["cfg"], shared["train_set"], shared["test_set"]
    caps = tuple(cfg.caps.stage_caps)
    train_pairs = torch.utils.data.Subset(train_set, range(DEVICE_TRAIN_STEPS))
    cfg = synthetic.training_config(cfg, steps=DEVICE_TRAIN_STEPS, train_pairs=DEVICE_TRAIN_STEPS)
    blocks = cfg.geotransformer.blocks
    # a deliberately small first bucket: every pair takes it (its stage 0
    # holds the fragments), overflows at stage 1 and escalates to the
    # calibrated caps (stage 0 a multiple of 256 above)
    buckets = [(caps[0], 256, 256, 256), (caps[0] + 256,) + caps[1:]]
    plan = DevicePreprocessPlan(cfg, buckets=buckets, with_inverse=True,
                                overflow_policy="escalate")
    print(f"device train: buckets {plan.buckets}", flush=True)

    out = os.path.join(tmp, "device")
    model = create_model(cfg, device=device)
    loader = PairLoader(train_pairs, shared["train_pipeline"], shuffle=True, num_workers=2,
                        seed=cfg.seed, device_plan=plan)
    test_loader = PairLoader(test_set, shared["test_pipeline"], num_workers=2,
                             device_plan=plan)
    feature_dir = os.path.join(out, "features")
    try:
        trainer = Trainer(cfg, model, loader, output_dir=os.path.join(out, "train"), log_steps=8,
                          device=DEVICE, device_plan=plan)
        counts = collections.Counter()
        step_for = trainer._train_step_for
        # the pyramid kernels' calls of the first group's two tries (bucket
        # 0, which overflows, and bucket 1), held against the plain versions
        # after the training
        raw_calls = collections.defaultdict(list)
        tries = []

        def counting_step_for(bucket):
            step = step_for(bucket)

            def run(batch, generator=None):
                if len(tries) < 2:
                    with capture_kernel_calls(PYRAMID) as calls:
                        metrics, c = counted(lambda: step(batch, generator))
                    tries.append(bucket)
                    for name in PYRAMID:
                        raw_calls[name] += calls[name]
                else:
                    metrics, c = counted(lambda: step(batch, generator))
                ran = float(metrics["pyramid_overflow"]) == 0.0
                expect_raw_launches(c, cfg, "train", "device train step", 1, ran)
                counts.update(c)
                return metrics
            return run

        trainer._train_step_for = counting_step_for
        trainer.initialize()
        start = time.perf_counter()
        trainer.run()
        train_wall = time.perf_counter() - start
        expect(tries == [0, 1], f"device train: the first group's tries at buckets {tries}")
        results["device_raw_train"] = compare_kernels(raw_calls, PYRAMID, reps=5)
        history = trainer.history
        expect([h["step"] for h in history] == list(range(1, DEVICE_TRAIN_STEPS + 1)),
               f"device train: steps {[h['step'] for h in history]}")
        for h in history:
            expect(h["grad_finite"] == 1.0, f"device train step {h['step']} skipped")
            expect(np.isfinite(h["loss"]), f"device train step {h['step']}: loss {h['loss']}")
        expect(trainer.overflows == DEVICE_TRAIN_STEPS and trainer.host_fallbacks == 0,
               f"device train: {trainer.overflows} overflowed tries, {trainer.host_fallbacks} "
               f"host fallbacks (every group escalates once)")
        launches["device_train"] = dict(counts)
        step_ms = [1e3 * h["process_s"] for h in history]
        print(f"device train: {len(history)} steps, the pyramid built in each, loss "
              f"{history[0]['loss']:.4f} -> {history[-1]['loss']:.4f}; "
              f"{statistics.median(step_ms):.3f} ms a step (median, CUDA events; min "
              f"{min(step_ms):.3f}, max {max(step_ms):.3f}); {train_wall:.1f} s wall with the "
              f"loader; {trainer.overflows} overflowed tries, {trainer.host_fallbacks} host "
              f"fallbacks", flush=True)

        tester = Tester(cfg, model, test_loader, output_dir=os.path.join(out, "test"),
                        feature_dir=feature_dir, device_plan=plan, device=DEVICE)
        test_counts = collections.Counter()
        run_pair = tester._run_pair

        stamps = []

        def counting_run_pair(batch):
            stamps.append(time.perf_counter())
            before = tester.overflows + tester.host_fallbacks
            result, c = counted(lambda: run_pair(batch))
            builds = 1 + tester.overflows - before
            expect(tester.host_fallbacks == 0, "device test: a host fallback")
            expect_raw_launches(c, cfg, "eval", "device test pair", builds, True)
            test_counts.update(c)
            return result

        tester._run_pair = counting_run_pair
        start = time.perf_counter()
        summary, test_results = tester.run()
        test_wall = time.perf_counter() - start
        pair_ms = [1e3 * t for t in tester.timer.process_times()]
    finally:
        loader.close()
        test_loader.close()
    expect(len(test_results) == len(test_set), f"device test: {len(test_results)} pairs")
    expect(tester.overflows == len(test_set), f"device test: {tester.overflows} escalations")
    expect(all(np.isfinite(v) for v in summary.values()), f"device test: {summary}")
    launches["device_eval"] = dict(test_counts)
    transforms = dumped_transforms(feature_dir)
    expect(len(transforms) == len(test_set), f"device test: {len(transforms)} dumps")
    for key, est in transforms.items():
        rot = est[:3, :3].astype(np.float64)
        expect(np.isfinite(est).all() and np.abs(rot @ rot.T - np.eye(3)).max() < 1e-3
               and abs(np.linalg.det(rot) - 1) < 1e-3,
               f"device test {key}: the estimated R is not a rotation ({est})")
    print(f"device test: {len(test_results)} pairs, "
          f"{ {k: round(v, 4) for k, v in summary.items()} }; "
          f"{statistics.median(pair_ms):.3f} ms a pair on the card, the build included "
          f"(median, CUDA events; min {min(pair_ms):.3f}, max {max(pair_ms):.3f}); "
          f"{test_wall:.1f} s wall with the loader ({stamps[0] - start:.1f} s to the first "
          f"pair: the 2 workers' start; {test_wall - stamps[0] + start:.1f} s for the "
          f"{len(test_set)} pairs); every R a rotation; escalations {tester.overflows}, "
          f"host fallbacks {tester.host_fallbacks}", flush=True)

    cmd, env = synthetic.eval_command(feature_dir, shared["benchmark_root"],
                                      os.path.join(out, "registration"), DEVICE)
    cmd = [sys.executable, "-m", "geotransformer_tpu_torch.scripts.test", "--dataset", "3dmatch",
           "--data_root", shared["data_root"], "--benchmark", "3DMatch",
           "--checkpoint_dir", os.path.join(out, "train", "checkpoints"),
           "--output_dir", os.path.join(out, "cli"), "--num_workers", "2", "--device", DEVICE,
           "--device_preprocess", "--overflow_policy", "escalate"]
    printed, test_s = run_script(cmd, env, "scripts.test --device_preprocess")
    cli = dumped_transforms(os.path.join(out, "cli", "features", "3DMatch"))
    expect(sorted(cli) == sorted(transforms), f"scripts.test dumped {sorted(cli)}")
    cli_diff = max(float(np.abs(cli[k] - transforms[k]).max()) for k in transforms)
    expect(cli_diff <= 1e-5, f"scripts.test --device_preprocess vs the Tester: estimated "
                             f"transforms differ by {cli_diff}")
    wall = time.perf_counter() - phase_start
    print(f"scripts.test --device_preprocess ({test_s:.1f} s, "
          f"{printed.strip().splitlines()[-1]}): its transforms vs the Tester's, max |diff| "
          f"{cli_diff:.3e} over {len(transforms)} pairs; phase 17 {wall:.1f} s wall", flush=True)
    report["device"] = dict(
        caps=caps, train_losses=[h["loss"] for h in history], train_step_ms=step_ms,
        train_wall_s=train_wall, train_overflows=trainer.overflows,
        train_host_fallbacks=trainer.host_fallbacks, buckets=plan.buckets,
        test_summary=summary, test_pair_ms=pair_ms, test_wall_s=test_wall,
        test_first_pair_s=stamps[0] - start, test_escalations=tester.overflows,
        test_host_fallbacks=tester.host_fallbacks, cli_max_abs_diff=cli_diff, wall_s=wall)
    return results


# --- phase 18: the training engine --------------------------------------
# the pairs phase 18c's two ranks take, 3 steps each, in the order one
# process would (rank r takes order[r::2], as PairLoader shards)
ENGINE_ORDER = (0, 1, 2, 1, 2, 0)
ENGINE_RANK_LIMIT_S = 300
# --ranks-across-cards: steps a rank takes (rank 0 profiles step 1, so the
# steady steps are 2 on)
ACROSS_CARDS_STEPS = 6


class BatchLoader:
    """The Trainer's loader over batches already built: one pair a group,
    the shard order[shard_index::num_shards], the same every epoch."""

    def __init__(self, batches, num_shards=1, shard_index=0):
        self.batches = batches[shard_index::num_shards]

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return ([batch] for batch in self.batches)

# --- phase 19: the native host library and the model extras --------------

@contextlib.contextmanager
def pyramid_route(flag):
    """The host pyramid's route inside the block: "1" the native library,
    "0" numpy (``GEOTRANSFORMER_TPU_NATIVE``)."""
    saved = os.environ.get("GEOTRANSFORMER_TPU_NATIVE")
    os.environ["GEOTRANSFORMER_TPU_NATIVE"] = flag
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("GEOTRANSFORMER_TPU_NATIVE")
        else:
            os.environ["GEOTRANSFORMER_TPU_NATIVE"] = saved


def native_route_phase(report):
    """19a: the native library took the earlier phases' host pyramids; on the
    3DMatch and KITTI cells' pairs its pyramids against the numpy route's
    (lengths and points bit for bit, each table row for row but distance
    ties within float32 rounding: the library sorts float32 squared
    distances, cKDTree float64 ones) and both routes' seconds a pair."""
    so_far = dict(native.calls)
    expect(so_far.get("grid_subsample", 0) > 0 and so_far.get("radius_search", 0) > 0,
           f"the earlier phases' host pyramids did not go through the native library: {so_far}")
    summary = {"calls_before": so_far, "library": native.lib_path()}
    for path, cfg in (("3dmatch", make_3dmatch_config()), ("kitti", make_kitti_config())):
        bb = cfg.backbone
        per_build = {"grid_subsample": bb.num_stages - 1, "radius_search": 3 * bb.num_stages - 2}
        seconds, ties = {"native": [], "numpy": []}, []
        for pyramid, _, _ in SHARED[path]:
            args = (pyramid["points"][0], pyramid["lengths"][0], bb.num_stages,
                    bb.init_voxel_size, bb.init_radius, list(cfg.caps.neighbor_limits))
            built = {}
            for route, flag in (("native", "1"), ("numpy", "0")):
                native.calls.clear()
                with pyramid_route(flag):
                    start = time.perf_counter()
                    built[route] = build_pyramid(*args)
                    seconds[route].append(time.perf_counter() - start)
                want = per_build if route == "native" else {}
                expect(dict(native.calls) == want,
                       f"{path} {route} route: native calls {dict(native.calls)}, expected {want}")
            got, want = built["native"], built["numpy"]
            for key in ("points", "lengths", "neighbors", "subsampling", "upsampling"):
                for a, b in zip(pyramid[key], got[key]):  # the earlier phases' route
                    expect(np.array_equal(a, b), f"{path}: the phases' {key} are not the native ones")
            for key in ("points", "lengths"):
                for i, (a, b) in enumerate(zip(got[key], want[key])):
                    expect(a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(),
                           f"{path}: {key}[{i}] differ between the native and numpy routes")
            points = got["points"]
            scale = max(float(np.abs(p).max()) for p in points)
            pair_ties = {}
            radius = bb.init_radius
            for key, q_of, s_of, r_of in (
                    ("neighbors", lambda i: i, lambda i: i, lambda i: radius * 2 ** i),
                    ("subsampling", lambda i: i + 1, lambda i: i, lambda i: radius * 2 ** i),
                    ("upsampling", lambda i: i, lambda i: i + 1, lambda i: radius * 2 ** (i + 1))):
                for i, (a, b) in enumerate(zip(got[key], want[key])):
                    expect(a.shape == b.shape, f"{path}: {key}[{i}] {a.shape} vs {b.shape}")
                    atol = 8 * np.finfo(np.float32).eps * (scale + r_of(i))
                    rows = table_ties(a, b, points[q_of(i)], points[s_of(i)],
                                      points[s_of(i)].shape[0], r_of(i), atol)
                    pair_ties[f"{key}[{i}]"] = [int(len(rows)), int(a.shape[0])]
            ties.append(pair_ties)
        share = max(t / n for pair in ties for t, n in pair.values())
        print(f"19a {path}: build_pyramid {statistics.mean(seconds['native']):.3f} s a pair native "
              f"({[round(x, 3) for x in seconds['native']]}) vs "
              f"{statistics.mean(seconds['numpy']):.3f} s numpy "
              f"({[round(x, 3) for x in seconds['numpy']]}), host of {card(DEVICE)}; points "
              f"bit-equal; tie rows (rows) by table {ties}; largest tie share {share:.2e}",
              flush=True)
        summary[path] = dict(native_s=seconds["native"], numpy_s=seconds["numpy"], ties=ties,
                             largest_tie_share=share)
    report["native"] = summary


def relative_difference(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


def variants_phase(device, cfg, out, launches, report):
    """19b: the vanilla, PE and LRPE conditional transformers at the
    3DMatch config's width on the default forward's superpoint features and
    masks (PE: seeded embeddings; LRPE: relative distance bins of sigma_d),
    seeded weights; the kernel route counted (fused_masked_attention twice a
    block, nothing else) and against the einsum route (1e-4 of the largest
    magnitude on every row); row 13's calls against its plain version (path
    "variants")."""
    gt = cfg.geotransformer
    generator = torch.Generator().manual_seed(VARIANT_SEED)
    feats = [out[f"{side}_feats_c"][None] for side in ("ref", "src")]
    masks = [out[f"{side}_masks_c"][None] for side in ("ref", "src")]
    embeddings = [torch.randn((1, f.shape[1], gt.hidden_dim), generator=generator).to(device)
                  for f in feats]
    bins = [torch.clamp((torch.cdist(out[f"{side}_points_c"], out[f"{side}_points_c"])
                         / gt.sigma_d).long(), max=VARIANT_EMBEDDINGS - 1)[None]
            for side in ("ref", "src")]
    specs = {
        "vanilla": (models_variants.VanillaConditionalTransformer, {}, (*feats, *masks)),
        "pe": (models_variants.PEConditionalTransformer, {}, (*feats, *embeddings, *masks)),
        "lrpe": (models_variants.LRPEConditionalTransformer,
                 {"num_embeddings": VARIANT_EMBEDDINGS}, (*feats, *bins, *masks)),
    }
    counts, summary, records = collections.Counter(), {}, collections.defaultdict(list)
    for name, (cls, extra, inputs) in specs.items():
        model = cls(gt.blocks, gt.hidden_dim, gt.num_heads, **extra)
        models_geotransformer.init_parameters(model, generator)
        for module in model.modules():
            if isinstance(module, models_variants.LearnablePositionalEmbedding):
                with torch.no_grad():
                    module.embeddings.normal_(generator=generator)
        plain = cls(gt.blocks, gt.hidden_dim, gt.num_heads, force=False, **extra)
        plain.load_state_dict(model.state_dict())
        model, plain = model.to(device).eval(), plain.to(device).eval()
        with torch.no_grad():
            with capture_kernel_calls(["fused_masked_attention"]) as calls:
                got, c = counted(lambda: model(*inputs))
            records["fused_masked_attention"] += calls["fused_masked_attention"]
            want = plain(*inputs)
            want_launches = {"fused_masked_attention": 2 * len(gt.blocks)}
            expect(c == want_launches, f"variants {name}: launches {c}, expected {want_launches}")
            counts.update(c)
            rel = max(relative_difference(g, w) for g, w in zip(got, want))
            expect(rel <= 1e-4, f"variants {name}: kernel vs einsum route {rel:.2e} > 1e-4")
            kernel_ms = time_ms(lambda: model(*inputs), 5)
            plain_ms = time_ms(lambda: plain(*inputs), 5)
        summary[name] = dict(rel=rel, kernel_ms=kernel_ms, plain_ms=plain_ms)
        print(f"19b {name}: kernel vs einsum route max rel diff {rel:.2e}; forward "
              f"{kernel_ms:.3f} ms (row 13) vs {plain_ms:.3f} ms (einsum), CUDA events",
              flush=True)
    launches["variants"] = dict(counts)
    report["variants"] = summary
    return compare_kernels(records, ["fused_masked_attention"], reps=5)


def rotation_check(rot):
    """|R R^T - I| and |det R - 1| of (B, 3, 3) rotations, in float64."""
    rot = rot.double()
    eye = torch.eye(3, dtype=torch.float64, device=rot.device)
    return ((rot @ rot.transpose(1, 2) - eye).abs().max().item(),
            (torch.linalg.det(rot) - 1.0).abs().max().item())


def kabsch_phase(cfg, model, batch, report):
    """19c (Kabsch): the covariances of one default forward's LGR hypotheses,
    solved by the quaternion Kabsch and by SVD, both timed; the quaternion
    rotations proper and on the card within 1e-4 of the same solver's on
    the CPU. Measured, not held: the rotations' difference from SVD's and
    the Kabsch objective tr(R H) the quaternion leaves short of SVD's,
    relative to the sum of H's singular values s, beside the gap between
    the top two eigenvalues of Horn's matrix, 2 (s2 + sign(det H) s3), on
    the same scale. JAX's algorithm (30 power iterations on the shifted,
    squared matrix) converges at the squared ratio of the shifted top
    eigenvalues an iteration, so it stops short where that gap is small.
    LGR with each solver on the forward's scores. Returns the forward's
    outputs."""
    captured = []
    solve_svd = models_procrustes.ROTATION_SOLVERS["svd"]
    models_procrustes.ROTATION_SOLVERS["svd"] = lambda h: (captured.append(h.clone()),
                                                           solve_svd(h))[1]
    try:
        out = model(batch)
    finally:
        models_procrustes.ROTATION_SOLVERS["svd"] = solve_svd
    h = captured[0]  # (P, 3, 3): one hypothesis a patch
    expect(h.shape == (cfg.coarse_matching.num_correspondences, 3, 3),
           f"LGR hypotheses' covariances {tuple(h.shape)}")
    quat = models_procrustes.rotation_from_covariance_quat
    r_quat, r_svd = quat(h), solve_svd(h)
    ortho, det = rotation_check(r_quat)
    expect(ortho < 1e-4 and det < 1e-4, f"quaternion Kabsch: |R R^T - I| {ortho}, |det - 1| {det}")
    card_vs_cpu = (r_quat.cpu() - quat(h.cpu())).abs().max().item()
    expect(card_vs_cpu <= 1e-4, f"quaternion Kabsch: card vs CPU {card_vs_cpu:.2e} > 1e-4")
    sv = torch.linalg.svdvals(h.double())
    ranked = sv[:, 1] > 1e-6 * sv[:, 0].clamp(min=1e-300)
    diff = (r_quat - r_svd).abs().amax(dim=(1, 2))[ranked]
    scale = sv.sum(dim=1).clamp(min=1e-300)
    gap = 2 * (sv[:, 1] + torch.sign(torch.linalg.det(h.double())) * sv[:, 2]) / scale
    conditioned = ranked & (gap >= 0.2)
    diff_conditioned = (r_quat - r_svd).abs().amax(dim=(1, 2))[conditioned]

    def objective(rot):
        return torch.einsum("bij,bji->b", rot.double(), h.double())

    shortfall = (objective(r_svd) - objective(r_quat)) / scale

    def worst(values):
        return values.max().item() if values.numel() else 0.0

    worst_shortfall, worst_conditioned = worst(shortfall[ranked]), worst(shortfall[conditioned])
    gap_of_worst = gap[ranked][shortfall[ranked].argmax()].item() if ranked.any() else 0.0
    quat_ms, svd_ms = time_ms(lambda: quat(h), 20), time_ms(lambda: solve_svd(h), 20)
    quat_device_ms = graph_ms(lambda: quat(h))
    fm = cfg.fine_matching
    lgr_args = (out["ref_node_corr_knn_points"], out["src_node_corr_knn_points"],
                out["ref_node_corr_knn_masks"], out["src_node_corr_knn_masks"],
                out["matching_scores"][:, :-1, :-1])
    lgr_kw = dict(k=fm.topk, acceptance_radius=fm.acceptance_radius,
                  confidence_threshold=fm.confidence_threshold, mutual=fm.mutual,
                  correspondence_threshold=fm.correspondence_threshold,
                  correspondence_limit=cfg.caps.correspondence_capacity,
                  num_refinement_steps=fm.num_refinement_steps, patch_masks=out["node_corr_masks"])
    expect(not fm.use_global_score, "the 3DMatch config uses no global score")
    lgr, lgr_ms = {}, {}
    with torch.no_grad():
        for method in ("svd", "quat"):
            run = functools.partial(local_to_global_registration, *lgr_args,
                                    procrustes_method=method, **lgr_kw)
            lgr[method] = run()["estimated_transform"]
            lgr_ms[method] = time_ms(run, 5)
    expect(torch.equal(lgr["svd"], out["estimated_transform"]), "LGR repeat differs")
    ortho, det = rotation_check(lgr["quat"][None, :3, :3])
    expect(bool(torch.isfinite(lgr["quat"]).all()) and ortho < 1e-3 and det < 1e-3,
           f"LGR with the quaternion Kabsch: |R R^T - I| {ortho}, |det - 1| {det}")
    lgr_diff = (lgr["quat"] - lgr["svd"]).abs().max().item()
    result = dict(hypotheses=int(h.shape[0]), ranked=int(ranked.sum()),
                  max_rotation_diff=diff.max().item() if diff.numel() else 0.0,
                  median_rotation_diff=diff.median().item() if diff.numel() else 0.0,
                  objective_shortfall=worst_shortfall, conditioned=int(conditioned.sum()),
                  objective_shortfall_conditioned=worst_conditioned, card_vs_cpu=card_vs_cpu,
                  gap_of_worst=gap_of_worst,
                  max_rotation_diff_conditioned=(diff_conditioned.max().item()
                                                 if diff_conditioned.numel() else 0.0),
                  quat_ms=quat_ms, quat_device_ms=quat_device_ms, svd_ms=svd_ms,
                  lgr_ms=lgr_ms, lgr_transform_diff=lgr_diff)
    print(f"19c Kabsch on the {h.shape[0]} LGR hypotheses of a 3DMatch forward "
          f"({result['ranked']} of rank >= 2): quaternion vs SVD rotations max |diff| "
          f"{result['max_rotation_diff']:.2e} (median {result['median_rotation_diff']:.2e}; "
          f"{result['max_rotation_diff_conditioned']:.2e} on the {result['conditioned']} whose "
          f"Horn eigengap is at least 0.2 sum(sv)), objective at most {worst_shortfall:.2e} of "
          f"sum(sv) short of SVD's (eigengap {gap_of_worst:.2e} there; {worst_conditioned:.2e} "
          f"on the gapped ones); card vs CPU {card_vs_cpu:.1e}; "
          f"quaternion {quat_ms:.4f} ms (CUDA events) / {quat_device_ms:.4f} ms (graph), SVD "
          f"{svd_ms:.4f} ms (CUDA events); LGR {lgr_ms['svd']:.3f} ms (svd) vs "
          f"{lgr_ms['quat']:.3f} ms (quat), transforms max |diff| {lgr_diff:.2e}; "
          f"{card(DEVICE)}", flush=True)
    report["kabsch"] = result
    return out


def extras_forward_phase(cfg, weights, batches, launches, report):
    """19c (forwards): full-width 3DMatch forwards with reduction_a="mean" (no
    GSE launch: the JAX package has no kernel for it either) and with the
    dustbin, counted, checked as phase 3 checks its forward, each against its
    force_pallas=False model."""
    truths = [{"transform": b["transform"].cpu().numpy()} for b in batches]
    for what, variant in (
            ("3dmatch_mean", dataclasses.replace(cfg, geotransformer=dataclasses.replace(
                cfg.geotransformer, reduction_a="mean"))),
            ("3dmatch_dustbin", dataclasses.replace(cfg, fine_matching=dataclasses.replace(
                cfg.fine_matching, use_dustbin=True)))):
        model = fresh_model(variant, weights)
        outs, times, launches[f"{what}_inference"] = register_pairs(
            model, variant, variant.caps.stage_caps, batches, truths, SEEDS, what)
        plain = fresh_model(variant.with_model(force_pallas=False), weights)
        compare_coarse_features(outs[-1], plain(batches[-1]),
                                f"{what} whole model vs force_pallas=False")
        report[f"{what}_forward_ms"] = times


def point_matching_phase(cfg, out, batch, report):
    """19d: point_matching on the default forward's Sinkhorn output, with and
    without the dustbin, on the card against the CPU: the same
    correspondences, scores within 1e-6 of their largest."""
    fm = cfg.fine_matching
    inputs = dict(
        ref_knn_points=out["ref_node_corr_knn_points"],
        src_knn_points=out["src_node_corr_knn_points"],
        ref_knn_masks=out["ref_node_corr_knn_masks"],
        src_knn_masks=out["src_node_corr_knn_masks"],
        ref_knn_indices=batch["ref_node_knn_indices"][out["ref_node_corr_indices"]],
        src_knn_indices=batch["src_node_knn_indices"][out["src_node_corr_indices"]],
        patch_masks=out["node_corr_masks"])
    kw = dict(k=fm.topk, mutual=fm.mutual, confidence_threshold=fm.confidence_threshold,
              correspondence_limit=cfg.caps.correspondence_capacity)
    summary = {}
    for dustbin in (False, True):
        scores = out["matching_scores"] if dustbin else out["matching_scores"][:, :-1, :-1]
        run = functools.partial(point_matching, log_score_mat=scores, use_dustbin=dustbin,
                                **inputs, **kw)
        got = run()
        want = point_matching(log_score_mat=scores.cpu(), use_dustbin=dustbin,
                              **{k: v.cpu() for k, v in inputs.items()}, **kw)
        entries = []
        for result in (got, want):
            m = result["corr_masks"].cpu()
            entries.append(dict(zip(zip(result["ref_corr_indices"].cpu()[m].tolist(),
                                        result["src_corr_indices"].cpu()[m].tolist()),
                                    result["corr_scores"].cpu()[m].tolist())))
        expect(entries[0] and sorted(entries[0]) == sorted(entries[1]),
               f"point_matching (dustbin {dustbin}): card and CPU correspondences differ "
               f"({len(entries[0])} vs {len(entries[1])})")
        top = max(entries[1].values())
        worst = max(abs(entries[0][k] - entries[1][k]) for k in entries[1])
        expect(worst <= 1e-6 * top, f"point_matching scores differ by {worst}")
        ms = time_ms(run, 10)
        summary[f"dustbin={dustbin}"] = dict(correspondences=len(entries[0]), ms=ms,
                                             max_score_diff=worst)
        print(f"19d point_matching (dustbin {dustbin}): {len(entries[0])} correspondences, "
              f"card = CPU (scores within {worst:.1e}); {ms:.3f} ms on the card (CUDA events)",
              flush=True)
    report["point_matching"] = summary


def scripts_phase(report):
    """19e: scripts.calibrate on phase 12's ModelNet pickle by both pyramid
    routes (the same caps; the native library's calls counted), and
    scripts.eval_dgr on phase 16's Tester dumps with its three methods
    (svd on the card)."""
    root = SHARED["modelnet_root"]
    caps = {}
    for route, flag in (("native", "1"), ("numpy", "0")):
        native.calls.clear()
        np.random.seed(0)  # the dataset's augmentation draws from np.random
        with pyramid_route(flag):
            start = time.perf_counter()
            caps[route] = calibrate_script.main(["--dataset", "modelnet", "--data_root", root,
                                                 "--num_samples", str(MODELNET_ENTRIES)])
            seconds = time.perf_counter() - start
        expect((native.calls["radius_search"] > 0) == (route == "native"),
               f"scripts.calibrate, {route} route: native calls {dict(native.calls)}")
        print(f"19e scripts.calibrate (modelnet, {route} route): {seconds:.2f} s", flush=True)
    expect(caps["native"] == caps["numpy"],
           f"scripts.calibrate: the routes' caps differ: {caps}")
    expect(len(caps["native"]["neighbor_limits"]) == make_modelnet_config().backbone.num_stages,
           "scripts.calibrate: neighbor limits a stage")
    tables = {}
    for method in ("lgr", "ransac", "svd"):
        start = time.perf_counter()
        table = eval_dgr.main(["--feature_dir", SHARED["synthetic"]["feature_dir"],
                               "--method", method, "--device", DEVICE])
        expect(all(np.isfinite(v) for k, v in table.items() if k not in ("RRE", "RTE")),
               f"scripts.eval_dgr {method}: {table}")
        tables[method] = dict(table, seconds=time.perf_counter() - start)
    report["scripts"] = dict(calibrate=caps["native"], eval_dgr=tables)


def extras_phases(device, launches, report):
    """Phase 19: (a) the native host library against the numpy route; (b)
    the transformer variants through row 13; (c) the mean-reduction and
    dustbin forwards, the quaternion Kabsch against SVD; (d) point_matching
    on the card; (e) scripts.calibrate and scripts.eval_dgr."""
    start = time.perf_counter()
    native_route_phase(report)
    cfg, model, batches = SHARED["3dmatch_train"]
    out = kabsch_phase(cfg, model, batches[0], report)
    results = variants_phase(device, cfg, out, launches, report)
    extras_forward_phase(cfg, model.state_dict(), batches, launches, report)
    point_matching_phase(cfg, out, batches[0], report)
    scripts_phase(report)
    report["phase19_s"] = time.perf_counter() - start
    print(f"phase 19: {report['phase19_s']:.1f} s; {card(DEVICE)}", flush=True)
    return {"variants": results}


# --- phase 20: the profiling and timing tools, the shell drivers ---------

# the wrappers a 3DMatch forward launches, whose events phase 20a counts
# (KERNEL_SYMBOLS)
SESSION_KERNELS = ("kpconv_stream_fused", "kpconv_fused", "gse_embedding_full", "rpe_pair_scores",
                   "fused_masked_attention", "sinkhorn_log_iterations")
# 20b: the layers of each stack
ENCODER_LAYERS = DECODER_LAYERS = 3
# 20c: the training steps drift takes (its default is 600), the steps of
# the convergence suite (whole epochs of the small workflow's 12 pairs)
DRIFT_STEPS, SUITE_STEPS = 20, 4
TOOL_TIMEOUT_S = 300
TOOL_WIDTH = 5


def profiler_sessions(model, batch):
    """Two torch.profiler sessions (utils.timing.top_device_ops), each around
    one model(batch) after its warm-up one: the hand-written kernel launches
    of one forward by wrapper, each session's kernel events by wrapper
    (KERNEL_SYMBOLS), and the events each session lost as top_device_ops
    reports them (its ``lost``)."""
    patterns = {name: re.compile(KERNEL_SYMBOLS[name]) for name in SESSION_KERNELS}
    cuda.launches.clear()
    model(batch)
    launched = {name: cuda.launches[name] for name in SESSION_KERNELS}
    counts, lost = [], []
    for _ in range(2):
        lost.append({})
        kernels, _ = top_device_ops(lambda: model(batch), lost=lost[-1])
        counts.append({name: sum(op.count for op in kernels if p.search(op.name))
                       for name, p in patterns.items()})
    cuda.launches.clear()
    return launched, counts, lost


def profiler_sessions_worker(out):
    """``chip_smoke.py --profiler-sessions OUT``: :func:`profiler_sessions`
    in a fresh process, on one full-width 3DMatch pair (seed 0) and seeded
    weights; the result into the JSON file OUT."""
    cfg = make_3dmatch_config()
    caps, _, batches_np, _ = build_batches(cfg, (0,))
    cfg = cfg.with_caps(stage_caps=caps)
    model = create_model(cfg, device=DEVICE)
    launched, counts, lost = profiler_sessions(model, batch_to_torch(batches_np[0], DEVICE))
    with open(out, "w") as f:
        json.dump(dict(launched=launched, counts=counts, lost=lost), f)


def profiler_sessions_phase(model, batch, report, tmp):
    """20a: two torch.profiler sessions around the same 3DMatch forward count
    the hand-written kernels' events by name, in a fresh process (the first
    and second sessions of ``--profiler-sessions``) and in this one (its
    later sessions). In the fresh process each session must hold one event
    a launch, and top_device_ops must report nothing lost. A long process
    may lose events of every session (the stream input conv's from phase
    18 on, PyTorch kernels too; PERF.md §7): there each wrapper's events
    must equal its launches or top_device_ops must report its shortfall,
    and what the sessions lost is recorded."""
    out = os.path.join(tmp, "profiler_sessions.json")
    run_script([sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--profiler-sessions", out],
               dict(os.environ), "chip_smoke.py --profiler-sessions")
    with open(out) as f:
        fresh = json.load(f)
    launched, counts, lost = fresh["launched"], fresh["counts"], fresh["lost"]
    expect(all(c == launched for c in counts) and not any(lost),
           f"a fresh process's profiler sessions lost events: launches {launched}, events "
           f"{counts}, reported lost {lost}")
    late_launched, late, late_lost = profiler_sessions(model, batch)
    for session, reported in zip(late, late_lost):
        short = [name for name in SESSION_KERNELS if session[name] < late_launched[name]]
        unreported = [name for name in short if not any(
            name in key.split("+") for key in reported)]
        expect(not unreported, f"top_device_ops did not report the lost events of "
                               f"{unreported}: launches {late_launched}, events {session}, "
                               f"reported {reported}")
    print(f"20a profiler: a fresh process's first and second sessions hold one event a launch "
          f"of the hand-written kernels of a forward, {launched}; this process's later sessions "
          f"{late[1]}, reported lost {late_lost}", flush=True)
    report["profiler_sessions"] = dict(launched=launched, fresh=counts, late=late,
                                       late_lost=late_lost)


def encoder_decoder_phase(device, out, launches, report):
    """20b: TransformerEncoder and TransformerDecoder at the 3DMatch width
    (256, 4 heads, 3 layers each) on a forward's superpoint features and
    masks, seeded weights: the kernel route counted (fused_masked_attention
    once a self-attention layer, twice a decoder layer, path
    "encoder_decoder") and within 1e-4 of the einsum route
    (force_pallas=False); row 13's calls against its plain version."""
    width, heads = out["ref_feats_c"].shape[1], make_3dmatch_config().geotransformer.num_heads
    ref, src = out["ref_feats_c"][None], out["src_feats_c"][None]
    ref_masks, src_masks = out["ref_masks_c"][None], out["src_masks_c"][None]
    generator = torch.Generator().manual_seed(VARIANT_SEED)
    specs = {"encoder": (models_transformer.TransformerEncoder, ENCODER_LAYERS,
                         (ref, ref_masks), ENCODER_LAYERS),
             "decoder": (models_transformer.TransformerDecoder, DECODER_LAYERS,
                         (ref, src, ref_masks, src_masks), 2 * DECODER_LAYERS)}
    counts, summary, records = collections.Counter(), {}, collections.defaultdict(list)
    for name, (cls, layers, inputs, calls) in specs.items():
        model = cls(width, heads, layers)
        models_geotransformer.init_parameters(model, generator)
        plain = cls(width, heads, layers, force=False)
        plain.load_state_dict(model.state_dict())
        model, plain = model.to(device).eval(), plain.to(device).eval()
        with torch.no_grad():
            with capture_kernel_calls(["fused_masked_attention"]) as captured:
                got, c = counted(lambda: model(*inputs))
            records["fused_masked_attention"] += captured["fused_masked_attention"]
            want = plain(*inputs)
            expect(c == {"fused_masked_attention": calls},
                   f"{name}: launches {c}, expected {calls} of fused_masked_attention")
            counts.update(c)
            rel = relative_difference(got, want)
            expect(rel <= 1e-4, f"{name}: kernel vs einsum route {rel:.2e} > 1e-4")
            kernel_ms, plain_ms = time_ms(lambda: model(*inputs), 5), time_ms(lambda: plain(*inputs), 5)
        summary[name] = dict(rel=rel, kernel_ms=kernel_ms, plain_ms=plain_ms)
        print(f"20b {name}: kernel vs einsum route max rel diff {rel:.2e}; forward "
              f"{kernel_ms:.3f} ms (row 13) vs {plain_ms:.3f} ms (einsum), CUDA events",
              flush=True)
    launches["encoder_decoder"] = dict(counts)
    report["encoder_decoder"] = summary
    return compare_kernels(records, ["fused_masked_attention"], reps=5)


def tool_command(name, *args):
    return [sys.executable, "-m", f"geotransformer_tpu_torch.scripts.{name}", *args]


def last_json(stdout, tool):
    """The last result line of ``tool`` in a tool's output."""
    results = [json.loads(line) for line in stdout.strip().splitlines()
               if line.startswith('{"tool": ')]
    results = [r for r in results if r["tool"] == tool]
    expect(results, f"{tool}: no result line in its output:\n{stdout[-2000:]}")
    return results[-1]


def run_tools(tools, cwd, env, width=1):
    """Each (label, command, timeout) of ``tools`` in a process of its own,
    at most ``width`` at once in the order given; a failure or a timeout
    fails the run. Returns {label: (stdout, seconds)}, each tool's seconds
    from its own start to its own end."""
    waiting, running, results = list(tools), {}, {}
    start = time.perf_counter()
    try:
        while waiting or running:
            while waiting and len(running) < width:
                label, cmd, timeout = waiting.pop(0)
                log = open(os.path.join(cwd, f"{label}.log"), "w+")
                # a session of its own, so that a kill reaches the tool's children
                running[label] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                                   cwd=cwd, env=env, text=True,
                                                   start_new_session=True),
                                  log, timeout, time.perf_counter())
            for label, (proc, log, timeout, started) in list(running.items()):
                if proc.poll() is not None or time.perf_counter() - started > timeout:
                    results[label] = finish_tool(label, *running.pop(label))
            time.sleep(0.2)
    finally:
        for proc, log, _, _ in running.values():
            kill_tool(proc)
            log.close()
    return results, time.perf_counter() - start


def kill_tool(proc):
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def finish_tool(label, proc, log, timeout, started):
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - started)))
    except subprocess.TimeoutExpired:
        kill_tool(proc)
        log.seek(0)
        raise RuntimeError(f"{label}: timed out after {timeout} s\n{log.read()[-3000:]}")
    seconds = time.perf_counter() - started
    log.seek(0)
    stdout = log.read()
    log.close()
    expect(proc.returncode == 0, f"{label}: exit {proc.returncode}\n{stdout[-4000:]}")
    return stdout, seconds


def brief(label, result):
    """A tool's key numbers, for its printed line."""
    r = {k: v for k, v in result.items() if k != "tool"}
    if label == "profile_stages":
        return {k: [None if v[t] is None else round(v[t], 3) for t in
                    ("graph_ms", "events_ms", "profiler_ms")] for k, v in r["stages"].items()}
    if label.startswith(("profile_forward", "profile_train")):
        keep = {k: v for k, v in r.items() if k not in ("top", "losses")}
        return dict(keep, top=[(t["name"][:48], round(t["ms"], 3), t["count"])
                               for t in r["top"][:5]])
    if label == "profile_ops":
        return {k: round(v["ms"], 3) for k, v in r["families"].items()}
    if label == "profile_device":
        top = sorted(r["phases"].items(), key=lambda kv: -(kv[1]["graph_ms"] or 0))[:4]
        return dict(build=r["build"], top_phases=top, stage0=r["stage0"])
    if label == "train_smoke":
        return {k: r[k] for k in ("steps", "first", "last", "step_ms")}
    if label == "drift":
        return dict(ok=r["ok"], **{route: {k: r["routes"][route][k] for k in
                                           ("feats_c", "feats_f", "excess_rre", "excess_rte",
                                            "rre_gt", "rte_gt")}
                                   for route in r["routes"]})
    if label == "drift_attrib":
        rows = {k: (v["feats_c"], v["feats_f"], v["share"]) for k, v in r["rows"].items()}
        return dict(rows, points={k: (v["feats_c"], v["feats_f"], v["rre_delta"], v["rte_delta"])
                                  for k, v in r["points"].items()})
    return r


def tools_phase(tmp, report):
    """20c: every profiling tool, the training smoke, the drift tools, the
    shell drivers and the convergence suite, each in a process of its own
    under a timeout, TOOL_WIDTH at once, the longest first; a failure fails
    the run. The times the tools print are taken beside the other tools on
    the card and host: they show the tools work, and a measurement runs a
    tool alone."""
    shared = SHARED["synthetic"]
    cwd = os.path.join(tmp, "tools")
    os.makedirs(cwd, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + ([os.environ["PYTHONPATH"]] if os.environ.get("PYTHONPATH") else [])))
    # eval.sh reads the protocol files at <data_root>/metadata/benchmarks/<benchmark>
    shutil.copytree(shared["benchmark_root"],
                    os.path.join(shared["data_root"], "metadata", "benchmarks", "3DMatch"))
    scripts_dir = os.path.join(ROOT, "geotransformer_tpu_torch", "scripts")
    weights = os.path.join(cwd, "drift", "weights.pt")
    tools = [
        # drift_attrib reads the weights drift saves
        ("drift", ["bash", "-c", " && ".join(shlex.join(cmd) for cmd in (
            tool_command("drift", "--steps", str(DRIFT_STEPS), "--weights", weights),
            tool_command("drift_attrib", "--weights", weights)))], 2 * TOOL_TIMEOUT_S),
        # its four short runs at once (JOBS)
        ("convergence suite", ["env", "JOBS=4", "bash",
                               os.path.join(scripts_dir, "run_convergence_suite.sh"),
                               os.path.join(cwd, "suite"), str(SUITE_STEPS), "0.90", "small",
                               "--num_workers", "0", "--device", DEVICE], 2 * TOOL_TIMEOUT_S),
        ("eval.sh", ["bash", os.path.join(scripts_dir, "eval.sh"), "3dmatch",
                     shared["data_root"], "3DMatch", "--checkpoint_dir",
                     os.path.join(tmp, "synthetic", "train", "checkpoints"), "--num_workers", "2",
                     "--device", DEVICE], TOOL_TIMEOUT_S),
        ("profile_train --kitti", tool_command("profile_train", "--kitti"), TOOL_TIMEOUT_S),
        ("profile_train", tool_command("profile_train"), TOOL_TIMEOUT_S),
        ("profile_ops", tool_command("profile_ops"), TOOL_TIMEOUT_S),
        ("train_smoke", tool_command("train_smoke"), TOOL_TIMEOUT_S),
        ("profile_kpconv", tool_command("profile_kpconv"), TOOL_TIMEOUT_S),
        ("profile_forward", tool_command("profile_forward"), TOOL_TIMEOUT_S),
        ("profile_stages", tool_command("profile_stages"), TOOL_TIMEOUT_S),
        ("profile_device", tool_command("profile_device"), TOOL_TIMEOUT_S),
        ("probe_kernels", tool_command("probe_kernels", "all"), TOOL_TIMEOUT_S),
        ("profile_batch", tool_command("profile_batch"), TOOL_TIMEOUT_S)]
    start = time.perf_counter()
    outputs, _ = run_tools(tools, cwd, env, width=TOOL_WIDTH)
    outputs["drift_attrib"] = outputs["drift"]
    results = {}
    for label, (stdout, seconds) in outputs.items():
        if label == "probe_kernels":
            passed = [line.split()[1] for line in stdout.splitlines() if line.startswith("PASS ")]
            expect(sorted(passed) == sorted({wrapper_of(name) for name in KERNELS}),
                   f"probe_kernels: PASS for {passed}\n{stdout[-2000:]}")
            results[label] = dict(seconds=seconds, passed=passed)
        elif label == "eval.sh":
            dumps = dumped_transforms(os.path.join(cwd, "output", "3dmatch", "features",
                                                   "3DMatch"))
            tester = dumped_transforms(shared["feature_dir"])
            expect(sorted(dumps) == sorted(tester), f"eval.sh dumped {sorted(dumps)}")
            diff = max(float(np.abs(dumps[k] - tester[k]).max()) for k in tester)
            expect(diff <= 1e-5, f"eval.sh: its transforms differ from the Tester's by {diff}")
            expect("Overall (lgr):" in stdout, f"eval.sh printed no table:\n{stdout[-2000:]}")
            table = stdout[stdout.index("Overall (lgr):"):].strip()
            results[label] = dict(seconds=seconds, max_abs_diff=diff, table=table,
                                  same_table=table == shared["eval_table"].strip())
        elif label == "convergence suite":
            logs = {}
            for run in ("kernels_s0", "plain_s0", "kernels_s1", "plain_s1"):
                with open(os.path.join(cwd, "suite", f"{run}.log")) as f:
                    text = f.read()
                expect("Overall (lgr):" in text, f"suite run {run}: no table\n{text[-2000:]}")
                logs[run] = [line.strip() for line in text.splitlines() if "RR" in line][:1]
            results[label] = dict(seconds=seconds, runs=logs)
        else:
            results[label] = dict(seconds=seconds, **last_json(stdout, label.split()[0]))
        print(f"20c {label} ({seconds:.1f} s): "
              f"{json.dumps(brief(label, results[label]), default=str)}", flush=True)
    expect(results["drift"]["ok"], f"drift failed its gate: {results['drift']}")
    seconds = time.perf_counter() - start
    print(f"20c tools: {seconds:.1f} s, {TOOL_WIDTH} at once", flush=True)
    report["tools"] = dict(results, seconds=seconds)


def tools_phases(device, launches, report, tmp):
    """Phase 20: (a) the profiler in later sessions, (b) the transformer
    encoder and decoder through row 13, (c) the tools."""
    start = time.perf_counter()
    cfg, model, batches = SHARED["3dmatch_train"]
    profiler_sessions_phase(model, batches[0], report, tmp)
    results = encoder_decoder_phase(device, model(batches[0]), launches, report)
    torch.cuda.empty_cache()
    tools_phase(tmp, report)
    report["phase20_s"] = time.perf_counter() - start
    print(f"phase 20: {report['phase20_s']:.1f} s; {card(DEVICE)}", flush=True)
    return {"encoder_decoder": results}


def fresh_model(cfg, weights, device=None):
    model = create_model(cfg, device=device or DEVICE)
    model.load_state_dict(weights)
    return model


def without_inverse(batch):
    return {k: v for k, v in batch.items() if k not in ("neighbors_inv", "subsampling_inv")}


def timed_step(step, batch, seed):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = step(batch, target_generator(seed))
    end.record()
    torch.cuda.synchronize()
    return metrics, start.elapsed_time(end)


def accumulation_phase(cfg, weights, batches, launches, report):
    """18a: 4 mini-steps of an accumulation of 2 through make_train_step, a
    NaN-hooked one between them, against the mini-steps' gradients taken
    one by one at the same parameters; the k = 1 step beside it."""
    model = fresh_model(cfg, weights)
    one_by_one = [step_gradients(model, cfg, batches[i], SEEDS[i])[1] for i in (0, 1)]
    acc_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(cfg.optim, grad_acc_steps=2))
    optimizer, scheduler = make_optimizer(model, acc_cfg, steps_per_epoch=len(batches))
    expect(isinstance(optimizer, MultiSteps), "grad_acc_steps 2 gave no MultiSteps")
    step = make_train_step(model, acc_cfg, optimizer, scheduler, device=DEVICE)
    total, times, mean_rel = collections.Counter(), [], None
    for i, (pair, nan) in enumerate([(0, False), (1, False), (2, False), (0, True), (0, False)]):
        handle = (model.transformer.in_proj.weight.register_hook(lambda g: g * float("nan"))
                  if nan else None)
        acc = [a.clone() for a in optimizer.acc_grads]
        mini = optimizer.mini_step
        (metrics, ms), counts = counted(lambda: timed_step(step, batches[pair], SEEDS[pair]))
        if handle is not None:
            handle.remove()
        total.update(counts)
        expect_launches(counts, [batches[pair]], "train", f"engine accumulation call {i}",
                        cfg.geotransformer.blocks)
        expect(metrics["grad_finite"].item() == (0.0 if nan else 1.0),
               f"engine accumulation call {i}: grad_finite {metrics['grad_finite'].item()}")
        if nan:
            expect(optimizer.mini_step == mini and all(
                torch.equal(a, b) for a, b in zip(acc, optimizer.acc_grads)),
                "the NaN-hooked mini-step moved the accumulator")
            continue
        times.append(ms)
        if i == 0:
            expect(all(torch.equal(p, weights[name]) for name, p in model.named_parameters()),
                   "the first mini-step of an accumulation changed the parameters")
        if i == 1:
            # the update applied the accumulated mean, left in .grad
            mean = {name: (one_by_one[0][name] + one_by_one[1][name]) / 2
                    for name in one_by_one[0]}
            mean_rel = relative_errors({name: p.grad.double() for name, p in
                                        model.named_parameters()}, mean)[0]
            expect(mean_rel <= 1e-6, f"accumulated mean {mean_rel:.2e} from the mini-steps' "
                                     f"gradients taken one by one")
    expect(scheduler.last_epoch == 2, f"{scheduler.last_epoch} updates, expected 2")
    launches["engine_accumulation_train"] = dict(total)
    # the k = 1 step on the same weights and pairs
    model = fresh_model(cfg, weights)
    step = make_train_step(model, cfg, *make_optimizer(model, cfg, len(batches)), device=DEVICE)
    plain_times = [timed_step(step, batches[i], SEEDS[i])[1] for i in (0, 1, 2, 0)]
    report["engine_accumulation"] = dict(mean_rel=mean_rel, step_ms=times,
                                         no_accumulation_step_ms=plain_times)
    return statistics.median(times), statistics.median(plain_times), mean_rel


def witness_gradients(model, plain_model, cfg, batch):
    """The kernel step's and the float32 plain step's gradients, and the
    float64 plain step along each one's discrete choices (``witness``)."""
    kernel_rec, plain_rec = {}, {}
    with witness(kernel_rec):
        grads_kernel = step_gradients(model, cfg, batch, 0)[1]
    plain_model.load_state_dict(model.state_dict())
    with witness(plain_rec):
        grads_plain = step_gradients(plain_model, cfg, batch, 0)[1]
    exact_model = copy.deepcopy(plain_model).double()
    batch64 = batch_to_float64(batch)
    exact = []
    for rec in (kernel_rec, plain_rec):
        with witness(rec, replay=CHOICES):
            exact.append(step_gradients(exact_model, cfg, batch64, 0)[1])
    return grads_kernel, grads_plain, exact[0], exact[1]


def no_inverse_phase(path, cfg, weights, batch, launches, report):
    """18b: one training step without inverse tables (the scatter backward)
    against the inverse-table route (row 6) on the same batch, per tensor,
    and against the float64 witness; bit-equal on a repeat."""
    if "gt_cand_indices" not in batch:
        batch = dict(batch, **precompute_gt_targets(cfg, batch, device=DEVICE))
    model = fresh_model(cfg, weights)
    plain_model = create_model(cfg.with_model(force_pallas=False), device=DEVICE)
    grads_inv, grads_plain, exact_kernel, exact_plain = witness_gradients(
        model, plain_model, cfg, batch)
    del plain_model
    bare = without_inverse(batch)
    (_, grads), counts = counted(lambda: step_gradients(model, cfg, bare, 0))
    expect_launches(counts, [bare], "train", f"{path} step without inverse tables",
                    cfg.geotransformer.blocks)
    launches[f"engine_noinv_{path}_train"] = counts
    again = step_gradients(model, cfg, bare, 0)[1]
    expect(all(torch.equal(grads[k], again[k]) for k in grads),
           f"{path}: the step without inverse tables is not bit-equal on a repeat")
    ms = {}
    for route, b in (("inverse", batch), ("scatter", bare)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            step_gradients(model, cfg, b, 0)
        end.record()
        torch.cuda.synchronize()
        ms[route] = start.elapsed_time(end) / 3
    r = compare_step_gradients(grads, grads_plain, exact_kernel, exact_plain)
    _, per_inv = relative_errors(grads, grads_inv)
    _, per_plain = relative_errors(grads_plain, exact_plain)
    worst = max(((per_inv[k], k) for k in per_inv if k not in r["vanishing"]))
    for name in per_inv:
        if name not in r["vanishing"] and per_inv[name] > 1e-3 + 2 * per_plain[name]:
            r["violations"].append(f"{name}: {per_inv[name]:.2e} from the inverse-table route")
    print(f"{path} step without inverse tables: gradient rel diff from the float64 step along "
          f"the kernel step's choices {r['whole_kernel']:.2e} (float32 plain "
          f"{r['whole_plain']:.2e}), from the inverse-table route "
          f"{relative_errors(grads, grads_inv)[0]:.2e} (worst tensor {worst[0]:.2e}, "
          f"{worst[1]}); bit-equal on a repeat; forward and backward {ms['scatter']:.3f} ms "
          f"against {ms['inverse']:.3f} ms with inverse tables (CUDA events, mean of 3); "
          f"violations {r['violations']}", flush=True)
    report[f"engine_noinv_{path}"] = dict(whole_kernel=r["whole_kernel"],
                                          whole_plain=r["whole_plain"], step_ms=ms,
                                          worst_vs_inverse=worst, violations=r["violations"])
    report.setdefault("violations", []).extend(f"{path} no inverse: {v}" for v in r["violations"])


def run_ranks(setup, tmp, what, world):
    """``world`` ranks of ``chip_smoke.py --rank-worker`` as subprocesses, on
    the setup's device or (``device`` None) each on card LOCAL_RANK = rank;
    every rank is killed when one fails or ENGINE_RANK_LIMIT_S passes, and
    the run fails with their output. Returns each rank's result."""
    out = os.path.join(tmp, what)
    os.makedirs(out, exist_ok=True)
    setup_path = os.path.join(out, "setup.pt")
    torch.save(setup, setup_path)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    logs = [open(os.path.join(out, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-worker", setup_path, out],
        stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
        env=dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                 LOCAL_RANK=str(r) if setup["device"] is None else "0",
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)))
        for r, log in enumerate(logs)]
    deadline, failure = time.monotonic() + ENGINE_RANK_LIMIT_S, None
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            failure = "a rank failed"
            break
        if time.monotonic() > deadline:
            failure = f"the ranks ran past {ENGINE_RANK_LIMIT_S} s"
            break
        time.sleep(0.5)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    tails = []
    for log in logs:
        log.seek(0)
        tails.append(log.read()[-3000:])
        log.close()
    if failure is None and any(p.returncode != 0 for p in procs):
        failure = "a rank failed"
    expect(failure is None, f"{what}: {failure}, exit codes {[p.returncode for p in procs]}\n"
           + "\n".join(f"--- rank {r}\n{t}" for r, t in enumerate(tails)))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def rank_worker(setup_path, out):
    """One rank of phase 18c (``chip_smoke.py --rank-worker``): joins the
    group the environment describes on this card, over the setup's backend,
    and takes its steps: through the Trainer (mode "trainer": the first
    step's averaged gradients kept, rank 0 profiling step 1) or one
    make_train_step step (mode "step")."""
    setup = torch.load(setup_path, weights_only=False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_process_group(device=setup["device"], backend=setup["backend"],
                                timeout=datetime.timedelta(seconds=120))
    rank, world = mesh_rank(), world_size()
    cfg = setup["cfg"]
    batches = [batch_to_torch(setup["batches"][i], device) for i in setup["order"]]
    model = fresh_model(cfg, setup["weights"], device)
    result = {}
    if setup["mode"] == "step":
        step = make_train_step(model, cfg, *make_optimizer(model, cfg, 1, world_size=world),
                               device=device)
        result["metrics"] = {k: float(v) for k, v in step(batches[0],
                                                          target_generator(0)).items()}
    else:
        trainer = Trainer(cfg, model, BatchLoader(batches, world, rank),
                          output_dir=os.path.join(out, "run"),
                          log_steps=cfg.optim.max_iteration,
                          profile_steps=(1, 2) if rank == 0 else None, device=device)
        grads, train_step = [], trainer.train_step

        def recording(batch, generator=None):
            metrics = train_step(batch, generator)
            grads.append({n: p.grad.detach().cpu() for n, p in model.named_parameters()})
            return metrics

        trainer.train_step = recording
        trainer.run_iterations()
        result.update(grads=grads[0], history=trainer.history, writer=trainer.writer is not None,
                      lr=[h["lr"] for h in trainer.history])
        if rank == 0:
            with open(os.path.join(out, "run", "profile", "trace_rank0.json")) as f:
                result["trace_kernels"] = sorted({e.get("name", "") for e in
                                                  json.load(f)["traceEvents"]
                                                  if e.get("cat") == "kernel"})
    result["params"] = {k: v.cpu() for k, v in model.state_dict().items()}
    barrier()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    destroy_process_group()


def ranks_against_one_process(cfg, weights, batches, world, backend, device, order, smi, tmp):
    """``world`` ranks (``backend``; all on ``device``, or None: a card each)
    taking len(order) / world steps through the Trainer on their shards of
    ``order``: their parameters bit-equal to each other and the lr ``world``
    x the config's; against one process over the same pairs in the same
    order, each pair with its rank's generator (seeded cfg.seed + rank),
    accumulating ``world`` a step at the ``world``-rank lr: the first step's
    gradients within 1e-5 and the parameters within the updates' reach; rank
    0's profile_steps trace holding a device kernel of every KERNELS entry
    the step launches. Rank 0 profiles step 1 and the others wait for it in
    the step's collective, so the steady step is rank 0's from step 2 on.
    Returns the readings."""
    what = f"{world} {backend} ranks ({'one card' if device else 'a card each'})"
    steps = len(order) // world
    rank_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, max_iteration=steps, snapshot_steps=10 ** 9))
    setup = dict(cfg=rank_cfg, weights={k: v.cpu() for k, v in weights.items()},
                 batches=[batch_to_torch(b, "cpu") for b in batches], order=order,
                 device=device, backend=backend, mode="trainer")
    start = time.perf_counter()
    ranks = run_ranks(setup, tmp, f"{backend}{world}", world)
    ranks_s = time.perf_counter() - start
    r0 = ranks[0]
    for r in ranks[1:]:
        for name, value in r0["params"].items():
            expect(torch.equal(value, r["params"][name]), f"{what}: {name} differs between ranks")
    schedule = make_lr_schedule(cfg, steps, world_size=world)
    expect(all(r["lr"] == [schedule(i) for i in range(steps)] for r in ranks)
           and r0["lr"][0] == world * cfg.optim.lr,
           f"{what}: lr {r0['lr']}, expected {world} x the config's {cfg.optim.lr}")
    single_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, lr=world * cfg.optim.lr, grad_acc_steps=world))
    model = fresh_model(single_cfg, weights)
    optimizer, scheduler = make_optimizer(model, single_cfg, steps)
    step = make_train_step(model, single_cfg, optimizer, scheduler, device=DEVICE)
    generators = [target_generator(cfg.seed + r) for r in range(world)]
    for i, pair in enumerate(order):
        step(batches[pair], generators[i % world])
        if i == world - 1:
            first = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    floor = 1e-6 * max(g.norm().item() for g in first.values())
    grad_worst = max((r0["grads"][n] - g).norm().item() / max(g.norm().item(), floor)
                     for n, g in first.items())
    expect(grad_worst <= 1e-5, f"{what}: first step's gradients {grad_worst:.2e} from one "
                               f"process accumulating the same pairs")
    # each update moves a parameter by at most ~lr; opposite directions at worst
    reach = steps * 2 * (world * cfg.optim.lr)
    param_worst = max((r0["params"][n] - v.cpu()).abs().max().item()
                      for n, v in model.state_dict().items())
    expect(param_worst <= reach, f"{what}: parameters {param_worst:.2e} from one process "
                                 f"accumulating, beyond the updates' reach {reach:.2e}")
    launched = [name for name, n in expected_launches(batches[0], "train",
                                                      cfg.geotransformer.blocks).items() if n]
    missing = [name for name in launched if not any(
        re.search(KERNEL_SYMBOLS[wrapper_of(name)], k) for k in r0["trace_kernels"])]
    expect(not missing, f"profile_steps trace lacks the kernels of {missing}; its kernels: "
                        f"{r0['trace_kernels']}")
    rank_ms = [[1e3 * h["process_s"] for h in r["history"]] for r in ranks]
    steady = statistics.median(rank_ms[0][2:])
    print(f"engine {what}: {steps} steps each through the Trainer, parameters "
          f"bit-equal between the ranks, lr {r0['lr'][0]:.2e} ({world}x), first step's gradients "
          f"{grad_worst:.2e} and parameters {param_worst:.2e} from one process accumulating the "
          f"same pairs; the profile trace holds {launched}; TensorBoard writer "
          f"{'on' if r0['writer'] else 'off'}; rank 0 step median "
          f"{statistics.median(rank_ms[0]):.3f} ms, {steady:.3f} ms from step 2 on (each "
          f"rank's steps "
          f"{[[round(t, 2) for t in ms] for ms in rank_ms]}, CUDA events), {ranks_s:.1f} s for "
          f"the {world} processes; {smi}", flush=True)
    return dict(grad_worst=grad_worst, param_worst=param_worst, reach=reach, rank_step_ms=rank_ms,
                ranks_s=ranks_s, writer=r0["writer"], trace_kernels=r0["trace_kernels"],
                median_ms=statistics.median(rank_ms[0]), steady_ms=steady)


def ranks_phase(cfg, weights, batches, smi, report, tmp):
    """18c: two ranks on this card over Gloo, 3 steps each through the
    Trainer, against each other and against one process accumulating the
    same pairs (k = 2, the 2-rank lr); the profile hook's trace; one rank
    over NCCL against a step without a process group; debug_nans."""
    readings = ranks_against_one_process(cfg, weights, batches, 2, "gloo", "cuda:0",
                                         ENGINE_ORDER, smi, tmp)
    setup = dict(cfg=cfg, weights={k: v.cpu() for k, v in weights.items()},
                 batches=[batch_to_torch(batches[0], "cpu")], order=(0,), device="cuda:0",
                 backend="nccl", mode="step")
    # one rank over NCCL against the same step without a process group
    nccl = run_ranks(setup, tmp, "nccl", 1)[0]
    model = fresh_model(cfg, weights)
    step = make_train_step(model, cfg, *make_optimizer(model, cfg, 1), device=DEVICE)
    metrics = step(batches[0], target_generator(0))
    for name, value in model.state_dict().items():
        expect(torch.equal(value.cpu(), nccl["params"][name]),
               f"one NCCL rank: {name} differs from the step without a process group")
    expect(nccl["metrics"]["loss"] == metrics["loss"].item(), "one NCCL rank: loss differs")
    # debug_nans: anomaly detection raises where a NaN enters a backward
    trainer = Trainer(dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, max_iteration=1, snapshot_steps=10 ** 9)), fresh_model(cfg, weights),
        BatchLoader(batches[:1]), output_dir=os.path.join(tmp, "debug_nans"),
        tensorboard=False, debug_nans=True, device=DEVICE)

    def inject(module, args, output):
        output.register_hook(lambda g: g * float("nan"))

    handle = trainer.model.transformer.in_proj.register_forward_hook(inject)
    try:
        trainer.run_iterations()
        raised = None
    except RuntimeError as error:
        raised = str(error)
    finally:
        handle.remove()
        torch.autograd.set_detect_anomaly(False)
    expect(raised is not None and "nan" in raised, f"debug_nans did not raise: {raised}")
    print(f"engine: one NCCL rank's step bit-equal to the step without a process group; "
          f"debug_nans raised: {raised.splitlines()[0]}", flush=True)
    report["engine_ranks"] = dict(readings, debug_nans=raised)
    return readings["median_ms"]


def engine_phase(launches, report):
    """Phase 18: the training engine on the phase-6 3DMatch pairs and
    weights (full width) and one KITTI pair."""
    start = time.perf_counter()
    smi = card(DEVICE)
    cfg, model, batches = SHARED["3dmatch_train"]  # phase 19 reads them too
    weights = copy.deepcopy(model.state_dict())
    acc_ms, plain_ms, mean_rel = accumulation_phase(cfg, weights, batches, launches, report)
    print(f"engine accumulation (grad_acc_steps 2): 4 mini-steps and a NaN-hooked one dropped, "
          f"2 updates, the accumulated mean {mean_rel:.2e} from the mini-steps' gradients one by "
          f"one; mini-step median {acc_ms:.3f} ms against {plain_ms:.3f} ms a step without "
          f"accumulation (CUDA events); {smi}", flush=True)
    no_inverse_phase("3dmatch", cfg, weights, batches[0], launches, report)
    kitti_cfg, kitti_model, kitti_batches = SHARED.pop("kitti_train")
    no_inverse_phase("kitti", kitti_cfg, kitti_model.state_dict(), kitti_batches[0], launches,
                     report)
    del kitti_model, kitti_batches
    with tempfile.TemporaryDirectory() as tmp:
        rank_ms = ranks_phase(cfg, weights, batches, smi, report, tmp)
    seconds = time.perf_counter() - start
    print(f"engine: phase 18 {seconds:.1f} s; steps {acc_ms:.3f} ms with accumulation, "
          f"{plain_ms:.3f} ms without, {rank_ms:.3f} ms on each of two ranks; {smi}",
          flush=True)
    report["engine"] = dict(seconds=seconds, accumulation_ms=acc_ms, step_ms=plain_ms,
                            two_rank_ms=rank_ms, smi=smi)


def across_cards(world):
    """``chip_smoke.py --ranks-across-cards N``: the data-parallel path on N
    cards of one host, NCCL, a rank a card (what phase 18c cannot show on one
    card), held as phase 18c holds its two ranks: against each other and
    against one process accumulating the same pairs. Seeded random weights,
    the phase-2 3DMatch pairs. The run without arguments needs one card."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        raise SystemExit(f"--ranks-across-cards {world} needs {world} CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"build: {cuda.build():.1f} s", flush=True)
    cfg = make_3dmatch_config()
    caps, _, batches_np, _ = build_batches(cfg, SEEDS)
    cfg = cfg.with_caps(stage_caps=caps)
    batches = [batch_to_torch(b, DEVICE) for b in batches_np]
    for batch in batches:
        batch.update(precompute_gt_targets(cfg, batch, device=DEVICE))
    weights = create_model(cfg, device=DEVICE).state_dict()
    smi = card(DEVICE)
    order = tuple(i % len(batches) for i in range(world * ACROSS_CARDS_STEPS))
    with tempfile.TemporaryDirectory() as tmp:
        readings = ranks_against_one_process(cfg, weights, batches, world, "nccl", None, order,
                                             smi.replace("\n", "; "), tmp)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "across_cards.json"), "w") as f:
        json.dump(dict(readings, nvidia_smi=smi), f, indent=1)
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


def limit_calls(device):
    """Phase 15's calls (inputs from a seed): each kernel at shapes its CUDA
    kernel once refused, at the former limit and past it, under its KERNELS
    entry: the input convs at K = 16, 20 and 32 kernel points (the configs
    use 15; KITTI's stream, a union of 2,000 queries), the Sinkhorn forward
    and training forward at 256 x 256, 257 x 257 and 400 x 300 and its
    backward at 160, 161 and 257 (16 patches, 100 iterations), the RPE pair
    scores at C = 130, 640 and 1024 and H = 12 and 16, the attention at head
    widths 24, 48, 96 and 128 (300 superpoints, 280 valid, a bias, holes in
    the key mask), and both with operands 4 bytes off a 16-byte boundary;
    the GSE embedding and its backward at C = 96 (the small synthetic
    workflow's width: the forward's channels across 4 warps, the backward
    in 32-channel blocks), 300 superpoints with 280 valid, the backward
    also with two reference vectors tied (its float64 settling); both at
    C = 48 (padded to 64), 160, 192 and 224 (the new instances; the
    backward's ragged row tiles), 512 (two channel blocks, two row chunks)
    with A = 3 and at C = 256 with A = 4 and 5 (two angle groups), the
    backward also at C = 160 tied; KPConv rows 1 and 6 at K = 16, 20 and 32
    kernel points and C = 64 on the union case's table and its inverse,
    row 5 at K = 20 on its split tables, row 1 at C_in = 1,028 (two passes
    of 256 channel groups)."""
    g = torch.Generator().manual_seed(15)
    to = lambda *ts: [t.to(device) for t in ts]  # noqa: E731
    calls = collections.defaultdict(list)

    def kernel_points(k):
        return (torch.rand(k, 3, generator=g) - 0.5) * 0.1

    m, h = 20004, 65  # KITTI's stream
    valid = torch.rand(m, h, generator=g) < 0.8
    feat = torch.randn(m, h, generator=g)
    stream = torch.randn(5, m, h, generator=g) * 0.03
    stream[3], stream[4] = (feat > 0).float(), feat
    stream = (stream * valid).to(device)
    for k in (16, 20, 32):
        kp, w = to(kernel_points(k), torch.randn(k, 1, 64, generator=g))
        calls["kpconv_stream_fused (residuals)"].append(((stream, kp, w, 0.3), {"residuals": True}))

    m, n, h, tile = 2000, 3000, 38, 128
    q_points, s_points = torch.rand(m, 3, generator=g), torch.rand(n, 3, generator=g)
    table = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    table[torch.rand(m, h, generator=g) < 0.3] = n
    table = table.numpy()
    cap = max(np.unique(table[t:t + tile][table[t:t + tile] < n]).size for t in range(0, m, tile))
    rows, sel = build_union_tables(table, n, tile=tile, union_cap=cap)
    feats = (torch.rand(n, 1, generator=g) > 0.2).float()
    union = to(feats, q_points, s_points, torch.from_numpy(rows), torch.from_numpy(sel))
    for k in (16, 20, 32):
        kp, w, bias = to(kernel_points(k), torch.randn(k, 1, 64, generator=g),
                         torch.randn(64, generator=g))
        calls["kpconv_union_input_fused"].append(
            ((*union, kp, w, 0.05, bias), {"tile": tile, "residuals": True}))

    def sinkhorn_case(p, m1, n1):
        scores = torch.randn(p, m1, n1, generator=g)
        rows = torch.rand(p, m1, generator=g) < 0.85
        cols = torch.rand(p, n1, generator=g) < 0.85
        rows[:, -1] = cols[:, -1] = True
        masked = ~(rows[:, :, None] & cols[:, None, :])
        return to(torch.where(masked, -1e12, scores),
                  torch.where(rows, -np.log(m1 + n1), -1e12).float(),
                  torch.where(cols, -np.log(m1 + n1), -1e12).float())

    for m1, n1 in ((256, 256), (257, 257), (400, 300)):
        scores, log_mu, log_nu = sinkhorn_case(16, m1, n1)
        for name in ("sinkhorn_log_iterations", "sinkhorn_fwd_train"):
            calls[name].append(((scores, log_mu, log_nu, 100), {}))
    for m1 in (160, 161, 257):
        scores, log_mu, log_nu = sinkhorn_case(16, m1, m1)
        _, v_hist = kernels_sinkhorn.sinkhorn_fwd_train_plain(scores, log_mu, log_nu, 100)
        dout = torch.where(scores > -1e11, torch.randn(scores.shape, generator=g).to(device), 0.0)
        calls["sinkhorn_bwd_train"].append(((scores, log_mu, v_hist, dout), {}))

    def shifted(t):
        """t's values in a view 4 bytes off a 16-byte boundary."""
        view = torch.empty(t.numel() + 1, device=device)[1:].view(t.shape)
        return view.copy_(t)

    n, nv = 300, torch.tensor(280, dtype=torch.int32, device=device)
    for c, heads, aligned in ((130, 4, True), (640, 4, True), (1024, 4, True), (256, 12, True),
                              (256, 16, True), (256, 4, False)):
        embed, qw = to(torch.randn(n, n, c, generator=g), torch.randn(n, heads, c, generator=g))
        if not aligned:
            embed, qw = shifted(embed), shifted(qw)
        calls["rpe_pair_scores"].append(((embed, qw, nv, nv), {}))
    key_masks = (torch.rand(n, generator=g) > 0.2).to(device)
    for dh, aligned in ((24, True), (48, True), (96, True), (128, True), (64, False)):
        q, k, v, bias = to(*(torch.randn(s, generator=g) for s in
                             ((4, n, dh), (4, n, dh), (4, n, dh), (n, 4, n))))
        if not aligned:
            q, k, v = shifted(q), shifted(k), shifted(v)
        calls["fused_masked_attention"].append(
            ((q, k, v, bias, nv, nv, dh ** -0.5, key_masks), {}))

    c = 96
    points, ref_vectors = torch.rand(n, 3, generator=g), torch.randn(n, 3, 3, generator=g) * 0.1
    w_d, w_a = (torch.randn(c, c, generator=g) / c**0.5 for _ in range(2))
    b_d, b_a = torch.randn(c, generator=g), torch.randn(c, generator=g)
    calls["gse_embedding_full"].append(
        ((*to(points, ref_vectors, w_d, b_d, w_a, b_a), 0.2, 15.0, nv), {}))
    tied = ref_vectors.clone()
    tied[:, 2] = tied[:, 0]  # their projections tie exactly everywhere
    for vectors in (ref_vectors, tied):
        de = torch.randn(n, n, c, generator=g)
        calls["gse_full_bwd"].append(
            ((*to(points, vectors, w_a), 0.2, 15.0, de.to(device), nv), {}))

    # the GSE rows at every kind of shape their JAX kernels take
    for c, angles in ((48, 3), (160, 3), (192, 3), (224, 3), (512, 3), (256, 4), (256, 5)):
        points = torch.rand(n, 3, generator=g)
        ref_vectors = torch.randn(n, angles, 3, generator=g) * 0.1
        w_d, w_a = (torch.randn(c, c, generator=g) / c**0.5 for _ in range(2))
        b_d, b_a = torch.randn(c, generator=g), torch.randn(c, generator=g)
        calls["gse_embedding_full"].append(
            ((*to(points, ref_vectors, w_d, b_d, w_a, b_a), 0.2, 15.0, nv), {}))
        vectors = [ref_vectors]
        if c == 160:
            tied = ref_vectors.clone()
            tied[:, 2] = tied[:, 0]
            vectors.append(tied)
        for v in vectors:
            de = torch.randn(n, n, c, generator=g)
            calls["gse_full_bwd"].append(((*to(points, v, w_a), 0.2, 15.0, de.to(device), nv), {}))

    # KPConv rows 1, 5 and 6 past 16 kernel points and row 1 past 256
    # channel groups a row, on the union case's table (2,000 queries of
    # 3,000 supports, 38 columns, 30 % sentinels) and its inverse
    m, n = q_points.shape[0], s_points.shape[0]
    table_t = torch.from_numpy(table).to(device)
    degree = int(np.bincount(table[table < n], minlength=n).max())
    inverse = torch.from_numpy(build_inverse_table(table, n, round_up(degree, 8))).to(device)
    s_feats = torch.randn(n, 64, generator=g)
    gdiv = torch.randn(m, 64, generator=g).to(device)
    for k in (16, 20, 32):
        kp, w = to(kernel_points(k), torch.randn(k, 64, 64, generator=g) / 64)
        calls["kpconv_fused"].append(((*to(s_feats, q_points, s_points), table_t, kp, w, 0.05), {}))
        calls["kpconv_bwd_fused"].append(
            ((*to(s_feats, s_points, q_points), gdiv, inverse, kp, w, 0.05), {}))
        if k == 20:
            m2 = int((table[:, 16:] < n).any(axis=1).sum())
            split = [torch.from_numpy(x).to(device)
                     for x in build_split_tables(table, n, 16, round_up(m2, 8))]
            calls["kpconv_split_fused"].append(
                ((*to(s_feats, q_points, s_points), table_t[:, :16].contiguous(), *split, kp, w,
                  0.05), {}))
    kp, w = to(kernel_points(15), torch.randn(15, 1028, 64, generator=g) / 1028)
    calls["kpconv_fused"].append(
        ((*to(torch.randn(n, 1028, generator=g), q_points, s_points), table_t, kp, w, 0.05), {}))
    launch_limit_calls(calls, g, to, device)
    precision_limit_calls(calls, g, to)
    return calls


def precision_limit_calls(calls, g, to):
    """Phase 15's calls at the bfloat16 point: one of each route family of
    the bfloat16 instances, copies of earlier calls of this phase with the
    precision keywords (row 12: its embedding in bfloat16). Row 1: the edge
    pass in chunks of 16 kernel points (K = 20, C = 64: four channels a
    thread), past 256 channel groups (C_in = 1,028), one channel a thread
    (C_in = 6, a new call) and the C_in = 1 CUDA-core product (a new call);
    row 5 at K = 20; row 2 on its general route (H = 512) and in chunks
    (K = 20); row 7 on its general route (a ~14,000-row union) and in chunks
    (K = 20); row 3 on gse_general_kernel (C = 48; C = 256 with A = 5, two
    angle groups) and on gse_kernel<96>, the embedding alone in bfloat16 on
    one of them; row 12 on the scalar route (C = 130)."""
    bf16 = torch.bfloat16
    mxu = {"mxu_dtype": bf16}

    def copy(name, pick, extra, args_of=None):
        args, kwargs = next((a, k) for a, k in calls[name] if pick(a, k))
        calls[name].append((args if args_of is None else args_of(args), dict(kwargs, **extra)))

    def conv_k_c(k, c):
        return lambda a, kw: a[5].shape[0] == k and a[5].shape[1] == c and not kw

    copy("kpconv_fused", conv_k_c(20, 64), mxu)
    copy("kpconv_fused", conv_k_c(15, 1028), mxu)
    s_feats, q_points, s_points, table, kp, w = next(a for a, kw in calls["kpconv_fused"]
                                                     if conv_k_c(20, 64)(a, kw))[:6]
    for c_in in (6, 1):
        feats = s_feats[:, :c_in].abs() if c_in == 1 else s_feats[:, :c_in].contiguous()
        weights = to(torch.randn(20, c_in, 64, generator=g) / c_in)[0]
        calls["kpconv_fused"].append(((feats.contiguous(), q_points, s_points, table, kp,
                                       weights, 0.05), dict(mxu)))
    copy("kpconv_split_fused", lambda a, kw: a[8].shape[0] == 20, mxu)
    copy("kpconv_stream_fused (residuals)", lambda a, kw: a[0].shape[2] == 512, mxu)
    copy("kpconv_stream_fused (residuals)", lambda a, kw: a[1].shape[0] == 20, mxu)
    copy("kpconv_union_input_fused", lambda a, kw: a[3].shape[1] > 10000, mxu)
    copy("kpconv_union_input_fused", lambda a, kw: a[5].shape[0] == 20, mxu)
    both = {"basis_dtype": bf16, "embed_dtype": bf16}
    copy("gse_embedding_full", lambda a, kw: a[2].shape[0] == 48, both)
    copy("gse_embedding_full", lambda a, kw: a[2].shape[0] == 256 and a[1].shape[1] == 5, both)
    copy("gse_embedding_full", lambda a, kw: a[2].shape[0] == 96, both)
    copy("gse_embedding_full", lambda a, kw: a[2].shape[0] == 96, {"embed_dtype": bf16})
    copy("rpe_pair_scores", lambda a, kw: a[0].shape[2] == 130, {},
         lambda a: (a[0].to(bf16),) + tuple(a[1:]))


def launch_limit_calls(calls, g, to, device):
    """Phase 15's calls past the launcher limits the JAX kernels do not
    share, each on its general route: the stream input conv at H = 512
    columns and at K D = 61,440 (K 15, D 4,096); the union input conv at a
    ~14,000-row union and at K D = 61,440; rows 1, 5 and 6 with the pool over
    1,024 columns at C = 4 (the pool phase in 128-column chunks); row 11 at
    K = 2,048, S = 8; row 13 at dh = 4,096, 4 heads, 256 keys; row 8 at A =
    255 and 300, C = 8; the search at cand_cap 32,768 and brute over 40,000
    support rows."""
    m, h = 4000, 512
    valid = torch.rand(m, h, generator=g) < 0.8
    feat = torch.randn(m, h, generator=g)
    stream = torch.randn(5, m, h, generator=g) * 0.03
    stream[3], stream[4] = (feat > 0).float(), feat
    kp15 = (torch.rand(15, 3, generator=g) - 0.5) * 0.1
    kp, w = to(kp15, torch.randn(15, 1, 64, generator=g))
    calls["kpconv_stream_fused (residuals)"].append(
        (((stream * valid).to(device), kp, w, 0.3), {"residuals": True}))
    kitti_stream = calls["kpconv_stream_fused (residuals)"][0][0][0]  # KITTI's (5, 20004, 65)
    calls["kpconv_stream_fused (residuals)"].append(
        ((kitti_stream, kp, torch.randn(15, 1, 4096, generator=g).to(device), 0.3),
         {"residuals": True}))

    # a union of ~14,000 support rows a 512-query tile: random neighbors
    m, n, h, tile = 2048, 60000, 34, 512
    q_points, s_points = torch.rand(m, 3, generator=g), torch.rand(n, 3, generator=g)
    table = torch.randint(0, n, (m, h), generator=g).to(torch.int32)
    table[torch.rand(m, h, generator=g) < 0.1] = n
    table = table.numpy()
    cap = max(np.unique(table[t:t + tile][table[t:t + tile] < n]).size for t in range(0, m, tile))
    rows, sel = build_union_tables(table, n, tile=tile, union_cap=cap)
    feats = (torch.rand(n, 1, generator=g) > 0.2).float()
    union = to(feats, q_points, s_points, torch.from_numpy(rows), torch.from_numpy(sel))
    w, bias = to(torch.randn(15, 1, 64, generator=g), torch.randn(64, generator=g))
    calls["kpconv_union_input_fused"].append(
        ((*union, kp, w, 0.05, bias), {"tile": tile, "residuals": True}))
    m, n, h, tile = 2000, 3000, 38, 128
    q_points, s_points = torch.rand(m, 3, generator=g), torch.rand(n, 3, generator=g)
    table = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32).numpy()
    cap = max(np.unique(table[t:t + tile]).size for t in range(0, m, tile))
    rows, sel = build_union_tables(table, n, tile=tile, union_cap=cap)
    union = to((torch.rand(n, 1, generator=g) > 0.2).float(), q_points, s_points,
               torch.from_numpy(rows), torch.from_numpy(sel))
    w, bias = to(torch.randn(15, 1, 4096, generator=g), torch.randn(4096, generator=g))
    calls["kpconv_union_input_fused"].append(
        ((*union, kp, w, 0.05, bias), {"tile": tile, "residuals": True}))

    # the pool over 1,024 columns at C = 4: rows 1 and 5, then row 6 over a
    # 1,024-column inverse table at C_out = 4
    m, n, h, c = 2000, 3000, 1024, 4
    q_points, s_points = torch.rand(m, 3, generator=g) * 0.3, torch.rand(n, 3, generator=g) * 0.3
    table = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    table[torch.rand(m, h, generator=g) < 0.3] = n
    pool = torch.randint(-2, 2, (n, c), generator=g).float()
    conv = to(torch.randn(n, c, generator=g), q_points, s_points)
    w = to(torch.randn(15, c, 8, generator=g) / c)[0]
    kw = {"pool_feats": pool.to(device), "residuals": True}
    calls["kpconv_fused"].append(((*conv, table.to(device), kp, w, 0.05), kw))
    m2 = int((table[:, 16:] < n).any(dim=1).sum())
    split = [torch.from_numpy(x).to(device)
             for x in build_split_tables(table.numpy(), n, 16, round_up(m2, 8))]
    calls["kpconv_split_fused"].append(
        ((*conv, table[:, :16].contiguous().to(device), *split, kp, w, 0.05), kw))
    n, m, h, j = 160, 1300, 160, 1024
    s_points, q_points = torch.rand(n, 3, generator=g) * 0.1, torch.rand(m, 3, generator=g) * 0.1
    nbrs = torch.argsort(torch.cdist(q_points, s_points), dim=1)[:, :h].to(torch.int32)
    nbrs[torch.rand(m, h, generator=g) < 0.3] = n
    pool = torch.randint(-2, 2, (n, c), generator=g).float()
    _, pooled, _, ties = kernels_kpconv.kpconv_fused_plain(
        torch.ones(n, 1), q_points, s_points, nbrs, kp15, torch.zeros(15, 1, 1), 0.05,
        pool_feats=pool, residuals=True)
    inverse = torch.from_numpy(build_inverse_table(nbrs.numpy(), n, j))
    calls["kpconv_bwd_fused"].append(
        (tuple(to(torch.randn(n, 8, generator=g), s_points, q_points,
                  torch.randn(m, c, generator=g), inverse, kp15,
                  torch.randn(15, 8, c, generator=g) / 8)) + (0.05,),
         {"pool_feats": pool.to(device), "pooled": pooled.to(device),
          "dpool_over_ties": (torch.randn(m, c, generator=g) / ties).to(device)}))

    # row 11: 2,048-point patches, 8 candidates a node
    m, n, k, s = 8, 12, 2048, 8
    ref = torch.rand(m, 1, 3, generator=g) + torch.rand(m, k, 3, generator=g) - 0.5
    src = torch.rand(n, 1, 3, generator=g) + torch.rand(n, k, 3, generator=g) - 0.5
    calls["patch_overlaps"].append(
        (tuple(to(ref, torch.rand(m, k, generator=g) > 0.3, src,
                  torch.rand(n, k, generator=g) > 0.3, torch.randint(0, n, (m, s), generator=g),
                  torch.rand(m, s, generator=g) > 0.25)) + (0.1,), {}))

    # row 13: head width 4,096 (its q tile read in place), 4 heads, 256 keys
    n, heads, dh = 256, 4, 4096
    nv = torch.tensor(250, dtype=torch.int32, device=device)
    q, k, v, bias = to(*(torch.randn(sh, generator=g) for sh in
                         ((heads, n, dh), (heads, n, dh), (heads, n, dh), (n, heads, n))))
    calls["fused_masked_attention"].append(
        ((q, k, v, bias, nv, nv, dh ** -0.5, (torch.rand(n, generator=g) > 0.2).to(device)), {}))

    # row 8: A = 255 and 300 angles (k* past a byte), C = 8, 300 rows (280 valid)
    n, c = 300, 8
    nv = torch.tensor(280, dtype=torch.int32, device=device)
    for angles in (255, 300):
        points = torch.rand(n, 3, generator=g)
        ref_vectors = torch.randn(n, angles, 3, generator=g) * 0.1
        w_a = torch.randn(c, c, generator=g) / c**0.5
        de = torch.randn(n, n, c, generator=g)
        calls["gse_full_bwd"].append(((*to(points, ref_vectors, w_a), 0.2, 15.0, de.to(device),
                                       nv), {}))

    # the search: cand_cap 32,768 on a dense cloud (thousands of keys in
    # radius a query) and brute over 40,000 support rows
    cs, n_s, n_q, radius = 40960, 40000, 1200, 0.25
    queries = torch.full((1, 1280, 3), 1e6)
    queries[0, :n_q] = 0.25 + 0.5 * torch.rand(n_q, 3, generator=g)
    points = torch.full((1, cs, 3), 1e6)
    points[0, :n_s] = torch.rand(n_s, 3, generator=g)
    q_len, s_len = to(torch.tensor([n_q], dtype=torch.int32), torch.tensor([n_s],
                                                                         dtype=torch.int32))
    queries, points = to(queries, points)
    support, starts, origin, dims, _ = preprocess_device._search_support(points, s_len, radius,
                                                                        1 << 20)
    calls["grid_radius_search"].append(
        ((queries, q_len, support, s_len, starts, origin, dims, radius, 40, 32768), {}))
    index = torch.arange(cs, device=device, dtype=torch.float32)
    brute = torch.cat([points, index[None, :, None]], dim=2)
    calls["grid_radius_search"].append(
        ((queries, q_len, brute, s_len, None, None, None, radius, 40, 0), {}))


def widths_phase(device, launches, report):
    """Phase 15's widths path: the 3DMatch cell's pair 0 at full width with
    geotransformer.hidden_dim = 192 and angle_k = 4 (the GSE forward's 192
    instance with two angle groups; the backward's ragged row tiles and two
    groups), seeded weights. One forward counted against what the batch
    implies (expected_launches), checked as phase 3 checks its pairs and
    against the force_pallas=False model on the same weights; one training
    step through make_train_step counted, finite and not skipped, its loss
    (before the step, from step_gradients) within 1e-3 of the plain
    route's; the forward's and a step's kernel calls against their plain
    versions. Returns them as path "widths"."""
    cfg, _, batches = SHARED["3dmatch_train"]
    cfg = dataclasses.replace(cfg, geotransformer=dataclasses.replace(
        cfg.geotransformer, hidden_dim=WIDTHS_HIDDEN, angle_k=WIDTHS_ANGLES))
    batch, blocks, start = batches[0], cfg.geotransformer.blocks, time.perf_counter()
    model = create_model(cfg, seed=WIDTHS_SEED, device=device)
    plain_model = create_model(cfg.with_model(force_pallas=False), device=device)
    plain_model.load_state_dict(model.state_dict())
    with torch.no_grad():
        forward_ms(model, batch)  # warm-up
        (ms, out), counts = counted(lambda: forward_ms(model, batch))
        expect_launches(counts, [batch], "inference", "widths forward", blocks)
        launches["widths_inference"] = counts
        check_output(out, cfg, cfg.caps.stage_caps)
        compare_coarse_features(out, plain_model(batch), "widths whole model vs force_pallas=False")
        with capture_kernel_calls(INFERENCE) as records:
            model(batch)
    results = compare_kernels(records, INFERENCE, reps=3, stage_of=stages_of(batch))
    with capture_kernel_calls(TRAINING) as records:
        loss_kernel, _ = step_gradients(model, cfg, batch, 0)
    results.update(compare_kernels(records, TRAINING, reps=3, stage_of=stages_of(batch)))
    loss_plain, _ = step_gradients(plain_model, cfg, batch, 0)
    rel = abs(loss_kernel - loss_plain) / abs(loss_plain)
    expect(rel <= 1e-3, f"widths step: loss {loss_kernel} vs plain route {loss_plain}")
    optimizer, scheduler = make_optimizer(model, cfg, steps_per_epoch=1)
    step = make_train_step(model, cfg, optimizer, scheduler, device=DEVICE)
    metrics, counts = counted(lambda: step(batch, target_generator(0)))
    expect_launches(counts, [batch], "train", "widths train step", blocks)
    launches["widths_train"] = counts
    expect(metrics["grad_finite"].item() == 1.0, "widths train step skipped by the guard")
    expect(np.isfinite(metrics["loss"].item()), f"widths train step: loss {metrics['loss']}")
    seconds = time.perf_counter() - start
    print(f"15 widths (hidden_dim {WIDTHS_HIDDEN}, angle_k {WIDTHS_ANGLES}): forward {ms:.3f} ms "
          f"(CUDA events); step loss kernel {loss_kernel:.6f}, plain {loss_plain:.6f} (rel "
          f"{rel:.2e}); trained step loss {metrics['loss'].item():.6f}; {seconds:.1f} s",
          flush=True)
    report["widths"] = dict(forward_ms=ms, loss_kernel=loss_kernel, loss_plain=loss_plain,
                            seconds=seconds)
    return {"widths": results}


def limits_phase(device, report):
    """Phase 15: each kernel at the shapes of ``limit_calls``, every call
    launching the kernel once (its counter rises: no plain route), held to
    its plain version within its row's tolerance and timed alone from its
    own graph with its shape and bound (by_call)."""
    start = time.perf_counter()
    calls = limit_calls(device)
    for name, entries in calls.items():
        kernel, counter = getattr(KERNELS[name].module, wrapper_of(name)), wrapper_of(name)
        for args, kwargs in entries:
            before = cuda.launches[counter]
            kernel(*args, **kwargs)
            expect(cuda.launches[counter] == before + 1,
                   f"limits: {name} did not launch its kernel once")
    results = compare_kernels(calls, list(calls), reps=3, shapes=LIMIT_SHAPES)
    print_results("limits", results)
    for name, r in results.items():
        for entry in r["by_call"]:
            shape = {k: v for k, v in entry.items() if k not in ("device_ms", "bound_ms",
                                                                  "max_abs_err")}
            print(f"limits {name} {shape}: {entry['device_ms']:.4f} ms on the device (graph), "
                  f"bound {entry['bound_ms']:.4f} ms, max|kernel - plain| "
                  f"{entry['max_abs_err']:.3e}", flush=True)
    seconds = time.perf_counter() - start
    print(f"15 limits: {sum(len(e) for e in calls.values())} calls in {seconds:.1f} s", flush=True)
    report["limits"] = results
    report["limits_s"] = seconds
    return results


def main():
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["--ranks-across-cards"]:
        across_cards(int(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--profiler-sessions"]:
        profiler_sessions_worker(sys.argv[2])
        return
    if sys.argv[1:2] == ["--profile-builds"]:
        profile_builds_worker(*sys.argv[2:4])
        return
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device (torch.cuda.is_available() is False)")
    script_start = time.perf_counter()
    device = torch.device(DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}

    # 1. build
    build_s = cuda.build()
    print(f"build: {build_s:.1f} s for {', '.join(cuda.SOURCES)} (nvcc, sm_90a)", flush=True)
    report["build_s"] = build_s

    launches = {}
    report["phase_s"] = {}

    def phase(label, run, *args):
        start = time.perf_counter()
        out = run(*args)
        report["phase_s"][label] = seconds = time.perf_counter() - start
        print(f"wall: {label} {seconds:.1f} s", flush=True)
        return out or {}

    by_path = {"3dmatch": phase("3dmatch", threedmatch_phases, device, launches, report)}
    by_path.update(phase("kitti", kitti_phases, device, launches, report))
    # the precision path: the JAX package's default point on the same pairs
    by_path.update(phase("precision", precision_phase, device, launches, report))
    by_path.update(phase("precision train", precision_train_phase, device, launches, report))
    # 18. the training engine on the phases' pairs and weights
    phase("engine", engine_phase, launches, report)
    with tempfile.TemporaryDirectory() as tmp:
        by_path.update(phase("modelnet", modelnet_phases, device, launches, report, tmp))
        by_path.update(phase("synthetic", synthetic_phases, device, launches, report, tmp))
        by_path.update(phase("device pyramid", device_pyramid_phases, device, launches, report,
                             tmp))
        # 19. the native host library and the model extras
        by_path.update(phase("extras", extras_phases, device, launches, report))
        # 20. the profiler's later sessions, the encoder and decoder, the tools
        by_path.update(phase("tools", tools_phases, device, launches, report, tmp))
    # 15. the widths path: the 3DMatch cell at hidden_dim 192, angle_k 4
    by_path.update(phase("widths", widths_phase, device, launches, report))
    for path, path_results in by_path.items():
        print_results(path, path_results)
    results = merge_paths(by_path)
    # 15. every lifted limit: each call under by_call (path "limits"), apart
    # from the paths' sums
    for name, r in phase("limits", limits_phase, device, report).items():
        results[name]["by_call"] += [dict(path="limits", **entry) for entry in r["by_call"]]
        results[name]["limits"] = {key: r[key] for key in ("calls", "max_abs_err",
                                                           "device_ms", "bound_ms")}
    report["kernels"] = results

    smi = card(DEVICE)
    report["nvidia_smi"] = smi
    report["launches"] = launches
    report["script_s"] = time.perf_counter() - script_start
    print(f"chip_smoke.py: {report['script_s']:.1f} s to this point", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    violations = report.get("violations", [])
    expect(not violations, f"whole-step gradients: {violations}")

    line = []
    precision = {name: {path: {"device_ms": v["beside"][name][0],
                               "f32_device_ms": v["beside"][name][1],
                               "witness": v["witness"].get(name)}
                        for path, v in report["precision"].items()
                        if isinstance(v, dict) and name in v["beside"]}
                 for name in KERNELS}
    for name, kernel in KERNELS.items():
        r = results[name]
        by_path = {path: counts.get(launch_key(name), 0) for path, counts in launches.items()
                   if kernel.runs is None or path.endswith(kernel.runs)}
        expect(sum(by_path.values()) > 0, f"{name}: never launched on a counted path")
        line.append({"name": name, "route": "cuda", "source": kernel.source,
                     "replaces": kernel.replaces,
                     "launches": sum(by_path.values()), "launches_by_path": by_path,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "library_device_ms": r["library_device_ms"],
                     "by_path": r["by_path"], **({"by_call": r["by_call"]} if r["by_call"] else {}),
                     **({"precision": precision[name]} if precision[name] else {}),
                     **({"limits": r["limits"]} if "limits" in r else {})})
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
