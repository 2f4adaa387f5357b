r"""Input pipeline: dataset sample -> host pyramid -> padded PairBatch
(``geotransformer_tpu/preprocess/loader.py``; reference `utils/data.py`).

A process pool runs the host pyramid (voxel subsampling and radius search,
the CPU-expensive part) and, optionally, the GT targets of training
(:func:`geotransformer_tpu_torch.models.precompute_gt_targets` on the CPU)
while the card consumes earlier batches. In the raw mode (a
``device_plan``) the workers only fetch samples, the main process pads each
group's raw points into its capacity bucket, and the step builds the
pyramid on the card (:mod:`geotransformer_tpu_torch.preprocess.device`).
Under data parallelism each process iterates its shard of the epoch's
order (``num_shards`` = the world size, ``shard_index`` = its rank).
"""

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from geotransformer_tpu_torch.preprocess.device import prepare_raw_pair
from geotransformer_tpu_torch.preprocess.pyramid import (
    build_pyramid,
    pad_registration_batch,
    table_align,
)

_WORKER_STATE = {}


def _init_worker(dataset, pipeline_cfg):
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["cfg"] = pipeline_cfg
    # one thread per worker: the pool is the parallelism
    torch.set_num_threads(1)


def _process_index(index):
    return prepare_pair(_WORKER_STATE["dataset"][int(index)], **_WORKER_STATE["cfg"])


def _fetch_index(index):
    return _WORKER_STATE["dataset"][int(index)]


def _is_bucketed(stage_caps, num_stages):
    """Capacity buckets (a list of whole-pyramid cap tuples) vs one pyramid
    spec whose per-stage entries are asymmetric (cap_ref, cap_src) pairs."""
    if not isinstance(stage_caps[0], (list, tuple)):
        return False
    asym = (len(stage_caps) == num_stages
            and all(isinstance(c, (list, tuple)) and len(c) == 2 for c in stage_caps)
            and num_stages != 2)
    return not asym


def _fits(size, cap):
    """(ref_len, src_len) fits cap, an int or a per-cloud pair."""
    if isinstance(cap, (list, tuple)):
        return size[0] <= cap[0] and size[1] <= cap[1]
    return max(size) <= cap


def _host_targets(model_cfg, stage_caps, batch):
    """The partition and GT overlap targets of one batch, computed on the
    CPU with the plain versions (the JAX loader's ``_host_targets``), as
    numpy arrays."""
    from geotransformer_tpu_torch.models.geotransformer import precompute_gt_targets

    cfg = dataclasses.replace(
        model_cfg,
        caps=dataclasses.replace(model_cfg.caps, stage_caps=tuple(stage_caps)),
        model=dataclasses.replace(model_cfg.model, force_pallas=False))
    targets = precompute_gt_targets(cfg, batch, device="cpu")
    return {k: v.numpy() for k, v in targets.items()}


def prepare_pair(sample, num_stages, voxel_size, search_radius, neighbor_limits, stage_caps,
                 input_dim=1, inverse_limits=None, precompute_targets=False, model_cfg=None,
                 neighbor_splits=None, subsampling_splits=None, inverse_splits=None,
                 sub_inverse_splits=None, input_stream=True):
    """Build and pad one registration pair from a dataset sample dict
    ('ref_points', 'src_points' (N, 3), 'transform' (4, 4), optionally
    'ref_feats' / 'src_feats'). ``stage_caps`` may be a list of capacity
    buckets: the smallest that fits is taken. With ``precompute_targets``
    the batch carries the GT targets of ``model_cfg``, and its forward
    tables the column alignment of ``model_cfg``'s precision point
    (:func:`..pyramid.table_align`, as the JAX ``prepare_pair`` pads at the
    point it installs). Scalar sample fields go to ``batch["meta"]``."""
    ref_points = np.asarray(sample["ref_points"], np.float32)
    src_points = np.asarray(sample["src_points"], np.float32)
    points = np.concatenate([ref_points, src_points], axis=0)
    lengths = np.asarray([len(ref_points), len(src_points)])
    pyramid = build_pyramid(points, lengths, num_stages, voxel_size, search_radius,
                            list(neighbor_limits))
    if _is_bucketed(stage_caps, num_stages):
        sizes = [tuple(int(x) for x in l) for l in pyramid["lengths"]]
        for bucket in stage_caps:
            if all(_fits(s, c) for s, c in zip(sizes, bucket)):
                stage_caps = tuple(bucket)
                break
        else:
            raise ValueError(f"pair with stage sizes {sizes} exceeds every capacity bucket "
                             f"{stage_caps}")
    if "ref_feats" in sample:
        feats = np.concatenate([np.asarray(sample["ref_feats"], np.float32),
                                np.asarray(sample["src_feats"], np.float32)], axis=0)
    else:
        feats = np.ones((points.shape[0], input_dim), np.float32)
    transform = np.asarray(sample.get("transform", np.eye(4)), np.float32)
    batch = pad_registration_batch(
        pyramid, feats, transform, stage_caps, inverse_limits=inverse_limits,
        neighbor_splits=neighbor_splits, subsampling_splits=subsampling_splits,
        inverse_splits=inverse_splits, sub_inverse_splits=sub_inverse_splits,
        input_stream=input_stream,
        align=table_align(None if model_cfg is None else model_cfg.precision))
    if precompute_targets:
        if model_cfg is None:
            raise ValueError("precompute_targets=True requires model_cfg")
        batch.update(_host_targets(model_cfg, stage_caps, batch))
    batch["meta"] = {k: v for k, v in sample.items() if isinstance(v, (str, int, float))}
    return batch


class PairLoader:
    """Iterate groups of padded pair batches, built by a process pool.

    Args:
        dataset: indexable returning sample dicts (picklable).
        pipeline_cfg: keyword arguments of :func:`prepare_pair`.
        batch_size: pairs per group (one card takes one pair a step).
        shuffle: reshuffle the order each epoch (seeded with seed + epoch).
        num_workers: pool size (0: in this process).
        seed: base shuffle seed.
        num_shards, shard_index: host sharding: this loader takes every
            ``num_shards``-th index of the epoch's (shuffled) order from
            ``shard_index`` (the JAX loader's ``order[shard_index::num_shards]``).
        drop_last: drop the trailing incomplete group.
        device_plan: a ``preprocess.device.DevicePreprocessPlan``: the raw
            mode. Workers only read (and augment) samples; the main process
            pads each group into the smallest bucket whose stage-0 capacity
            holds every member (a copy), and the step builds the pyramid on
            the card. GT targets need a pyramid, so a pipeline that asks for
            them (``precompute_targets``) raises here: the step computes
            them.
    """

    def __init__(self, dataset, pipeline_cfg, batch_size=1, shuffle=False, num_workers=0, seed=0,
                 num_shards=1, shard_index=0, drop_last=True, device_plan=None):
        if not 0 <= shard_index < num_shards:
            raise ValueError(f"shard {shard_index} of {num_shards}")
        if device_plan is not None and pipeline_cfg.get("precompute_targets"):
            raise ValueError("precompute_targets needs the host pyramid: in the raw "
                             "device-preprocess mode the step computes the GT targets")
        self.dataset = dataset
        self.pipeline_cfg = dict(pipeline_cfg)
        self.device_plan = device_plan
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.epoch = 0
        self._pool = None

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        order = (np.random.default_rng(self.seed + self.epoch).permutation(n) if self.shuffle
                 else np.arange(n))
        return order[self.shard_index::self.num_shards]

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _ensure_pool(self):
        if self._pool is None:
            # spawn, not fork: the parent may hold a CUDA context
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers, initializer=_init_worker,
                initargs=(self.dataset, self.pipeline_cfg),
                mp_context=multiprocessing.get_context("spawn"))
        return self._pool

    def _pad_raw_group(self, samples):
        """The group's samples padded into the smallest bucket whose stage-0
        capacity holds every member (members share one shape)."""
        plan = self.device_plan
        bucket = max(plan.bucket_for_lengths(len(s["ref_points"]), len(s["src_points"]))
                     for s in samples)
        cap0 = plan.buckets[bucket][0]
        input_dim = self.pipeline_cfg.get("input_dim", 1)
        return [prepare_raw_pair(s, cap0, input_dim) for s in samples]

    def __iter__(self):
        indices = self._indices()
        if self.drop_last:
            indices = indices[:len(indices) - len(indices) % self.batch_size]
        raw = self.device_plan is not None
        if self.num_workers > 0:
            worker = _fetch_index if raw else _process_index
            results = self._ensure_pool().map(worker, indices, chunksize=1)
        elif raw:
            results = (self.dataset[int(i)] for i in indices)
        else:
            results = (prepare_pair(self.dataset[int(i)], **self.pipeline_cfg) for i in indices)
        group = []
        for item in results:
            group.append(item)
            if len(group) == self.batch_size:
                yield self._pad_raw_group(group) if raw else group
                group = []
        if group and not self.drop_last:
            yield self._pad_raw_group(group) if raw else group

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
