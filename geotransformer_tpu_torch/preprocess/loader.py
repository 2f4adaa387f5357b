r"""Input pipeline: dataset sample -> host pyramid -> padded PairBatch
(``geotransformer_tpu/preprocess/loader.py``; reference `utils/data.py`).

A process pool runs the host pyramid (voxel subsampling and radius search,
the CPU-expensive part) and, optionally, the GT targets of training
(:func:`geotransformer_tpu_torch.models.precompute_gt_targets` on the CPU)
while the card consumes earlier batches. One process group: host sharding
and the raw device-preprocess mode of the JAX loader are not ported.
"""

import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from geotransformer_tpu_torch.preprocess.pyramid import build_pyramid, pad_registration_batch

_WORKER_STATE = {}


def _init_worker(dataset, pipeline_cfg):
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["cfg"] = pipeline_cfg
    # one thread per worker: the pool is the parallelism
    torch.set_num_threads(1)


def _process_index(index):
    return prepare_pair(_WORKER_STATE["dataset"][int(index)], **_WORKER_STATE["cfg"])


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
    the batch carries the GT targets of ``model_cfg``. Scalar sample fields
    go to ``batch["meta"]``."""
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
        input_stream=input_stream)
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
        num_shards, shard_index: host sharding (not ported: 1 and 0).
        drop_last: drop the trailing incomplete group.
        device_plan: the JAX loader's raw device-preprocess mode (not
            ported: must be None).
    """

    def __init__(self, dataset, pipeline_cfg, batch_size=1, shuffle=False, num_workers=0, seed=0,
                 num_shards=1, shard_index=0, drop_last=True, device_plan=None):
        if num_shards != 1 or shard_index != 0:
            raise NotImplementedError("host sharding is not ported: one process group")
        if device_plan is not None:
            raise NotImplementedError(
                "the raw device-preprocess mode (preprocess/device.py) is not ported")
        self.dataset = dataset
        self.pipeline_cfg = dict(pipeline_cfg)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self._pool = None

    def set_epoch(self, epoch):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

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

    def __iter__(self):
        indices = self._indices()
        if self.drop_last:
            indices = indices[:len(indices) - len(indices) % self.batch_size]
        if self.num_workers > 0:
            results = self._ensure_pool().map(_process_index, indices, chunksize=1)
        else:
            results = (prepare_pair(self.dataset[int(i)], **self.pipeline_cfg) for i in indices)
        group = []
        for item in results:
            group.append(item)
            if len(group) == self.batch_size:
                yield group
                group = []
        if group and not self.drop_last:
            yield group

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
