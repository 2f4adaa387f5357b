"""One rank of the two-process run of ``tests/test_torch_parallel.py``.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=r MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_parallel_worker.py <setup.pt> <out_dir>

Joins a Gloo group on the CPU (a 60 s collective timeout), trains the
setup's configuration with ``Trainer.run_iterations`` on its shard of the
pairs (a checkpoint at the last step), restores that checkpoint into a
fresh model, then takes one raw-mode step whose pyramid overflows on rank 1
only. Writes what it saw to ``<out_dir>/rank<r>.pt``; any failure exits
non-zero.
"""

import datetime
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from geotransformer_tpu_torch.engine import Trainer  # noqa: E402
from geotransformer_tpu_torch.models import create_model  # noqa: E402
from geotransformer_tpu_torch.parallel import make_train_step, mesh  # noqa: E402
from geotransformer_tpu_torch.preprocess import DevicePreprocessPlan  # noqa: E402
from geotransformer_tpu_torch.preprocess.device import (  # noqa: E402
    build_pyramid_device,
    prepare_raw_pair,
)
from geotransformer_tpu_torch.preprocess.loader import PairLoader  # noqa: E402
from geotransformer_tpu_torch.preprocess.pyramid import batch_to_torch  # noqa: E402


def main(setup_path, out):
    torch.set_num_threads(2)
    setup = torch.load(setup_path, weights_only=False)
    cfg, dataset, pipeline = setup["cfg"], setup["dataset"], setup["pipeline"]
    mesh.init_process_group(device="cpu", timeout=datetime.timedelta(seconds=60))
    rank = mesh.rank()
    run_dir = os.path.join(out, "run")
    loader = PairLoader(dataset, pipeline, shuffle=True, seed=1, num_shards=mesh.world_size(),
                        shard_index=rank)
    model = create_model(cfg, seed=0, device="cpu")
    trainer = Trainer(cfg, model, loader, output_dir=run_dir, log_steps=1, tensorboard=False,
                      device="cpu")
    grads = []
    step = trainer.train_step

    def recording(batch, generator=None):
        metrics = step(batch, generator)
        grads.append({name: p.grad.clone() for name, p in model.named_parameters()})
        return metrics

    trainer.train_step = recording
    trainer.run_iterations()

    restored = Trainer(cfg, create_model(cfg, seed=3, device="cpu"), loader, output_dir=run_dir,
                       tensorboard=False, device="cpu")
    assert restored.resume()

    # a raw-mode step whose pyramid overflows its caps on rank 1 only (its
    # pair spread 4x wider): both ranks skip it
    plan = DevicePreprocessPlan(cfg)
    sample = dict(dataset[0])
    if rank == 1:
        sample["ref_points"] = sample["ref_points"] * 4.0
        sample["src_points"] = sample["src_points"] * 4.0
    raw = prepare_raw_pair(sample, plan.buckets[0][0])
    raw.pop("meta")
    spec = plan.spec(0)
    raw_t = batch_to_torch(raw, "cpu")
    _, overflow = build_pyramid_device(raw_t["raw_points"], raw_t["raw_lengths"],
                                       raw_t["raw_feats"], raw_t["transform"], **spec)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    raw_step = make_train_step(model, cfg, trainer.optimizer, trainer.scheduler, device="cpu",
                               pyramid_spec=spec)
    raw_metrics = raw_step(raw, torch.Generator().manual_seed(0))
    unchanged = all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    mesh.barrier()

    torch.save({
        "grads": grads, "history": trainer.history,
        "params": {k: v.clone() for k, v in model.state_dict().items()},
        "generator": trainer.generator.get_state(),
        "restored_generator": restored.generator.get_state(),
        "restored_params": {k: v.clone() for k, v in restored.model.state_dict().items()},
        "restored_step": restored.step,
        "checkpoints": restored.checkpoints.all_steps(),
        "local_overflow": bool(overflow.any()),
        "raw_metrics": {k: float(v) for k, v in raw_metrics.items()},
        "raw_unchanged": unchanged,
        "shard": np.asarray(loader._indices()),
    }, os.path.join(out, f"rank{rank}.pt"))
    mesh.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
