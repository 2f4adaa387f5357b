"""Which kernel family moves the ModelNet training step's gradients off the
float64 plain step, on one CUDA card:

    python3 grad_diag.py

Builds the kernels, reads chip_smoke.py's synthetic ModelNet pairs at the
full-width make_modelnet_config(), and for pair 0, at random weights and
after 8 Adam steps, prints each variant's whole-step gradient distance from
the float64 plain step (relative norm) and its three worst tensors: the
kernel model, the plain model, the kernel model with one family (KPConv,
GSE, attention, Sinkhorn) switched to its plain version, and the plain model
with one family switched to its kernel; then the attention kernels on the
step's own inputs against their plain versions."""
import copy
import dataclasses
import os
import tempfile

import torch

import chip_smoke as cs
from geotransformer_tpu_torch.configs import make_modelnet_config
from geotransformer_tpu_torch.kernels import attention as ka
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.parallel import make_optimizer, make_train_step
from geotransformer_tpu_torch.models import kpconv as mk
from geotransformer_tpu_torch.models import sinkhorn as ms
from geotransformer_tpu_torch.models import transformer as mt
from geotransformer_tpu_torch.preprocess import batch_to_torch
from geotransformer_tpu_torch.preprocess.loader import prepare_pair

FAMILIES = {"kpconv": (mk.KPConv,), "gse": (mt.GeometricStructureEmbedding,),
            "attention": (mt.MultiHeadAttention, mt.RPEMultiHeadAttention),
            "sinkhorn": (ms.LearnableLogOptimalTransport,)}


def main():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.cuda.build()
    cfg = make_modelnet_config()
    with tempfile.TemporaryDirectory() as tmp:
        dataset, samples, caps, _, _ = cs.modelnet_dataset_and_caps(cfg, tmp)
    cfg = cfg.with_caps(stage_caps=caps)
    bb = cfg.backbone
    pipeline = dict(num_stages=bb.num_stages, voxel_size=bb.init_voxel_size,
                    search_radius=bb.init_radius, neighbor_limits=cfg.caps.neighbor_limits,
                    stage_caps=caps, input_dim=bb.input_dim, inverse_limits=cfg.caps.inverse_limits,
                    precompute_targets=True, model_cfg=cfg)
    train_cfg = dataclasses.replace(cfg, optim=dataclasses.replace(
        cfg.optim, max_iteration=8, warmup_steps=4))
    batches = []
    for index in range(4):
        batch = prepare_pair(samples[index], **pipeline)
        batch.pop("meta")
        batches.append(batch_to_torch(batch, "cuda"))
    model = create_model(cfg, device="cuda")
    for trained in (False, True):
        if trained:
            optimizer, scheduler = make_optimizer(model, train_cfg, steps_per_epoch=4)
            step = make_train_step(model, train_cfg, optimizer, scheduler, device="cuda")
            for i in range(8):
                step(batches[i % 4], torch.Generator().manual_seed(i))
        batch = batches[0]
        plain = create_model(cfg.with_model(force_pallas=False), device="cuda")
        plain.load_state_dict(model.state_dict())
        exact = copy.deepcopy(plain).double()
        _, g64 = cs.step_gradients(exact, cfg, {k: cs.float64(v) for k, v in batch.items()}, 0)
        floor = 1e-6 * max(g.norm().item() for g in g64.values())
        live = [k for k, g in g64.items() if g.norm().item() > floor]
        variants = {"kernel": model, "plain": plain}
        for family, classes in FAMILIES.items():
            m = copy.deepcopy(model)
            for module in m.modules():
                if isinstance(module, classes):
                    module.force = False
            variants[f"kernel, {family} plain"] = m
        for family, classes in FAMILIES.items():
            m = copy.deepcopy(plain)
            for module in m.modules():
                if isinstance(module, classes):
                    module.force = None
            variants[f"plain, {family} kernel"] = m
        for name, m in variants.items():
            _, g = cs.step_gradients(m, cfg, batch, 0)
            whole, per = cs.relative_errors(g, g64)
            top = sorted(((k, per[k]) for k in live), key=lambda kv: -kv[1])[:3]
            print(f"trained {trained} {name:28s} whole {whole:.2e}; top "
                  f"{[(k, f'{v:.2e}') for k, v in top]}", flush=True)
        # the attention kernels on this step's inputs against their plain versions
        calls = {"rpe_pair_scores": [], "fused_masked_attention": []}
        saved = {n: getattr(ka, n) for n in calls}

        def recorder(n):
            def record(*args, **kwargs):
                calls[n].append((args, kwargs))
                return saved[n](*args, **kwargs)
            return record

        for n in calls:
            setattr(ka, n, recorder(n))
        try:
            cs.step_gradients(model, cfg, batch, 0)
        finally:
            for n, fn in saved.items():
                setattr(ka, n, fn)
        for n, plain_fn in (("rpe_pair_scores", ka.rpe_pair_scores_plain),
                            ("fused_masked_attention", ka.fused_masked_attention_plain)):
            worst = 0.0
            for args, kwargs in calls[n]:
                got = saved[n](*args, **kwargs)
                want = plain_fn(*args, **{k: v for k, v in kwargs.items() if k != "force"})
                rel = ((got - want).abs().max() / want.abs().max()).item()
                worst = max(worst, rel)
            print(f"trained {trained} {n}: {len(calls[n])} calls in the step, max |kernel - plain|"
                  f" / max|plain| {worst:.2e}", flush=True)


if __name__ == "__main__":
    main()
