#!/usr/bin/env python
r"""The kernel route's numerical drift on trained weights, against the
plain routes (the port's counterpart of ``scripts/bf16_drift.py``).

    python -m geotransformer_tpu_torch.scripts.drift [--steps 600] [--weights PATH] [--reuse]

1. Train the 3DMatch architecture at the training smoke's capacities
   (``train_smoke.smoke_config``) on its four synthetic pairs for
   ``--steps`` steps on the plain float32 route with TF32 off, and save
   the weights to ``--weights`` (``--reuse`` loads them instead).
2. Run the same weights through four inference routes on the four pairs:

   * ``f64``: the plain route in float64, the numeric reference;
   * ``f32``: the plain route in float32;
   * ``tf32``: the plain route with ``torch.backends.cuda.matmul.allow_tf32``
     on: what a stock PyTorch model pays on this card;
   * ``kernels``: the hand-written CUDA kernels, TF32 off.

   The plain routes are the same model with every kernel wrapper on its
   plain PyTorch version (:func:`plain_wrappers`: each wrapper replaced,
   wherever the package holds it, by a call of it with ``force=False``).
   ``force_pallas=False`` is not used: it also moves the transformer to
   its einsum attention, which is not row 13's plain version, so the
   ``f32`` route would not be the ``kernels`` route's plain twin. A plain
   route that launches a kernel, or a ``kernels`` route on the card that
   launches none, raises.
3. For each route against ``f64``: the coarse and fine feature drift (the
   relative norm of the difference), the coarse rows' cosines, the
   superpoint-correspondence Jaccard, the transform delta; against ground
   truth: RRE and RTE, and their excess over the ``f32`` route's. The worst
   over the pairs.

Pass: the ``kernels`` route's RRE and RTE against ground truth exceed the
``f32`` route's by at most ``--rre_budget`` deg and ``--rte_budget`` m (0.5
and 0.005, the JAX tool's budgets), and its coarse and fine feature drift
against ``f64`` stay within the band of the plain float32 routes (at most
the larger of the ``tf32`` and ``f32`` routes' drift). On the CPU every
wrapper takes its plain version, so the ``kernels`` route is the ``f32``
route bit for bit there.
"""

import argparse
import contextlib
import os
import sys

import numpy as np
import torch

from geotransformer_tpu_torch.kernels import attention, cuda, gse, kpconv, overlap, pyramid
from geotransformer_tpu_torch.kernels import sinkhorn
from geotransformer_tpu_torch.models import create_model
from geotransformer_tpu_torch.preprocess import batch_to_float64
from geotransformer_tpu_torch.scripts import train_smoke
from geotransformer_tpu_torch.scripts.common import (
    add_device_argument,
    print_result,
    resolve_device,
)
from geotransformer_tpu_torch.utils import timing
from geotransformer_tpu_torch.utils.timing import KERNEL_SYMBOLS
from geotransformer_tpu_torch.utils.registration import compute_registration_error

ROUTES = ("f32", "tf32", "kernels")
KERNEL_MODULES = (attention, gse, kpconv, overlap, pyramid, sinkhorn)


@contextlib.contextmanager
def plain_wrappers(names):
    """Within the block, the kernel wrappers ``names`` take their plain
    versions: every module attribute of the package that is one of them
    becomes a call of it with ``force=False``."""
    wrappers = {name: getattr(module, name) for module in KERNEL_MODULES
                for name in names if hasattr(module, name)}
    missing = set(names) - set(wrappers)
    if missing:
        raise ValueError(f"no kernel wrapper {sorted(missing)}")
    saved = []
    for module in [m for key, m in list(sys.modules.items())
                   if key.startswith("geotransformer_tpu_torch.") and m is not None]:
        for attr, value in list(vars(module).items()):
            for name, fn in wrappers.items():
                if value is fn:
                    saved.append((module, attr, fn))
                    setattr(module, attr, lambda *a, _fn=fn, **k: _fn(*a, **dict(k, force=False)))
    try:
        yield
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


@contextlib.contextmanager
def tf32(enabled):
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def forward(model, batch):
    """The forward's outputs the tool reads, as float64 numpy arrays."""
    out = model(batch)
    keys = ("ref_feats_c", "ref_feats_f", "estimated_transform", "ref_node_corr_indices",
            "src_node_corr_indices", "node_corr_masks")
    return {k: out[k].detach().cpu().double().numpy() if out[k].is_floating_point()
            else out[k].cpu().numpy() for k in keys}


@contextlib.contextmanager
def launching(device, kernels):
    """Raise unless the block's hand-written kernel launches fit
    ``kernels``: True, some on a CUDA ``device``; False, none anywhere."""
    before = sum(cuda.launches.values())
    yield
    launched = sum(cuda.launches.values()) - before
    if kernels and torch.device(device).type == "cuda" and not launched:
        raise RuntimeError("the kernels route launched no hand-written kernel")
    if not kernels and launched:
        raise RuntimeError(f"a plain route launched {launched} hand-written kernels")


def route_outputs(weights, cfg, pairs, route, device):
    """Each pair's outputs on ``route`` ("f64", "f32", "tf32", "kernels")."""
    kernels = route == "kernels"
    model = create_model(cfg, device=device)
    model.load_state_dict(weights)
    if route == "f64":
        model, pairs = model.double(), [batch_to_float64(p) for p in pairs]
    plain = () if kernels else tuple(KERNEL_SYMBOLS)
    with plain_wrappers(plain), launching(device, kernels), tf32(route == "tf32"):
        return [forward(model, pair) for pair in pairs]


def rel_drift(a, b):
    return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))


def row_cosines(a, b):
    """(median, min, share under 0.99) of the cosines of the rows nonzero in
    both (padded rows are zero)."""
    na, nb = np.linalg.norm(a, axis=1), np.linalg.norm(b, axis=1)
    keep = (na > 1e-9) & (nb > 1e-9)
    cos = np.sum(a[keep] * b[keep], axis=1) / (na[keep] * nb[keep])
    return float(np.median(cos)), float(np.min(cos)), float(np.mean(cos < 0.99))


def correspondence_jaccard(a, b):
    def pairs(out):
        m = out["node_corr_masks"].astype(bool)
        return set(zip(out["ref_node_corr_indices"][m].tolist(),
                       out["src_node_corr_indices"][m].tolist()))

    pa, pb = pairs(a), pairs(b)
    return len(pa & pb) / max(len(pa | pb), 1)


def compare(outs, refs, gts, base=None):
    """The worst over the pairs of a route's quantities against the f64
    route ``refs`` and ground truth; ``base``: the f32 route's outputs, for
    the excess over its errors."""
    rec = dict(feats_c=0.0, feats_f=0.0, cos_med=1.0, cos_min=1.0, cos_frac=0.0, jaccard=1.0,
               rre_delta=0.0, rte_delta=0.0, rre_gt=0.0, rte_gt=0.0, excess_rre=0.0,
               excess_rte=0.0)
    for i, (out, ref, gt) in enumerate(zip(outs, refs, gts)):
        rec["feats_c"] = max(rec["feats_c"], rel_drift(out["ref_feats_c"], ref["ref_feats_c"]))
        rec["feats_f"] = max(rec["feats_f"], rel_drift(out["ref_feats_f"], ref["ref_feats_f"]))
        med, low, frac = row_cosines(out["ref_feats_c"], ref["ref_feats_c"])
        rec["cos_med"], rec["cos_min"] = min(rec["cos_med"], med), min(rec["cos_min"], low)
        rec["cos_frac"] = max(rec["cos_frac"], frac)
        rec["jaccard"] = min(rec["jaccard"], correspondence_jaccard(out, ref))
        rre, rte = compute_registration_error(ref["estimated_transform"],
                                              out["estimated_transform"])
        rec["rre_delta"], rec["rte_delta"] = max(rec["rre_delta"], rre), max(rec["rte_delta"], rte)
        rre, rte = compute_registration_error(gt, out["estimated_transform"])
        rec["rre_gt"], rec["rte_gt"] = max(rec["rre_gt"], rre), max(rec["rte_gt"], rte)
        if base is not None:
            base_rre, base_rte = compute_registration_error(gt, base[i]["estimated_transform"])
            rec["excess_rre"] = max(rec["excess_rre"], rre - base_rre)
            rec["excess_rte"] = max(rec["excess_rte"], rte - base_rte)
    return {k: float(v) for k, v in rec.items()}


def print_route(name, rec):
    print(f"  [{name}] coarse / fine feature drift vs f64 {rec['feats_c']:.4e} / "
          f"{rec['feats_f']:.4e}; coarse row cosine median {rec['cos_med']:.7f}, min "
          f"{rec['cos_min']:.5f}, share < 0.99 {rec['cos_frac']:.2%}; correspondence Jaccard "
          f"{rec['jaccard']:.3f}; transform vs f64 RRE {rec['rre_delta']:.4f} deg, RTE "
          f"{rec['rte_delta'] * 1000:.3f} mm; vs GT RRE {rec['rre_gt']:.4f} deg, RTE "
          f"{rec['rte_gt'] * 1000:.3f} mm (excess over f32 {rec['excess_rre']:.4f} deg, "
          f"{rec['excess_rte'] * 1000:.3f} mm)", flush=True)


def trained_weights(cfg, pairs, steps, path, reuse, device):
    """The plain float32 route's weights after ``steps`` steps (TF32 off),
    saved to ``path``; with ``reuse`` and a saved file, that file's."""
    if reuse and os.path.exists(path):
        print(f"reusing the weights of {path}", flush=True)
        return torch.load(path, map_location=device, weights_only=True)
    with plain_wrappers(tuple(KERNEL_SYMBOLS)), launching(device, False), tf32(False):
        model, losses, _ = train_smoke.train(cfg, pairs, steps, device, log_every=50)
    weights = model.state_dict()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(weights, path)
    print(f"trained {steps} steps on the plain float32 route (loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}); weights in {path}", flush=True)
    return weights


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=600)
    parser.add_argument("--rre_budget", type=float, default=0.5, help="deg")
    parser.add_argument("--rte_budget", type=float, default=0.005, help="m")
    parser.add_argument("--weights", default="output/drift/weights.pt")
    parser.add_argument("--reuse", action="store_true",
                        help="load --weights where it exists instead of training")
    add_device_argument(parser)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    print(timing.card(device), flush=True)
    cfg = train_smoke.smoke_config()
    pairs = [train_smoke.make_smoke_pair(cfg, seed, device) for seed in range(train_smoke.PAIRS)]
    gts = [p["transform"].double().cpu().numpy() for p in pairs]
    weights = trained_weights(cfg, pairs, args.steps, args.weights, args.reuse, device)
    refs = route_outputs(weights, cfg, pairs, "f64", device)
    outs = {route: route_outputs(weights, cfg, pairs, route, device) for route in ROUTES}
    report = {"f64": compare(refs, refs, gts)}
    report.update({route: compare(outs[route], refs, gts, outs["f32"]) for route in ROUTES})
    print(f"worst over {len(pairs)} pairs; f64 vs GT: RRE {report['f64']['rre_gt']:.4f} deg, "
          f"RTE {report['f64']['rte_gt'] * 1000:.3f} mm", flush=True)
    for route in ROUTES:
        print_route(route, report[route])
    kernels = report["kernels"]
    band = {k: max(report["tf32"][k], report["f32"][k]) for k in ("feats_c", "feats_f")}
    ok = (kernels["excess_rre"] <= args.rre_budget and kernels["excess_rte"] <= args.rte_budget
          and all(kernels[k] <= band[k] for k in band))
    equal = all(np.array_equal(a[k], b[k]) for a, b in zip(outs["kernels"], outs["f32"])
                for k in a)
    print(f"kernels route bit-equal to the f32 route: {equal}", flush=True)
    print_result("drift", {"steps": args.steps, "ok": ok, "kernels_equal_f32": equal,
                           "routes": report})
    print("PASS" if ok else "FAIL", flush=True)
    if not ok:
        raise SystemExit(1)
    return report, outs


if __name__ == "__main__":
    main()
