"""The public helpers the port adds under the JAX package's names, held
against the JAX functions on the same seeded numpy inputs (on the CPU):

  * ``ops.se3``: ``apply_rotation`` (one and batched rotations),
    ``skew_symmetric_matrix``, ``rodrigues_rotation_matrix`` and
    ``rodrigues_alignment_matrix`` (general, parallel and anti-parallel
    pairs) within 1e-6;
  * ``ops.partition``: ``knn_partition`` and ``ball_query_partition`` with
    masked points, on a 1/16 grid where every squared distance is exact:
    distances and masks equal, indices as sets (``torch.topk`` has no tie
    order): each index a point at its row's returned distance, none twice,
    sentinels where JAX has them; the counts equal;
  * ``ops.gather.masked_topk``, largest and smallest, with rows holding
    fewer than k valid entries: values and ``valid`` equal, the valid
    indices as sets, no masked entry chosen while k valid ones exist;
  * ``models.kpconv``: ``maxpool`` (with and without ``valid_cols``),
    ``knn_interpolate`` and ``global_avgpool`` within 1e-6;
  * ``models.norms.LayerNorm`` within 1e-5, the JAX ``scale`` carried into
    ``weight``;
  * ``models.transformer``: ``TransformerEncoder`` and ``TransformerDecoder``
    (2 layers, width 32, 4 heads, key masks) with the port's seeded weights
    carried into the flax modules by the JAX converter (no key left over),
    within 1e-5 on every row, on the einsum route and on the attention
    kernel's route (its plain version on the CPU);
  * ``losses.metrics.modified_chamfer_distance``, masked, within 1e-6;
  * the ``preprocess`` re-exports of ``grid_subsample``,
    ``grid_subsample_single`` and ``radius_search``: the port's functions,
    equal to the JAX ones on the same cloud;
  * each helper is exported where the JAX package exports it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu import losses as jax_losses
from geotransformer_tpu import models as jax_models
from geotransformer_tpu import ops as jax_ops
from geotransformer_tpu.models import norms as jax_norms
from geotransformer_tpu.preprocess import neighbors as jax_neighbors
from geotransformer_tpu.preprocess import voxel as jax_voxel
from geotransformer_tpu.utils.convert import torch_state_dict_to_variables

from geotransformer_tpu_torch import losses as port_losses
from geotransformer_tpu_torch import models as port_models
from geotransformer_tpu_torch import ops as port_ops
from geotransformer_tpu_torch import preprocess as port_preprocess
from geotransformer_tpu_torch.models.geotransformer import init_parameters
from geotransformer_tpu_torch.models.norms import LayerNorm
from geotransformer_tpu_torch.preprocess import neighbors as port_neighbors
from geotransformer_tpu_torch.preprocess import voxel as port_voxel


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


def rng_array(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


# --- ops/se3.py --------------------------------------------------------------

def test_apply_rotation_and_skew_match_jax():
    points, batch = rng_array((50, 3), 0), rng_array((2, 50, 3), 1)
    rot = port_ops.rodrigues_rotation_matrix(torch.tensor([0.3, -0.2, 0.9]), torch.tensor(0.7))
    rots = torch.stack([rot, rot.T])
    for args in ((points, rot.numpy()), (batch, rots.numpy())):
        close(port_ops.apply_rotation(*(torch.from_numpy(a) for a in args)),
              jax_ops.apply_rotation(*(jnp.asarray(a) for a in args)), 1e-6)
    vectors = rng_array((4, 5, 3), 2)
    close(port_ops.skew_symmetric_matrix(torch.from_numpy(vectors)),
          jax_ops.skew_symmetric_matrix(jnp.asarray(vectors)), 1e-6)


def test_rodrigues_matrices_match_jax():
    axes, angles = rng_array((6, 3), 3), rng_array((6,), 4)
    close(port_ops.rodrigues_rotation_matrix(torch.from_numpy(axes), torch.from_numpy(angles)),
          jax_ops.rodrigues_rotation_matrix(jnp.asarray(axes), jnp.asarray(angles)), 1e-6)
    src, ref = rng_array((8, 3), 5), rng_array((8, 3), 6)
    src[1], ref[1] = [0.0, 0.0, 2.0], [0.0, 0.0, 0.5]  # parallel: the identity
    src[2], ref[2] = [1.0, 2.0, 0.0], [-2.0, -4.0, 0.0]  # anti-parallel: minus the identity
    got = port_ops.rodrigues_alignment_matrix(torch.from_numpy(src), torch.from_numpy(ref))
    close(got, jax_ops.rodrigues_alignment_matrix(jnp.asarray(src), jnp.asarray(ref)), 1e-6)
    np.testing.assert_array_equal(got[1].numpy(), np.eye(3))
    np.testing.assert_array_equal(got[2].numpy(), -np.eye(3))
    aligned = torch.einsum("bij,bj->bi", got, torch.from_numpy(src))
    unit = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    close(aligned[3:] / aligned[3:].norm(dim=1, keepdim=True), unit[3:], 1e-6)


# --- ops/partition.py, ops/gather.py ----------------------------------------

def grid_cloud(n, seed):
    """Points on a 1/16 grid: every squared distance is exact in float32."""
    return (np.random.default_rng(seed).integers(0, 16, (n, 3)) / 16.0).astype(np.float32)


def assert_knn_rows(distances, indices, points, nodes, valid):
    """Each returned index a valid point at its row's returned distance, none
    twice in a row."""
    d = np.sqrt(((nodes[:, None] - points[None]) ** 2).sum(-1))
    for row in range(len(nodes)):
        idx = indices[row]
        assert len(set(idx.tolist())) == len(idx)
        assert valid[idx].all()
        np.testing.assert_array_equal(d[row, idx].astype(np.float32), distances[row])


@pytest.mark.parametrize("masked", [False, True])
def test_knn_partition_matches_jax(masked):
    points, nodes = grid_cloud(120, 7), grid_cloud(10, 8)
    mask = np.arange(120) < (90 if masked else 120)
    kw = dict(point_masks=mask) if masked else {}
    got_d, got_i = port_ops.knn_partition(torch.from_numpy(points), torch.from_numpy(nodes), 16,
                                          **{k: torch.from_numpy(v) for k, v in kw.items()})
    want_d, _ = jax_ops.knn_partition(jnp.asarray(points), jnp.asarray(nodes), 16,
                                      **{k: jnp.asarray(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert_knn_rows(got_d.numpy(), got_i.numpy(), points, nodes, mask)


def test_ball_query_partition_matches_jax():
    points, nodes = grid_cloud(150, 9), grid_cloud(12, 10)
    mask = np.arange(150) < 130
    args = (0.3, 24)
    got = port_ops.ball_query_partition(torch.from_numpy(points), torch.from_numpy(nodes), *args,
                                        point_masks=torch.from_numpy(mask), return_count=True)
    want = jax_ops.ball_query_partition(jnp.asarray(points), jnp.asarray(nodes), *args,
                                        point_masks=jnp.asarray(mask), return_count=True)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    indices, masks = got[0].numpy(), got[1].numpy()
    assert (indices[~masks] == len(points)).all()
    want_indices = np.asarray(want[0])
    d = np.sqrt(((nodes[:, None] - points[None]) ** 2).sum(-1)).astype(np.float32)
    for row in range(len(nodes)):
        # the same distances on the valid slots (ties may pick other points)
        np.testing.assert_array_equal(np.sort(d[row, indices[row][masks[row]]]),
                                      np.sort(d[row, want_indices[row][masks[row]]]))
        assert len(set(indices[row][masks[row]].tolist())) == masks[row].sum()
        assert mask[indices[row][masks[row]]].all()


@pytest.mark.parametrize("largest", [True, False])
def test_masked_topk_matches_jax(largest):
    scores = rng_array((6, 40), 11)
    mask = np.random.default_rng(12).random((6, 40)) < 0.6
    mask[3] = np.arange(40) < 5  # fewer valid entries than k
    got = port_ops.masked_topk(torch.from_numpy(scores), 8, torch.from_numpy(mask), largest)
    want = jax_ops.masked_topk(jnp.asarray(scores), 8, jnp.asarray(mask), largest)
    valid = got[2].numpy()
    np.testing.assert_array_equal(valid, np.asarray(want[2]))
    np.testing.assert_array_equal(got[0].numpy()[valid], np.asarray(want[0])[valid])
    for row in range(6):
        assert set(got[1].numpy()[row][valid[row]]) == set(np.asarray(want[1])[row][valid[row]])
        assert mask[row, got[1].numpy()[row][valid[row]]].all()
    assert valid[3].sum() == 5 and valid[[0, 1, 2, 4, 5]].all()


# --- models/kpconv.py, models/norms.py ---------------------------------------

def test_kpconv_helpers_match_jax():
    s_feats, points = rng_array((60, 8), 13), grid_cloud(60, 14)
    q_points = grid_cloud(20, 15)
    table = np.random.default_rng(16).integers(0, 61, (20, 12)).astype(np.int32)  # 60: sentinel
    t = {k: torch.from_numpy(v) for k, v in dict(f=s_feats, p=points, q=q_points, n=table).items()}
    j = {k: jnp.asarray(v) for k, v in dict(f=s_feats, p=points, q=q_points, n=table).items()}
    for cols in (None, 7):
        close(port_models.maxpool(t["f"], t["n"], cols), jax_models.maxpool(j["f"], j["n"], cols),
              1e-6)
    close(port_models.knn_interpolate(t["f"], t["q"], t["p"], t["n"], 3),
          jax_models.knn_interpolate(j["f"], j["q"], j["p"], j["n"], 3), 1e-6)
    masks = np.arange(60) < 41
    close(port_models.global_avgpool(t["f"], torch.from_numpy(masks)),
          jax_models.global_avgpool(j["f"], jnp.asarray(masks)), 1e-6)


def test_layer_norm_matches_jax():
    x = rng_array((5, 7, 32), 17, scale=3.0)
    scale, bias = rng_array((32,), 18), rng_array((32,), 19)
    want = jax_norms.LayerNorm(32).apply({"params": {"scale": scale, "bias": bias}},
                                         jnp.asarray(x))
    norm = LayerNorm(32)
    assert isinstance(norm, torch.nn.LayerNorm) and norm.eps == 1e-5
    with torch.no_grad():
        norm.weight.copy_(torch.from_numpy(scale))
        norm.bias.copy_(torch.from_numpy(bias))
        close(norm(torch.from_numpy(x)), want, 1e-5)


# --- models/transformer.py ---------------------------------------------------

D_MODEL, HEADS, LAYERS, N0, N1 = 32, 4, 2, 24, 19


def stack_case(stack):
    q, s = rng_array((1, N0, D_MODEL), 20), rng_array((1, N1, D_MODEL), 21)
    q_masks, s_masks = np.arange(N0)[None] < 20, np.arange(N1)[None] < 15
    if stack == "encoder":
        return (port_models.TransformerEncoder, jax_models.TransformerEncoder), (q, q_masks)
    return (port_models.TransformerDecoder, jax_models.TransformerDecoder), (q, s, q_masks, s_masks)


@functools.cache
def stack_weights_and_jax_output(stack):
    """The port's seeded weights of ``stack`` and the JAX module's output
    with them, carried by the JAX converter (no key left over)."""
    (port_cls, jax_cls), inputs = stack_case(stack)
    model = port_cls(D_MODEL, HEADS, LAYERS)
    generator = torch.Generator().manual_seed(22)
    init_parameters(model, generator)
    with torch.no_grad():  # nonzero biases and norm shifts, so each is carried
        for name, p in model.named_parameters():
            if name.endswith("bias") or name.endswith("norm.weight"):
                p.add_(0.1 * torch.randn(p.shape, generator=generator))
    jax_model = jax_cls(D_MODEL, HEADS, LAYERS)
    args = [jnp.asarray(a) for a in inputs]
    template = jax.jit(jax_model.init)(jax.random.PRNGKey(0), *args)
    variables, unused = torch_state_dict_to_variables(model.state_dict(), template)
    assert unused == []
    return model.state_dict(), np.asarray(jax.jit(jax_model.apply)(variables, *args))


@pytest.mark.parametrize("force", [False, None], ids=["einsum", "kernel_route"])
@pytest.mark.parametrize("stack", ["encoder", "decoder"])
def test_encoder_decoder_match_jax(stack, force):
    (port_cls, _), inputs = stack_case(stack)
    state_dict, want = stack_weights_and_jax_output(stack)
    model = port_cls(D_MODEL, HEADS, LAYERS, force=force)
    model.load_state_dict(state_dict)
    with torch.no_grad():
        got = model(*(torch.from_numpy(a) for a in inputs))
    close(got, want, 1e-5)
    if stack == "decoder":
        assert {"layers.1.self_attention.attention.proj_q.weight",
                "layers.1.cross_attention.norm.weight",
                "layers.0.output.expand.weight"} <= set(state_dict)


# --- losses/metrics.py, preprocess -------------------------------------------

def test_modified_chamfer_distance_matches_jax():
    raw, ref, src = rng_array((80, 3), 23), rng_array((60, 3), 24), rng_array((50, 3), 25)
    rot = port_ops.rodrigues_rotation_matrix(torch.tensor([0.1, 0.7, -0.3]), torch.tensor(0.4))
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3], gt[:3, 3] = rot.numpy(), [0.1, -0.2, 0.05]
    est = gt.copy()
    est[:3, 3] += 0.02
    masks = [np.arange(n) < m for n, m in ((80, 70), (60, 41), (50, 50))]
    for kw in ({}, dict(raw_masks=masks[0], ref_masks=masks[1], src_masks=masks[2])):
        args = (raw, ref, src, gt, est)
        got = port_losses.modified_chamfer_distance(
            *(torch.from_numpy(a) for a in args), **{k: torch.from_numpy(v) for k, v in kw.items()})
        want = jax_losses.modified_chamfer_distance(
            *(jnp.asarray(a) for a in args), **{k: jnp.asarray(v) for k, v in kw.items()})
        close(got, want, 1e-6)


def test_preprocess_reexports_match_jax():
    assert port_preprocess.grid_subsample is port_voxel.grid_subsample
    assert port_preprocess.grid_subsample_single is port_voxel.grid_subsample_single
    assert port_preprocess.radius_search is port_neighbors.radius_search
    points = rng_array((400, 3), 26, scale=0.2)
    lengths = np.asarray([250, 150])
    got = port_preprocess.grid_subsample(points, lengths, 0.05)
    want = jax_voxel.grid_subsample(points, lengths, 0.05)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(port_preprocess.grid_subsample_single(points, 0.05),
                                  jax_voxel.grid_subsample_single(points, 0.05))
    args = (got[0], points, got[1], lengths, 0.1, 20)
    np.testing.assert_array_equal(port_preprocess.radius_search(*args),
                                  jax_neighbors.radius_search(*args))


@pytest.mark.parametrize("package, names", [
    ("ops", ["apply_rotation", "skew_symmetric_matrix", "rodrigues_rotation_matrix",
             "rodrigues_alignment_matrix", "knn_partition", "ball_query_partition",
             "masked_topk"]),
    ("models", ["maxpool", "knn_interpolate", "global_avgpool", "TransformerEncoder",
                "TransformerDecoder"]),
    ("losses", ["modified_chamfer_distance"]),
    ("preprocess", ["grid_subsample", "grid_subsample_single", "radius_search"])])
def test_exported_where_jax_exports_them(package, names):
    import importlib

    port = importlib.import_module(f"geotransformer_tpu_torch.{package}")
    jax_package = importlib.import_module(f"geotransformer_tpu.{package}")
    for name in names:
        assert hasattr(jax_package, name) and hasattr(port, name), name
