"""The port's attention (plain versions of the two attention kernels, and the
transformer stack that calls them) vs the JAX package, on the CPU.

Tolerances: the Pallas kernels in interpret mode read bf16 operands (the
JAX tests' bar, 2e-2; the inputs here are bf16-exact, so only the Pallas
kernel's bf16 probabilities and the sum order differ); the f32 XLA
references (the einsum, ``_xla_attention_ref``) at 1e-5; the ``*_diff``
gradients against ``jax.vjp`` of the JAX ``*_diff`` functions (whose
backward is f32 XLA) at 1e-5. Shapes include ModelNet's superpoint cap of
192 and sizes that are no multiple of the Pallas tiles. One Adam update
(optax's chain against the port's ``make_optimizer``) of an RPE stack whose
``proj_p.bias`` gets the fused route's exact zero gradient, at 1e-3 of lr.
The CUDA attention kernel's arithmetic (3xTF32 products, keys split over
8 warps), emulated in torch, at the kernel's own tolerance, 1e-5 x
max|plain|.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from geotransformer_tpu.configs import OptimConfig
from geotransformer_tpu.kernels import attention as jax_attention
from geotransformer_tpu.models import transformer as jax_transformer
from geotransformer_tpu.parallel.train import make_optimizer as jax_make_optimizer

from geotransformer_tpu_torch.kernels.attention import (
    fused_masked_attention,
    fused_masked_attention_diff,
    fused_masked_attention_plain,
    rpe_pair_scores,
    rpe_pair_scores_diff,
    rpe_pair_scores_plain,
)
from geotransformer_tpu_torch.models.transformer import (
    MultiHeadAttention,
    RPEConditionalTransformer,
)
from geotransformer_tpu_torch.parallel import make_optimizer
from geotransformer_tpu_torch.utils.convert import gradients_to_state_dict, variables_to_state_dict

# (N, M, C, H, n_valid_q, n_valid_k)
PAIR_SHAPES = [(192, 192, 32, 4, 150, 150), (96, 80, 64, 4, 70, 61), (40, 40, 16, 2, None, None)]
# (H, N, M, dh, n_valid_q, n_valid_k)
ATTN_SHAPES = [(4, 192, 192, 64, 150, 150), (2, 100, 75, 16, 83, 61), (2, 40, 40, 32, None, None)]


def bf16_exact(rng, shape, scale=1.0):
    """Normal samples rounded to bf16, as float32."""
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def pair_case(seed, n, m, c, h):
    rng = np.random.default_rng(seed)
    return bf16_exact(rng, (n, m, c), 0.5), bf16_exact(rng, (n, h, c), 0.5)


def attn_case(seed, h, n, m, dh):
    rng = np.random.default_rng(seed)
    return [bf16_exact(rng, s, 0.5) for s in ((h, n, dh), (h, m, dh), (h, m, dh), (n, h, m))]


def jax_count(n_valid):
    return None if n_valid is None else jnp.int32(n_valid)


def rectangle(n, m, nv_q, nv_k):
    rows = np.arange(n) < (n if nv_q is None else nv_q)
    cols = np.arange(m) < (m if nv_k is None else nv_k)
    return rows[:, None, None] & cols[None, None, :]


@pytest.mark.parametrize("n, m, c, h, nv_q, nv_k", PAIR_SHAPES)
def test_pair_scores_plain_matches_pallas_interpret(n, m, c, h, nv_q, nv_k):
    embed, qw = pair_case(0, n, m, c, h)
    want = np.asarray(jax_attention.rpe_pair_scores(
        jnp.asarray(embed), jnp.asarray(qw), jax_count(nv_q), jax_count(nv_k), interpret=True))
    got = rpe_pair_scores(torch.from_numpy(embed), torch.from_numpy(qw), nv_q, nv_k).numpy()
    # the Pallas skip is tile-granular: compare on the valid rectangle
    inside = np.broadcast_to(rectangle(n, m, nv_q, nv_k), got.shape)
    np.testing.assert_allclose(got[inside], want[inside], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n, m, c, h, nv_q, nv_k", PAIR_SHAPES)
def test_pair_scores_plain_matches_xla_einsum_and_zeroes_the_padding(n, m, c, h, nv_q, nv_k):
    embed, qw = pair_case(1, n, m, c, h)
    # the XLA path's contraction (models/transformer.py:272-273), f32
    want = np.asarray(jnp.einsum("nmc,nhc->nhm", jnp.asarray(embed), jnp.asarray(qw),
                                 precision=jax.lax.Precision.HIGHEST))
    nv_q_t = None if nv_q is None else torch.tensor(nv_q, dtype=torch.int32)
    got = rpe_pair_scores_plain(torch.from_numpy(embed), torch.from_numpy(qw), nv_q_t,
                                nv_k).numpy()
    inside = np.broadcast_to(rectangle(n, m, nv_q, nv_k), got.shape)
    np.testing.assert_allclose(got[inside], want[inside], rtol=1e-5, atol=1e-5)
    assert (got[~inside] == 0.0).all()


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("h, n, m, dh, nv_q, nv_k", ATTN_SHAPES)
def test_attention_plain_matches_pallas_interpret(h, n, m, dh, nv_q, nv_k, with_bias):
    q, k, v, bias = attn_case(2, h, n, m, dh)
    bias = bias if with_bias else None
    scale = dh ** -0.5
    want = np.asarray(jax_attention.fused_masked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if bias is None else jnp.asarray(bias), jax_count(nv_q), jax_count(nv_k),
        scale=scale, interpret=True))
    got = fused_masked_attention(*(None if x is None else torch.from_numpy(x)
                                   for x in (q, k, v, bias)), nv_q, nv_k, scale).numpy()
    rows = n if nv_q is None else nv_q
    np.testing.assert_allclose(got[:rows], want[:rows], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("h, n, m, dh, nv_q, nv_k", ATTN_SHAPES)
def test_attention_plain_matches_xla_reference_and_zeroes_padded_rows(h, n, m, dh, nv_q, nv_k,
                                                                      with_bias):
    q, k, v, bias = attn_case(3, h, n, m, dh)
    bias = bias if with_bias else None
    scale = dh ** -0.5
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_attention._xla_attention_ref(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if bias is None else jnp.asarray(bias), m if nv_k is None else nv_k, scale))
    got = fused_masked_attention_plain(*(None if x is None else torch.from_numpy(x)
                                         for x in (q, k, v, bias)), nv_q, nv_k, scale).numpy()
    rows = n if nv_q is None else nv_q
    np.testing.assert_allclose(got[:rows], want[:rows], rtol=1e-5, atol=1e-5)
    assert (got[rows:] == 0.0).all()


def tf32(x):
    """f32 -> TF32 as the kernel's ``cvt.rna.tf32.f32``: rounded to nearest
    (ties away from zero), the low 13 mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_product(a, b, terms):
    """a @ b in f32 from TF32 operands: big . big alone (``terms`` 1), or
    with big . small + small . big (3, the kernel's 3xTF32 split)."""
    a_big, b_big = tf32(a), tf32(b)
    if terms == 1:
        return a_big @ b_big
    a_small, b_small = tf32(a - a_big), tf32(b - b_big)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def attention_kernel_emulation(q, k, v, bias, nv_q, nv_k, scale, key_masks, terms):
    """``csrc/attention.cu``'s attention_kernel in torch: 16-key chunks,
    chunk c on warp c % 8, an online softmax a warp with both products from
    TF32 operands, the 8 partial softmaxes merged in warp order."""
    warps, keys = 8, 16
    h, n, dh = q.shape
    m = k.shape[1]
    keep = torch.arange(m) < nv_k
    if key_masks is not None:
        keep &= key_masks
    parts = []
    for w in range(warps):
        m_run = torch.full((h, n, 1), -torch.inf)
        l_run, o = torch.zeros((h, n, 1)), torch.zeros((h, n, dh))
        for c0 in range(keys * w, nv_k, keys * warps):
            chunk = slice(c0, min(c0 + keys, nv_k))
            s = tf32_product(q, k[:, chunk].transpose(1, 2), terms)
            if bias is not None:
                s = s + bias[:, :, chunk].transpose(0, 1)
            s = torch.where(keep[chunk], s * scale, -torch.inf)
            m_new = torch.maximum(m_run, s.amax(-1, keepdim=True))
            correction = torch.where(m_run == -torch.inf, 0.0, torch.exp(m_run - m_new))
            p = torch.where(s == -torch.inf, 0.0, torch.exp(s - m_new))
            l_run = l_run * correction + p.sum(-1, keepdim=True)
            o = o * correction + tf32_product(p, v[:, chunk], terms)
            m_run = m_new
        parts.append((m_run, l_run, o))
    m_all = torch.stack([part[0] for part in parts]).amax(0)
    num, den = torch.zeros((h, n, dh)), torch.zeros((h, n, 1))
    for m_w, l_w, o_w in parts:
        f = torch.where(m_w == -torch.inf, 0.0, torch.exp(m_w - m_all))
        num, den = num + o_w * f, den + l_w * f
    out = torch.where(den > 0, num / den, 0.0).transpose(0, 1).reshape(n, h * dh)
    return torch.where(torch.arange(n)[:, None] < nv_q, out, 0.0)


# (H, N, M, dh, n_valid_q, n_valid_k, key holes): the superpoint caps, head
# widths and valid counts of chip_smoke.py's 3DMatch, KITTI and ModelNet
# pairs (self and cross attention)
TF32_CASES = [(4, 512, 512, 64, 293, 293, False), (4, 512, 512, 64, 293, 262, True),
              (4, 512, 512, 32, 357, 357, False), (4, 512, 512, 32, 357, 273, True),
              (4, 192, 192, 64, 107, 107, False), (4, 192, 192, 64, 107, 116, True)]


@pytest.mark.parametrize("h, n, m, dh, nv_q, nv_k, holes", TF32_CASES,
                         ids=["3dmatch-self", "3dmatch-cross", "kitti-self", "kitti-cross",
                              "modelnet-self", "modelnet-cross"])
def test_3xtf32_split_keeps_the_attention_within_its_tolerance(h, n, m, dh, nv_q, nv_k, holes):
    """The kernel's 3xTF32 products and key-split merge, emulated, stand
    within 1e-5 x max|plain| of the f32 plain version, of the float64 one
    and of the JAX f32 reference; one TF32 product alone would not."""
    rng = np.random.default_rng(12)
    q, k, v = (rng.normal(size=(h, r, dh)).astype(np.float32) for r in (n, m, m))
    bias = (2.0 * rng.normal(size=(n, h, m))).astype(np.float32)
    key_masks = rng.uniform(size=m) > 0.2 if holes else np.ones(m, bool)
    args = [torch.from_numpy(x) for x in (q, k, v, bias)]
    masks = torch.from_numpy(key_masks)
    scale = dh ** -0.5
    plain = fused_masked_attention_plain(*args, nv_q, nv_k, scale, masks)
    exact = fused_masked_attention_plain(*(x.double() for x in args), nv_q, nv_k, scale, masks)
    with jax.default_matmul_precision("highest"):
        # the JAX reference takes a prefix of valid keys: drop the holes from k, v, bias
        kept = np.flatnonzero(key_masks[:nv_k])
        reference = np.asarray(jax_attention._xla_attention_ref(
            jnp.asarray(q), jnp.asarray(k[:, kept]), jnp.asarray(v[:, kept]),
            jnp.asarray(bias[:, :, kept]), len(kept), scale))
    split = attention_kernel_emulation(*args, nv_q, nv_k, scale, masks, terms=3)
    single = attention_kernel_emulation(*args, nv_q, nv_k, scale, masks, terms=1)
    bound = 1e-5 * plain[:nv_q].abs().max().item()
    assert (split[:nv_q] - plain[:nv_q]).abs().max().item() <= bound
    assert (split[:nv_q].double() - exact[:nv_q]).abs().max().item() <= bound
    assert np.abs(split[:nv_q].numpy() - reference[:nv_q]).max() <= bound
    assert not split[nv_q:].any()
    assert (single[:nv_q] - plain[:nv_q]).abs().max().item() > bound


def test_pair_scores_diff_gradients_match_jax_vjp():
    n, m, c, h, nv = 96, 96, 32, 4, 70
    embed, qw = pair_case(4, n, m, c, h)
    rng = np.random.default_rng(5)
    # the model's cotangent: zero outside the rectangle (padded keys are
    # softmax-masked, padded query rows are zeroed at the stack output)
    ds = np.where(rectangle(n, m, nv, nv), rng.normal(size=(n, h, m)), 0.0).astype(np.float32)
    _, vjp = jax.vjp(lambda e, w: jax_attention.rpe_pair_scores_diff(e, w, jnp.int32(nv),
                                                                     jnp.int32(nv)),
                     jnp.asarray(embed), jnp.asarray(qw))
    want = [np.asarray(g) for g in vjp(jnp.asarray(ds))]
    embed_t = torch.from_numpy(embed).requires_grad_()
    qw_t = torch.from_numpy(qw).requires_grad_()
    rpe_pair_scores_diff(embed_t, qw_t, torch.tensor(nv, dtype=torch.int32), nv).backward(
        torch.from_numpy(ds))
    for got, w in zip((embed_t.grad, qw_t.grad), want):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("with_bias", [False, True])
def test_attention_diff_gradients_match_jax_vjp(with_bias):
    h, n, m, dh, nv_q, nv_k = 2, 100, 90, 16, 77, 64
    q, k, v, bias = attn_case(6, h, n, m, dh)
    bias = bias if with_bias else None
    rng = np.random.default_rng(7)
    dout = np.where(np.arange(n)[:, None] < nv_q, rng.normal(size=(n, h * dh)), 0.0)
    dout = dout.astype(np.float32)
    inputs = [x for x in (q, k, v, bias) if x is not None]

    def jax_fn(*a):
        return jax_attention.fused_masked_attention_diff(
            a[0], a[1], a[2], a[3] if with_bias else None, jnp.int32(nv_q), jnp.int32(nv_k), 0.25)

    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(jax_fn, *map(jnp.asarray, inputs))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    tensors = [torch.from_numpy(x).requires_grad_() for x in inputs]
    out = fused_masked_attention_diff(tensors[0], tensors[1], tensors[2],
                                      tensors[3] if with_bias else None, nv_q, nv_k, 0.25)
    out.backward(torch.from_numpy(dout))
    for t, w in zip(tensors, want):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-5, atol=1e-5)


def transformer_case(seed, n=100, m=70, d=32, h=2, valid=(83, 61)):
    rng = np.random.default_rng(seed)
    f0 = rng.normal(size=(1, n, d)).astype(np.float32)
    f1 = rng.normal(size=(1, m, d)).astype(np.float32)
    e0 = (0.3 * rng.normal(size=(1, n, n, d))).astype(np.float32)
    e1 = (0.3 * rng.normal(size=(1, m, m, d))).astype(np.float32)
    masks0 = np.arange(n)[None] < valid[0]
    masks1 = np.arange(m)[None] < valid[1]
    return (f0, f1, e0, e1), (masks0, masks1)


@pytest.mark.parametrize("use_pallas, force, rtol", [(True, None, 2e-2), (False, False, 1e-4),
                                                      (False, None, 1e-4)],
                         ids=["fused-vs-pallas", "einsum-vs-xla", "fused-vs-xla"])
def test_transformer_matches_jax(use_pallas, force, rtol):
    blocks = ("self", "cross", "self")
    (f0, f1, e0, e1), (masks0, masks1) = transformer_case(8)
    jax_module = jax_transformer.RPEConditionalTransformer(blocks, 32, 2, use_pallas=use_pallas)
    arrays = [jnp.asarray(x) for x in (f0, f1, e0, e1)]
    variables = jax_module.init(jax.random.PRNGKey(0), *arrays, masks0=jnp.asarray(masks0),
                                masks1=jnp.asarray(masks1))
    # non-zero proj_p biases, so dropping q . b_p is exercised
    params = jax.tree.map(np.asarray, variables)["params"]
    rng = np.random.default_rng(9)
    for name, layer in params.items():
        if "proj_p" in layer["attention"]["attention"]:
            proj_p = layer["attention"]["attention"]["proj_p"]
            proj_p["bias"] = rng.normal(size=proj_p["bias"].shape).astype(np.float32)
    want = jax_module.apply({"params": params}, *arrays, masks0=jnp.asarray(masks0),
                            masks1=jnp.asarray(masks1))
    port = RPEConditionalTransformer(blocks, 32, 2, force=force)
    port.load_state_dict(variables_to_state_dict({"params": params}), strict=True)
    with torch.no_grad():
        got = port(*map(torch.from_numpy, (f0, f1, e0, e1)), masks0=torch.from_numpy(masks0),
                   masks1=torch.from_numpy(masks1))
    for g, w, mask in zip(got, want, (masks0, masks1)):
        np.testing.assert_allclose(g.numpy()[mask], np.asarray(w)[mask], rtol=rtol, atol=rtol)


def test_non_prefix_key_mask_is_honoured():
    rng = np.random.default_rng(10)
    n, m, d, h = 50, 64, 32, 2
    feats_q = rng.normal(size=(1, n, d)).astype(np.float32)
    feats_k = rng.normal(size=(1, m, d)).astype(np.float32)
    key_masks = rng.uniform(size=(1, m)) < 0.6  # holes anywhere: not a prefix
    key_masks[0, 0] = True
    args = [jnp.asarray(feats_q), jnp.asarray(feats_k), jnp.asarray(feats_k)]
    module = jax_transformer.MultiHeadAttention(d, h)
    variables = module.init(jax.random.PRNGKey(1), *args)
    masked = np.asarray(module.apply(variables, *args, key_masks=jnp.asarray(key_masks))[0])
    unmasked = np.asarray(module.apply(variables, *args)[0])
    fused = jax_transformer.MultiHeadAttention(d, h, use_pallas=True)
    jax_fused = np.asarray(fused.apply(variables, *args, key_masks=jnp.asarray(key_masks))[0])
    # the JAX fused path reads a non-prefix mask as all keys valid
    np.testing.assert_allclose(jax_fused, unmasked, rtol=2e-2, atol=2e-2)
    assert np.abs(jax_fused - masked).max() > 0.1
    # the port masks exactly the masked keys
    port = MultiHeadAttention(d, h)
    port.load_state_dict(variables_to_state_dict(jax.tree.map(np.asarray, variables)))
    with torch.no_grad():
        got = port(torch.from_numpy(feats_q), torch.from_numpy(feats_k),
                   torch.from_numpy(feats_k), key_masks=torch.from_numpy(key_masks)).numpy()
    np.testing.assert_allclose(got, masked, rtol=1e-5, atol=1e-5)
    # and a masked key's value does not reach the output
    feats_k2 = feats_k.copy()
    feats_k2[0, ~key_masks[0]] += 10.0
    with torch.no_grad():
        moved = port(torch.from_numpy(feats_q), torch.from_numpy(feats_k2),
                     torch.from_numpy(feats_k2), key_masks=torch.from_numpy(key_masks)).numpy()
    np.testing.assert_array_equal(moved, got)


def test_proj_p_bias_gets_an_exact_zero_gradient():
    (f0, f1, e0, e1), (masks0, masks1) = transformer_case(11)
    port = RPEConditionalTransformer(("self",), 32, 2)
    out0, out1 = port(*map(torch.from_numpy, (f0, f1, e0, e1)), masks0=torch.from_numpy(masks0),
                      masks1=torch.from_numpy(masks1))
    (out0.square().sum() + out1.square().sum()).backward()
    bias = port.layers[0].attention.attention.proj_p.bias
    # a tensor of zeros, not None: the optimizer does not skip the parameter
    assert bias.grad is not None and not bias.grad.any()
    assert port.layers[0].attention.attention.proj_p.weight.grad.abs().max() > 0


def test_adam_update_of_an_rpe_stack_matches_optax():
    """Two Adam steps with coupled weight decay on an RPE self/cross stack:
    the port on its fused route (``proj_p.bias`` gradient exactly 0) against
    optax on ``jax.grad`` of the XLA stack (``q . b_p`` kept, its gradient
    rounding noise). Every bias is non-zero, so the decay term dominates the
    gradients that vanish in exact arithmetic and both sides move them alike;
    a parameter the optimizer skipped would stay put, off by about lr."""
    blocks = ("self", "cross")
    (f0, f1, e0, e1), (masks0, masks1) = transformer_case(12)
    arrays = [jnp.asarray(x) for x in (f0, f1, e0, e1)]
    jax_masks = dict(masks0=jnp.asarray(masks0), masks1=jnp.asarray(masks1))
    jax_module = jax_transformer.RPEConditionalTransformer(blocks, 32, 2, use_pallas=False)
    params = jax.tree.map(np.asarray, jax_module.init(jax.random.PRNGKey(2), *arrays,
                                                      **jax_masks))["params"]
    rng = np.random.default_rng(13)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (rng.normal(size=x.shape).astype(np.float32)
                         if path[-1].key == "bias" else x), params)
    cfg = types.SimpleNamespace(optim=OptimConfig(lr=1e-2, weight_decay=1e-2))

    def loss_j(p):  # valid rows only: the routes differ on padded ones
        out0, out1 = jax_module.apply({"params": p}, *arrays, **jax_masks)
        return jnp.sum(out0[masks0] ** 2) + jnp.sum(out1[masks1] ** 2)

    tx = jax_make_optimizer(cfg, steps_per_epoch=1)
    state, p_j = tx.init(params), params
    port = RPEConditionalTransformer(blocks, 32, 2)
    port.load_state_dict(variables_to_state_dict({"params": params}), strict=True)
    optimizer, scheduler = make_optimizer(port, cfg, steps_per_epoch=1)
    inputs = [torch.from_numpy(x) for x in (f0, f1, e0, e1)]
    torch_masks = dict(masks0=torch.from_numpy(masks0), masks1=torch.from_numpy(masks1))
    for step in range(2):
        updates, state = tx.update(jax.grad(loss_j)(p_j), state, p_j)
        p_j = optax.apply_updates(p_j, updates)
        optimizer.zero_grad(set_to_none=True)
        out0, out1 = port(*inputs, **torch_masks)
        (out0[torch_masks["masks0"]].square().sum()
         + out1[torch_masks["masks1"]].square().sum()).backward()
        optimizer.step()
        scheduler.step()
        want = variables_to_state_dict({"params": jax.tree.map(np.asarray, p_j)})
        for name, param in port.named_parameters():
            # 1e-3 of lr: the vanishing biases' rounding noise passes Adam's
            # normalization; a skipped parameter would be off by about lr
            np.testing.assert_allclose(param.detach().numpy(), want[name], rtol=1e-6, atol=1e-5,
                                       err_msg=f"{name} after step {step}")
    bias = port.layers[0].attention.attention.proj_p.bias
    assert not bias.grad.any()
    assert np.abs(bias.detach().numpy() - params["layers_0"]["attention"]["attention"]["proj_p"][
        "bias"]).min() > 1e-3  # the decay moved it


def test_force_true_on_cpu_raises():
    q = torch.rand(2, 5, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        fused_masked_attention(q, q, q, force=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        rpe_pair_scores(torch.rand(5, 5, 8), torch.rand(5, 2, 8), force=True)
