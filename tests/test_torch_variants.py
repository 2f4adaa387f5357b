"""The port's ablation transformers (``models/transformer_variants.py``) vs
the JAX package's flax modules.

Vanilla, PE and LRPE conditional transformers at d_model 32, 4 heads,
blocks ``self, cross``, on padded clouds with prefix masks, the JAX
``init`` weights carried into the port by ``utils/convert.py``:

  * features on every row within 1e-4 on both routes: the einsum route
    (``force=False``) and the attention kernel's route (its plain version
    on the CPU, row 13 on the card);
  * the self layers' attention scores on the einsum route, and None on the
    kernel route, which never writes them;
  * the parameters round-trip to the JAX tree (the LRPE bank and its
    LayerNorm, PE's ``proj_p``);
  * gradients of the kernel route (the ``*_diff`` forms, the LRPE bias
    among the inputs) equal the einsum route's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geotransformer_tpu.models import transformer_variants as jax_variants
from geotransformer_tpu.utils.convert import torch_state_dict_to_variables

from geotransformer_tpu_torch.models import transformer_variants as port_variants
from geotransformer_tpu_torch.utils.convert import variables_to_state_dict

D_MODEL, HEADS, BLOCKS, NUM_EMBEDDINGS = 32, 4, ("self", "cross"), 16
N0, N1, VALID0, VALID1 = 24, 20, 20, 17


def make_inputs():
    rng = np.random.default_rng(0)
    masks0 = np.arange(N0)[None] < VALID0
    masks1 = np.arange(N1)[None] < VALID1
    return dict(
        feats0=rng.normal(size=(1, N0, D_MODEL)).astype(np.float32),
        feats1=rng.normal(size=(1, N1, D_MODEL)).astype(np.float32),
        embeddings0=rng.normal(size=(1, N0, D_MODEL)).astype(np.float32),
        embeddings1=rng.normal(size=(1, N1, D_MODEL)).astype(np.float32),
        # past the bank too: both clamp to its last row
        emb_indices0=rng.integers(0, NUM_EMBEDDINGS + 4, (1, N0, N0)).astype(np.int32),
        emb_indices1=rng.integers(0, NUM_EMBEDDINGS + 4, (1, N1, N1)).astype(np.int32),
        masks0=masks0, masks1=masks1,
    )


VARIANTS = {
    "vanilla": (("VanillaConditionalTransformer", {}), ("feats0", "feats1", "masks0", "masks1")),
    "pe": (("PEConditionalTransformer", {}),
           ("feats0", "feats1", "embeddings0", "embeddings1", "masks0", "masks1")),
    "lrpe": (("LRPEConditionalTransformer", {"num_embeddings": NUM_EMBEDDINGS}),
             ("feats0", "feats1", "emb_indices0", "emb_indices1", "masks0", "masks1")),
}


def _port_model(name, state_dict, force):
    (cls, extra), _ = VARIANTS[name]
    model = getattr(port_variants, cls)(BLOCKS, D_MODEL, HEADS, force=force, **extra)
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def case(request):
    name = request.param
    (cls, extra), keys = VARIANTS[name]
    inputs = make_inputs()
    args = [jnp.asarray(inputs[k]) for k in keys]
    jax_model = getattr(jax_variants, cls)(BLOCKS, D_MODEL, HEADS, **extra)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(1), *args)
    want = [np.asarray(x) for x in jax.jit(jax_model.apply)(variables, *args)]
    variables = jax.tree.map(np.asarray, variables)
    torch_args = [torch.from_numpy(inputs[k]) for k in keys]
    return dict(name=name, variables=variables, state_dict=variables_to_state_dict(variables),
                inputs=inputs, keys=keys, torch_args=torch_args, want=want)


@pytest.mark.parametrize("force", [False, None], ids=["einsum", "kernel_route"])
def test_features_match_jax(case, force):
    model = _port_model(case["name"], case["state_dict"], force)
    with torch.no_grad():
        got = model(*case["torch_args"])
    for side, (g, w) in enumerate(zip(got, case["want"])):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4, err_msg=f"feats{side}")


def test_parameters_round_trip(case):
    model = _port_model(case["name"], case["state_dict"], False)
    back, unused = torch_state_dict_to_variables(model.state_dict(), case["variables"])
    assert unused == []
    for (path, want), (_, got) in zip(jax.tree_util.tree_leaves_with_path(case["variables"]),
                                      jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=str(path))
    names = set(model.state_dict())
    if case["name"] == "lrpe":
        assert {"layers.0.attention.embedding.embeddings",
                "layers.0.attention.embedding.norm.weight"} <= names
    if case["name"] == "pe":
        assert "layers.0.attention.proj_p.weight" in names


@pytest.mark.parametrize("case", ["lrpe", "pe"], indirect=True)
def test_self_layer_scores(case):
    """The self layer's scores on the einsum route equal JAX's; the kernel
    route returns None. (The vanilla layers are the port's TransformerLayer,
    which returns none, as its JAX callers discard them.)"""
    inputs = case["inputs"]
    params = {"params": case["variables"]["params"]["layers_0"]}
    if case["name"] == "pe":
        jax_layer = jax_variants.PETransformerLayer(D_MODEL, HEADS)
        extra = ("embeddings0", "embeddings0")
    else:
        jax_layer = jax_variants.LRPETransformerLayer(D_MODEL, HEADS, NUM_EMBEDDINGS)
        extra = ("emb_indices0",)
    x, masks = inputs["feats0"], inputs["masks0"]
    want_out, want_scores = jax.jit(jax_layer.apply)(params, x, x, *[inputs[k] for k in extra],
                                                     memory_masks=masks)
    for force in (False, None):
        layer = _port_model(case["name"], case["state_dict"], force).layers[0]
        with torch.no_grad():
            out, scores = layer(torch.from_numpy(x), torch.from_numpy(x),
                                *[torch.from_numpy(inputs[k]) for k in extra],
                                memory_masks=torch.from_numpy(masks))
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out), rtol=1e-4, atol=1e-4)
        if force is False:
            np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), atol=1e-5)
        else:
            assert scores is None


def test_kernel_route_gradients(case):
    grads = {}
    for force in (False, None):
        model = _port_model(case["name"], case["state_dict"], force)
        feats0, feats1 = model(*case["torch_args"])
        ((feats0 ** 2).sum() + feats1.sum()).backward()
        grads[force] = {n: p.grad.clone() for n, p in model.named_parameters()}
    assert set(grads[False]) == set(grads[None])
    for name, want in grads[False].items():
        np.testing.assert_allclose(grads[None][name].numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
