r"""JAX-package variables -> the port's state_dict.

The inverse of ``geotransformer_tpu/utils/convert.py:_torch_key_candidates``
(which maps reference torch keys onto the flax tree), so parameters carry
across both ways:

  * a Dense ``kernel`` (in, out) becomes ``weight`` (out, in);
  * a norm's ``scale``/``bias`` become ``weight``/``bias`` — under
    ``norm.`` for the backbone's GroupNorm wrapper (reference
    `modules/kpconv/modules.py`), directly for the transformer LayerNorms;
  * ``layers_<i>`` becomes ``layers.<i>``;
  * KPConv ``weights``, ``kernel_points`` (the ``constants`` collection),
    the Sinkhorn ``alpha`` and the LRPE bank ``embeddings`` keep their
    names.

The same rules carry the transformer variants
(``models/transformer_variants.py``): PE's ``proj_p`` as a Dense, the LRPE
``embedding.embeddings`` bank and its LayerNorm ``embedding.norm``.

Takes plain nested dicts of arrays (``params`` and ``constants``); imports
neither JAX nor flax. A gradient pytree (``jax.grad`` with respect to
``params``) has the params' structure, so :func:`gradients_to_state_dict`
maps it onto the same parameter names, to compare gradients name by name.
"""

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def variables_to_state_dict(variables):
    """``{"params": ..., "constants": ...}`` nested dicts of arrays -> a flat
    ``{torch key: tensor}`` state_dict for :class:`GeoTransformer`."""
    state_dict = {}
    for collection in ("params", "constants"):
        leaves = dict(_flatten(variables.get(collection, {})))
        for path, value in leaves.items():
            *prefix, leaf = path
            module = [p.replace("layers_", "layers.") for p in prefix]
            is_norm = tuple(prefix) + ("scale",) in leaves
            array = np.array(value, dtype=np.float32)  # a writable copy
            if leaf == "kernel":
                leaf, array = "weight", array.T
            elif leaf == "scale":
                leaf = "weight"
            if is_norm and prefix and prefix[0] == "backbone":
                module.append("norm")  # GroupNorm wrapper: norm.norm.weight
            key = ".".join(module + [leaf])
            state_dict[key] = torch.tensor(array)  # a 0-d alpha stays 0-d
    return state_dict


def gradients_to_state_dict(grads):
    """A JAX gradient pytree of the ``params`` collection -> ``{torch
    parameter name: tensor}`` in the port's layout (Dense gradients
    transposed like their kernels)."""
    return variables_to_state_dict({"params": grads})
