"""Carry the JAX reference's parameters into the port.

``params_from_jax`` takes the pytree that ``k8s_dra_driver_tpu``'s
``init_params`` returns, with every leaf already turned into a numpy array
(``jax.tree.map(np.asarray, params)``), and returns a state dict for
``SliceProof.load_state_dict``. ``state_to_jax_tree`` is its inverse: a
state dict (or grads by parameter name) back to the nested numpy tree, to
compare leaf by leaf with a JAX tree. No JAX import is needed: the layouts
are the same on both sides, only the nesting differs.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

LAYER_KEYS = ("wqkv", "wo", "w1", "w2", "ln1", "ln2")


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """{"embed", "unembed", "layers": [{...}, ...]} of numpy arrays ->
    {"embed", "unembed", "layers.<i>.<name>"} of f32 CPU tensors."""
    def tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    state = {"embed": tensor(tree["embed"]), "unembed": tensor(tree["unembed"])}
    for i, layer in enumerate(tree["layers"]):
        for key in LAYER_KEYS:
            state[f"layers.{i}.{key}"] = tensor(layer[key])
    return state


def state_to_jax_tree(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """{"embed", "unembed", "layers.<i>.<name>"} of tensors -> {"embed",
    "unembed", "layers": [{...}, ...]} of f32 numpy arrays."""
    def array(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    n_layers = len({k.split(".")[1] for k in state if k.startswith("layers.")})
    return {
        "embed": array(state["embed"]),
        "unembed": array(state["unembed"]),
        "layers": [{key: array(state[f"layers.{i}.{key}"]) for key in LAYER_KEYS}
                   for i in range(n_layers)],
    }
