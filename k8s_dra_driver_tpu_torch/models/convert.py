"""Carry the JAX reference's parameters into the port.

``params_from_jax`` takes the pytree that ``k8s_dra_driver_tpu``'s
``init_params`` returns, with every leaf already turned into a numpy array
(``jax.tree.map(np.asarray, params)``), and returns a state dict for
``SliceProof.load_state_dict``. It needs no JAX import: the layouts are
the same on both sides, only the nesting differs.
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
