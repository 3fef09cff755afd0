"""PyTorch and CUDA port of the SliceProof workload for NVIDIA Hopper.

The JAX package ``k8s_dra_driver_tpu`` is the reference; this package
mirrors its module names (``models/common.py``, ``models/flagship.py``,
``ops/fused_ce.py``) so each piece has an obvious counterpart. It imports
neither JAX nor the JAX package.

Entry points take ``device=None``, which means the CUDA card: with no card
present they raise instead of falling back to the CPU. Pass
``device="cpu"`` to run the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA device (raises without a card);
    anything else -> ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
