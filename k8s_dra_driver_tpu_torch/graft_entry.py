"""Single-device forward entry point of the port (counterpart of the
root ``__graft_entry__.entry``)."""

from __future__ import annotations

import torch

from k8s_dra_driver_tpu_torch import DeviceLike, resolve_device
from k8s_dra_driver_tpu_torch.models.flagship import SliceProofConfig, init_params


def entry(device: DeviceLike = None):
    """Return (fn, example_args): the flagship forward at ``tiny()`` with
    seed-0 weights and a [2, seq_len] batch of zero tokens. ``fn(model,
    tokens)`` returns f32 logits [2, seq_len, vocab]."""
    device = resolve_device(device)
    cfg = SliceProofConfig.tiny()
    model = init_params(cfg, seed=0, device=device)
    tokens = torch.zeros((2, cfg.seq_len), dtype=torch.long, device=device)

    def fn(model, tokens):
        return model(tokens)

    return fn, (model, tokens)
