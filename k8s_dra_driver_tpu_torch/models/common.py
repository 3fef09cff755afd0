"""Pieces shared by the model families: RMSNorm, causal einsum attention,
the NLL loss, the momentum-SGD update and the token batch (counterpart of
``k8s_dra_driver_tpu/models/common.py``).

The numerics follow the JAX reference step for step, including where it
rounds to bf16: matmuls take bf16 operands cast from the f32 master
parameters, while norms, softmax and the loss run in f32.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + 1e-6) * g computed in f32, returned as bf16."""
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + 1e-6)
    return (x * g).to(torch.bfloat16)


def causal_einsum_attention(wqkv: torch.Tensor, wo: torch.Tensor,
                            x: torch.Tensor, h: torch.Tensor,
                            head_dim: int) -> torch.Tensor:
    """x + Attn(h): ``wqkv`` [d, 3, heads, head_dim], ``wo`` [heads,
    head_dim, d], ``h`` the pre-normed bf16 input of ``x`` [b, s, d]."""
    s = x.shape[1]
    qkv = torch.einsum("bsd,dthk->tbshk", h, wqkv.to(torch.bfloat16))
    q, k, v = qkv[0], qkv[1], qkv[2]
    # The reference divides the bf16 scores by a numpy float64, which JAX
    # promotes to f32: the scale is applied in f32, after the cast.
    scores = torch.einsum("bshk,bthk->bhst", q, k).float() / math.sqrt(head_dim)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = torch.where(mask, scores, torch.tensor(-1e30, device=x.device))
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    attn = torch.einsum("bhst,bthk->bshk", probs, v)
    return x + torch.einsum("bshk,hkd->bsd", attn, wo.to(torch.bfloat16))


def nll_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL: logits [b, s, v] f32, tokens [b, s] int."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -torch.gather(logp, -1, tgt[..., None])[..., 0].mean()


@torch.no_grad()
def momentum_sgd(params: Mapping[str, torch.Tensor],
                 momentum: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], lr: float,
                 beta: float = 0.9) -> Tuple[Mapping, Mapping]:
    """Heavy-ball SGD, by parameter name: ``m = beta*m + g``, then ``p = p -
    lr*m``, in that order and in f32, as the reference computes it. The JAX
    side returns new trees; here ``params`` and ``momentum`` are updated in
    place (no second copy of either) and returned."""
    for name, p in params.items():
        m = momentum[name]
        m.mul_(beta).add_(grads[name])
        p.sub_(lr * m)
    return params, momentum


def make_token_batch(seed: int, rows: int, seq_len: int, vocab: int,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    """{"tokens": [rows, seq_len] int64} drawn as the reference draws them
    (``np.random.default_rng(seed).integers(0, vocab, ...)``), so both
    sides train on identical tokens. No mesh: one device."""
    tokens = np.random.default_rng(seed).integers(0, vocab, size=(rows, seq_len))
    return {"tokens": torch.from_numpy(tokens).to(device)}
