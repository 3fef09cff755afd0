"""SliceProof, the flagship decoder-only transformer, in PyTorch
(counterpart of ``k8s_dra_driver_tpu/models/flagship.py``).

Parameters keep the JAX pytree's layout and names (``wqkv`` [d, 3, heads,
head_dim], ``wo`` [heads, head_dim, d], ``w1``, ``w2``, ``ln1``, ``ln2``,
``embed`` [vocab, d], ``unembed`` [d, vocab]) as f32 masters, cast to bf16
at each matmul as the reference does, so ``convert.params_from_jax`` can
load a JAX ``init_params`` tree and both sides compute the same function.

This slice runs the single-device forward, the scoring path
``evaluate_nll`` (differentiable: its unembed + cross-entropy is the
fused CUDA forward and backward of ``ops/fused_ce.py``), ``remat`` and the
single-device training step ``sgd_train_step`` (the materializing
``loss_fn`` and momentum SGD, as in the reference), with either
attention: ``"einsum"`` or ``"flash"`` (the causal flash-attention
kernels of ``ops/flash_attention.py``, forward and backward). The dp x tp
step comes with a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from k8s_dra_driver_tpu_torch import DeviceLike, resolve_device
from k8s_dra_driver_tpu_torch.models.common import (
    causal_einsum_attention,
    make_token_batch,
    momentum_sgd,
    nll_loss,
    rmsnorm,
)
from k8s_dra_driver_tpu_torch.ops.flash_attention import BLOCK, flash_attention
from k8s_dra_driver_tpu_torch.ops.fused_ce import fused_ce_losses


@dataclass(frozen=True)
class SliceProofConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    seq_len: int = 64
    learning_rate: float = 1e-3
    # "einsum" materializes the scores; "flash" runs the flash-attention
    # kernels (seq_len must divide by their 128 block, as in the reference).
    attention: str = "einsum"
    # Recompute each block's activations in the backward pass
    # (torch.utils.checkpoint, as the reference uses jax.checkpoint).
    remat: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} is not a multiple of "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads

    @classmethod
    def tiny(cls) -> "SliceProofConfig":
        return cls()

    @classmethod
    def bench(cls) -> "SliceProofConfig":
        """The benchmark shape of the reference (~690M matmul params):
        d_model 2048, 2 heads of head_dim 1024, ratio-8 FFN, 8 layers."""
        return cls(vocab=8192, d_model=2048, n_heads=2, n_layers=8,
                   d_ff=16384, seq_len=1024)


def matmul_param_count(cfg: SliceProofConfig) -> int:
    """Parameters on the matmul path (excludes norms and the embedding
    lookup): the N in the 6·N·T FLOPs-per-train-step estimate."""
    per_layer = 3 * cfg.d_model * cfg.d_model   # wqkv
    per_layer += cfg.d_model * cfg.d_model      # wo
    per_layer += 2 * cfg.d_model * cfg.d_ff     # w1 + w2
    return cfg.n_layers * per_layer + cfg.d_model * cfg.vocab  # + unembed


class Block(nn.Module):
    """One pre-norm transformer layer: einsum or flash attention, then a
    GELU FFN."""

    def __init__(self, cfg: SliceProofConfig, device: torch.device):
        super().__init__()
        d, h, k, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
        self.head_dim = k
        self.flash = cfg.attention == "flash"
        self.wqkv = nn.Parameter(torch.empty(d, 3, h, k, device=device))
        self.wo = nn.Parameter(torch.empty(h, k, d, device=device))
        self.w1 = nn.Parameter(torch.empty(d, f, device=device))
        self.w2 = nn.Parameter(torch.empty(f, d, device=device))
        self.ln1 = nn.Parameter(torch.ones(d, device=device))
        self.ln2 = nn.Parameter(torch.ones(d, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(x, self.ln1)
        if self.flash:
            # [b, h, s, k] straight out of the projection, as the reference.
            qkv = torch.einsum("bsd,dthk->tbhsk", h, self.wqkv.to(torch.bfloat16))
            attn = flash_attention(qkv[0], qkv[1], qkv[2], causal=True,
                                   sm_scale=float(1.0 / np.sqrt(self.head_dim)))
            attn = attn.transpose(1, 2)  # -> [b, s, h, k]
            x = x + torch.einsum("bshk,hkd->bsd", attn, self.wo.to(torch.bfloat16))
        else:
            x = causal_einsum_attention(self.wqkv, self.wo, x, h, self.head_dim)
        return ffn_half(x, self.ln2, self.w1, self.w2)


def ffn_half(x: torch.Tensor, ln2: torch.Tensor, w1: torch.Tensor,
             w2: torch.Tensor) -> torch.Tensor:
    """The FFN half of a Block: x + gelu(rmsnorm(x, ln2) @ w1) @ w2, the
    weights cast to bf16 at each matmul."""
    h = rmsnorm(x, ln2)
    # jax.nn.gelu defaults to the tanh approximation.
    ff = F.gelu(h @ w1.to(torch.bfloat16), approximate="tanh")
    return x + ff @ w2.to(torch.bfloat16)


class SliceProof(nn.Module):
    """The flagship model. ``forward`` returns f32 logits [b, s, vocab]."""

    def __init__(self, cfg: SliceProofConfig, device: DeviceLike = None):
        super().__init__()
        if cfg.attention not in ("einsum", "flash"):
            raise ValueError(f"attention={cfg.attention!r}: 'einsum' or 'flash'")
        if cfg.attention == "flash" and cfg.seq_len % BLOCK:
            raise ValueError(
                f"attention='flash' needs seq_len ({cfg.seq_len}) % {BLOCK} == 0: "
                f"the reference flash kernel's block is {BLOCK}")
        device = resolve_device(device)
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, device=device))
        self.unembed = nn.Parameter(torch.empty(cfg.d_model, cfg.vocab, device=device))
        self.layers = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))

    def forward_hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [b, s] int -> final hidden states [b, s, d_model] bf16."""
        x = self.embed.to(torch.bfloat16)[tokens.long()]
        for layer in self.layers:
            x = checkpoint(layer, x, use_reentrant=False) if self.cfg.remat else layer(x)
        return x

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [b, s] int -> logits [b, s, vocab] float32."""
        x = self.forward_hidden(tokens)
        return (x @ self.unembed.to(torch.bfloat16)).float()

    def loss_fn(self, tokens: torch.Tensor) -> torch.Tensor:
        """Mean next-token NLL through the materialized logits."""
        return nll_loss(self.forward(tokens), tokens)

    def evaluate_nll(self, tokens: torch.Tensor, *,
                     block_t: int = 256) -> torch.Tensor:
        """Mean next-token NLL for scoring: the same value as ``loss_fn``,
        but the unembed projection and cross-entropy run in the fused
        kernels, so the [tokens, vocab] logits never reach device memory.
        Differentiable (a pure function in the reference): callers that
        only score wrap it in ``torch.no_grad()``. Its CUDA backward writes
        the logits' gradient p in bf16 one vocab chunk at a time, each at
        most ``ops.fused_ce.P_BUDGET`` bytes (at this model's bench shape,
        4096 tokens by vocab 8192, two chunks of 32 MB), and, with more
        than one chunk, an f32 [tokens, d_model] sum of dx."""
        cfg = self.cfg
        h = self.forward_hidden(tokens)[:, :-1]
        labels = tokens[:, 1:].reshape(-1).long()
        flat = h.reshape(-1, cfg.d_model)
        t_dim = flat.shape[0]
        block_v = min(512, cfg.vocab)
        pad = (-t_dim) % block_t
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad, cfg.d_model)])
            labels = torch.cat([labels, labels.new_full((pad,), -1)])  # no class
        losses = fused_ce_losses(flat, self.unembed.to(torch.bfloat16),
                                 labels, block_t, block_v)
        return losses[:t_dim].mean()


@torch.no_grad()
def init_params(cfg: SliceProofConfig, seed: int = 0,
                device: DeviceLike = None) -> SliceProof:
    """A SliceProof with random weights from ``seed``: dense weights
    0.02·N(0, 1), norm gains 1, drawn from an explicit ``torch.Generator``
    on the target device (its numbers differ from ``jax.random``'s; use
    ``convert.params_from_jax`` to carry JAX weights over)."""
    device = resolve_device(device)
    model = SliceProof(cfg, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.rsplit(".", 1)[-1] in ("ln1", "ln2"):
            p.fill_(1.0)
        else:
            p.normal_(0.0, 0.02, generator=gen)
    return model


def sgd_train_step(cfg: SliceProofConfig, state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]):
    """One full training step: forward and backward of the materializing
    ``loss_fn`` (as the reference differentiates it), then momentum SGD at
    ``cfg.learning_rate``. ``state`` is ``{"params": SliceProof,
    "momentum": {name: tensor}}``; returns ``(state, loss)``. The JAX step
    is functional and returns a new state; this one updates the model's
    parameters and the momentum in place and returns the same dict."""
    model, mom = state["params"], state["momentum"]
    params = dict(model.named_parameters())
    loss = model.loss_fn(batch["tokens"])
    grads = torch.autograd.grad(loss, list(params.values()))
    momentum_sgd(params, mom, dict(zip(params, grads)), cfg.learning_rate)
    return state, loss.detach()


def make_sharded_train_step(cfg: SliceProofConfig, devices: Sequence[DeviceLike],
                            *, batch_per_replica: int = 2, seed: int = 0):
    """(step, state, batch) for one device: the state from
    ``init_params(cfg, seed, device)`` with zero momentum, the batch from
    ``make_token_batch(seed, batch_per_replica, ...)``; ``step(state,
    batch)`` is ``sgd_train_step``. More than one device needs the dp x tp
    step, not ported yet."""
    if len(devices) > 1:
        raise NotImplementedError(
            f"{len(devices)} devices need the dp x tp train step "
            "(ROADMAP Queue 1 item 6); this slice runs one device")
    if not devices:
        raise ValueError("make_sharded_train_step needs one device")
    device = resolve_device(devices[0])
    model = init_params(cfg, seed=seed, device=device)
    state = {"params": model,
             "momentum": {n: torch.zeros_like(p) for n, p in model.named_parameters()}}
    batch = make_token_batch(seed, batch_per_replica, cfg.seq_len, cfg.vocab, device)
    return partial(sgd_train_step, cfg), state, batch
