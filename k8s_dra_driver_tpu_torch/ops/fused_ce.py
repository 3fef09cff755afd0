"""Fused unembed + softmax cross-entropy, forward and backward (counterpart
of ``k8s_dra_driver_tpu/ops/fused_ce.py``).

``fused_ce_losses(x, w, labels)`` returns the per-token loss
``logsumexp(x @ w) - (x @ w)[label]`` without materializing the
``[T, vocab]`` logits, and is differentiable in ``x`` and ``w`` through
``FusedCE``, a ``torch.autograd.Function`` that saves ``(x, w, labels,
lse)`` as the JAX custom VJP does and recomputes each logits tile in the
backward. On CUDA tensors (bf16 x and w) the forward launches
``csrc/fused_ce_fwd.cu`` and the backward ``csrc/fused_ce_dx.cu`` and
``csrc/fused_ce_dw.cu``, or raises; on CPU tensors both run the plain
PyTorch versions below. ``reference_ce_losses`` materializes the logits
and is the check.

A label of -1 matches no class (its loss is the row's logsumexp): callers
pad the token dimension with it, as ``evaluate_nll`` does. Other labels
must lie in ``[0, vocab)``.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

from k8s_dra_driver_tpu_torch.ops import _build, on_cpu

KERNEL = "fused_ce_fwd"
KERNEL_DX = "fused_ce_dx"
KERNEL_DW = "fused_ce_dw"
# The backward kernels keep a [16, d_model] (dx) or [d_model, 16] (dw) f32
# accumulator in registers, 16 fragments a warp: d_model up to 2048.
MAX_BWD_D = 2048


def _check(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
           bt: int, bv: int) -> None:
    t_dim, d = x.shape
    if t_dim % bt:
        raise ValueError(
            f"fused_ce needs T ({t_dim}) % block_t ({bt}) == 0 "
            f"(vocab is padded internally)")
    if w.shape[0] != d or tuple(labels.shape) != (t_dim,):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, labels {tuple(labels.shape)}")


def fused_ce_losses(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                    block_t: int = 256, block_v: int = 512) -> torch.Tensor:
    """Per-token softmax cross-entropy of ``x @ w`` against ``labels``.

    x: [T, D], w: [D, vocab], labels: [T] int. Returns [T] float32,
    differentiable in x and w. T must divide by ``block_t``. ``block_v``
    is the vocab tile of the plain versions; the CUDA kernels use their
    own tile sizes.
    """
    _check(x, w, labels, block_t, block_v)
    return FusedCE.apply(x, w, labels, block_t, block_v)


class FusedCE(torch.autograd.Function):
    """Forward: (lse, picked) from the fused kernel; saves (x, w, labels,
    lse). Backward: dx and dw from the two backward kernels (CUDA) or
    ``fused_ce_dx_plain`` / ``fused_ce_dw_plain`` (CPU), each computed only
    when its input needs a grad."""

    @staticmethod
    def forward(ctx, x, w, labels, block_t: int, block_v: int):
        if on_cpu("fused_ce_losses", x, w, labels):
            lse, picked = _plain_parts(x, w, labels, block_v)
        else:
            lse, picked = _launch(x, w, labels)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.block_v = block_v
        return lse - picked

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        need_dx, need_dw = ctx.needs_input_grad[:2]
        dx = dw = None
        if on_cpu("fused_ce_losses", x, w, labels, lse):
            if need_dx:
                dx = fused_ce_dx_plain(x, w, labels, lse, g, ctx.block_v)
            if need_dw:
                dw = fused_ce_dw_plain(x, w, labels, lse, g, ctx.block_v)
        else:
            if need_dx:
                dx = _launch_bwd(KERNEL_DX, x, w, labels, lse, g)
            if need_dw:
                dw = _launch_bwd(KERNEL_DW, x, w, labels, lse, g)
        return dx, dw, None, None, None


def _kernel_labels(x: torch.Tensor, w: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
    """Check what every CUDA fused_ce kernel takes; return the int32
    labels it reads."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA fused_ce kernels take bf16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA fused_ce kernels take contiguous x and w")
    if max(x.numel(), w.numel()) >= 2 ** 31:
        raise ValueError("the CUDA fused_ce kernels index rows with int32 sizes")
    return labels.to(torch.int32).contiguous()


def _launch(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
    """Run the CUDA forward kernel: returns (lse, picked), each [T] f32."""
    labels32 = _kernel_labels(x, w, labels)
    t_dim, d = x.shape
    vocab = w.shape[1]
    lse = torch.empty(t_dim, dtype=torch.float32, device=x.device)
    picked = torch.empty_like(lse)
    _build.launch(KERNEL, x.device, x, w, labels32, lse, picked, t_dim, d, vocab)
    return lse, picked


def _launch_bwd(kernel: str, x: torch.Tensor, w: torch.Tensor,
                labels: torch.Tensor, lse: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """Run one CUDA backward kernel: ``fused_ce_dx`` returns dx [T, D],
    ``fused_ce_dw`` returns dw [D, vocab], both bf16."""
    labels32 = _kernel_labels(x, w, labels)
    t_dim, d = x.shape
    vocab = w.shape[1]
    if d > MAX_BWD_D:
        raise ValueError(f"the CUDA fused_ce backward kernels take d_model <= "
                         f"{MAX_BWD_D}, got {d}")
    lse, g = lse.float().contiguous(), g.float().contiguous()
    shape = (t_dim, d) if kernel == KERNEL_DX else (d, vocab)
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    _build.launch(kernel, x.device, x, w, labels32, lse, g, out, t_dim, d, vocab)
    return out


def _plain_parts(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 block_v: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, picked), each [T] f32: walk the vocab in tiles of ``block_v``
    with an online (max, sum) logsumexp in f32, mask the pad columns of
    the last tile, and pick out each label's logit."""
    t_dim, vocab = x.shape[0], w.shape[1]
    xf = x.float()
    lab = labels.long()[:, None]
    m = torch.full((t_dim, 1), -float("inf"), device=x.device)
    l = torch.zeros((t_dim, 1), device=x.device)
    picked = torch.zeros((t_dim, 1), device=x.device)
    for v0 in range(0, vocab, block_v):
        wt = w[:, v0:v0 + block_v].float()
        if wt.shape[1] < block_v:
            wt = F.pad(wt, (0, block_v - wt.shape[1]))
        logits = xf @ wt                                  # [T, block_v]
        cols = torch.arange(v0, v0 + block_v, device=x.device)[None, :]
        logits = torch.where(cols < vocab, logits, -float("inf"))
        m_new = torch.maximum(m, logits.max(dim=1, keepdim=True).values)
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new).sum(1, keepdim=True)
        m = m_new
        picked = picked + torch.where(cols == lab, logits, 0.0).sum(1, keepdim=True)
    return (m + torch.log(l))[:, 0], picked[:, 0]


def fused_ce_losses_plain(x: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor, block_t: int = 256,
                          block_v: int = 512) -> torch.Tensor:
    """The forward kernel's computation in plain PyTorch, as the CPU path
    of ``fused_ce_losses`` runs it."""
    _check(x, w, labels, block_t, block_v)
    lse, picked = _plain_parts(x, w, labels, block_v)
    return lse - picked


def _p_tiles(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
             lse: torch.Tensor, g: torch.Tensor, block_v: int
             ) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
    """Yield (v0, w tile f32 [D, block_v], p [T, block_v] f32) per vocab
    tile, p = (where(col < V, exp(logits - lse), 0) - onehot(label)) * g,
    with the logits tile recomputed from x @ w_tile in f32."""
    vocab = w.shape[1]
    xf = x.float()
    lab = labels.long()[:, None]
    lse2, g2 = lse.float()[:, None], g.float()[:, None]
    for v0 in range(0, vocab, block_v):
        wt = w[:, v0:v0 + block_v].float()
        if wt.shape[1] < block_v:
            wt = F.pad(wt, (0, block_v - wt.shape[1]))
        cols = torch.arange(v0, v0 + block_v, device=x.device)[None, :]
        p = torch.where(cols < vocab, torch.exp(xf @ wt - lse2), 0.0)
        yield v0, wt, (p - (cols == lab).float()) * g2


def fused_ce_dx_plain(x, w, labels, lse, g, block_v: int = 512) -> torch.Tensor:
    """``_dx_kernel`` in plain PyTorch: dx = sum over vocab tiles of
    p @ w_tile^T, accumulated in f32, returned in ``x.dtype``."""
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for _, wt, p in _p_tiles(x, w, labels, lse, g, block_v):
        dx += p @ wt.T
    return dx.to(x.dtype)


def fused_ce_dw_plain(x, w, labels, lse, g, block_v: int = 512) -> torch.Tensor:
    """``_dw_kernel`` in plain PyTorch: dw[:, tile] = x^T @ p in f32,
    returned in ``w.dtype`` and sliced back to the true vocab."""
    vocab = w.shape[1]
    xt = x.float().T
    dw = torch.empty((x.shape[1], vocab), dtype=w.dtype, device=x.device)
    for v0, _, p in _p_tiles(x, w, labels, lse, g, block_v):
        dw[:, v0:v0 + block_v] = (xt @ p)[:, :vocab - v0].to(w.dtype)
    return dw


def fused_ce_bwd_plain(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                       lse: torch.Tensor, g: torch.Tensor, block_t: int = 256,
                       block_v: int = 512) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_dx_kernel`` and ``_dw_kernel`` compute, in plain PyTorch:
    (dx [T, D] in x.dtype, dw [D, vocab] in w.dtype). ``g`` is the upstream
    gradient, one value per token (0 on padded rows)."""
    _check(x, w, labels, block_t, block_v)
    return (fused_ce_dx_plain(x, w, labels, lse, g, block_v),
            fused_ce_dw_plain(x, w, labels, lse, g, block_v))


def reference_ce_losses(x: torch.Tensor, w: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Materializing reference: logits -> log_softmax -> gather. Labels
    must lie in ``[0, vocab)``."""
    logits = x.float() @ w.float()
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
