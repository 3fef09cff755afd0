"""Fused unembed + softmax cross-entropy forward (counterpart of
``k8s_dra_driver_tpu/ops/fused_ce.py``).

``fused_ce_losses(x, w, labels)`` returns the per-token loss
``logsumexp(x @ w) - (x @ w)[label]`` without materializing the
``[T, vocab]`` logits. On a CUDA tensor it launches the hand-written
kernel in ``csrc/fused_ce_fwd.cu`` (bf16 x and w) or raises; on a CPU
tensor it runs ``fused_ce_losses_plain``, the same computation in plain
PyTorch. ``reference_ce_losses`` materializes the logits and is the check.

A label of -1 matches no class (its loss is the row's logsumexp): callers
pad the token dimension with it, as ``evaluate_nll`` does. Other labels
must lie in ``[0, vocab)``. Only the forward exists so far; inputs that
require grad are refused until the backward kernels are ported.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from k8s_dra_driver_tpu_torch.ops import LAUNCHES, _build

KERNEL = "fused_ce_fwd"


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

    x: [T, D], w: [D, vocab], labels: [T] int. Returns [T] float32. T must
    divide by ``block_t``. ``block_v`` is the vocab tile of the plain
    version; the CUDA kernel uses its own tile sizes.
    """
    _check(x, w, labels, block_t, block_v)
    if x.requires_grad or w.requires_grad:
        raise NotImplementedError(
            "fused_ce_losses is forward-only: the backward kernels "
            "(_dx_kernel, _dw_kernel) are not ported yet; call it under "
            "torch.no_grad() or on detached tensors")
    if x.device.type == "cpu" and w.device.type == "cpu":
        return fused_ce_losses_plain(x, w, labels, block_t, block_v)
    if x.device.type != "cuda" or w.device != x.device or labels.device != x.device:
        raise ValueError(f"fused_ce_losses: x, w and labels must share one "
                         f"CUDA device (or all lie on the CPU); got {x.device}, "
                         f"{w.device}, {labels.device}")
    lse, picked = _launch(x, w, labels)
    return lse - picked


def _launch(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
    """Run the CUDA kernel: returns (lse, picked), each [T] float32."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA fused_ce kernel takes bf16 x and w, got "
                        f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the CUDA fused_ce kernel takes contiguous x and w")
    t_dim, d = x.shape
    vocab = w.shape[1]
    if max(t_dim * d, d * vocab) >= 2 ** 31:
        raise ValueError("the CUDA fused_ce kernel indexes rows with int32 sizes")
    labels32 = labels.to(torch.int32).contiguous()
    lse = torch.empty(t_dim, dtype=torch.float32, device=x.device)
    picked = torch.empty_like(lse)
    fn = _build.load(KERNEL).fused_ce_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), labels32.data_ptr(),
                 lse.data_ptr(), picked.data_ptr(), t_dim, d, vocab, stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_fwd launch failed: CUDA error {err}")
    LAUNCHES[KERNEL] += 1
    return lse, picked


def fused_ce_losses_plain(x: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor, block_t: int = 256,
                          block_v: int = 512) -> torch.Tensor:
    """The kernel's computation in plain PyTorch: walk the vocab in tiles
    of ``block_v`` with an online (max, sum) logsumexp in f32, mask the pad
    columns of the last tile, and pick out each label's logit."""
    _check(x, w, labels, block_t, block_v)
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
    return (m + torch.log(l) - picked)[:, 0]


def reference_ce_losses(x: torch.Tensor, w: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    """Materializing reference: logits -> log_softmax -> gather. Labels
    must lie in ``[0, vocab)``."""
    logits = x.float() @ w.float()
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
