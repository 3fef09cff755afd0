"""Causal flash attention, forward and backward (counterpart of the Pallas
TPU kernel ``jax.experimental.pallas.ops.tpu.flash_attention`` that the
reference flagship calls when ``attention="flash"``).

``flash_attention(q, k, v, causal=True, sm_scale=...)`` takes q, k, v
[batch, heads, seq, head_dim] and returns softmax(q kᵀ · sm_scale, causal)
v in q's dtype without materializing the [seq, seq] scores. It is
differentiable through ``FlashAttention``, a ``torch.autograd.Function``
that saves (q, k, v, o, l, m) as the library's custom VJP does: l and m
are each row's softmax sum and max, [batch, heads, seq] f32. On CUDA
tensors (bf16, head_dim a multiple of 16 up to ``MAX_HEAD_DIM``) the
forward launches ``csrc/flash_fwd.cu`` and the backward
``csrc/flash_dkv.cu`` and ``csrc/flash_dq.cu``, or raises; on CPU tensors
they run the plain PyTorch versions below, which walk blocks of 128 as
the library's kernels do (``flash_fwd_plain``, ``flash_dkv_plain``,
``flash_dq_plain``). ``reference_attention`` materializes the scores and
is the check.

seq must divide by 128, the library's default block (its kernels refuse
other lengths). Only causal attention, the flagship's, is ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from k8s_dra_driver_tpu_torch.ops import _build, on_cpu

KERNEL_FWD = "flash_fwd"
KERNEL_DQ = "flash_dq"
KERNEL_DKV = "flash_dkv"
BLOCK = 128
# The library's additive mask value (flash_attention.py DEFAULT_MASK_VALUE).
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# The three kernels keep [64, head_dim] f32 accumulators in a warpgroup's
# registers, the head_dim cut into slices of 256 (forward and dq) or 128
# (dkv) columns over the blocks of a thread-block cluster of at most 8:
# head_dim <= 1024.
MAX_HEAD_DIM = 1024


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if not causal:
        raise NotImplementedError("only causal flash attention is ported")
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention takes q, k, v of one shape [b, h, s, "
                         f"head_dim]; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[2] % BLOCK:
        raise ValueError(f"flash_attention needs seq ({q.shape[2]}) % {BLOCK} == 0, "
                         f"the reference kernel's block")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float = 1.0) -> torch.Tensor:
    """Causal attention of q, k, v [b, h, s, head_dim]; returns [b, h, s,
    head_dim] in q's dtype, differentiable in q, k and v."""
    _check(q, k, v, causal)
    return FlashAttention.apply(q, k, v, float(sm_scale))


class FlashAttention(torch.autograd.Function):
    """Forward: (o, l, m) from the forward kernel; saves (q, k, v, o, l, m).
    Backward: di = sum(o * do) over head_dim in torch, as the library does,
    then dk and dv from the dkv kernel and dq from the dq kernel (CUDA) or
    their plain versions (CPU), each only when an input needs it."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale: float):
        if on_cpu("flash_attention", q, k, v):
            o, l, m = flash_fwd_plain(q, k, v, sm_scale)
        else:
            q, k, v = _kernel_inputs(q, k, v)
            o, l, m = _launch_fwd(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, l, m)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, l, m = ctx.saved_tensors
        need_q, need_k, need_v = ctx.needs_input_grad[:3]
        di = (o.float() * do.float()).sum(-1)
        dq = dk = dv = None
        if on_cpu("flash_attention", q, do):
            if need_k or need_v:
                dk, dv = flash_dkv_plain(q, k, v, do, l, m, di, ctx.sm_scale)
            if need_q:
                dq = flash_dq_plain(q, k, v, do, l, m, di, ctx.sm_scale)
        else:
            (do,) = _kernel_inputs(do)
            if need_k or need_v:
                dk, dv = _launch_bwd(KERNEL_DKV, q, k, v, do, l, m, di, ctx.sm_scale)
            if need_q:
                (dq,) = _launch_bwd(KERNEL_DQ, q, k, v, do, l, m, di, ctx.sm_scale)
        return dq, dk, dv, None


def _kernel_inputs(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Check what every CUDA flash kernel takes; return contiguous tensors
    on 16-byte boundaries (the kernels copy 16 bytes at a time)."""
    out = []
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the CUDA flash kernels take bf16 tensors, got {t.dtype}")
        t = t.contiguous()
        out.append(t.clone() if t.data_ptr() % 16 else t)
    b, h, s, d = out[0].shape
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA flash kernels take head_dim a multiple of 16 "
                         f"and <= {MAX_HEAD_DIM}, got {d}")
    if out[0].numel() >= 2 ** 31:
        raise ValueError("the CUDA flash kernels index with int32 sizes")
    return tuple(out)


def _launch_fwd(q, k, v, sm_scale: float):
    """Run the CUDA forward kernel: (o bf16 [b, h, s, d], l, m f32 [b, h, s])."""
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    l = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    m = torch.empty_like(l)
    _build.launch(KERNEL_FWD, q.device, q, k, v, o, l, m, b * h, s, d, sm_scale)
    return o, l, m


def _launch_bwd(kernel: str, q, k, v, do, l, m, di, sm_scale: float):
    """Run one CUDA backward kernel: ``flash_dkv`` returns (dk, dv),
    ``flash_dq`` returns (dq,), each bf16 [b, h, s, d]."""
    b, h, s, d = q.shape
    l, m, di = (t.float().contiguous() for t in (l, m, di))
    outs = tuple(torch.empty_like(q) for _ in range(2 if kernel == KERNEL_DKV else 1))
    _build.launch(kernel, q.device, q, k, v, do, l, m, di, *outs, b * h, s, d,
                  sm_scale)
    return outs


def _causal_bias(q0: int, k0: int, bq: int, bk: int, device) -> torch.Tensor:
    """[bq, bk] additive mask of the block at rows q0.., columns k0..: 0
    where column <= row, the library's mask value elsewhere."""
    rows = torch.arange(q0, q0 + bq, device=device)[:, None]
    cols = torch.arange(k0, k0 + bk, device=device)[None, :]
    return torch.where(cols <= rows, 0.0, MASK_VALUE)


def _scores(qb: torch.Tensor, kb: torch.Tensor, q0: int, k0: int,
            sm_scale: float) -> torch.Tensor:
    """The masked, scaled f32 scores of one block: q kᵀ in f32, then
    ``*= sm_scale``, then the additive causal mask."""
    s = qb.float() @ kb.float().transpose(-1, -2)
    s = s * sm_scale
    return s + _causal_bias(q0, k0, qb.shape[-2], kb.shape[-2], qb.device)


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The library's forward kernel in plain PyTorch: for each query block,
    walk the key blocks up to the diagonal with an online (m, l), p cast to
    v's dtype before p·v, and the f32 accumulator renormalized each step.
    Returns (o in q.dtype, l, m), l and m [b, h, s] f32."""
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    l_out = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    m_out = torch.empty_like(l_out)
    for q0 in range(0, s, BLOCK):
        qb = q[:, :, q0:q0 + BLOCK]
        m = torch.full((b, h, qb.shape[2], 1), -float("inf"), device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        for k0 in range(0, q0 + BLOCK, BLOCK):
            sc = _scores(qb, k[:, :, k0:k0 + BLOCK], q0, k0, sm_scale)
            m_next = torch.maximum(m, sc.max(-1, keepdim=True).values)
            p = torch.exp(sc - m_next)
            l_corr = torch.exp(m - m_next) * l
            l_next = p.sum(-1, keepdim=True) + l_corr
            l_inv = torch.where(l_next == 0.0, 1.0, 1.0 / l_next)
            vb = v[:, :, k0:k0 + BLOCK]
            acc = acc * (l_corr * l_inv) + (p.to(v.dtype).float() @ vb.float()) * l_inv
            m, l = m_next, l_next
        o[:, :, q0:q0 + BLOCK] = acc.to(q.dtype)
        l_out[:, :, q0:q0 + BLOCK] = l[..., 0]
        m_out[:, :, q0:q0 + BLOCK] = m[..., 0]
    return o, l_out, m_out


def _probs(qb, kb, q0, k0, l, m, sm_scale):
    """p = exp(s - m) * (1/l) of one block, from the saved row statistics."""
    sc = _scores(qb, kb, q0, k0, sm_scale)
    rows = slice(q0, q0 + qb.shape[2])
    return torch.exp(sc - m[:, :, rows, None]) * (1.0 / l[:, :, rows, None])


def flash_dkv_plain(q, k, v, do, l, m, di, sm_scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The library's dkv kernel in plain PyTorch: for each key block, walk
    the query blocks from the diagonal down; dv += pᵀ·do and dk +=
    dsᵀ·q in f32, with p and ds = (do·vᵀ - di)·p·sm_scale cast to do's
    dtype first. Returns (dk in k.dtype, dv in v.dtype)."""
    s = q.shape[2]
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, s, BLOCK):
        kb, vb = k[:, :, k0:k0 + BLOCK], v[:, :, k0:k0 + BLOCK]
        dk_acc = torch.zeros(kb.shape, dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
        for q0 in range(k0, s, BLOCK):
            qb, dob = q[:, :, q0:q0 + BLOCK], do[:, :, q0:q0 + BLOCK]
            p = _probs(qb, kb, q0, k0, l, m, sm_scale)
            dv_acc += p.to(do.dtype).float().transpose(-1, -2) @ dob.float()
            dp = dob.float() @ vb.float().transpose(-1, -2)
            ds = (dp - di[:, :, q0:q0 + BLOCK, None]) * p
            ds = ds * sm_scale
            dk_acc += ds.to(do.dtype).float().transpose(-1, -2) @ qb.float()
        dk[:, :, k0:k0 + BLOCK] = dk_acc.to(k.dtype)
        dv[:, :, k0:k0 + BLOCK] = dv_acc.to(v.dtype)
    return dk, dv


def flash_dq_plain(q, k, v, do, l, m, di, sm_scale: float) -> torch.Tensor:
    """The library's dq kernel in plain PyTorch: for each query block, walk
    the key blocks up to the diagonal; dq += ds·k in f32, with ds cast to
    k's dtype first. Returns dq in q.dtype."""
    s = q.shape[2]
    dq = torch.empty_like(q)
    for q0 in range(0, s, BLOCK):
        qb, dob = q[:, :, q0:q0 + BLOCK], do[:, :, q0:q0 + BLOCK]
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        for k0 in range(0, q0 + BLOCK, BLOCK):
            kb, vb = k[:, :, k0:k0 + BLOCK], v[:, :, k0:k0 + BLOCK]
            p = _probs(qb, kb, q0, k0, l, m, sm_scale)
            dp = dob.float() @ vb.float().transpose(-1, -2)
            ds = (dp - di[:, :, q0:q0 + BLOCK, None]) * p
            ds = ds * sm_scale
            acc += ds.to(k.dtype).float() @ kb.float()
        dq[:, :, q0:q0 + BLOCK] = acc.to(q.dtype)
    return dq


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        sm_scale: float = 1.0) -> torch.Tensor:
    """Materializing causal attention in f32 (the library's
    ``mha_reference``): scores, mask, softmax, weights·v. Differentiable;
    returns f32."""
    s = q.shape[2]
    sc = (q.float() @ k.float().transpose(-1, -2)) * sm_scale
    sc = sc + _causal_bias(0, 0, s, s, q.device)
    return torch.softmax(sc, dim=-1) @ v.float()
