"""Fused unembed + softmax cross-entropy, forward and backward (counterpart
of ``k8s_dra_driver_tpu/ops/fused_ce.py``).

``fused_ce_losses(x, w, labels)`` returns the per-token loss
``logsumexp(x @ w) - (x @ w)[label]`` without materializing the
``[T, vocab]`` logits, and is differentiable in ``x`` and ``w`` through
``FusedCE``, a ``torch.autograd.Function`` that saves ``(x, w, labels,
lse)`` as the JAX custom VJP does and recomputes each logits tile in the
backward. On CUDA tensors (bf16 x and w) both directions launch the
kernels under ``csrc/``, or raise; on CPU tensors they run the plain
PyTorch versions below. ``reference_ce_losses`` materializes the logits
and is the check.

The CUDA forward, ``csrc/fused_ce_fwd.cu``, is one launch of the bf16
wgmma product x @ w over the whole vocab in tiles of ``FWD_ROWS`` rows by
``FWD_TILE`` columns. Each tile's epilogue reduces its f32 logits in
registers to a (max, sum of exp) pair a row, written to an f32 scratch
[2, vocab tiles, T], and the tile holding a row's label writes the picked
logit; the last block of each row tile to arrive folds the pairs into lse.
``fused_ce_fwd_partials_plain`` and ``fused_ce_lse_fold_plain`` are those
two steps in plain PyTorch.

The CUDA backward walks the vocab in chunks (``_bwd_chunks``). For each
chunk ``csrc/fused_ce_p.cu`` recomputes the logits and writes p =
(softmax - onehot) * g for the chunk's columns in bf16 to a scratch
``p_c`` [T, chunk], and ``csrc/fused_ce_dx.cu`` and ``csrc/fused_ce_dw.cu``
multiply it into dx and dw: three bf16 wgmma products, the last two each
only for the grad asked for. Neither direction writes the
[T, vocab] logits to device memory; the backward writes p one chunk at a
time, at most ``P_BUDGET`` bytes (except that a chunk is never narrower
than 256 columns), and with more than one chunk an f32 [T, D] sum of dx.

A label of -1 matches no class (its loss is the row's logsumexp): callers
pad the token dimension with it, as ``evaluate_nll`` does. Other labels
must lie in ``[0, vocab)``.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from k8s_dra_driver_tpu_torch.ops import _build, on_cpu
from k8s_dra_driver_tpu_torch.ops.kernels import _operand

KERNEL = "fused_ce_fwd"
KERNEL_P = "fused_ce_p"
KERNEL_DX = "fused_ce_dx"
KERNEL_DW = "fused_ce_dw"
# The forward kernel's tile: rows of a block, and vocab columns whose
# (max, sum) pair a row it writes to the scratch.
FWD_ROWS, FWD_TILE = 128, 256
# The backward's vocab chunks are multiples of the kernels' 256-column
# tile (but for the last), as wide as keeps p_c, [T, chunk] bf16, within
# P_BUDGET bytes: 32 MB, so that p_c, written by fused_ce_p and read at
# once by the two products, fits the H100's 50 MB L2, and so that no [T,
# vocab] tensor of the flagship's bench shape (T = 4096, V = 8192: 64 MB)
# reaches device memory. Wider chunks are faster (fewer launches, fuller
# waves, less of dx's f32 sum): ops/fused_ce_budget.py times the whole
# backward at that shape for 16, 32 and 64 MB (4, 2 and 1 chunks);
# its readings are in PERF.md.
BWD_TILE = 256
P_BUDGET = 32 * 2 ** 20


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
    """Forward: (lse, picked) from ``fused_ce_fwd``, one launch (CUDA), or
    ``_plain_parts`` (CPU); saves (x, w, labels, lse). Backward: dx and dw
    from the chunked backward kernels (CUDA) or ``fused_ce_dx_plain`` /
    ``fused_ce_dw_plain`` (CPU), each computed only when its input needs a
    grad."""

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
        elif need_dx or need_dw:
            dx, dw = _launch_bwd(x, w, labels, lse, g, need_dx, need_dw)
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


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` [r, c] as the kernels read it by TMA, with its row pitch in
    ``stride(0)``: ``t`` itself when that pitch spans a multiple of 16
    bytes and its base is 16-byte aligned (``kernels._operand``'s rule),
    else the first c columns of an aligned copy."""
    buf, _, _ = _operand(t)
    return buf[:, :t.shape[1]]


# The forward kernel's arrival counters, one int32 a row tile, kept per
# (device, stream) and grown as needed: zeroed once, then left zeroed by
# each launch, and launches on one stream never overlap.
_ARRIVED: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _arrivals(dev: torch.device, row_tiles: int) -> torch.Tensor:
    """Zeroed arrival counters [row_tiles] int32 for a forward launch on
    the current stream of ``dev``."""
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    buf = _ARRIVED.get(key)
    if buf is None or buf.numel() < row_tiles:
        buf = _ARRIVED[key] = torch.zeros(row_tiles, dtype=torch.int32, device=dev)
    return buf[:row_tiles]


def _fwd_args(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor) -> tuple:
    """The CUDA forward kernel's arguments after its device: (x, w,
    labels32, part, arrived, lse, picked, T, D, V, ldx, ldw). x and w as
    ``_tma_rows`` gives them; part [2, vocab tiles, T] f32 is the scratch
    (each ``FWD_TILE`` columns' row max, then row sum of exp, as
    ``fused_ce_fwd_partials_plain`` forms them), lse and picked [T] f32
    the outputs, all three from ``torch.empty``; arrived from
    ``_arrivals``."""
    labels32 = _kernel_labels(x, w, labels)
    t_dim, d = x.shape
    vocab = w.shape[1]
    x, w = _tma_rows(x), _tma_rows(w)
    dev = x.device
    part = torch.empty((2, -(-vocab // FWD_TILE), t_dim), dtype=torch.float32, device=dev)
    lse = torch.empty(t_dim, dtype=torch.float32, device=dev)
    picked = torch.empty_like(lse)
    return (x, w, labels32, part, _arrivals(dev, -(-t_dim // FWD_ROWS)), lse, picked,
            t_dim, d, vocab, x.stride(0), w.stride(0))


def _launch_with_partials(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the CUDA forward kernel on ``_fwd_args``: (lse, picked), each
    [T] f32, and the scratch it folded, part."""
    args = _fwd_args(x, w, labels)
    _build.launch(KERNEL, x.device, *args)
    part, _, lse, picked = args[3:7]
    return lse, picked, part


def _launch(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
    """Run the CUDA forward kernel: returns (lse, picked), each [T] f32."""
    return _launch_with_partials(x, w, labels)[:2]


def _bwd_chunks(t_dim: int, vocab: int) -> List[Tuple[int, int]]:
    """The CUDA backward's plan: (first column, width) of each vocab chunk,
    covering [0, vocab) in order. Every chunk but the last is the widest
    multiple of ``BWD_TILE`` whose p_c (``t_dim`` x width bf16) fits
    ``P_BUDGET`` bytes, and at least ``BWD_TILE``; one chunk when the whole
    vocab fits."""
    width = max(BWD_TILE, P_BUDGET // (2 * t_dim) // BWD_TILE * BWD_TILE)
    return [(v0, min(width, vocab - v0)) for v0 in range(0, vocab, width)]


def _launch_p(x: torch.Tensor, w: torch.Tensor, labels32: torch.Tensor,
              lse: torch.Tensor, g: torch.Tensor, p: torch.Tensor, v0: int) -> None:
    """``fused_ce_p``: p (a [T, width] bf16 view with an aligned row pitch)
    = the chunk of p for w's columns [v0, v0 + width). x and w as
    ``_tma_rows`` gives them; lse and g f32."""
    (t_dim, d), vocab = x.shape, w.shape[1]
    _build.launch(KERNEL_P, x.device, x, w, labels32, lse, g, p, t_dim, d, vocab,
                  x.stride(0), w.stride(0), p.stride(0), v0, p.shape[1])


def _launch_dx(p: torch.Tensor, w: torch.Tensor, acc: torch.Tensor, dx: torch.Tensor,
               v0: int, first: bool, last: bool) -> None:
    """``fused_ce_dx``: one chunk's p @ w[:, chunk]^T into the f32 scratch
    ``acc`` [T, D] (stored if ``first``, else added into) or, if ``last``,
    added to acc (unless also first) and written to ``dx`` [T, D] bf16."""
    t_dim, d = dx.shape
    _build.launch(KERNEL_DX, p.device, p, w, acc, dx, t_dim, d, p.stride(0), w.stride(0),
                  v0, p.shape[1], int(first), int(last))


def _launch_dw(x: torch.Tensor, p: torch.Tensor, dw: torch.Tensor, v0: int) -> None:
    """``fused_ce_dw``: dw[:, v0:v0 + width] = x^T @ p, dw [D, V] bf16."""
    (t_dim, d), vocab = x.shape, dw.shape[1]
    _build.launch(KERNEL_DW, x.device, x, p, dw, t_dim, d, vocab, x.stride(0),
                  p.stride(0), v0, p.shape[1])


def _bwd_launches(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  lse: torch.Tensor, g: torch.Tensor, need_dx: bool = True,
                  need_dw: bool = True
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor],
                             torch.Tensor, List[tuple]]:
    """The CUDA backward, planned and not yet launched: (dx [T, D] bf16 or
    None, dw [D, vocab] bf16 or None, p, launches). ``launches`` lists
    (kernel, v0, width, launch) for each chunk of ``_bwd_chunks``, in the
    order they must run: ``fused_ce_p``, then ``fused_ce_dx`` if
    ``need_dx``, then ``fused_ce_dw`` if ``need_dw``; ``launch()`` issues
    the kernel. p is the scratch whose first ``width`` columns hold a
    chunk's p after its ``fused_ce_p``. The scratch (p; the f32 sum of dx
    with more than one chunk) and the outputs come from ``torch.empty``."""
    labels32 = _kernel_labels(x, w, labels)
    t_dim, d = x.shape
    vocab = w.shape[1]
    x, w = _tma_rows(x), _tma_rows(w)
    lse, g = lse.float().contiguous(), g.float().contiguous()
    chunks = _bwd_chunks(t_dim, vocab)
    pitch = -(-chunks[0][1] // 8) * 8  # a multiple of 16 bytes
    p = torch.empty((t_dim, pitch), dtype=torch.bfloat16, device=x.device)
    dx = dw = acc = None
    if need_dx:
        dx = torch.empty((t_dim, d), dtype=torch.bfloat16, device=x.device)
        # With one chunk dx is written straight away and acc is not read.
        acc = dx if len(chunks) == 1 else torch.empty(
            (t_dim, d), dtype=torch.float32, device=x.device)
    if need_dw:
        dw = torch.empty((d, vocab), dtype=torch.bfloat16, device=x.device)
    launches = []
    for i, (v0, width) in enumerate(chunks):
        pc = p[:, :width]
        launches.append((KERNEL_P, v0, width,
                         partial(_launch_p, x, w, labels32, lse, g, pc, v0)))
        if need_dx:
            launches.append((KERNEL_DX, v0, width, partial(
                _launch_dx, pc, w, acc, dx, v0, i == 0, i == len(chunks) - 1)))
        if need_dw:
            launches.append((KERNEL_DW, v0, width, partial(_launch_dw, x, pc, dw, v0)))
    return dx, dw, p, launches


def _launch_bwd(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                lse: torch.Tensor, g: torch.Tensor, need_dx: bool = True,
                need_dw: bool = True
                ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Run the CUDA backward: (dx [T, D] bf16 or None, dw [D, vocab] bf16 or
    None), each grad only when asked for, by the launches of
    ``_bwd_launches`` in order."""
    dx, dw, _, launches = _bwd_launches(x, w, labels, lse, g, need_dx, need_dw)
    for *_, launch in launches:
        launch()
    return dx, dw


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


def fused_ce_fwd_partials_plain(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                                tile: int = FWD_TILE
                                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernel's first step in plain PyTorch: (m, l, picked).
    m and l are [vocab tiles, T] f32, each tile of ``tile`` columns' row
    max of the f32 logits and row sum of exp(logits - m), over the columns
    below vocab only (the last tile is ragged); picked [T] is the label's
    logit, 0 for a label outside [0, vocab)."""
    t_dim, vocab = x.shape[0], w.shape[1]
    xf = x.float()
    lab = labels.long()
    ms, ls = [], []
    picked = torch.zeros(t_dim, device=x.device)
    for v0 in range(0, vocab, tile):
        logits = xf @ w[:, v0:v0 + tile].float()
        m = logits.max(dim=1).values
        ms.append(m)
        ls.append(torch.exp(logits - m[:, None]).sum(1))
        inside = (lab >= v0) & (lab < v0 + logits.shape[1])
        at = (lab - v0).clamp(0, logits.shape[1] - 1)[:, None]
        picked = torch.where(inside, logits.gather(1, at)[:, 0], picked)
    return torch.stack(ms), torch.stack(ls), picked


def fused_ce_lse_fold_plain(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The forward kernel's fold in plain PyTorch: lse [T] = M + log sum_i
    l_i exp(m_i - M), M = max_i m_i, over the tiles' partials [tiles, T]."""
    top = m.max(dim=0).values
    return top + torch.log((l * torch.exp(m - top)).sum(0))


def fused_ce_p_plain(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                     lse: torch.Tensor, g: torch.Tensor, v0: int,
                     width: int) -> torch.Tensor:
    """``fused_ce_p`` in plain PyTorch: p [T, width] f32 for w's columns
    [v0, v0 + width), p = (exp(x @ w_chunk - lse) - onehot(label)) * g, the
    logits recomputed in f32 (every column lies below vocab)."""
    logits = x.float() @ w[:, v0:v0 + width].float()
    cols = torch.arange(v0, v0 + width, device=x.device)[None, :]
    p = torch.exp(logits - lse.float()[:, None])
    return (p - (cols == labels.long()[:, None]).float()) * g.float()[:, None]


def fused_ce_dx_chunk_plain(p: torch.Tensor, w: torch.Tensor, v0: int) -> torch.Tensor:
    """``fused_ce_dx``'s product for one chunk in plain PyTorch: p [T,
    width] @ w[:, v0:v0 + width]^T in f32, [T, D]."""
    return p.float() @ w[:, v0:v0 + p.shape[1]].float().T


def fused_ce_dw_chunk_plain(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``fused_ce_dw``'s product for one chunk in plain PyTorch: x^T @ p in
    f32, [D, width]."""
    return x.float().T @ p.float()


def _p_tiles(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
             lse: torch.Tensor, g: torch.Tensor, block_v: int
             ) -> Iterator[Tuple[int, torch.Tensor]]:
    """Yield (v0, p [T, width] f32) per vocab tile of ``block_v`` columns
    (the last one ragged), p from ``fused_ce_p_plain``."""
    xf = x.float()
    vocab = w.shape[1]
    for v0 in range(0, vocab, block_v):
        yield v0, fused_ce_p_plain(xf, w, labels, lse, g, v0, min(block_v, vocab - v0))


def fused_ce_dx_plain(x, w, labels, lse, g, block_v: int = 512) -> torch.Tensor:
    """``_dx_kernel`` in plain PyTorch: dx = sum over vocab tiles of
    p @ w_tile^T, accumulated in f32, returned in ``x.dtype``."""
    dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for v0, p in _p_tiles(x, w, labels, lse, g, block_v):
        dx += fused_ce_dx_chunk_plain(p, w, v0)
    return dx.to(x.dtype)


def fused_ce_dw_plain(x, w, labels, lse, g, block_v: int = 512) -> torch.Tensor:
    """``_dw_kernel`` in plain PyTorch: dw[:, tile] = x^T @ p in f32,
    returned in ``w.dtype``."""
    xf = x.float()
    dw = torch.empty((x.shape[1], w.shape[1]), dtype=w.dtype, device=x.device)
    for v0, p in _p_tiles(x, w, labels, lse, g, block_v):
        dw[:, v0:v0 + p.shape[1]] = fused_ce_dw_chunk_plain(xf, p).to(w.dtype)
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
