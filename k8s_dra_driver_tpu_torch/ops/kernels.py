"""Fused RMSNorm and the tiled matmul, forward and VJP (counterpart of
``k8s_dra_driver_tpu/ops/kernels.py``).

``rmsnorm(x, gain)`` normalizes the last dim in f32 and returns
``x.dtype``; ``tiled_matmul(a, b)`` is a[M, K] @ b[K, N] with f32
accumulation, returned in ``a.dtype``. Both are differentiable through a
``torch.autograd.Function``: ``RMSNorm``'s backward is the reference's
analytical formula in torch ops (the reference has no backward kernel
either), and ``TiledMatmul``'s backward runs dA = dY·Bᵀ and dB = Aᵀ·dY
through the same forward kernel, each only when its input needs a grad.

On CUDA tensors the forwards launch ``csrc/rmsnorm.cu`` and
``csrc/tiled_matmul.cu`` (bf16 on wgmma; f32 as three TF32 products on
wgmma, f32-accurate), or raise; on CPU tensors they run
the plain PyTorch versions ``rmsnorm_plain`` and ``tiled_matmul_plain``.
The reference's ``block_rows``, ``bm`` and ``bn`` are TPU grid sizes that
never change the result: they are checked and otherwise unused, and the
CUDA kernels pick their own tiles. As in the reference, no model calls
these entry points: they are standalone, whole-op kernels.
"""

from __future__ import annotations

from typing import Tuple

import torch

from k8s_dra_driver_tpu_torch.ops import _build, on_cpu

KERNEL_RMSNORM = "rmsnorm"
KERNEL_MATMUL = "tiled_matmul"
# The dtype codes the C entry points take.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _positive(**sizes: int) -> None:
    for name, v in sizes.items():
        if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
            raise ValueError(f"{name} must be a positive int, got {v!r}")


def _code(dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernels of ops.kernels take float32 or bfloat16, "
                        f"got {dtype}")
    return DTYPE_CODES[dtype]


# -- fused RMSNorm -----------------------------------------------------------

def rmsnorm(x: torch.Tensor, gain: torch.Tensor, *, block_rows: int = 256,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim: x [..., d], gain [d]; returns
    (f32(x) · rsqrt(mean(f32(x)²) + eps) · f32(gain)) in ``x.dtype``,
    differentiable in x and gain. With no rows or d == 0, x comes back as
    it is."""
    _positive(block_rows=block_rows)
    d = x.shape[-1] if x.dim() else -1
    if tuple(gain.shape) != (d,):
        raise ValueError(f"rmsnorm: gain must be [{d}], got {tuple(gain.shape)}")
    if x.numel() == 0:
        return x
    return RMSNorm.apply(x, gain, float(eps))


class RMSNorm(torch.autograd.Function):
    """Forward: the RMSNorm kernel (CUDA) or ``rmsnorm_plain`` (CPU); saves
    (x, gain). Backward: ``_rmsnorm_bwd`` in torch ops on either device."""

    @staticmethod
    def forward(ctx, x, gain, eps: float):
        if on_cpu("rmsnorm", x, gain):
            y = rmsnorm_plain(x, gain, eps)
        else:
            y = _launch_rmsnorm(x, gain, eps)
        ctx.save_for_backward(x, gain)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gain = ctx.saved_tensors
        dx, dg = _rmsnorm_bwd(x, gain, dy, ctx.eps)
        return dx, dg, None


def rmsnorm_plain(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``_rmsnorm_kernel`` in plain PyTorch, in the reference's order of
    operations: for bf16 x and f32 gain it is ``models.common.rmsnorm``
    bit for bit."""
    xf = x.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * r * gain.float()).to(x.dtype)


def _rmsnorm_bwd(x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's analytical VJP (``_rmsnorm_cv_bwd``) in f32: with
    r = rsqrt(mean(x²) + eps),
        dx = r·g·dy − x · r³/d · Σ_d(x·g·dy),   dg = Σ_rows(x·r·dy);
    dx in ``x.dtype``, dg in ``gain.dtype``."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).float()
    dyf = dy.reshape(-1, d).float()
    gf = gain.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gdy = gf * dyf
    dx = r * gdy - xf * (r ** 3 / d) * torch.sum(xf * gdy, dim=-1, keepdim=True)
    dg = torch.sum((xf * r) * dyf, dim=0)
    return dx.reshape(x.shape).to(x.dtype), dg.to(gain.dtype)


def _launch_rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """Run the CUDA RMSNorm kernel: y in ``x.dtype``, x's shape."""
    x_code, g_code = _code(x.dtype), _code(gain.dtype)
    d = x.shape[-1]
    x2 = x.reshape(-1, d).contiguous()
    if x2.numel() >= 2 ** 31:
        raise ValueError("the CUDA rmsnorm kernel indexes with int32 sizes")
    y = torch.empty_like(x2)
    _build.launch(KERNEL_RMSNORM, x.device, x2, gain.contiguous(), y, x2.shape[0], d,
                  float(eps), x_code, g_code)
    return y.reshape(x.shape)


# -- tiled matmul ------------------------------------------------------------

def tiled_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 256,
                 bn: int = 256) -> torch.Tensor:
    """a[M, K] @ b[K, N] with f32 accumulation, in ``a.dtype``; mixed
    dtypes compute in ``torch.promote_types`` (as ``jnp.dot`` promotes).
    Differentiable in a and b. Every shape is taken: M or N of 0 gives an
    empty result, K of 0 zeros."""
    _positive(bm=bm, bn=bn)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"tiled_matmul takes a [M, K] and b [K, N]; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    return TiledMatmul.apply(a, b)


class TiledMatmul(torch.autograd.Function):
    """Forward: ``_matmul`` (the kernel on CUDA); saves (a, b). Backward:
    dA = dY·Bᵀ and dB = Aᵀ·dY through ``_matmul`` again, each only when
    asked for, cast to a's and b's dtypes as the reference's VJP does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _matmul(a, b)

    @staticmethod
    def backward(ctx, dy):
        a, b = ctx.saved_tensors
        need_a, need_b = ctx.needs_input_grad[:2]
        da = _matmul(dy, b.T).to(a.dtype) if need_a else None
        db = _matmul(a.T, dy).to(b.dtype) if need_b else None
        return da, db


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One product in ``a.dtype``: the CUDA kernel, or ``tiled_matmul_plain``
    for CPU tensors. Empty shapes launch nothing."""
    cpu = on_cpu("tiled_matmul", a, b)
    m, n = a.shape[0], b.shape[1]
    if m == 0 or n == 0:
        return torch.empty((m, n), dtype=a.dtype, device=a.device)
    if cpu:
        return tiled_matmul_plain(a, b)
    return _launch_matmul(a, b).to(a.dtype)


def tiled_matmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``_matmul_kernel`` in plain PyTorch: both operands in the promoted
    dtype widened to at least f32, one product, cast to ``a.dtype``."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype), torch.float32)
    return (a.to(acc) @ b.to(acc)).to(a.dtype)


# The kernel reads its operands through TMA, which needs a 16-byte base and
# a leading dimension that spans a multiple of 16 bytes: 8 bf16, 4 f32.
TMA_ALIGN = 16


def _operand(t: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    """(tensor, transposed flag, leading dimension) of a 2-D operand as the
    kernel reads it. In place when it is row-major (flag 0) or the
    transpose of a row-major matrix (flag 1), as ``b.T`` and ``a.T`` in the
    VJP are, its leading dimension spans a multiple of ``TMA_ALIGN`` bytes
    and its base is ``TMA_ALIGN``-byte aligned. Otherwise a row-major copy
    in a fresh buffer whose leading dimension is rounded up to that rule
    (the columns past the matrix are never read)."""
    r, c = t.shape
    step = TMA_ALIGN // t.element_size()

    def fits(ld: int) -> bool:
        return ld % step == 0 and t.data_ptr() % TMA_ALIGN == 0

    if t.stride(1) == 1 and (r == 1 or t.stride(0) >= c):
        ld = t.stride(0) if r > 1 else max(c, 1)
        if fits(ld):
            return t, 0, ld
    elif t.stride(0) == 1 and (c == 1 or t.stride(1) >= r):
        ld = t.stride(1) if c > 1 else max(r, 1)
        if fits(ld):
            return t, 1, ld
    ld = -(-max(c, 1) // step) * step
    buf = torch.empty((r, ld), dtype=t.dtype, device=t.device)
    buf[:, :c] = t
    return buf, 0, ld


def _launch_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Run the CUDA matmul kernel: [M, N] in the promoted dtype."""
    ct = torch.promote_types(a.dtype, b.dtype)
    code = _code(ct)
    # The kernel takes one dtype: the narrower operand is cast up first, as
    # jnp.dot promotes inside the reference's kernel body.
    (m, k), n = a.shape, b.shape[1]
    a, a_t, lda = _operand(a.to(ct))
    b, b_t, ldb = _operand(b.to(ct))
    # The offset of each operand's last element, as the kernel computes it.
    last = [(c - 1) * ld + r - 1 if t else (r - 1) * ld + c - 1
            for r, c, t, ld in ((m, k, a_t, lda), (k, n, b_t, ldb))]
    if m * n >= 2 ** 31 or max(last) >= 2 ** 31:
        raise ValueError("the CUDA tiled_matmul kernel indexes with int32 offsets")
    out = torch.empty((m, n), dtype=ct, device=a.device)
    _build.launch(KERNEL_MATMUL, a.device, a, b, out, m, n, k, lda, ldb, a_t, b_t, code)
    return out
