"""Port parity: the standalone RMSNorm and tiled matmul, forward and VJP.

The same numpy inputs, made from a seed, go through the JAX package's
``ops.kernels.rmsnorm`` and ``ops.kernels.tiled_matmul`` (Pallas in
interpret mode, as tests/test_jax_ops.py runs them, gradients through
their custom VJPs) and through the port on the CPU, where ``RMSNorm`` and
``TiledMatmul`` run the plain PyTorch versions. The CUDA kernels
themselves are held to those plain versions on the card by
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from k8s_dra_driver_tpu.ops import kernels as jax_k
from k8s_dra_driver_tpu_torch.models import common
from k8s_dra_driver_tpu_torch.ops import LAUNCHES, _build
from k8s_dra_driver_tpu_torch.ops import kernels as torch_k

# f32 forward: the bound test_jax_ops.py holds the Pallas kernels to.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# f32 grads: the bound test_jax_ops.py holds the custom VJPs to.
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16 products: test_jax_ops.py's bound for the bf16 matmul.
BF16_MATMUL_TOL = dict(rtol=2e-2, atol=2e-2)
# The FFN-half chain in bf16, as max|err| / max|value| per tensor: each
# side rounds to bf16 after every op, GELU's internal precision differs
# (JAX in bf16, torch in f32), so values differ by a few bf16 ulps; the
# repo's bf16 tolerance.
CHAIN_BF16_REL_TOL = 2e-2


def _np(shape, seed, scale=1.0, shift=0.0):
    return (shift + scale * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def _pair(x, dtype):
    """The same values as a torch tensor and a JAX array of ``dtype``
    (both round f32 to bf16 to nearest even)."""
    t = torch.from_numpy(x).to(dtype)
    j = jnp.asarray(x).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return t, j


def _bf16_ulps(got: torch.Tensor, want) -> int:
    """Largest distance in bf16 ulps between two bf16 arrays of one sign
    pattern (their bit patterns as integers)."""
    g = got.view(torch.int16).numpy().astype(np.int64)
    w = np.asarray(want).view(np.int16).astype(np.int64)
    return int(np.abs(g - w).max())


# -- rmsnorm -----------------------------------------------------------------

# The reference's cases: (64, 128) with a normal gain; (3, 7, 128) with odd
# rows and a block_rows (4) that does not divide its 21 rows.
@pytest.mark.parametrize("shape,block_rows,gain_scale", [
    ((64, 128), 256, 1.0), ((3, 7, 128), 4, 0.0)])
def test_rmsnorm_matches_jax_f32(shape, block_rows, gain_scale):
    x = _np(shape, 0)
    g = _np(shape[-1:], 1, scale=gain_scale, shift=1.0 - gain_scale)
    want = np.asarray(jax_k.rmsnorm(jnp.asarray(x), jnp.asarray(g),
                                    block_rows=block_rows, interpret=True))
    got = torch_k.rmsnorm(torch.from_numpy(x), torch.from_numpy(g), block_rows=block_rows)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    ref = x / np.sqrt(np.mean(x * x, -1, keepdims=True) + 1e-6) * g
    np.testing.assert_allclose(got.numpy(), ref, **F32_TOL)


@pytest.mark.parametrize("x_dtype,g_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_rmsnorm_mixed_dtypes_match_jax(x_dtype, g_dtype):
    """The output keeps x's dtype. bf16 out: within one bf16 ulp (the f32
    sum of squares is taken in another order, so a value on a rounding
    boundary may round the other way); f32 out: the f32 bound."""
    tx, jx = _pair(_np((16, 256), 2), x_dtype)
    tg, jg = _pair(_np((256,), 3, scale=0.1, shift=1.0), g_dtype)
    want = jax_k.rmsnorm(jx, jg, interpret=True)
    got = torch_k.rmsnorm(tx, tg)
    assert got.dtype == x_dtype and str(want.dtype) == str(x_dtype).split(".")[-1]
    if x_dtype == torch.bfloat16:
        assert _bf16_ulps(got, want) <= 1
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("shape", [(0, 128), (4, 0)])
def test_rmsnorm_without_rows_or_width_returns_x(shape):
    x = torch.zeros(shape)
    assert torch_k.rmsnorm(x, torch.ones(shape[-1])) is x
    jx = jnp.zeros(shape)
    assert jax_k.rmsnorm(jx, jnp.ones(shape[-1]), interpret=True).shape == shape


def test_rmsnorm_grads_match_jax():
    """Grads of sum(sin(rmsnorm(x, g))) at (4, 16, 128), as the reference's
    own differentiability test: the port's analytical backward against
    jax.grad through the JAX custom VJP."""
    x = _np((4, 16, 128), 4)
    g = _np((128,), 5, scale=0.1, shift=1.0)
    want = jax.grad(lambda x, g: jnp.sum(jnp.sin(jax_k.rmsnorm(x, g, interpret=True))),
                    argnums=(0, 1))(jnp.asarray(x), jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    got = torch.autograd.grad(torch.sin(torch_k.rmsnorm(tx, tg)).sum(), (tx, tg))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **GRAD_TOL)


def test_rmsnorm_equals_the_models_rmsnorm_for_bf16_x():
    x = torch.from_numpy(_np((8, 128), 6)).to(torch.bfloat16)
    g = torch.from_numpy(_np((128,), 7, scale=0.1, shift=1.0))
    assert torch.equal(torch_k.rmsnorm(x, g), common.rmsnorm(x, g))


def test_rmsnorm_bwd_is_what_autograd_runs():
    x = torch.from_numpy(_np((2, 3, 64), 8)).requires_grad_()
    g = torch.from_numpy(_np((64,), 9, shift=1.0)).requires_grad_()
    dy = torch.from_numpy(_np((2, 3, 64), 10))
    got = torch.autograd.grad(torch_k.rmsnorm(x, g, eps=1e-5), (x, g), dy)
    want = torch_k._rmsnorm_bwd(x.detach(), g.detach(), dy, 1e-5)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# -- tiled matmul --------------------------------------------------------------

def test_tiled_matmul_bf16_matches_jax():
    ta, ja = _pair(_np((128, 64), 11), torch.bfloat16)
    tb, jb = _pair(_np((64, 128), 12), torch.bfloat16)
    want = jax_k.tiled_matmul(ja, jb, bm=64, bn=64, interpret=True)
    got = torch_k.tiled_matmul(ta, tb, bm=64, bn=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **BF16_MATMUL_TOL)


def test_tiled_matmul_untileable_shape():
    """13x7 @ 7x9 with bm = bn = 8: the reference sends it to XLA's dot,
    the port computes it the same way as every other shape."""
    got = torch_k.tiled_matmul(torch.ones(13, 7), torch.ones(7, 9), bm=8, bn=8)
    want = jax_k.tiled_matmul(jnp.ones((13, 7)), jnp.ones((7, 9)), bm=8, bn=8,
                              interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.full((13, 9), 7.0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("a_dtype,b_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_tiled_matmul_mixed_dtypes_match_jax(a_dtype, b_dtype):
    """The product runs in the promoted dtype (f32) and is cast to a's:
    bf16 out within one bf16 ulp, f32 out at the f32 bound."""
    ta, ja = _pair(_np((64, 96), 13), a_dtype)
    tb, jb = _pair(_np((96, 32), 14, scale=0.1), b_dtype)
    want = jax_k.tiled_matmul(ja, jb, bm=32, bn=32, interpret=True)
    got = torch_k.tiled_matmul(ta, tb, bm=32, bn=32)
    assert got.dtype == a_dtype
    if a_dtype == torch.bfloat16:
        assert _bf16_ulps(got, want) <= 1
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("bm,bn", [(64, 64), (32, 128), (256, 256), (8, 16), (48, 40)])
def test_tiled_matmul_block_sizes_do_not_change_the_result(bm, bn):
    a, b = _np((128, 64), 15), _np((64, 128), 16)
    got = torch_k.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b), bm=bm, bn=bn)
    assert torch.equal(got, torch_k.tiled_matmul(torch.from_numpy(a), torch.from_numpy(b)))
    want = jax_k.tiled_matmul(jnp.asarray(a), jnp.asarray(b), bm=bm, bn=bn, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("m,k,n", [(0, 5, 7), (5, 0, 7), (5, 3, 0)])
def test_tiled_matmul_empty_shapes(m, k, n):
    """M or N of 0: the reference sends the shape to XLA's dot, an empty
    result. K of 0: its Pallas call is refused in interpret mode (a block
    of width 0), so the port is held to jnp.dot, zeros."""
    got = torch_k.tiled_matmul(torch.ones(m, k), torch.ones(k, n))
    want = jnp.dot(jnp.ones((m, k)), jnp.ones((k, n)))
    if k:
        want = jax_k.tiled_matmul(jnp.ones((m, k)), jnp.ones((k, n)), interpret=True)
    assert got.shape == (m, n) == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (64, 32) @ (32, 48): the reference's own test; (131, 67) @ (67, 259):
# ragged against every tile of the CUDA kernels (128 x 128 and 32 deep in
# f32), so the VJP's two transposed orientations meet an edge too. Its
# operands are scaled by 0.1 so that the grads, sums of 131 and 259 terms,
# stay of the reference case's size, where GRAD_TOL's atol applies.
@pytest.mark.parametrize("m,k,n,scale", [(64, 32, 48, 1.0), (131, 67, 259, 0.1)])
def test_tiled_matmul_grads_match_jax(m, k, n, scale):
    """Grads of sum(sin(a @ b)) in f32: both VJP products against jax.grad
    through the JAX custom VJP."""
    a, b = _np((m, k), 17, scale=scale), _np((k, n), 18, scale=scale)
    want = jax.grad(lambda a, b: jnp.sum(jnp.sin(jax_k.tiled_matmul(a, b, interpret=True))),
                    argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    got = torch.autograd.grad(torch.sin(torch_k.tiled_matmul(ta, tb)).sum(), (ta, tb))
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), **GRAD_TOL)


def test_tiled_matmul_computes_only_the_grads_asked_for(monkeypatch):
    a = torch.from_numpy(_np((16, 8), 19))
    b = torch.from_numpy(_np((8, 12), 20)).requires_grad_()
    calls = []
    real = torch_k._matmul
    monkeypatch.setattr(torch_k, "_matmul", lambda x, y: calls.append(1) or real(x, y))
    (db,) = torch.autograd.grad(torch_k.tiled_matmul(a, b).sum(), (b,))
    assert len(calls) == 2  # the forward and dB = A^T @ dY only
    np.testing.assert_allclose(db.numpy(), (a.T @ torch.ones(16, 12)).numpy(), **F32_TOL)


def test_the_vjp_operands_are_read_in_place():
    """b.T and a.T of a row-major matrix go to the kernel as transposed
    operands, with no copy; other strides are made contiguous."""
    w = torch.zeros(32, 48)
    t, flag, ld = torch_k._operand(w.T)
    assert flag == 1 and ld == 48 and t.data_ptr() == w.data_ptr()
    t, flag, ld = torch_k._operand(w)
    assert flag == 0 and ld == 48 and t.data_ptr() == w.data_ptr()
    t, flag, ld = torch_k._operand(w[:, ::2])
    assert flag == 0 and ld == 24 and t.is_contiguous()


def _bf16(rows, cols, seed=28):
    return torch.from_numpy(_np((rows, cols), seed)).to(torch.bfloat16)


@pytest.mark.parametrize("make,flag,ld,in_place", [
    (lambda: _bf16(32, 48), 0, 48, True),
    (lambda: _bf16(48, 32).T, 1, 32, True),
    (lambda: _bf16(32, 64)[:, :40], 0, 64, True),
    (lambda: _bf16(32, 64)[:, 8:], 0, 64, True),
    (lambda: _bf16(32, 64)[8:].T, 1, 64, True),
    (lambda: _bf16(13, 7), 0, 8, False),
    (lambda: _bf16(1, 12), 0, 16, False),
    (lambda: _bf16(30, 9).T, 0, 32, False),
    (lambda: _bf16(32, 56)[:, 1:], 0, 56, False),
    (lambda: _bf16(32, 49)[:, 1:], 0, 48, False),
    (lambda: _bf16(32, 48)[:, ::2], 0, 24, False),
], ids=["row_major", "transposed", "row_major_ld64", "offset_16_bytes",
        "transposed_offset", "odd_ld", "one_row_ld12", "transposed_odd_ld",
        "offset_2_bytes", "offset_and_odd_ld", "strided"])
def test_bf16_operands_follow_the_tma_layout_rule(make, flag, ld, in_place):
    """The bf16 kernel reads its operands through TMA: row-major and
    transposed operands whose leading dimension is a multiple of 8, on a
    16-byte base, are read in place with the right flag and leading
    dimension; an odd leading dimension, a storage offset off 16 bytes or
    other strides get a row-major copy, on a 16-byte base, with the
    leading dimension rounded up to a multiple of 8 and equal values."""
    t = make()
    got, f, l = torch_k._operand(t)
    assert (f, l) == (flag, ld)
    assert (got.data_ptr() == t.data_ptr()) == in_place
    assert l * 2 % torch_k.TMA_ALIGN == 0 and got.data_ptr() % torch_k.TMA_ALIGN == 0
    r, c = t.shape
    if f:
        assert got.stride() == (1, l) and torch.equal(got, t)
    else:
        assert got.stride(1) == 1 and (r == 1 or got.stride(0) == l)
        assert torch.equal(got[:, :c], t)


def _f32(rows, cols, seed=29):
    return torch.from_numpy(_np((rows, cols), seed))


@pytest.mark.parametrize("make,flag,ld,in_place", [
    (lambda: _f32(32, 48), 0, 48, True),
    (lambda: _f32(48, 32).T, 1, 32, True),
    (lambda: _f32(8, 12), 0, 12, True),
    (lambda: _f32(32, 64)[:, :40], 0, 64, True),
    (lambda: _f32(32, 64)[:, 4:], 0, 64, True),
    (lambda: _f32(32, 64)[4:].T, 1, 64, True),
    (lambda: _f32(13, 7), 0, 8, False),
    (lambda: _f32(16, 6), 0, 8, False),
    (lambda: _f32(1, 6), 0, 8, False),
    (lambda: _f32(30, 9).T, 0, 32, False),
    (lambda: _f32(32, 52)[:, 1:], 0, 52, False),
    (lambda: _f32(32, 49)[:, 1:], 0, 48, False),
    (lambda: _f32(32, 48)[:, ::2], 0, 24, False),
], ids=["row_major", "transposed", "ld12", "row_major_ld64", "offset_16_bytes",
        "transposed_offset", "odd_ld", "ld6", "one_row_ld6", "transposed_odd_ld",
        "offset_4_bytes", "offset_and_odd_ld", "strided"])
def test_f32_operands_follow_the_tma_layout_rule(make, flag, ld, in_place):
    """The f32 kernel reads its operands through TMA too: row-major and
    transposed operands whose leading dimension is a multiple of 4 (16
    bytes), on a 16-byte base, are read in place with the right flag and
    leading dimension; a leading dimension off that rule, a storage offset
    off 16 bytes or other strides get a row-major copy, on a 16-byte base,
    with the leading dimension rounded up to a multiple of 4 and equal
    values."""
    t = make()
    got, f, l = torch_k._operand(t)
    assert (f, l) == (flag, ld)
    assert (got.data_ptr() == t.data_ptr()) == in_place
    assert l % 4 == 0 and got.data_ptr() % torch_k.TMA_ALIGN == 0
    r, c = t.shape
    if f:
        assert got.stride() == (1, l) and torch.equal(got, t)
    else:
        assert got.stride(1) == 1 and (r == 1 or got.stride(0) == l)
        assert torch.equal(got[:, :c], t)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to 10
    mantissa bits, to nearest with ties away from zero (half of the
    dropped 13 bits' range added to the magnitude, then cut)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The f32 CUDA kernel's arithmetic in torch: each operand split into
    hi = tf32(v) and lo = tf32(v - hi), and a_lo·b_hi + a_hi·b_lo + a_hi·b_hi
    summed in f32 (each product of two TF32 values is exact in f32)."""
    a_hi, b_hi = _tf32_rna(a), _tf32_rna(b)
    a_lo, b_lo = _tf32_rna(a - a_hi), _tf32_rna(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def test_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10  # the TF32 neighbour above 1
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -11 - 2.0 ** -23,
                      -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11, 3.0, 0.0])
    want = torch.tensor([one, 1.0, -one, 1.0 + 2 * 2.0 ** -10, 3.0, 0.0])
    assert torch.equal(_tf32_rna(x), want)


# chip_smoke.py's f32 cases with M and N cut (K kept, since the error grows
# with K): the bench product [4096, 2048] @ [2048, 2048] (b scaled 0.02),
# the ragged 1000x999x1001 case, the long sum [512, 16384] @ [16384, 512],
# and ones.
@pytest.mark.parametrize("m,k,n,b_scale", [
    (256, 2048, 128, 0.02), (100, 999, 101, 1.0), (64, 16384, 64, 1.0), (13, 7, 9, 0.0)],
    ids=["bench_f32", "ragged", "long_k", "ones"])
def test_3xtf32_split_keeps_f32_accuracy(m, k, n, b_scale):
    """The split's numerics, emulated on the CPU, within the 1e-5 of
    max|plain| that chip_smoke.py holds the kernel to; TF32 alone (one
    product of the rounded operands) misses it at every random case."""
    if b_scale:
        a = torch.from_numpy(_np((m, k), 30))
        b = torch.from_numpy(_np((k, n), 31, scale=b_scale))
    else:
        a, b = torch.ones(m, k), torch.ones(k, n)
    plain = torch_k.tiled_matmul_plain(a, b)
    scale = float(plain.abs().max())
    err = float((_matmul_3xtf32(a, b) - plain).abs().max()) / scale
    assert err <= 1e-5, err
    tf32_err = float((_tf32_rna(a) @ _tf32_rna(b) - plain).abs().max()) / scale
    assert (tf32_err > 1e-5) == bool(b_scale), tf32_err


# -- the slice as a whole ----------------------------------------------------

def _torch_chain(x, ln2, w1, w2):
    h = torch_k.tiled_matmul(torch_k.rmsnorm(x, ln2), w1)
    return x + torch_k.tiled_matmul(F.gelu(h, approximate="tanh"), w2)


def _jax_chain(x, ln2, w1, w2):
    h = jax_k.tiled_matmul(jax_k.rmsnorm(x, ln2, interpret=True), w1, interpret=True)
    return x + jax_k.tiled_matmul(jax.nn.gelu(h), w2, interpret=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_half_through_the_standalone_ops_matches_jax(dtype):
    """The FFN half of a Block built from rmsnorm and tiled_matmul alone,
    at d_model 128, d_ff 512, 2x16 tokens: y and the grads to x, ln2, w1
    and w2 against the same chain of the JAX package's kernels. f32 at the
    reference's grad bound; bf16 at the repo's bf16 tolerance."""
    d, ff, t = 128, 512, 32
    arrays = [_np((t, d), 21), _np((d,), 22, scale=0.1, shift=1.0),
              _np((d, ff), 23, scale=0.05), _np((ff, d), 24, scale=0.05)]
    dy = _np((t, d), 25)
    pairs = [_pair(a, dtype) for a in arrays]
    tdy, jdy = _pair(dy, dtype)
    y_j, vjp = jax.vjp(_jax_chain, *[j for _, j in pairs])
    want = [y_j, *vjp(jdy)]
    inputs = [p.requires_grad_() for p, _ in pairs]
    y_t = _torch_chain(*inputs)
    got = [y_t.detach(), *torch.autograd.grad(y_t, inputs, tdy)]
    for name, g, w in zip(["y", "dx", "dln2", "dw1", "dw2"], got, want):
        assert g.dtype == dtype and tuple(g.shape) == w.shape, name
        g, w = g.float().numpy(), np.asarray(w, np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, **GRAD_TOL, err_msg=name)
        else:
            assert np.abs(g - w).max() <= CHAIN_BF16_REL_TOL * np.abs(w).max(), name


# -- what the wrappers take --------------------------------------------------

@pytest.mark.parametrize("call", [
    lambda: torch_k.rmsnorm(torch.ones(2, 4), torch.ones(4), block_rows=0),
    lambda: torch_k.rmsnorm(torch.ones(2, 4), torch.ones(4), block_rows=2.5),
    lambda: torch_k.rmsnorm(torch.ones(2, 4), torch.ones(3)),
    lambda: torch_k.tiled_matmul(torch.ones(2, 4), torch.ones(4, 3), bm=0),
    lambda: torch_k.tiled_matmul(torch.ones(2, 4), torch.ones(4, 3), bn=-128),
    lambda: torch_k.tiled_matmul(torch.ones(2, 4), torch.ones(5, 3)),
    lambda: torch_k.rmsnorm(torch.ones(2, 4), torch.ones(4, device="meta")),
    lambda: torch_k.tiled_matmul(torch.ones(2, 4), torch.ones(4, 3, device="meta")),
], ids=["block_rows_0", "block_rows_float", "gain_shape", "bm_0", "bn_negative",
        "inner_dims", "rmsnorm_mixed_devices", "matmul_mixed_devices"])
def test_what_the_wrappers_refuse(call):
    with pytest.raises(ValueError):
        call()


def test_cuda_launchers_refuse_what_their_kernels_do_not_take():
    """Checked before any build or launch: dtypes other than f32 and bf16,
    and sizes beyond int32 offsets."""
    half = torch.empty(8, 8, dtype=torch.float16, device="meta")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        torch_k._launch_matmul(half, half)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        torch_k._launch_rmsnorm(half, torch.empty(8, device="meta"), 1e-6)
    big = torch.empty(2 ** 16, 2 ** 15 + 1, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="int32"):
        torch_k._launch_matmul(big, torch.empty(2 ** 15 + 1, 8, dtype=torch.bfloat16,
                                                device="meta"))
    with pytest.raises(ValueError, match="int32"):
        torch_k._launch_rmsnorm(big, torch.empty(2 ** 15 + 1, device="meta"), 1e-6)


def test_cpu_path_launches_no_kernel():
    x = torch.from_numpy(_np((4, 64), 26)).requires_grad_()
    w = torch.from_numpy(_np((64, 32), 27)).requires_grad_()
    LAUNCHES.clear()
    torch_k.tiled_matmul(torch_k.rmsnorm(x, torch.ones(64)), w).sum().backward()
    assert sum(LAUNCHES.values()) == 0


def test_sources_are_built_beside_the_others():
    stems = [p.stem for p in _build.sources()]
    assert torch_k.KERNEL_RMSNORM in stems and torch_k.KERNEL_MATMUL in stems
