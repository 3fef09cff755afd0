"""Port parity: the fused unembed + cross-entropy, forward and backward.

The same numpy inputs, made from a seed, go through the JAX package's
``fused_ce_losses`` (Pallas in interpret mode; its gradients through
``jax.vjp`` of the custom VJP) and ``reference_ce_losses`` and through the
port on the CPU, where ``FusedCE`` runs the plain PyTorch versions. The
CUDA kernels themselves are held to those plain versions on the card by
``chip_smoke.py``.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_tpu.ops import fused_ce as jax_ce
from k8s_dra_driver_tpu_torch.ops import LAUNCHES, _build
from k8s_dra_driver_tpu_torch.ops import fused_ce as torch_ce

# f32 on both sides: the same products summed in another order. The same
# bound the reference's own test_jax_ops.py holds its kernel to.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16 operands: both sides form exact bf16 products and sum them in f32,
# so only the summation order differs; losses are ~log(V) ~ 7.
BF16_TOL = dict(rtol=1e-5, atol=2e-5)
# Grads in f32: the bound test_jax_ops.py holds the JAX custom VJP to.
GRAD_F32_TOL = dict(rtol=1e-5, atol=1e-6)
# Grads in bf16: both sides sum in f32 and round once to bf16; a sum that
# lands near a rounding boundary may round to the neighbouring bf16 value,
# one ulp, at most 2**-7 of the value.
GRAD_BF16_TOL = dict(rtol=2 ** -7, atol=1e-7)


def _inputs(seed, T, D, V):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, V)) * 0.05).astype(np.float32)
    labels = rng.integers(0, V, T).astype(np.int32)
    return x, w, labels


# The shapes of test_jax_ops.py's fused-CE tests: a vocab that divides the
# 512 block, and V=1000 that does not.
@pytest.mark.parametrize("T,D,V", [(512, 128, 1024), (256, 128, 1000)])
def test_plain_matches_jax_kernel_and_reference_f32(T, D, V):
    x, w, labels = _inputs(7, T, D, V)
    want_kernel = np.asarray(jax_ce.fused_ce_losses(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels), 256, 512, True))
    want_ref = np.asarray(jax_ce.reference_ce_losses(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(labels)))
    tx, tw, tl = map(torch.from_numpy, (x, w, labels))
    got = torch_ce.fused_ce_losses(tx, tw, tl, 256, 512).numpy()
    np.testing.assert_allclose(got, want_kernel, **F32_TOL)
    np.testing.assert_allclose(got, want_ref, **F32_TOL)
    np.testing.assert_allclose(
        torch_ce.reference_ce_losses(tx, tw, tl).numpy(), want_ref, **F32_TOL)


@pytest.mark.parametrize("T,D,V", [(256, 128, 1024), (256, 64, 1000)])
def test_plain_matches_jax_kernel_bf16(T, D, V):
    x, w, labels = _inputs(11, T, D, V)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(jax_ce.fused_ce_losses(jx, jw, jnp.asarray(labels),
                                             256, 512, True))
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    # Both sides round f32 -> bf16 to nearest even: identical operands.
    np.testing.assert_array_equal(tx.float().numpy(),
                                  np.asarray(jx.astype(jnp.float32)))
    got = torch_ce.fused_ce_losses(tx, tw, torch.from_numpy(labels)).numpy()
    np.testing.assert_allclose(got, want, **BF16_TOL)


def test_label_minus_one_matches_no_class():
    x, w, labels = _inputs(3, 256, 64, 1000)
    labels[::3] = -1
    tx, tw, tl = map(torch.from_numpy, (x, w, labels))
    got = torch_ce.fused_ce_losses(tx, tw, tl)
    lse = torch.logsumexp(tx @ tw, dim=1)
    pad = tl == -1
    np.testing.assert_allclose(got[pad].numpy(), lse[pad].numpy(), **F32_TOL)
    np.testing.assert_allclose(
        got[~pad].numpy(),
        torch_ce.reference_ce_losses(tx[~pad], tw, tl[~pad]).numpy(), **F32_TOL)


def test_shape_contract_raises_value_error():
    x, w, labels = map(torch.from_numpy, _inputs(0, 512, 32, 64))
    with pytest.raises(ValueError, match="block_t"):
        torch_ce.fused_ce_losses(x[:500], w, labels[:500])
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_ce.fused_ce_losses(x, w[:16], labels)
    with pytest.raises(ValueError, match="shape mismatch"):
        torch_ce.fused_ce_losses(x, w, labels[:256])


# The forward kernel's two steps in plain PyTorch, partials of 256-column
# tiles and their fold, against the JAX kernel's (lse, picked): a vocab that
# divides the tile, V = 1000 and 700 (a ragged last tile), every fifth row
# labelled -1.
@pytest.mark.parametrize("V", [1024, 1000, 700])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fwd_partials_and_fold_match_jax_kernel(dtype, V):
    T, D = 256, 128
    x, w, labels = _inputs(31, T, D, V)
    labels[::5] = -1
    jx, jw = jnp.asarray(x), jnp.asarray(w)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    if dtype == torch.bfloat16:
        jx, jw = jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16)
        tx, tw = tx.to(dtype), tw.to(dtype)
    want_lse, want_picked = (np.asarray(a) for a in jax_ce._fwd_parts(
        jx, jw, jnp.asarray(labels), 256, 512, True))
    want = np.asarray(jax_ce.fused_ce_losses(jx, jw, jnp.asarray(labels), 256, 512, True))
    m, l, picked = torch_ce.fused_ce_fwd_partials_plain(tx, tw, torch.from_numpy(labels))
    n_tiles = -(-V // torch_ce.FWD_TILE)
    assert m.shape == l.shape == (n_tiles, T) and picked.shape == (T,)
    assert bool((l >= 1.0).all())  # each tile's max term is exp(0)
    lse = torch_ce.fused_ce_lse_fold_plain(m, l)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(lse.numpy(), want_lse, **tol)
    np.testing.assert_allclose(picked.numpy(), want_picked, **tol)
    np.testing.assert_array_equal(picked.numpy()[labels < 0], 0.0)
    np.testing.assert_allclose((lse - picked).numpy(), want, **tol)


def _cotangent(seed, labels):
    """A non-uniform upstream gradient, 0 on rows labelled -1 (padding)."""
    g = np.random.default_rng(seed).uniform(0.1, 2.0, labels.shape[0])
    g = (g / labels.shape[0]).astype(np.float32)
    g[labels < 0] = 0.0
    return g


def _jax_grads(x, w, labels, g):
    _, vjp = jax.vjp(lambda x, w: jax_ce.fused_ce_losses(
        x, w, jnp.asarray(labels), 256, 512, True), x, w)
    return [np.asarray(a.astype(jnp.float32)) for a in vjp(jnp.asarray(g))]


def _port_grads(x, w, labels, g):
    x = x.detach().requires_grad_()
    w = w.detach().requires_grad_()
    losses = torch_ce.fused_ce_losses(x, w, torch.from_numpy(labels))
    return [a.float().numpy() for a in torch.autograd.grad(
        losses, (x, w), torch.from_numpy(g))]


# The shapes of test_jax_ops.py's fused-CE grad tests, with a non-uniform
# cotangent, and once with padded rows labelled -1 (g = 0 there).
@pytest.mark.parametrize("T,D,V,pad_every", [
    (512, 128, 1024, 0), (256, 128, 1000, 0), (256, 128, 1000, 4)])
def test_grads_match_jax_custom_vjp_f32(T, D, V, pad_every):
    x, w, labels = _inputs(13, T, D, V)
    if pad_every:
        labels[::pad_every] = -1
    g = _cotangent(5, labels)
    want_dx, want_dw = _jax_grads(jnp.asarray(x), jnp.asarray(w), labels, g)
    got_dx, got_dw = _port_grads(torch.from_numpy(x), torch.from_numpy(w), labels, g)
    assert got_dw.shape == (D, V)
    np.testing.assert_allclose(got_dx, want_dx, **GRAD_F32_TOL)
    np.testing.assert_allclose(got_dw, want_dw, **GRAD_F32_TOL)


@pytest.mark.parametrize("T,D,V", [(256, 128, 1024), (256, 64, 1000)])
def test_grads_match_jax_custom_vjp_bf16(T, D, V):
    x, w, labels = _inputs(17, T, D, V)
    labels[-3:] = -1
    g = _cotangent(6, labels)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    jw = jnp.asarray(w).astype(jnp.bfloat16)
    want_dx, want_dw = _jax_grads(jx, jw, labels, g)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    got_dx, got_dw = _port_grads(tx, tw, labels, g)
    assert got_dw.shape == (D, V)
    np.testing.assert_allclose(got_dx, want_dx, **GRAD_BF16_TOL)
    np.testing.assert_allclose(got_dw, want_dw, **GRAD_BF16_TOL)


def test_grads_match_materializing_reference():
    """Where every label is a class, the fused grads are those of the
    materializing reference (as test_jax_ops.py checks the JAX pair)."""
    x, w, labels = map(torch.from_numpy, _inputs(19, 256, 64, 1000))
    g = torch.from_numpy(_cotangent(7, labels.numpy()))
    got = torch.autograd.grad(
        torch_ce.fused_ce_losses(x.requires_grad_(), w.requires_grad_(), labels),
        (x, w), g)
    want = torch.autograd.grad(torch_ce.reference_ce_losses(x, w, labels), (x, w), g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD_F32_TOL)


def test_bwd_plain_is_what_autograd_runs():
    x, w, labels = map(torch.from_numpy, _inputs(23, 256, 64, 700))
    labels[::5] = -1
    g = torch.from_numpy(_cotangent(8, labels.numpy()))
    lse = torch.logsumexp(x @ w, dim=1)
    dx, dw = torch_ce.fused_ce_bwd_plain(x, w, labels, lse, g, 256, 512)
    got = torch.autograd.grad(
        torch_ce.fused_ce_losses(x.requires_grad_(), w.requires_grad_(), labels),
        (x, w), g)
    assert dx.shape == x.shape and dw.shape == w.shape
    np.testing.assert_allclose(got[0].numpy(), dx.numpy(), **GRAD_F32_TOL)
    np.testing.assert_allclose(got[1].numpy(), dw.numpy(), **GRAD_F32_TOL)
    # Only the grads asked for are computed.
    only_w = torch.autograd.grad(
        torch_ce.fused_ce_losses(x.detach(), w, labels), w, g)[0]
    np.testing.assert_array_equal(only_w.numpy(), got[1].numpy())


def _fake_kernels(monkeypatch):
    """Replace ``_build.launch`` by each kernel's plain version, run on the
    very buffers the wrappers hand the kernel (the forward's partials and
    their fold into part, lse and picked; p rounded to bf16 by its bf16
    scratch, as the kernels round it), and record every launch as (name,
    args)."""
    calls = []

    def launch(name, device, *args):
        calls.append((name, args))
        if name == torch_ce.KERNEL:
            x, w, lab, part, arrived, lse, picked, *_ = args
            assert not bool(arrived.any())  # the counters come zeroed
            m, l, pk = torch_ce.fused_ce_fwd_partials_plain(x, w, lab)
            part[0].copy_(m)
            part[1].copy_(l)
            lse.copy_(torch_ce.fused_ce_lse_fold_plain(part[0], part[1]))
            picked.copy_(pk)
        elif name == torch_ce.KERNEL_P:
            x, w, lab, lse, g, p, _, _, _, _, _, _, v0, width = args
            p.copy_(torch_ce.fused_ce_p_plain(x, w, lab, lse, g, v0, width))
        elif name == torch_ce.KERNEL_DX:
            p, w, acc, dx, _, _, _, _, v0, _, first, last = args
            s = torch_ce.fused_ce_dx_chunk_plain(p, w, v0)
            if not first:
                s += acc
            (dx if last else acc).copy_(s)
        else:
            assert name == torch_ce.KERNEL_DW
            x, p, dw, _, _, _, _, _, v0, width = args
            dw[:, v0:v0 + width] = torch_ce.fused_ce_dw_chunk_plain(x, p)

    monkeypatch.setattr(_build, "launch", launch)
    return calls


def _fake_streams(monkeypatch):
    """Give ``torch.cuda.current_stream`` one stream handle (7) for any
    device, and empty the forward's counter cache."""
    monkeypatch.setattr(torch_ce, "_ARRIVED", {})
    handle = SimpleNamespace(cuda_stream=7)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: handle)
    return handle


def test_fwd_counters_are_kept_per_stream_and_grow(monkeypatch):
    """The forward's arrival counters come zeroed from one buffer per
    (device, stream), reused while it is long enough and replaced by a
    longer zeroed one when it is not."""
    dev = torch.device("cpu")
    handle = _fake_streams(monkeypatch)
    first = torch_ce._arrivals(dev, 4)
    assert first.shape == (4,) and first.dtype == torch.int32 and not bool(first.any())
    assert torch_ce._arrivals(dev, 2).data_ptr() == first.data_ptr()
    handle.cuda_stream = 8
    other = torch_ce._arrivals(dev, 4)
    assert other.data_ptr() != first.data_ptr()
    handle.cuda_stream = 7
    grown = torch_ce._arrivals(dev, 6)
    assert grown.shape == (6,) and not bool(grown.any())
    assert torch_ce._arrivals(dev, 5).data_ptr() == grown.data_ptr()


# (T, D, V): aligned; D and V off the 8-element TMA pitch (aligned copies);
# a ragged last vocab tile and a ragged last row tile.
@pytest.mark.parametrize("T,D,V", [(256, 128, 1024), (256, 100, 1001), (320, 64, 700)])
def test_launch_fwd_hands_the_kernel_aligned_operands(monkeypatch, T, D, V):
    """``FusedCE``'s forward on CPU tensors taken for CUDA ones: one
    ``fused_ce_fwd`` a call, x and w with 16-byte row pitches and bases (an
    aligned copy where D or V is not a multiple of 8), the scratch and the
    zeroed counters sized by the kernel's tiles, and the losses of the
    plain version."""
    calls = _fake_kernels(monkeypatch)
    monkeypatch.setattr(torch_ce, "on_cpu", lambda op, *ts: False)
    _fake_streams(monkeypatch)
    x, w, labels = _inputs(37, T, D, V)
    labels[::4] = -1
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    tl = torch.from_numpy(labels)
    with torch.no_grad():
        got = torch_ce.fused_ce_losses(tx, tw, tl, block_t=64)
        torch_ce.fused_ce_losses(tx, tw, tl, block_t=64)
    assert [name for name, _ in calls] == [torch_ce.KERNEL] * 2
    xk, wk, lab, part, arrived, lse, picked, t_dim, d, vocab, ldx, ldw = calls[0][1]
    assert (t_dim, d, vocab) == (T, D, V)
    assert lab.dtype == torch.int32 and lab.shape == (T,)
    step = 16 // tx.element_size()
    for t, ld in ((xk, ldx), (wk, ldw)):
        assert t.stride(1) == 1 and t.stride(0) == ld
        assert ld % step == 0 and t.data_ptr() % 16 == 0
    assert ldx == -(-D // step) * step and ldw == -(-V // step) * step
    assert (xk.data_ptr() == tx.data_ptr()) == (D % step == 0)
    assert (wk.data_ptr() == tw.data_ptr()) == (V % step == 0)
    assert part.shape == (2, -(-V // torch_ce.FWD_TILE), T) and part.dtype == torch.float32
    assert arrived.shape == (-(-T // torch_ce.FWD_ROWS),) and arrived.dtype == torch.int32
    assert calls[1][1][4].data_ptr() == arrived.data_ptr()  # kept, not zeroed anew
    assert lse.shape == picked.shape == (T,)
    np.testing.assert_allclose(got.numpy(),
                               torch_ce.fused_ce_losses_plain(tx, tw, tl, 64).numpy(),
                               **BF16_TOL)


def _bwd_args(T, D, V, dtype=torch.bfloat16, seed=29):
    x, w, labels = _inputs(seed, T, D, V)
    labels[::4] = -1
    g = _cotangent(9, labels)
    tx = torch.from_numpy(x).to(dtype)
    tw = torch.from_numpy(w).to(dtype)
    tl = torch.from_numpy(labels)
    lse = torch.logsumexp(tx.float() @ tw.float(), dim=1)
    return tx, tw, tl, lse, torch.from_numpy(g)


def test_cuda_backward_refuses_what_its_kernels_do_not_take(monkeypatch):
    """The backward wrapper checks before it builds or launches: f32
    operands raise. d_model has no cap: at 4096 the kernels are launched."""
    def args(d, dtype):
        x = torch.empty(256, d, dtype=dtype, device="meta")
        w = torch.empty(d, 512, dtype=dtype, device="meta")
        lab = torch.empty(256, dtype=torch.int32, device="meta")
        vec = torch.empty(256, device="meta")
        return x, w, lab, vec, vec

    with pytest.raises(TypeError, match="bf16"):
        torch_ce._launch_bwd(*args(64, torch.float32))
    calls = _fake_kernels(monkeypatch)
    dx, dw = torch_ce._launch_bwd(*_bwd_args(256, 4096, 512))
    assert [name for name, _ in calls] == [
        torch_ce.KERNEL_P, torch_ce.KERNEL_DX, torch_ce.KERNEL_DW]
    assert dx.shape == (256, 4096) and dw.shape == (4096, 512)


# (T, V, budget): one chunk when everything fits, a budget that is not a
# multiple of a tile's bytes, the minimum width, the bench shape at the
# module's budget (32 MB: two chunks) and at 64 MB (one), three chunks
# with a ragged last, 32000 (eight, the last ragged), a 16 MB budget, a 128k vocab.
@pytest.mark.parametrize("T,V,budget,n", [
    (256, 1000, 2 ** 20, 1), (256, 1000, 3 * 2 ** 17, 2), (256, 1000, 1, 4),
    (512, 256, 2 ** 18, 1), (4096, 8192, None, 2), (4096, 8192, 64 * 2 ** 20, 1),
    (4096, 20000, 64 * 2 ** 20, 3), (4096, 32000, None, 8), (4096, 1000, None, 1),
    (4096, 8192, 16 * 2 ** 20, 4), (4096, 131072, None, 32)])
def test_bwd_chunks_cover_the_vocab_within_the_budget(monkeypatch, T, V, budget, n):
    if budget is None:
        budget = torch_ce.P_BUDGET
    monkeypatch.setattr(torch_ce, "P_BUDGET", budget)
    chunks = torch_ce._bwd_chunks(T, V)
    assert len(chunks) == n
    assert chunks[0][0] == 0
    for (v0, width), (nxt, _) in zip(chunks, chunks[1:]):
        assert nxt == v0 + width
        assert width % torch_ce.BWD_TILE == 0
    assert sum(width for _, width in chunks) == V
    widest = max(width for _, width in chunks)
    assert 2 * T * widest <= budget or widest == torch_ce.BWD_TILE
    if n > 1:  # the widest multiple of the tile that fits
        assert 2 * T * (widest + torch_ce.BWD_TILE) > budget


def _chunked_plain_grads(x, w, labels, lse, g, chunks, need_dx, need_dw):
    """The per-kernel plain versions composed over ``chunks`` as the CUDA
    backward launches them, with f32 p and f32 sums."""
    dx = torch.zeros(x.shape, dtype=torch.float32) if need_dx else None
    dw = torch.empty(w.shape, dtype=torch.float32) if need_dw else None
    for v0, width in chunks:
        p = torch_ce.fused_ce_p_plain(x, w, labels, lse, g, v0, width)
        if need_dx:
            dx += torch_ce.fused_ce_dx_chunk_plain(p, w, v0)
        if need_dw:
            dw[:, v0:v0 + width] = torch_ce.fused_ce_dw_chunk_plain(x, p)
    return (dx.to(x.dtype) if need_dx else None,
            dw.to(w.dtype) if need_dw else None)


@pytest.mark.parametrize("need", ["both", "dx", "dw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunked_plain_versions_match_jax_custom_vjp(monkeypatch, dtype, need):
    """Four chunks of 256, 256, 256 and 232 columns at V = 1000, rows
    labelled -1."""
    x, w, labels, lse, g = _bwd_args(256, 128, 1000, dtype)
    monkeypatch.setattr(torch_ce, "P_BUDGET", 2 * 256 * 256)
    chunks = torch_ce._bwd_chunks(256, 1000)
    assert [c[1] for c in chunks] == [256, 256, 256, 232]
    jx, jw = (jnp.asarray(t.float().numpy()) for t in (x, w))
    if dtype == torch.bfloat16:
        jx, jw = jx.astype(jnp.bfloat16), jw.astype(jnp.bfloat16)
    want = _jax_grads(jx, jw, labels.numpy(), g.numpy())
    got = _chunked_plain_grads(x, w, labels, lse, g, chunks, need != "dw", need != "dx")
    tol = GRAD_F32_TOL if dtype == torch.float32 else GRAD_BF16_TOL
    for name, a, b in zip(("dx", "dw"), got, want):
        if need in ("both", name):
            np.testing.assert_allclose(a.float().numpy(), b, **tol)
        else:
            assert a is None


# The card's tolerance for the backward kernels (chip_smoke.py's
# BWD_REL_TOL): max|err| / max|grad|.
BWD_REL_TOL = 1e-2


@pytest.mark.parametrize("T,D,V,budget", [(256, 128, 1000, 2 * 256 * 256),
                                          (512, 64, 1000, torch_ce.P_BUDGET)])
def test_bf16_p_emulation_matches_jax_custom_vjp(monkeypatch, T, D, V, budget):
    """The kernels' arithmetic, emulated by ``_launch_bwd`` with each
    kernel's plain version on its buffers: p rounded to bf16 before both
    products, f32 sums, bf16 dx and dw. Measured here against the custom
    VJP's f32 p: 5.7e-3 (dx) and 4.0e-3 (dw) of max|grad| at 4 chunks,
    5.7e-3 and 3.3e-3 at one chunk, each one bf16 step of an output near
    max|grad| (where ``fused_ce_bwd_plain``, f32 p, gives 1.4e-3 and
    3.1e-5, and 1.8e-4 and 3.2e-6); the card's bound is 1e-2."""
    _fake_kernels(monkeypatch)
    monkeypatch.setattr(torch_ce, "P_BUDGET", budget)
    x, w, labels, lse, g = _bwd_args(T, D, V)
    got = torch_ce._launch_bwd(x, w, labels, lse, g)
    want = _jax_grads(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                      jnp.asarray(w.float().numpy()).astype(jnp.bfloat16),
                      labels.numpy(), g.numpy())
    for a, b in zip(got, want):
        rel = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert rel <= BWD_REL_TOL, rel


# (T, D, V): aligned; D and V off the 8-element TMA pitch (aligned copies);
# a vocab whose last chunk is ragged.
@pytest.mark.parametrize("T,D,V", [(256, 128, 1024), (256, 100, 1001), (256, 64, 700)])
@pytest.mark.parametrize("need_dx,need_dw", [(True, True), (True, False), (False, True)])
def test_launch_bwd_follows_the_plan(monkeypatch, T, D, V, need_dx, need_dw):
    """``_launch_bwd`` on CPU tensors, each kernel recorded: the launches
    in the plan's order and number, each operand with a row pitch of a
    multiple of 16 bytes (an aligned copy where D or V is not), and the
    grads of the plain versions."""
    calls = _fake_kernels(monkeypatch)
    x, w, labels, lse, g = _bwd_args(T, D, V)
    monkeypatch.setattr(torch_ce, "P_BUDGET", 2 * T * 256)
    dx, dw = torch_ce._launch_bwd(x, w, labels, lse, g, need_dx, need_dw)
    chunks = torch_ce._bwd_chunks(T, V)
    kinds = [torch_ce.KERNEL_P] + [torch_ce.KERNEL_DX] * need_dx + [torch_ce.KERNEL_DW] * need_dw
    assert [name for name, _ in calls] == kinds * len(chunks)
    step = 16 // x.element_size()
    # The operands each kernel reads by TMA: x, w and p_c.
    read = {torch_ce.KERNEL_P: (0, 1, 5), torch_ce.KERNEL_DX: (0, 1),
            torch_ce.KERNEL_DW: (0, 1)}
    for name, args in calls:
        for i in read[name]:
            assert args[i].stride(0) % step == 0 and args[i].stride(1) == 1
            assert args[i].data_ptr() % 16 == 0
        if name == torch_ce.KERNEL_P:
            xk, wk, _, _, _, p, t_dim, d, vocab, ldx, ldw, ldp, v0, width = args
            assert (t_dim, d, vocab) == (T, D, V)
            assert (ldx, ldw, ldp) == (xk.stride(0), wk.stride(0), p.stride(0))
            assert ldx == -(-D // step) * step and ldw == -(-V // step) * step
            assert (v0, width) in chunks and p.shape == (T, width)
        elif name == torch_ce.KERNEL_DX:
            p, _, acc, _, t_dim, d, _, _, v0, width, first, last = args
            i = chunks.index((v0, width))
            assert (first, last) == (int(i == 0), int(i == len(chunks) - 1))
            assert acc.dtype == (torch.float32 if len(chunks) > 1 else torch.bfloat16)
    want = torch_ce.fused_ce_bwd_plain(x, w, labels, lse, g)
    for got, plain, need in zip((dx, dw), want, (need_dx, need_dw)):
        if not need:
            assert got is None
            continue
        assert got.dtype == torch.bfloat16 and got.shape == plain.shape
        rel = (got.float() - plain.float()).abs().max() / plain.float().abs().max()
        assert rel <= BWD_REL_TOL


def test_budget_sweep_needs_a_card(monkeypatch, capsys):
    """``ops/fused_ce_budget.py`` times CUDA kernels only: without a card it
    exits 2 and prints no result, and the module's budget stays as it was."""
    from k8s_dra_driver_tpu_torch.ops import fused_ce_budget

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert fused_ce_budget.main([]) == 2
    assert capsys.readouterr().out == ""
    assert torch_ce.P_BUDGET == 32 * 2 ** 20


def test_cpu_path_launches_no_kernel_and_other_devices_raise():
    x, w, labels = map(torch.from_numpy, _inputs(0, 256, 32, 64))
    LAUNCHES.clear()
    losses = torch_ce.fused_ce_losses(x.requires_grad_(), w, labels)
    losses.sum().backward()
    assert sum(LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="CUDA device"):
        torch_ce.fused_ce_losses(x.to("meta"), w.to("meta"), labels.to("meta"))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setenv("PATH", str(tmp_path))
    import torch.utils.cpp_extension as cpp_ext

    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_build_dir_is_keyed_inside_the_checkout():
    stems = [p.stem for p in _build.sources()]
    for kernel in (torch_ce.KERNEL, torch_ce.KERNEL_P, torch_ce.KERNEL_DX,
                   torch_ce.KERNEL_DW):
        assert kernel in stems
    d = _build.build_dir()
    assert d.parent == _build.BUILD_ROOT and d == _build.build_dir()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.relpath(_build.BUILD_ROOT, repo) == os.path.join(
        "build", "torch_kernels")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def _fake_nvcc(tmp_path, monkeypatch, script):
    exe = tmp_path / "bin" / "nvcc"
    exe.parent.mkdir()
    exe.write_text("#!/bin/sh\n" + script)
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", str(exe.parent))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")


def test_build_compiles_every_source_once(tmp_path, monkeypatch):
    # Writes the file named after -o, as nvcc would.
    _fake_nvcc(tmp_path, monkeypatch,
               'while [ "$1" != "-o" ]; do shift; done; echo built > "$2"\n')
    assert _build.build_all() >= 0.0
    for src in _build.sources():
        assert (_build.build_dir() / f"lib{src.stem}.so").read_text() == "built\n"
    assert _build.build_all() == 0.0  # cached by source hash


def test_build_failure_raises(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 'echo "error: no sm_90a here"; exit 1\n')
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build_all()
    assert not list(_build.build_dir().glob("*.so"))
