"""Port parity: the fused unembed + cross-entropy, forward and backward.

The same numpy inputs, made from a seed, go through the JAX package's
``fused_ce_losses`` (Pallas in interpret mode; its gradients through
``jax.vjp`` of the custom VJP) and ``reference_ce_losses`` and through the
port on the CPU, where ``FusedCE`` runs the plain PyTorch versions. The
CUDA kernels themselves are held to those plain versions on the card by
``chip_smoke.py``.
"""

import os

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


def test_cuda_backward_refuses_what_its_kernels_do_not_take():
    """The backward wrappers check before they build or launch: f32
    operands and d_model beyond the kernels' accumulator raise."""
    def args(d, dtype):
        x = torch.empty(256, d, dtype=dtype, device="meta")
        w = torch.empty(d, 512, dtype=dtype, device="meta")
        lab = torch.empty(256, dtype=torch.int32, device="meta")
        vec = torch.empty(256, device="meta")
        return x, w, lab, vec, vec

    for kernel in (torch_ce.KERNEL_DX, torch_ce.KERNEL_DW):
        with pytest.raises(TypeError, match="bf16"):
            torch_ce._launch_bwd(kernel, *args(64, torch.float32))
        with pytest.raises(ValueError, match="d_model <= 2048"):
            torch_ce._launch_bwd(kernel, *args(4096, torch.bfloat16))


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
    for kernel in (torch_ce.KERNEL, torch_ce.KERNEL_DX, torch_ce.KERNEL_DW):
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
