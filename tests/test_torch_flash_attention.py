"""Port parity: causal flash attention, forward and backward.

The same numpy-seeded bf16 q, k, v and upstream gradient go through the
library Pallas kernel the reference flagship calls
(``jax.experimental.pallas.ops.tpu.flash_attention``, run in TPU interpret
mode on the CPU, with its custom VJP) and through the port's
``flash_attention`` and its autograd, whose CPU path is the plain PyTorch
versions of the three CUDA kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import (
    flash_attention as jax_flash_attention,
)

from k8s_dra_driver_tpu_torch.ops import LAUNCHES, _build
from k8s_dra_driver_tpu_torch.ops import flash_attention as fa

# Port vs library, per tensor as max|err| / max|library|: both round p (and
# ds) to bf16 before the second product and write bf16 outputs, so they
# differ by a bf16 rounding here and there (2**-9 relative): bf16 level.
REL_TOL = 2e-2
# Port vs the materializing f32 reference: o is rounded to bf16 and p to
# bf16 before p·v, against an f32 softmax.
REF_REL_TOL = 2e-2
# The f32 path of the plain versions against autograd of the f32 reference:
# the same function, summed in another order.
F32_TOL = dict(rtol=1e-4, atol=1e-5)

# (1, 1, 256, 384): a head_dim that the CUDA forward's and dq's cluster
# split cuts raggedly (256 + 128) and the dkv kernel over a cluster of 3;
# (1, 1, 256, 1024): the bench head_dim, split over a cluster by all three
# kernels (4 blocks forward and dq, 8 dkv). The library kernel takes
# head_dims above 128 only in multiples of 128.
SHAPES = [(1, 2, 256, 128), (1, 2, 384, 64), (1, 1, 256, 384), (1, 1, 256, 1024)]


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: "x".join(map(str, s)))
def case(request):
    """(inputs, sm_scale, library (o, dq, dk, dv), port (o, dq, dk, dv))."""
    shape = request.param
    arrays = _inputs(shape)
    sm_scale = float(1.0 / np.sqrt(shape[-1]))
    jq, jk, jv, jdo = (jnp.asarray(a, jnp.bfloat16) for a in arrays)
    with pltpu.force_tpu_interpret_mode():
        o, vjp = jax.vjp(lambda q, k, v: jax_flash_attention(
            q, k, v, causal=True, sm_scale=sm_scale), jq, jk, jv)
        want = [np.asarray(t.astype(jnp.float32)) for t in (o, *vjp(jdo))]
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    LAUNCHES.clear()
    out = fa.flash_attention(q, k, v, causal=True, sm_scale=sm_scale)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert sum(LAUNCHES.values()) == 0  # the CPU runs the plain versions
    got = [t.float().numpy() for t in (out.detach(), *grads)]
    assert all(t.dtype == torch.bfloat16 for t in (out, *grads))
    return arrays, sm_scale, want, got


@pytest.mark.parametrize("i,name", enumerate(["o", "dq", "dk", "dv"]))
def test_matches_library_kernel(case, i, name):
    _, _, want, got = case
    assert got[i].shape == want[i].shape
    assert _rel(got[i], want[i]) < REL_TOL, name


@pytest.mark.parametrize("i,name", enumerate(["o", "dq", "dk", "dv"]))
def test_matches_reference_attention(case, i, name):
    arrays, sm_scale, _, got = case
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).float().requires_grad_()
               for a in arrays[:3])
    do = torch.from_numpy(arrays[3]).to(torch.bfloat16).float()
    ref = fa.reference_attention(q, k, v, sm_scale=sm_scale)
    want = [ref.detach(), *torch.autograd.grad(ref, (q, k, v), do)]
    assert _rel(got[i], want[i].numpy()) < REF_REL_TOL, name


@pytest.mark.parametrize("shape", [(1, 1, 256, 272)], ids=lambda s: "x".join(map(str, s)))
def test_ragged_head_dim_matches_reference_attention(shape):
    """head_dim 272, which the library kernel refuses and the CUDA kernels
    cut raggedly (256 + 16 forward, 128 + 128 + 16 dkv): the plain versions
    that the kernels are held to on the card match the f32 reference."""
    arrays = _inputs(shape, seed=5)
    sm_scale = float(1.0 / np.sqrt(shape[-1]))
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in arrays[:3])
    do = torch.from_numpy(arrays[3]).to(torch.bfloat16)
    out = fa.flash_attention(q, k, v, sm_scale=sm_scale)
    got = [out.detach(), *torch.autograd.grad(out, (q, k, v), do)]
    qr, kr, vr = (t.detach().float().requires_grad_() for t in (q, k, v))
    ref = fa.reference_attention(qr, kr, vr, sm_scale=sm_scale)
    want = [ref.detach(), *torch.autograd.grad(ref, (qr, kr, vr), do.float())]
    for name, g, w in zip(["o", "dq", "dk", "dv"], got, want):
        assert g.dtype == torch.bfloat16
        assert _rel(g.float().numpy(), w.numpy()) < REF_REL_TOL, name


def test_f32_plain_versions_match_reference_autograd():
    """With f32 inputs nothing is rounded to bf16, so the block-wise plain
    versions compute the materializing reference's values and grads."""
    arrays = _inputs((2, 2, 256, 32), seed=1)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    do = torch.from_numpy(arrays[3])
    got = fa.flash_attention(q, k, v, sm_scale=0.3)
    ref = fa.reference_attention(q, k, v, sm_scale=0.3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), **F32_TOL)
    for g, r in zip(torch.autograd.grad(got, (q, k, v), do),
                    torch.autograd.grad(ref, (q, k, v), do)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **F32_TOL)


def test_row_statistics_are_the_softmax_max_and_sum():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs((1, 2, 256, 16), seed=2))
    o, l, m = fa.flash_fwd_plain(q, k, v, 0.5)
    s = (q @ k.transpose(-1, -2)) * 0.5
    s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool).tril(), -float("inf"))
    np.testing.assert_allclose(m.numpy(), s.max(-1).values.numpy(), rtol=1e-6)
    np.testing.assert_allclose(
        l.numpy(), torch.exp(s - s.max(-1, keepdim=True).values).sum(-1).numpy(),
        rtol=1e-5)


def test_autograd_backward_is_the_plain_kernels():
    """The CPU backward is the dkv and dq plain versions on the saved row
    statistics and di = sum(o * do), as the library's VJP runs them."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs((1, 1, 256, 32), seed=3))
    grads = torch.autograd.grad(
        fa.flash_attention(*(t.requires_grad_() for t in (q, k, v)), sm_scale=0.2),
        (q, k, v), do)
    q, k, v = (t.detach() for t in (q, k, v))
    o, l, m = fa.flash_fwd_plain(q, k, v, 0.2)
    di = (o * do).sum(-1)
    want = (fa.flash_dq_plain(q, k, v, do, l, m, di, 0.2),
            *fa.flash_dkv_plain(q, k, v, do, l, m, di, 0.2))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_only_the_grads_asked_for_are_computed():
    arrays = _inputs((1, 1, 128, 16), seed=4)
    q, k, v = (torch.from_numpy(a) for a in arrays[:3])
    k.requires_grad_()
    (dk,) = torch.autograd.grad(fa.flash_attention(q, k, v, sm_scale=0.25), k,
                                torch.from_numpy(arrays[3]))
    assert dk.shape == k.shape


@pytest.mark.parametrize("shape,causal,err", [
    ((1, 2, 200, 64), True, "% 128"),
    ((2, 64, 128), True, "one shape"),
    ((1, 2, 128, 64), False, "only causal"),
])
def test_what_flash_attention_refuses(shape, causal, err):
    t = torch.zeros(shape)
    with pytest.raises((ValueError, NotImplementedError), match=err):
        fa.flash_attention(t, t, t, causal=causal)


def test_cuda_kernels_refuse_what_they_do_not_take():
    """The kernel wrappers check before they build or launch: f32, head_dim
    beyond the accumulator or off the 16-column grid raise."""
    with pytest.raises(TypeError, match="bf16"):
        fa._kernel_inputs(torch.empty(1, 1, 128, 64, device="meta"))
    for d in (2048, 72):
        with pytest.raises(ValueError, match="multiple of 16 and <= 1024"):
            fa._kernel_inputs(torch.empty(1, 1, 128, d, dtype=torch.bfloat16,
                                          device="meta"))


def test_other_devices_raise():
    t = torch.zeros(1, 1, 128, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(t, t, t)


def test_flash_sources_are_built_beside_the_others():
    stems = [p.stem for p in _build.sources()]
    for kernel in (fa.KERNEL_FWD, fa.KERNEL_DQ, fa.KERNEL_DKV):
        assert kernel in stems
