"""Port parity: the flagship SliceProof forward and its evaluate_nll path.

JAX ``init_params`` weights are carried into the port with
``params_from_jax``, so both sides compute the same function on the same
numpy tokens. The JAX side runs on the CPU, its fused-CE kernel in Pallas
interpret mode; the port runs on the CPU with the plain fused-CE version.
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import k8s_dra_driver_tpu_torch as port
from k8s_dra_driver_tpu.models import flagship as jflag
from k8s_dra_driver_tpu_torch.graft_entry import entry
from k8s_dra_driver_tpu_torch.models import flagship as tflag
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax
from k8s_dra_driver_tpu_torch.ops import LAUNCHES

ROOT = pathlib.Path(__file__).resolve().parents[1]

# Logits: both sides round at the same places to bf16, but their bf16
# matmuls and GELU round differently inside; measured ~6e-3 of max|logit|
# at tiny(), held to 2e-2 (the repo's bf16 tolerance).
LOGIT_REL_TOL = 2e-2
# evaluate_nll: a mean over ~100 tokens averages the rounding out.
NLL_RTOL = 1e-4
# Port evaluate_nll vs port loss_fn, as test_jax_ops.py holds the JAX pair.
EVAL_VS_LOSS_TOL = dict(rtol=2e-5, atol=2e-5)


def _configs():
    # tiny(): b*(s-1) = 126 tokens pad to 256. "odd_vocab": vocab 300 does
    # not divide the 512 block, so evaluate_nll uses one ragged vocab tile.
    return {
        "tiny": (jflag.SliceProofConfig.tiny(), tflag.SliceProofConfig.tiny()),
        "odd_vocab": (
            jflag.SliceProofConfig(vocab=300, d_model=64, n_heads=4,
                                   n_layers=2, d_ff=128, seq_len=32),
            tflag.SliceProofConfig(vocab=300, d_model=64, n_heads=4,
                                   n_layers=2, d_ff=128, seq_len=32)),
    }


@pytest.fixture(scope="module", params=["tiny", "odd_vocab"])
def pair(request):
    jcfg, tcfg = _configs()[request.param]
    jparams = jflag.init_params(jcfg, seed=0)
    model = tflag.SliceProof(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, tcfg.seq_len)).astype(np.int32)
    return jcfg, jparams, model, tokens


def test_config_and_param_count_match_reference():
    for jcfg, tcfg in _configs().values():
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert jflag.matmul_param_count(jcfg) == tflag.matmul_param_count(tcfg)
    assert (dataclasses.asdict(jflag.SliceProofConfig.bench())
            == dataclasses.asdict(tflag.SliceProofConfig.bench()))


def test_forward_logits_match_jax(pair):
    jcfg, jparams, model, tokens = pair
    want = np.asarray(jflag.forward(jcfg, jparams, jnp.asarray(tokens)))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < LOGIT_REL_TOL, err


def test_evaluate_nll_matches_jax(pair):
    jcfg, jparams, model, tokens = pair
    want = float(jflag.evaluate_nll(jcfg, jparams, jnp.asarray(tokens),
                                    interpret=True))
    with torch.no_grad():
        got = float(model.evaluate_nll(torch.from_numpy(tokens)))
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)


def test_evaluate_nll_matches_loss_fn(pair):
    _, _, model, tokens = pair
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        a = float(model.evaluate_nll(t))
        b = float(model.loss_fn(t))
    np.testing.assert_allclose(a, b, **EVAL_VS_LOSS_TOL)


def test_forward_shapes_and_dtype():
    cfg = tflag.SliceProofConfig.tiny()
    model = tflag.init_params(cfg, seed=0, device="cpu")
    with torch.no_grad():
        logits = model(torch.zeros((2, cfg.seq_len), dtype=torch.long))
    assert logits.shape == (2, cfg.seq_len, cfg.vocab)
    assert logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


def test_causality():
    """Changing a future token must not change past logits."""
    cfg = tflag.SliceProofConfig.tiny()
    model = tflag.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    t1 = torch.from_numpy(rng.integers(0, cfg.vocab, (1, cfg.seq_len)))
    t2 = t1.clone()
    t2[0, -1] = (t1[0, -1] + 1) % cfg.vocab
    with torch.no_grad():
        l1, l2 = model(t1), model(t2)
    np.testing.assert_allclose(l1[0, :-1], l2[0, :-1], rtol=2e-2, atol=2e-2)
    assert not np.allclose(l1[0, -1], l2[0, -1], rtol=1e-3, atol=1e-3)


def test_init_params_is_seeded():
    cfg = tflag.SliceProofConfig.tiny()
    a = tflag.init_params(cfg, seed=5, device="cpu").state_dict()
    b = tflag.init_params(cfg, seed=5, device="cpu").state_dict()
    c = tflag.init_params(cfg, seed=6, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["unembed"], c["unembed"])
    assert torch.equal(a["layers.0.ln1"], torch.ones(cfg.d_model))
    assert abs(float(a["unembed"].std()) - 0.02) < 2e-3


def test_entry_runs_forward_on_cpu():
    fn, (model, tokens) = entry(device="cpu")
    with torch.no_grad():
        logits = fn(model, tokens)
    cfg = tflag.SliceProofConfig.tiny()
    assert logits.shape == (2, cfg.seq_len, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


# attention="flash": the smallest config the reference's flash kernel takes
# (seq a multiple of its 128 block), one layer, batch 1: in TPU interpret
# mode its forward takes ~3 s on a CPU.
FLASH_SMALL = dict(vocab=256, d_model=128, n_heads=2, n_layers=1, d_ff=256,
                   seq_len=128, attention="flash")


@pytest.fixture(scope="module")
def flash_pair():
    jcfg = jflag.SliceProofConfig(**FLASH_SMALL)
    jparams = jflag.init_params(jcfg, seed=0)
    model = tflag.SliceProof(tflag.SliceProofConfig(**FLASH_SMALL), device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab, (1, jcfg.seq_len))
    return jcfg, jparams, model, tokens.astype(np.int32)


def test_flash_forward_logits_match_jax(flash_pair):
    jcfg, jparams, model, tokens = flash_pair
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jflag.forward(jcfg, jparams, jnp.asarray(tokens)))
    LAUNCHES.clear()
    with torch.no_grad():
        got = model(torch.from_numpy(tokens)).numpy()
    assert sum(LAUNCHES.values()) == 0  # the CPU runs the plain versions
    assert got.shape == want.shape and got.dtype == np.float32
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < LOGIT_REL_TOL, err


def test_flash_evaluate_nll_matches_jax(flash_pair):
    jcfg, jparams, model, tokens = flash_pair
    with pltpu.force_tpu_interpret_mode():
        want = float(jflag.evaluate_nll(jcfg, jparams, jnp.asarray(tokens),
                                        interpret=True))
    with torch.no_grad():
        got = float(model.evaluate_nll(torch.from_numpy(tokens)))
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL)


def test_flash_matches_einsum_attention(flash_pair):
    """The two attentions compute one function; the einsum path rounds the
    scores to bf16 and the flash path does not, so they agree at bf16
    level (the reference's check_flash_numerics tolerance)."""
    _, _, model, tokens = flash_pair
    einsum = tflag.SliceProof(dataclasses.replace(model.cfg, attention="einsum"),
                              device="cpu")
    einsum.load_state_dict(model.state_dict())
    t = torch.from_numpy(tokens)
    with torch.no_grad():
        a, b = model(t), einsum(t)
        na, nb = float(model.evaluate_nll(t)), float(einsum.evaluate_nll(t))
    assert float((a - b).abs().max() / b.abs().max()) < LOGIT_REL_TOL
    np.testing.assert_allclose(na, nb, rtol=2e-2)


@pytest.mark.parametrize("seq_len", [64, 200])
def test_flash_needs_seq_len_a_multiple_of_128(seq_len):
    cfg = dataclasses.replace(tflag.SliceProofConfig.tiny(), attention="flash",
                              seq_len=seq_len)
    with pytest.raises(ValueError, match="% 128"):
        tflag.SliceProof(cfg, device="cpu")


def test_unknown_attention_raises():
    cfg = dataclasses.replace(tflag.SliceProofConfig.tiny(), attention="ring")
    with pytest.raises(ValueError, match="'einsum' or 'flash'"):
        tflag.SliceProof(cfg, device="cpu")


def test_default_device_is_cuda_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    assert port.resolve_device("cpu") == torch.device("cpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PORT_FILES = sorted((ROOT / "k8s_dra_driver_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "k8s_dra_driver_tpu"), (path, mod)
