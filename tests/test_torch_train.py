"""Port parity: the flagship's single-device training slice.

JAX ``init_params`` weights are carried into the port with
``params_from_jax``, and the port's grads and updated parameters come back
with ``state_to_jax_tree``, so both sides are compared leaf by leaf on the
same numpy tokens. The JAX side runs on the CPU (its fused-CE kernels in
Pallas interpret mode); the port runs on the CPU with the plain versions.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from k8s_dra_driver_tpu.models import common as jcommon
from k8s_dra_driver_tpu.models import flagship as jflag
from k8s_dra_driver_tpu_torch.models import common as tcommon
from k8s_dra_driver_tpu_torch.models import flagship as tflag
from k8s_dra_driver_tpu_torch.models.convert import params_from_jax, state_to_jax_tree
from k8s_dra_driver_tpu_torch.ops import LAUNCHES

# Loss: both sides round at the same places to bf16, but their bf16 matmuls
# round differently inside; a mean over ~100 tokens averages that out.
LOSS_RTOL = 1e-4
# Grads and parameters, per leaf, normalized by max|JAX leaf|: the repo's
# bf16 tolerance (test_models_flagship.py's remat test).
LEAF_ATOL = 2e-2
# remat recomputes the same ops: the reference's remat bound.
REMAT_RTOL = 1e-3


def _configs():
    # As test_torch_flagship.py: tiny(), and vocab 300, which does not
    # divide the fused CE's 512 vocab block.
    small = dict(vocab=300, d_model=64, n_heads=4, n_layers=2, d_ff=128, seq_len=32)
    return {
        "tiny": (jflag.SliceProofConfig.tiny(), tflag.SliceProofConfig.tiny()),
        "odd_vocab": (jflag.SliceProofConfig(**small), tflag.SliceProofConfig(**small)),
    }


def _port_model(tcfg, jparams):
    model = tflag.SliceProof(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams)))
    return model


@pytest.fixture(scope="module", params=["tiny", "odd_vocab"])
def pair(request):
    jcfg, tcfg = _configs()[request.param]
    jparams = jflag.init_params(jcfg, seed=0)
    tokens = np.random.default_rng(1).integers(
        0, tcfg.vocab, (2, tcfg.seq_len)).astype(np.int32)
    return jcfg, tcfg, jparams, tokens


def _assert_trees_close(got, want, atol=LEAF_ATOL):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(got)):
        w = np.asarray(w, dtype=np.float32)
        assert g.shape == w.shape, path
        denom = max(float(np.abs(w).max()), 1e-6)
        np.testing.assert_allclose(g / denom, w / denom, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _port_grads(model, loss):
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return state_to_jax_tree(dict(zip(names, grads)))


def test_momentum_sgd_matches_jax():
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (7,), "c": (2, 3, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    mom = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    jp, jm = params, mom
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tm = {k: torch.from_numpy(v.copy()) for k, v in mom.items()}
    ids = {k: id(v) for k, v in tp.items()}
    for g in grads:
        jp, jm = jcommon.momentum_sgd(jp, jm, g, 1e-3)
        tcommon.momentum_sgd(tp, tm, {k: torch.from_numpy(v) for k, v in g.items()}, 1e-3)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]), rtol=1e-6, atol=1e-7)
    assert {k: id(v) for k, v in tp.items()} == ids  # updated in place


def test_loss_and_grads_match_jax(pair):
    jcfg, tcfg, jparams, tokens = pair
    batch = {"tokens": jnp.asarray(tokens)}
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jflag.loss_fn(jcfg, p, batch))(jparams)
    model = _port_model(tcfg, jparams)
    loss = model.loss_fn(torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    _assert_trees_close(_port_grads(model, loss), want_grads)


def test_three_sgd_steps_match_jax(pair):
    jcfg, tcfg, jparams, tokens = pair
    jstep = jax.jit(partial(jflag.sgd_train_step, jcfg))
    jstate = {"params": jparams, "momentum": jax.tree.map(jnp.zeros_like, jparams)}
    model = _port_model(tcfg, jparams)
    state = {"params": model,
             "momentum": {n: torch.zeros_like(p) for n, p in model.named_parameters()}}
    jbatch = {"tokens": jnp.asarray(tokens)}
    batch = {"tokens": torch.from_numpy(tokens)}
    for _ in range(3):
        jstate, jloss = jstep(jstate, jbatch)
        state, loss = tflag.sgd_train_step(tcfg, state, batch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    _assert_trees_close(state_to_jax_tree(model.state_dict()), jstate["params"])
    # Three steps at lr 1e-3 move a weight by ~1e-4 of its size, which the
    # check above cannot see; the momentum is the sum of the updates.
    _assert_trees_close(state_to_jax_tree(state["momentum"]), jstate["momentum"])


def test_make_sharded_train_step_matches_jax_on_one_device():
    jcfg, tcfg = _configs()["tiny"]
    jstep, jstate, jbatch = jflag.make_sharded_train_step(
        jcfg, jax.devices("cpu")[:1], seed=3)
    step, state, batch = tflag.make_sharded_train_step(tcfg, ["cpu"], seed=3)
    np.testing.assert_array_equal(batch["tokens"].numpy(), np.asarray(jbatch["tokens"]))
    assert batch["tokens"].shape == (2, tcfg.seq_len)
    assert all(float(m.abs().max()) == 0.0 for m in state["momentum"].values())
    # Both sides draw seed-3 weights from their own generators, so the
    # losses agree only to ~1e-3; carry the JAX weights over to compare the
    # step itself.
    jp0 = jax.tree.map(np.asarray, jstate["params"])
    _, own_loss = step(state, batch)
    state["params"].load_state_dict(params_from_jax(jp0))
    _, jloss = jstep(jstate, jbatch)
    _, loss = step(state, batch)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(own_loss), float(jloss), rtol=1e-2)


def test_loss_falls_over_five_steps():
    step, state, batch = tflag.make_sharded_train_step(
        tflag.SliceProofConfig.tiny(), ["cpu"], seed=0)
    losses = []
    for _ in range(5):
        state, loss = step(state, batch)
        losses.append(float(loss))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def _remat_inputs():
    cfg = tflag.SliceProofConfig.tiny()
    jparams = jflag.init_params(jflag.SliceProofConfig.tiny(), seed=5)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(2, cfg.seq_len)).astype(np.int32)
    return cfg, jparams, tokens


def test_remat_matches_plain_loss_and_grads():
    """Mirrors test_models_flagship.py's remat test on the port."""
    cfg, jparams, tokens = _remat_inputs()
    t = torch.from_numpy(tokens)
    plain = _port_model(cfg, jparams)
    remat = _port_model(dataclasses.replace(cfg, remat=True), jparams)
    loss_p, loss_r = plain.loss_fn(t), remat.loss_fn(t)
    np.testing.assert_allclose(float(loss_r.detach()), float(loss_p.detach()),
                               rtol=REMAT_RTOL)
    _assert_trees_close(_port_grads(remat, loss_r), _port_grads(plain, loss_p))


def test_remat_matches_jax_remat():
    cfg, jparams, tokens = _remat_inputs()
    jcfg = dataclasses.replace(jflag.SliceProofConfig.tiny(), remat=True)
    batch = {"tokens": jnp.asarray(tokens)}
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jflag.loss_fn(jcfg, p, batch))(jparams)
    model = _port_model(dataclasses.replace(cfg, remat=True), jparams)
    loss = model.loss_fn(torch.from_numpy(tokens))
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    _assert_trees_close(_port_grads(model, loss), want_grads)


def test_remat_train_step_matches_plain():
    cfg, jparams, tokens = _remat_inputs()
    batch = {"tokens": torch.from_numpy(tokens)}
    losses = []
    for c in (cfg, dataclasses.replace(cfg, remat=True)):
        model = _port_model(c, jparams)
        state = {"params": model, "momentum": {
            n: torch.zeros_like(p) for n, p in model.named_parameters()}}
        for _ in range(2):
            state, loss = tflag.sgd_train_step(c, state, batch)
        losses.append(float(loss))
    np.testing.assert_allclose(losses[1], losses[0], rtol=REMAT_RTOL)


def test_evaluate_nll_grads_match_jax(pair):
    """The port's evaluate_nll is differentiable through FusedCE, as the
    JAX one is through its custom VJP."""
    jcfg, tcfg, jparams, tokens = pair
    want = jax.grad(lambda p: jflag.evaluate_nll(
        jcfg, p, jnp.asarray(tokens), interpret=True))(jparams)
    model = _port_model(tcfg, jparams)
    LAUNCHES.clear()
    got = _port_grads(model, model.evaluate_nll(torch.from_numpy(tokens)))
    assert sum(LAUNCHES.values()) == 0  # the CPU runs the plain versions
    _assert_trees_close(got, want)


def test_evaluate_nll_grads_match_loss_fn_grads(pair):
    _, tcfg, jparams, tokens = pair
    model = _port_model(tcfg, jparams)
    t = torch.from_numpy(tokens)
    _assert_trees_close(_port_grads(model, model.evaluate_nll(t)),
                        _port_grads(model, model.loss_fn(t)))


def test_more_than_one_device_raises():
    cfg = tflag.SliceProofConfig.tiny()
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        tflag.make_sharded_train_step(cfg, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="one device"):
        tflag.make_sharded_train_step(cfg, [])


def test_make_token_batch_is_seeded_on_the_device():
    a = tcommon.make_token_batch(4, 3, 16, 50, torch.device("cpu"))["tokens"]
    b = tcommon.make_token_batch(4, 3, 16, 50, torch.device("cpu"))["tokens"]
    want = np.random.default_rng(4).integers(0, 50, size=(3, 16))
    assert a.shape == (3, 16) and a.device.type == "cpu"
    np.testing.assert_array_equal(a.numpy(), want)
    assert torch.equal(a, b)


def test_state_to_jax_tree_inverts_params_from_jax():
    jcfg, _ = _configs()["odd_vocab"]
    tree = jax.tree.map(np.asarray, jflag.init_params(jcfg, seed=2))
    back = state_to_jax_tree(params_from_jax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# attention="flash" at the smallest size the reference's flash kernel takes
# (seq a multiple of its 128 block), one layer, batch 1: one JAX training
# step in TPU interpret mode takes ~10 s on a CPU.
FLASH_SMALL = dict(vocab=256, d_model=128, n_heads=2, n_layers=1, d_ff=256,
                   seq_len=128, attention="flash")


@pytest.fixture(scope="module")
def flash_step():
    """One JAX sgd_train_step from zero momentum, with the flash kernel run
    in TPU interpret mode: (initial params, tokens, loss, params after,
    momentum after). The momentum after one step is the grads."""
    jcfg = jflag.SliceProofConfig(**FLASH_SMALL)
    jparams = jflag.init_params(jcfg, seed=0)
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab, (1, jcfg.seq_len)).astype(np.int32)
    p0 = jax.tree.map(np.asarray, jparams)
    state = {"params": jparams, "momentum": jax.tree.map(jnp.zeros_like, jparams)}
    with pltpu.force_tpu_interpret_mode():
        state, loss = jax.jit(partial(jflag.sgd_train_step, jcfg))(
            state, {"tokens": jnp.asarray(tokens)})
        loss = float(loss)
    return p0, tokens, loss, state["params"], state["momentum"]


# The port's remat step is held to the JAX step without remat: remat
# recomputes the same function, and the JAX flash kernel cannot run under
# jax.checkpoint on a CPU (interpret mode's ordered callbacks are effects
# that remat refuses).
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_flash_loss_and_grads_match_jax(flash_step, remat):
    p0, tokens, want_loss, _, want_grads = flash_step
    model = _port_model(tflag.SliceProofConfig(**FLASH_SMALL, remat=remat), p0)
    LAUNCHES.clear()
    loss = model.loss_fn(torch.from_numpy(tokens))
    got = _port_grads(model, loss)
    assert sum(LAUNCHES.values()) == 0  # the CPU runs the plain versions
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_RTOL)
    _assert_trees_close(got, want_grads)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_flash_sgd_step_matches_jax(flash_step, remat):
    p0, tokens, want_loss, want_params, want_mom = flash_step
    tcfg = tflag.SliceProofConfig(**FLASH_SMALL, remat=remat)
    model = _port_model(tcfg, p0)
    state = {"params": model,
             "momentum": {n: torch.zeros_like(p) for n, p in model.named_parameters()}}
    state, loss = tflag.sgd_train_step(tcfg, state, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_trees_close(state_to_jax_tree(model.state_dict()), want_params)
    _assert_trees_close(state_to_jax_tree(state["momentum"]), want_mom)


def test_flash_train_step_reduces_loss_and_remat_matches():
    cfg = tflag.SliceProofConfig(**FLASH_SMALL)
    losses = {}
    for remat in (False, True):
        step, state, batch = tflag.make_sharded_train_step(
            dataclasses.replace(cfg, remat=remat), ["cpu"], seed=0)
        losses[remat] = [float(step(state, batch)[1]) for _ in range(3)]
    assert all(np.isfinite(losses[False])) and losses[False][-1] < losses[False][0]
    np.testing.assert_allclose(losses[True], losses[False], rtol=REMAT_RTOL)


def test_flash_evaluate_nll_grads_match_loss_fn_grads():
    model = tflag.init_params(tflag.SliceProofConfig(**FLASH_SMALL), seed=1, device="cpu")
    t = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 128)))
    _assert_trees_close(_port_grads(model, model.evaluate_nll(t)),
                        _port_grads(model, model.loss_fn(t)))
