#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports the port only (never JAX) and fails with a non-zero exit code,
printing no result, when there is no card or no port beside it.

Phases, each fatal on failure:
 1. build: compile every CUDA source of the port with nvcc (sm_90a), all
    at once;
 2. kernels: hold each kernel to its plain PyTorch version (and the
    materializing reference) on the card at the shapes the main paths give
    it, and time kernel, plain version, one library call and the bound.
    fused_ce_fwd (one launch: the wgmma product, per-tile (max, sum)
    partials and their fold) at T=4096, D=2048, V=8192 and V=32000, timed
    (the kernel alone on prepared buffers too, its TFLOP/s, cuBLAS's
    x @ w, its library call on the bf16 operands and, labelled f32, on
    f32 copies), and untimed at V=1000 (also with every fifth label -1),
    labels -1, V=1001 (w's aligned copy), d_model 4096, 2000 and 1001
    (x's aligned copy); its partials at the bench shape held to
    fused_ce_fwd_partials_plain; its ptxas report (a spill is fatal).
    The fused-CE backward at the fused objective's shape (T=4096: 4*1023
    tokens padded, the last 4 rows labelled -1 with g=0, g=1/4092
    elsewhere): its vocab chunks printed; fused_ce_p, fused_ce_dx and
    fused_ce_dw launched one by one in the wrapper's own plan
    (fused_ce._bwd_launches), each held to its plain version on the same
    inputs and timed summed over the chunks beside one library call of its
    function over the whole vocab; the whole backward held to
    fused_ce_dx_plain / fused_ce_dw_plain and to torch.autograd.grad of
    the materializing reference, and timed (also with its launches queued
    behind a sleeping kernel: no host time) beside the bound, the plain
    versions and the library's autograd of both grads on the bf16 operands
    and on f32 copies; the same, timed, at vocab 32000 (eight chunks, the
    last ragged); untimed, dx only, dw only, V=1000, V=1001 at T=512 (w's
    aligned copy), d_model 4096, 2000 and 1001 (x's aligned copy). The
    ptxas report of the three (a spill is fatal).
    flash_fwd, flash_dq and flash_dkv at [batch, heads, seq, head_dim] =
    [4, 2, 1024, 1024] (the bench attention), [1, 16, 8192, 128] and
    [2, 4, 256, 64], each against its plain version on the same saved row
    statistics and against reference_attention (its autograd for the
    grads); the library call is F.scaled_dot_product_attention; and,
    untimed, at head_dim 16, 48, 144, 272, 528 and 1008 and at seq 384 with
    head_dim 128, 256, 272 and 1024. For each flash kernel: the ptxas
    registers and spills of every instantiation (a spill is fatal), the
    cluster size and TFLOP/s at each timed shape, and the share of its
    time that the cluster exchange costs at equal work, head_dim 128 to
    1024;
 3. scoring: SliceProof at the full width of SliceProofConfig.bench() with
    seeded random weights scores a few batches of 4x1024 tokens through
    evaluate_nll under torch.no_grad(): exactly one fused_ce_fwd a batch
    and no backward kernel. The NLL is checked against the materializing
    loss_fn, and a tiny() model against itself on the CPU;
 4. fused objective: torch.autograd.grad(evaluate_nll, params) at bench
    width, batch 4x1024: exactly one fused_ce_fwd a call and one
    fused_ce_p, fused_ce_dx and fused_ce_dw a vocab chunk of the
    backward's plan; the grads held leaf by leaf to those of loss_fn;
 5. flash scoring: the same weights and batches with attention="flash":
    exactly one flash_fwd a layer and one fused_ce_fwd a batch, no
    backward kernel; the NLL held to the einsum model's;
 6. training: make_sharded_train_step(SliceProofConfig.bench(), [card],
    batch_per_replica=4, seed=0), one warm-up step and five more on the
    same batch, each ending in float(loss): finite losses, the last below
    the first, the first equal to loss_fn at the initial weights; step ms,
    tokens/s, peak memory and MFU. Then one remat=True step from fresh
    seed-0 weights, whose loss must equal the first plain loss;
 7. flash training: the same with attention="flash": the loss and grads
    of loss_fn at the initial weights held to the einsum model's, then
    six steps with exactly one flash_fwd, flash_dq and flash_dkv a layer a
    step and no fused-CE kernel, and a remat=True step (flash_fwd twice a
    layer) whose loss must equal the first plain flash loss;
 8. long sequence: bench width at seq 8192, batch 1: evaluate_nll with
    flash and with einsum on the same weights, tokens/s of both and their
    NLL agreement;
 9. standalone ops (the kernels' checks run with phase 2): rmsnorm at [4,
    1024, d], d 128, 512, 2048, 4096 and 8192, in bf16 and f32, and
    tiled_matmul at the FFN half's four bf16 products (forward, and the two
    VJP products with a transposed operand) and at [4096, 2048] @ [2048,
    2048] in f32 in all four orientations, each timed beside its plain
    version, one library call (F.rms_norm, torch.matmul) and the bound
    (rmsnorm and F.rms_norm also with the L2 emptied before each call),
    with tiled_matmul's TFLOP/s and the ptxas report of both kernels'
    instantiations (a spill is fatal); untimed at small, odd, ragged,
    unaligned, mixed-dtype and empty shapes and, in f32, at [512, 16384] @
    [16384, 512]. Then the whole-op path: the FFN half of a Block built from
    rmsnorm and tiled_matmul alone, on seed-0 bench weights cast to bf16
    and a [4096, 2048] bf16 row block, forward and autograd to x, ln2, w1
    and w2: exactly one rmsnorm and two tiled_matmul launches forward and
    four tiled_matmul backward; y and the grads held to the model's own
    ffn_half (cuBLAS); ms of both chains;
10. device: the card's name and power limit from nvidia-smi.
Each of phases 3-9 clears the launch counts just before its path and
reads them just after.

Tolerances, with their reasons, stand beside their constants below.

The last three lines of standard output are the kernels' JSON record, the
nvidia-smi line and ``{"ok": true, "device": {...}}``. ``--profile DIR``
also traces one scoring batch and one training step, each with einsum and
with flash attention, and one grad(evaluate_nll) call, with torch.profiler
and writes the tables of device time by kernel to DIR.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM published dense peaks (NVIDIA data sheet), for the bound.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12  # non-tensor FP32
PEAK_TF32_FLOPS = 495e12  # tensor-core TF32

SCORE_BATCH, SCORE_BATCHES = 4, 4
# The fused CE's shape at bench width: evaluate_nll on 4x1024 tokens gives
# 4*1023 scored tokens, padded to T=4096; d_model 2048, vocab 8192.
KERNEL_T, KERNEL_D, KERNEL_V = 4096, 2048, 8192
# Kernel vs plain version: both sum the same exact bf16 products in f32,
# in another order over D=2048 terms; the exp/log of the fold add ~1e-6
# relative on losses of ~9.
KERNEL_ATOL, KERNEL_RTOL = 1e-3, 1e-4
# Untimed forward cases, (T, D, V), every fifth row labelled -1: a ragged
# last vocab tile; w's aligned copy (V % 8 != 0); d_model 4096 (no cap);
# ragged K; x's aligned copy (D % 8 != 0). V = 32000 (BWD_LARGE_VOCAB) is
# timed like the bench shape.
FWD_CASES = {"vocab_1000_pad": (4096, 2048, 1000), "vocab_1001": (512, 2048, 1001),
             "d_model_4096": (4096, 4096, 8192), "d_model_2000": (4096, 2000, 8192),
             "d_model_1001": (512, 1001, 1000)}
# evaluate_nll vs the materializing loss_fn at bench width: the repo's bf16
# tolerance (bench.py, check_fused_ce_numerics); the logits of loss_fn are
# rounded to bf16, the kernel's are not.
NLL_RTOL = 2e-2
# The whole backward vs its plain versions and the materializing reference,
# as max|err| / max|plain| per output tensor: the kernels round p to bf16
# before both products (2**-9 relative a term, f32 sums) and write bf16
# (2**-9 relative); the plain versions keep f32 p, as the reference does.
BWD_REL_TOL = 1e-2
# Each backward kernel vs its plain version on the same inputs, max|err| /
# max|plain|: both form the same exact products and sum them in f32 in
# another order; the kernel rounds its output (p, dx or dw) to bf16 once,
# one step of bf16 (2**-7 relative) at most.
BWD_KERNEL_REL_TOL = 2 ** -7
BWD_KERNELS = ("fused_ce_p", "fused_ce_dx", "fused_ce_dw")
# A large vocab, timed like the bench shape: T=4096, d_model 2048, vocab
# 32000 (Llama 2's), eight chunks at the wrapper's budget (seven of 4096
# columns and 3328: dx's f32 sum stored, added into, and added and
# written), every fifth row labelled -1.
BWD_LARGE_VOCAB = (4096, 2048, 32000)
# Untimed backward cases, (T, D, V), every fifth row labelled -1: one
# ragged chunk; w's aligned copy (V % 8 != 0) and dw's masked stores;
# d_model 4096 (no cap); d_model 2000 (ragged K of the p kernel, ragged N
# of dx, ragged M of dw); x's aligned copy (D % 8 != 0) and dx's masked
# stores.
BWD_CASES = {"vocab_1000": (4096, 2048, 1000), "vocab_1001": (512, 2048, 1001),
             "d_model_4096": (4096, 4096, 8192), "d_model_2000": (4096, 2000, 8192),
             "d_model_1001": (512, 1001, 1000)}
# Grads of evaluate_nll vs grads of loss_fn, per leaf, normalized by
# max|loss_fn leaf|: the repo's bf16 tolerance (test_models_flagship.py's
# remat test). loss_fn's logits and their grads are bf16, the kernels'
# are f32 with bf16 p.
GRAD_LEAF_ATOL = 2e-2
# The first training step's loss vs loss_fn at the same weights: the same
# ops on the same inputs; only a cuBLAS algorithm chosen differently with
# autograd recording could move the last bits.
FIRST_LOSS_RTOL = 1e-5
# remat recomputes the same ops: the reference's remat bound.
REMAT_RTOL = 1e-3

# The flash kernels' shapes [batch, heads, seq, head_dim]: the attention of
# SliceProofConfig.bench() at batch 4; the head count of the reference's
# long-sequence table at seq 8192; bench.py check_flash_numerics' shape.
FLASH_SHAPES = {"bench": (4, 2, 1024, 1024), "long": (1, 16, 8192, 128),
                "numerics": (2, 4, 256, 64)}
FLASH_KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
# Untimed head_dims at [1, 2, 256, d], none a multiple of 128: every slice
# width of the forward and dkv kernels (64, 128, 256), ragged last slices
# (144, 272, 528, 1008) and clusters of 2 to 8 blocks.
FLASH_HEAD_DIMS = (16, 48, 144, 272, 528, 1008)
# Untimed at seq 384 (6 tiles of 64, not a power of two): one and two
# 128-column slices, a ragged cluster of 3 (dkv) and of 2 (forward, dq),
# and the bench head_dim's clusters of 4 (forward, dq) and 8 (dkv).
FLASH_SEQ384_HEAD_DIMS = (128, 256, 272, 1024)
# Equal work to the bench attention (b·h·d = 8192, seq 1024) at these
# head_dims: at 128 no kernel splits head_dim over a cluster, above it the
# clusters grow (forward and dq 1, 2, 4; dkv 2, 4, 8), so the time over
# the head_dim-128 time is what the cluster exchange costs.
FLASH_SWEEP_HEAD_DIMS = (128, 256, 512, 1024)
# Flash kernels vs their plain versions and the f32 reference, as max|err|
# / max|value| per output tensor: the kernels walk key tiles of 64 where
# the plain versions walk blocks of 128, so p is rounded to bf16 against
# another running max in the forward, and the score sums over head_dim are
# taken in another order (split over a cluster's blocks above head_dim 256
# forward and dq, 128 dkv); all round p and ds to bf16 before the second
# products and write bf16 (2**-9 relative); the reference keeps f32
# throughout. The repo's bf16 tolerance.
FLASH_REL_TOL = 2e-2
# The long-sequence scoring point: batch 1 at seq 8192, calls timed.
LONG_SEQ, LONG_CALLS = 8192, 2

# Calls of grad(evaluate_nll) before the counted ones: the first two grow
# the caching allocator (371 and 283 ms against 60 ms steady on an H100).
OBJECTIVE_WARMUP, OBJECTIVE_CALLS = 2, 3
TRAIN_BATCH, TRAIN_STEPS = 4, 5  # per step: 4x1024 tokens; plus one warm-up

# The standalone ops at bench width: RMSNorm over a [4, 1024, 2048] batch
# of hidden states; the FFN half's products on 4x1024 token rows, d_model
# 2048, d_ff 16384; the f32 product at [4096, 2048] @ [2048, 2048].
OPS_TOKENS, OPS_D, OPS_FF = 4096, 2048, 16384
# rmsnorm is also timed over [4, 1024, d] at these widths, in bf16 and f32:
# the rows-a-warp kernel's lane groups of 16 and 32 lanes at 1 to 8 chunks
# a lane, with and without the next row's prefetch, and the block-a-row
# kernel above 8 chunks a lane (f32 from d 2048, bf16 from d 4096).
RMS_WIDTHS = (128, 512, 2048, 4096, 8192)
# The f32 product's long sum, untimed: [512, 16384] @ [16384, 512].
LONG_K = 16384
# rmsnorm kernel vs plain version, per element: the row's f32 sum of
# squares is taken in another order, so r differs in its last bits; a bf16
# output may then round to the neighbouring value, one ulp, at most 2**-7
# of the value. f32: the bound the reference's own test holds its kernel to.
RMS_TOL = {"torch.bfloat16": dict(rtol=2 ** -7, atol=1e-6),
           "torch.float32": dict(rtol=1e-5, atol=1e-5)}
# tiled_matmul kernel vs plain version, max|err| / max|plain|, by output
# dtype: bf16: both sum exact products in f32 in another order; a bf16
# output then rounds once (one ulp, 2**-7 relative at most). f32 must be
# real f32: sums of K products in another order differ by ~1e-7 relative,
# where one TF32 product would differ by ~3e-4; the kernel's three TF32
# products (split operands) drop less than 2**-20 of each product.
MATMUL_REL_TOL = {"torch.bfloat16": 2 ** -7, "torch.float32": 1e-5}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 2, queued: bool = False) -> float:
    """Device ms a call of ``fn``. ``queued`` holds the calls back behind a
    sleeping kernel so that the host's launch cost does not space them out:
    for kernels of a few microseconds, faster than their host-side wrapper."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(200_000 * iters)  # ~0.1 ms a call at ~2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_cold_ms(fn, iters: int) -> float:
    """Device ms a call of ``fn`` with the L2 cache emptied of its inputs
    before each call (a 128 MB buffer read between calls, outside the
    timed span, which leaves clean lines: nothing to write back), as a
    caller whose inputs were written long before would find it. Each call
    is held back behind a sleeping kernel (~1 ms, longer than the host
    takes to issue the flush and the call), so the span holds no host
    time."""
    import torch

    flush = torch.ones(2 ** 25, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        flush.sum()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def check_kernel_case(name, x, w, labels, timed: bool):
    """Kernel vs plain version and the materializing reference. Returns the
    case's row: the max abs errors and, when ``timed``, the kernel's ms
    through ``fused_ce_losses`` and alone on prepared buffers
    (``launch_ms``), its TFLOP/s, the plain version's, both library calls'
    and the bound."""
    import torch
    import torch.nn.functional as F

    from k8s_dra_driver_tpu_torch.ops import _build
    from k8s_dra_driver_tpu_torch.ops import fused_ce as fc

    got = fc.fused_ce_losses(x, w, labels)
    torch.cuda.synchronize()
    plain = fc.fused_ce_losses_plain(x, w, labels)
    err = float((got - plain).abs().max())
    bad = ~torch.isclose(got, plain, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    if got.shape != labels.shape or not bool(torch.isfinite(got).all()) or bool(bad.any()):
        fail(f"fused_ce kernel vs plain, {name}: max abs err {err:.3e}, "
             f"{int(bad.sum())} rows outside tolerance")
    real = labels >= 0
    if bool(real.all()):
        ref = fc.reference_ce_losses(x, w, labels)
    else:  # a label of -1 matches no class: the loss is the logsumexp
        logits = x.float() @ w.float()
        ref = torch.logsumexp(logits, dim=1)
        del logits
        ref[real] = fc.reference_ce_losses(x[real], w, labels[real])
    ref_err = float((got - ref).abs().max())
    if not bool(torch.isclose(got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL).all()):
        fail(f"fused_ce kernel vs reference, {name}: max abs err {ref_err:.3e}")
    T, D = x.shape
    V = w.shape[1]
    row = {"case": name, "T": T, "D": D, "V": V,
           "max_abs_err_vs_plain": err, "max_abs_err_vs_reference": ref_err}
    if timed:
        row["ms"] = time_ms(lambda: fc.fused_ce_losses(x, w, labels), 20)
        # The kernel alone, on the buffers of one call prepared once (the
        # counters are left zeroed by each launch, so they are reused as
        # they are).
        args = fc._fwd_args(x, w, labels)
        row["launch_ms"] = time_ms(lambda: _build.launch(fc.KERNEL, x.device, *args), 20)
        if bool(args[4].any()):
            fail(f"fused_ce_fwd {name}: the arrival counters were not left zeroed")
        row["tflops"] = 2.0 * T * D * V / row["ms"] / 1e9
        row["plain_ms"] = time_ms(lambda: fc.fused_ce_losses_plain(x, w, labels), 5)
        # One PyTorch call on the kernel's bf16 operands (the logits'
        # product in bf16, cross-entropy in f32), and on f32 copies of them
        # (true f32 products).
        row["library_ms"] = time_ms(lambda: F.cross_entropy(
            (x @ w).float(), labels, reduction="none", ignore_index=-1), 5)
        row["library_f32_ms"] = time_ms(lambda: F.cross_entropy(
            x.float() @ w.float(), labels, reduction="none", ignore_index=-1), 5)
        # The product alone, cuBLAS's x @ w writing the bf16 logits: what
        # the kernel's row passes and fold add to its mainloop, at most.
        row["matmul_ms"] = time_ms(lambda: x @ w, 5)
        row["bound_ms"], row["bound_by"] = bound_ms(T, D, V)
    print(f"kernel fused_ce_fwd {json.dumps(row)}")
    return row


def check_fwd_partials(name, x, w, labels) -> None:
    """The forward kernel's scratch after a launch, each vocab tile's row
    max and row sum of exp, and its lse and picked, held to
    fused_ce_fwd_partials_plain and fused_ce_lse_fold_plain."""
    import torch

    from k8s_dra_driver_tpu_torch.ops import fused_ce as fc

    lse, picked, part = fc._launch_with_partials(x, w, labels)
    torch.cuda.synchronize()
    m, l, pk = fc.fused_ce_fwd_partials_plain(x, w, labels)
    errs = {}
    for tname, got, want in (("max", part[0], m), ("sum", part[1], l), ("picked", picked, pk),
                             ("lse", lse, fc.fused_ce_lse_fold_plain(m, l))):
        errs[tname] = float((got - want).abs().max())
        if got.shape != want.shape or not bool(torch.isclose(
                got, want, rtol=KERNEL_RTOL, atol=KERNEL_ATOL).all()):
            fail(f"fused_ce_fwd partials {name} {tname}: {tuple(got.shape)} (want "
                 f"{tuple(want.shape)}), max abs err {errs[tname]:.3e}")
    print(f"kernel fused_ce_fwd partials {name}: vocab tiles {m.shape[0]}, max abs err "
          f"{json.dumps(errs)}")


def bound_ms(T: int, D: int, V: int):
    from k8s_dra_driver_tpu_torch.ops.fused_ce import FWD_TILE

    flops = 2.0 * T * D * V
    # x and w in bf16, int32 labels read once; the partials, a (max, sum)
    # pair of f32 a row and vocab tile, written and read once; lse and
    # picked f32 written.
    tiles = -(-V // FWD_TILE)
    nbytes = 2.0 * (T * D + D * V) + 4.0 * T + 2 * 8.0 * tiles * T + 8.0 * T
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def bwd_bound_ms(T: int, D: int, V: int, kernel: str):
    """Least time for one backward kernel summed over a backward's chunks,
    or for the whole backward ("fused_ce_bwd"): its operations at the bf16
    peak (2*T*D*V a product, three products in all) against the bytes it
    must move, each input read and each output written once (p, the
    scratch between the kernels, counts as an output of fused_ce_p and an
    input of the products; the whole backward reads x, w and the [T]
    vectors and writes dx and dw)."""
    # bf16 [T, D] (x, dx), [D, V] (w, dw) and [T, V] (p); labels, lse, g.
    td, dv, tv, rows = 2.0 * T * D, 2.0 * D * V, 2.0 * T * V, 12.0 * T
    nbytes = {"fused_ce_p": td + dv + rows + tv,
              "fused_ce_dx": tv + dv + td,
              "fused_ce_dw": td + tv + dv,
              "fused_ce_bwd": 2 * (td + dv) + rows}[kernel]
    flops = 2.0 * T * D * V * (3 if kernel == "fused_ce_bwd" else 1)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def rel_err(got, want) -> float:
    """max|got - want| / max|want| in f32; inf where got is not finite."""
    import torch

    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).abs().max() / want.abs().max())


def bwd_library_calls(x, w, labels, g):
    """One PyTorch call for both grads, timed: autograd of the
    materializing loss to x and w, the graph kept between runs, on the bf16
    operands the kernels take (the logits' product in bf16, cross-entropy
    in f32) and on f32 copies of them (true f32 products)."""
    import torch
    import torch.nn.functional as F

    out = {}
    for tag, cast in (("bf16", lambda t: t), ("f32", lambda t: t.float())):
        xl = x.detach().requires_grad_()
        wl = w.detach().requires_grad_()
        loss = F.cross_entropy((cast(xl) @ cast(wl)).float(), labels, reduction="none",
                               ignore_index=-1)
        out[tag] = time_ms(lambda: torch.autograd.grad(loss, (xl, wl), g,
                                                       retain_graph=True), 5)
        del loss, xl, wl
    return out


def bwd_kernel_library_calls(x, w, labels, lse, g, p):
    """One PyTorch call for each backward kernel's function over the whole
    vocab (the kernel's launches summed over the chunks), timed, on the
    same bf16 operands: for fused_ce_p the logits' product in bf16 and p
    formed from it in f32, written bf16; for fused_ce_dx torch.matmul(p,
    w^T) and for fused_ce_dw torch.matmul(x^T, p), on the p [T, V] bf16
    the p kernel wrote. Returns {kernel: ms}."""
    import torch

    real = torch.nonzero(labels >= 0)[:, 0]
    lab = labels[real]

    def p_call():
        q = torch.exp((x @ w).float() - lse[:, None])
        q[real, lab] -= 1.0
        return (q * g[:, None]).to(torch.bfloat16)

    return {"fused_ce_p": time_ms(p_call, 5),
            "fused_ce_dx": time_ms(lambda: torch.matmul(p, w.T), 10),
            "fused_ce_dw": time_ms(lambda: torch.matmul(x.T, p), 10)}


def check_bwd_case(name, x, w, labels, g, timed: bool, need=("dx", "dw")):
    """The chunked backward on the card. fused_ce_p, fused_ce_dx and
    fused_ce_dw launched one by one as ``fused_ce._bwd_launches`` plans
    them, each held to its plain version on the same inputs (the products
    on the p chunks the p kernel wrote); then the whole backward
    (``_launch_bwd``, the grads in ``need``) held to fused_ce_dx_plain /
    fused_ce_dw_plain and to torch.autograd.grad of the materializing
    reference. When ``timed``: each kernel's, its plain version's and its
    library call's ms over a backward's chunks, the whole backward's, the
    plain whole backward's, both library calls' of the whole backward, and
    the bounds. Returns {kernel: row} for the three kernels and
    "fused_ce_bwd"."""
    import torch

    from k8s_dra_driver_tpu_torch.ops import fused_ce as fc

    T, D = x.shape
    V = w.shape[1]
    lse = torch.logsumexp(x.float() @ w.float(), dim=1)
    # g is 0 on the rows labelled -1, so any class stands in for them.
    xr = x.float().requires_grad_()
    wr = w.float().requires_grad_()
    ref = torch.autograd.grad(fc.reference_ce_losses(xr, wr, labels.clamp(min=0)),
                              (xr, wr), g)
    del xr, wr
    chunks = fc._bwd_chunks(T, V)
    print(f"fused_ce backward {name}: T {T}, D {D}, V {V}, chunks (v0, width) {chunks}")
    row = {"case": name, "T": T, "D": D, "V": V, "chunks": len(chunks)}
    out = {}

    def held(kernel, got, want, tol):
        rel = rel_err(got, want)
        err = float((got.float() - want.float()).abs().max())
        if got.shape != want.shape or rel > tol:
            fail(f"{kernel} {name}: {tuple(got.shape)} (want {tuple(want.shape)}), "
                 f"error {rel:.3e} of max|value| (tolerance {tol})")
        return err, rel

    if need == ("dx", "dw"):
        # Kernel by kernel in the wrapper's plan, each chunk's p kept as
        # the products read it (the next chunk's p overwrites the scratch).
        dx, dw, p, launches = fc._bwd_launches(x, w, labels, lse, g)
        ps = []
        for kernel, v0, width, launch in launches:
            launch()
            if kernel == fc.KERNEL_P:
                ps.append((v0, p[:, :width].clone()))
        torch.cuda.synchronize()

        def run(kernel):
            def fn():
                for k, _, _, launch in launches:
                    if k == kernel:
                        launch()
            return fn

        def plain_p():
            return torch.cat([fc.fused_ce_p_plain(x, w, labels, lse, g, v0, pc.shape[1])
                              for v0, pc in ps], dim=1)

        def plain_dx():
            total = torch.zeros((T, D), dtype=torch.float32, device=x.device)
            for v0, pc in ps:
                total += fc.fused_ce_dx_chunk_plain(pc, w, v0)
            return total

        def plain_dw():
            return torch.cat([fc.fused_ce_dw_chunk_plain(x, pc) for _, pc in ps], dim=1)

        p_all = torch.cat([pc for _, pc in ps], dim=1)
        plains = {fc.KERNEL_P: plain_p, fc.KERNEL_DX: plain_dx, fc.KERNEL_DW: plain_dw}
        for kernel, got in ((fc.KERNEL_P, p_all), (fc.KERNEL_DX, dx), (fc.KERNEL_DW, dw)):
            err, rel = held(kernel, got, plains[kernel](), BWD_KERNEL_REL_TOL)
            row[kernel] = {"max_abs_err_vs_plain": err, "rel_err_vs_plain": rel}
            out[kernel] = {"max_abs_err": err}
        if timed:
            lib = bwd_kernel_library_calls(x, w, labels, lse, g, p_all)
            for kernel in BWD_KERNELS:
                t = out[kernel]
                t["ms"] = time_ms(run(kernel), 10)
                t["plain_ms"] = time_ms(plains[kernel], 3, warmup=1)
                t["library_ms"] = lib[kernel]
                t["bound_ms"], t["bound_by"] = bwd_bound_ms(T, D, V, kernel)
                t["tflops"] = 2.0 * T * D * V / t["ms"] / 1e9
                row[kernel].update(ms=t["ms"], plain_ms=t["plain_ms"],
                                   library_ms=t["library_ms"], tflops=t["tflops"])
        del ps, p_all, dx, dw, p, launches

    # The whole backward, as FusedCE.backward runs it.
    got = fc._launch_bwd(x, w, labels, lse, g, "dx" in need, "dw" in need)
    torch.cuda.synchronize()
    whole = {}
    for tname, grad, plain_fn, want in (
            ("dx", got[0], fc.fused_ce_dx_plain, ref[0]),
            ("dw", got[1], fc.fused_ce_dw_plain, ref[1])):
        if tname not in need:
            if grad is not None:
                fail(f"fused_ce backward {name}: {tname} computed though not asked for")
            continue
        plain = plain_fn(x, w, labels, lse, g)
        if grad.dtype != torch.bfloat16:
            fail(f"fused_ce backward {name}: {tname} is {grad.dtype}, want bf16")
        err, rel = held(f"fused_ce backward {tname}", grad, plain, BWD_REL_TOL)
        rel_ref = held(f"fused_ce backward {tname} vs reference", grad, want, BWD_REL_TOL)[1]
        whole[tname] = {"max_abs_err_vs_plain": err, "rel_err_vs_plain": rel,
                        "rel_err_vs_reference": rel_ref,
                        "plain_rel_err_vs_reference": rel_err(plain, want)}
        del plain
    row["backward"] = whole
    out["fused_ce_bwd"] = {"max_abs_err": max(v["max_abs_err_vs_plain"] for v in whole.values())}
    del got, ref
    if timed:
        t = out["fused_ce_bwd"]
        t["ms"] = time_ms(lambda: fc._launch_bwd(x, w, labels, lse, g), 10)
        t["queued_ms"] = time_ms(lambda: fc._launch_bwd(x, w, labels, lse, g), 10,
                                 queued=True)
        t["plain_ms"] = time_ms(lambda: (fc.fused_ce_dx_plain(x, w, labels, lse, g),
                                         fc.fused_ce_dw_plain(x, w, labels, lse, g)), 3, warmup=1)
        lib = bwd_library_calls(x, w, labels, g)
        t["library_ms"], t["library_f32_ms"] = lib["bf16"], lib["f32"]
        t["bound_ms"], t["bound_by"] = bwd_bound_ms(T, D, V, "fused_ce_bwd")
        t["tflops"] = 6.0 * T * D * V / t["ms"] / 1e9
        row["times"] = out
    print(f"kernel fused_ce_bwd {json.dumps(row)}")
    return out


def phase_bwd_kernels(device):
    import torch

    for kernel in BWD_KERNELS:
        print_ptxas(kernel, "fused_ce")
    gen = torch.Generator(device=device).manual_seed(3)

    def inputs(t, d, v, pad_every):
        x = torch.randn(t, d, generator=gen, device=device).to(torch.bfloat16)
        w = (0.02 * torch.randn(d, v, generator=gen, device=device)).to(torch.bfloat16)
        labels = torch.randint(0, v, (t,), generator=gen, device=device)
        if pad_every:
            labels[::pad_every] = -1
        # A non-uniform upstream gradient, 0 on the rows labelled -1.
        g = (0.5 + torch.rand(t, generator=gen, device=device)) / t
        return x, w, labels, torch.where(labels >= 0, g, 0.0)

    # The fused objective's shape: 4*1023 tokens padded to 4096 with label
    # -1 and g=0; the mean gives g=1/4092 on every real row.
    T, D, V = KERNEL_T, KERNEL_D, KERNEL_V
    x, w, labels, _ = inputs(T, D, V, 0)
    labels[-4:] = -1
    g = torch.where(labels >= 0, 1.0 / (T - 4), 0.0)
    bench = check_bwd_case("bench", x, w, labels, g, timed=True)
    errs = [bench]
    errs.append(check_bwd_case("dx_only", x, w, labels, g, timed=False, need=("dx",)))
    errs.append(check_bwd_case("dw_only", x, w, labels, g, timed=False, need=("dw",)))
    del x, w, labels, g
    errs.append(check_bwd_case("vocab_32000", *inputs(*BWD_LARGE_VOCAB, 5), timed=True))
    for name, (t, d, v) in BWD_CASES.items():
        errs.append(check_bwd_case(name, *inputs(t, d, v, 5), timed=False))
    for kernel, row in bench.items():
        row["max_abs_err"] = max(e[kernel]["max_abs_err"] for e in errs if kernel in e)
    return bench


def phase_kernels(device):
    """fused_ce_fwd held to its plain version and the reference at the bench
    shape and vocab 32000 (both timed) and at FWD_CASES, its partials at
    the bench shape; its ptxas report (fatal on a spill). Returns the
    bench shape's row, with max_abs_err the worst loss error over every
    case."""
    import torch

    print_ptxas("fused_ce_fwd", "fused_ce")
    gen = torch.Generator(device=device).manual_seed(0)
    T, D, V = KERNEL_T, KERNEL_D, KERNEL_V

    def inputs(t, d, v, pad_every=0):
        x = torch.randn(t, d, generator=gen, device=device).to(torch.bfloat16)
        w = (0.02 * torch.randn(d, v, generator=gen, device=device)).to(torch.bfloat16)
        labels = torch.randint(0, v, (t,), generator=gen, device=device)
        if pad_every:
            labels[::pad_every] = -1
        return x, w, labels

    x, w, labels = inputs(T, D, V)
    rows = [check_kernel_case("bench", x, w, labels, timed=True)]
    check_fwd_partials("bench", x, w, labels)
    rows.append(check_kernel_case("vocab_1000", *inputs(T, D, 1000), timed=False))
    x, w, labels = inputs(T, D, V)
    labels[::5] = -1
    labels[-4:] = -1  # the token padding evaluate_nll adds at bench width
    rows.append(check_kernel_case("label_minus_one", x, w, labels, timed=False))
    check_fwd_partials("label_minus_one", x, w, labels)
    del x, w, labels
    rows.append(check_kernel_case("vocab_32000", *inputs(*BWD_LARGE_VOCAB, 5), timed=True))
    for name, (t, d, v) in FWD_CASES.items():
        rows.append(check_kernel_case(name, *inputs(t, d, v, 5), timed=False))
    bench = rows[0]
    bench["max_abs_err"] = max(r["max_abs_err_vs_plain"] for r in rows)
    return bench


def flash_flops(shape, kernel: str) -> float:
    """The operations of one flash kernel at ``shape`` [b, h, s, d]: its
    [s x s x d] products over the causal half (the pairs key <= query the
    walk needs)."""
    b, h, s, d = shape
    product = 2.0 * b * h * (s * (s + 1) / 2) * d
    return {"flash_fwd": 2, "flash_dq": 3, "flash_dkv": 4}[kernel] * product


def flash_bound_ms(shape, kernel: str):
    """Least time for one flash kernel at ``shape``: its operations against
    its bytes (inputs read once, outputs written once)."""
    b, h, s, d = shape
    n = b * h * s * d
    rows = 4.0 * b * h * s  # one f32 per row: l, m or di
    nbytes = {
        "flash_fwd": 2.0 * 4 * n + 2 * rows,    # q k v -> o, l, m
        "flash_dq": 2.0 * 5 * n + 3 * rows,     # q k v do l m di -> dq
        "flash_dkv": 2.0 * 6 * n + 3 * rows,    # ... -> dk, dv
    }[kernel]
    t_ops = flash_flops(shape, kernel) / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def sdpa_backend(q, k, v, scale):
    """The first of PyTorch's attention backends, in its own order of
    preference, that takes these inputs: which one the library call ran."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                F.scaled_dot_product_attention(q[:1, :1], k[:1, :1], v[:1, :1],
                                               is_causal=True, scale=scale)
            return backend.name
        except RuntimeError:
            continue
    return "none"


def check_flash_case(name, shape, gen, timed: bool = True):
    """The three flash kernels vs their plain versions, on the same inputs
    and the same saved row statistics, and vs the materializing reference
    (its autograd for the grads); when ``timed``, time each kernel, its
    plain version, one library call and the bound. Returns {kernel:
    {max_abs_err, and when timed: ms, plain_ms, library_ms, bound_ms,
    bound_by}}."""
    import torch
    import torch.nn.functional as F

    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa

    q, k, v, do = (torch.randn(shape, generator=gen, device=gen.device)
                   .to(torch.bfloat16) for _ in range(4))
    scale = float(1.0 / math.sqrt(shape[-1]))
    o, l, m = fa._launch_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    po, pl, pm = fa.flash_fwd_plain(q, k, v, scale)
    di = (po.float() * do.float()).sum(-1)
    dk, dv = fa._launch_bwd(fa.KERNEL_DKV, q, k, v, do, pl, pm, di, scale)
    (dq,) = fa._launch_bwd(fa.KERNEL_DQ, q, k, v, do, pl, pm, di, scale)
    torch.cuda.synchronize()
    pdk, pdv = fa.flash_dkv_plain(q, k, v, do, pl, pm, di, scale)
    pdq = fa.flash_dq_plain(q, k, v, do, pl, pm, di, scale)

    qr, kr, vr = (t.float().requires_grad_() for t in (q, k, v))
    ref = fa.reference_attention(qr, kr, vr, sm_scale=scale)
    ref_grads = torch.autograd.grad(ref, (qr, kr, vr), do.float())
    ref = ref.detach()
    del qr, kr, vr

    def rel(got, want):
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            return float("inf"), float("inf")
        err = float((got - want).abs().max())
        return err, err / float(want.abs().max())

    row = {"case": name, "shape": list(shape)}
    out = {}
    for kernel, pairs in (
            ("flash_fwd", (("o", o, po, ref), ("l", l, pl, None), ("m", m, pm, None))),
            ("flash_dq", (("dq", dq, pdq, ref_grads[0]),)),
            ("flash_dkv", (("dk", dk, pdk, ref_grads[1]), ("dv", dv, pdv, ref_grads[2])))):
        res = {}
        for tname, got, plain, want in pairs:
            err, r = rel(got, plain)
            res[tname] = {"max_abs_err_vs_plain": err, "rel_err_vs_plain": r}
            if want is not None:
                res[tname]["rel_err_vs_reference"] = rel(got, want)[1]
                res[tname]["plain_rel_err_vs_reference"] = rel(plain, want)[1]
            worst = max(r, res[tname].get("rel_err_vs_reference", 0.0))
            if got.shape != plain.shape or worst > FLASH_REL_TOL:
                fail(f"{kernel} {name} {tname}: error vs plain {r:.3e}, vs "
                     f"reference {res[tname].get('rel_err_vs_reference')} of "
                     f"max|value| (tolerance {FLASH_REL_TOL})")
        row[kernel] = res
        out[kernel] = {"max_abs_err": max(x["max_abs_err_vs_plain"] for x in res.values())}
    if timed:
        del ref, ref_grads
        torch.cuda.empty_cache()
        out["flash_fwd"]["ms"] = time_ms(lambda: fa._launch_fwd(q, k, v, scale), 10)
        out["flash_dkv"]["ms"] = time_ms(lambda: fa._launch_bwd(
            fa.KERNEL_DKV, q, k, v, do, pl, pm, di, scale), 10)
        out["flash_dq"]["ms"] = time_ms(lambda: fa._launch_bwd(
            fa.KERNEL_DQ, q, k, v, do, pl, pm, di, scale), 10)
        out["flash_fwd"]["plain_ms"] = time_ms(
            lambda: fa.flash_fwd_plain(q, k, v, scale), 3, warmup=1)
        out["flash_dkv"]["plain_ms"] = time_ms(
            lambda: fa.flash_dkv_plain(q, k, v, do, pl, pm, di, scale), 3, warmup=1)
        out["flash_dq"]["plain_ms"] = time_ms(
            lambda: fa.flash_dq_plain(q, k, v, do, pl, pm, di, scale), 3, warmup=1)
        # One PyTorch call each: SDPA forward; its autograd backward (dq,
        # dk and dv together, the graph kept between runs).
        row["library_backend"] = sdpa_backend(q, k, v, scale)
        fwd_lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, scale=scale), 10)
        ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
        ol = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True, scale=scale)
        bwd_lib = time_ms(lambda: torch.autograd.grad(
            ol, (ql, kl, vl), do, retain_graph=True), 10)
        del ol, ql, kl, vl
        out["flash_fwd"]["library_ms"] = fwd_lib
        out["flash_dkv"]["library_ms"] = out["flash_dq"]["library_ms"] = bwd_lib
        for kernel in ("flash_fwd", "flash_dq", "flash_dkv"):
            t = out[kernel]
            t["bound_ms"], t["bound_by"] = flash_bound_ms(shape, kernel)
            tflops = flash_flops(shape, kernel) / t["ms"] / 1e9
            print(f"flash {kernel} {name} {list(shape)}: cluster "
                  f"{flash_cluster(kernel, shape[-1])}, {t['ms']:.4f} ms, "
                  f"{tflops:.1f} TFLOP/s")
        row["times"] = out
    print(f"kernel flash {json.dumps(row)}")
    return out


def flash_cluster(kernel: str, head_dim: int) -> int:
    """Blocks a thread-block cluster of ``kernel`` has at ``head_dim``, as
    the kernel's C entry point reports it."""
    from k8s_dra_driver_tpu_torch.ops import _build

    return getattr(_build.load(kernel), f"{kernel}_cluster")(head_dim)


def ptxas_report(kernel: str):
    """(entry function, registers line, spills line) for each instantiation
    of ``kernel`` that ptxas compiled in this run."""
    from k8s_dra_driver_tpu_torch.ops import _build

    report, entry, spills = [], "", ""
    for line in _build.BUILD_LOGS.get(kernel, "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line:
            report.append((entry, line.strip().split("info    : ")[-1], spills))
    return report


def print_ptxas(kernel: str, label: str) -> None:
    """Print the ptxas report of ``kernel``'s instantiations; fail on a
    spill."""
    report = ptxas_report(kernel)
    if not report:
        print(f"{label} {kernel} ptxas: library reused, not compiled in this run")
    for entry, regs, spills in report:
        print(f"{label} {kernel} ptxas: {entry}: {regs}; {spills}")
    if any(not spills.startswith("0 bytes stack frame, 0 bytes spill stores")
           for _, _, spills in report):
        fail(f"{kernel}: ptxas reports spills")


def phase_flash_kernels(device):
    """Each flash kernel held to its plain version and to the reference at
    the bench attention shape, the long-sequence shape and the reference's
    numerics-check shape, all three timed, and at FLASH_HEAD_DIMS and
    FLASH_SEQ384_HEAD_DIMS; the ptxas report of each (fatal on a spill) and
    the cluster exchange's share of its time at equal work over
    FLASH_SWEEP_HEAD_DIMS. Returns the bench shape's rows, with max_abs_err
    the worst over every case."""
    import torch

    from k8s_dra_driver_tpu_torch.ops import flash_attention as fa

    for kernel in FLASH_KERNELS:
        print_ptxas(kernel, "flash")
    gen = torch.Generator(device=device).manual_seed(4)
    rows = {name: check_flash_case(name, shape, gen)
            for name, shape in FLASH_SHAPES.items()}
    for d in FLASH_HEAD_DIMS:
        rows[d] = check_flash_case(f"head_dim_{d}", (1, 2, 256, d), gen, timed=False)
    for d in FLASH_SEQ384_HEAD_DIMS:
        rows[f"seq384_{d}"] = check_flash_case(f"seq384_head_dim_{d}", (1, 2, 384, d),
                                               gen, timed=False)
    # What the exchange across a cluster costs: equal work at growing
    # head_dims, against head_dim 128.
    sweep = {}
    for d in FLASH_SWEEP_HEAD_DIMS:
        shape = (4, 2048 // d, 1024, d)
        q, k, v, do = (torch.randn(shape, generator=gen, device=device)
                       .to(torch.bfloat16) for _ in range(4))
        scale = float(1.0 / math.sqrt(d))
        o, l, m = fa._launch_fwd(q, k, v, scale)
        di = (o.float() * do.float()).sum(-1)
        sweep[d] = {"flash_fwd": time_ms(lambda: fa._launch_fwd(q, k, v, scale), 10),
                    "flash_dq": time_ms(lambda: fa._launch_bwd(
                        fa.KERNEL_DQ, q, k, v, do, l, m, di, scale), 10),
                    "flash_dkv": time_ms(lambda: fa._launch_bwd(
                        fa.KERNEL_DKV, q, k, v, do, l, m, di, scale), 10)}
        del q, k, v, do, o, l, m, di
    base = sweep[FLASH_SWEEP_HEAD_DIMS[0]]
    for kernel in FLASH_KERNELS:
        print(f"flash {kernel} exchange at equal work [4, 2048 / d, 1024, d]: " + ", ".join(
            f"d {d} cluster {flash_cluster(kernel, d)} {t[kernel]:.4f} ms share "
            f"{1 - base[kernel] / t[kernel]:.3f}" for d, t in sweep.items()))
    bench = rows["bench"]
    for kernel, row in bench.items():
        row["max_abs_err"] = max(r[kernel]["max_abs_err"] for r in rows.values())
    return bench


def phase_scoring(device, profile_dir):
    import torch

    from k8s_dra_driver_tpu_torch.graft_entry import entry
    from k8s_dra_driver_tpu_torch.models.flagship import (
        SliceProof,
        SliceProofConfig,
        init_params,
    )
    from k8s_dra_driver_tpu_torch.ops import LAUNCHES

    # Small input, two devices: the tiny model's CUDA path (kernel, cuBLAS)
    # against its CPU path (plain version) on the same weights and tokens.
    fn, (tiny_gpu, zeros) = entry()
    with torch.no_grad():
        logits0 = fn(tiny_gpu, zeros)
    tcfg = tiny_gpu.cfg
    if logits0.shape != (2, tcfg.seq_len, tcfg.vocab) or not bool(torch.isfinite(logits0).all()):
        fail(f"entry() forward gave {tuple(logits0.shape)} or non-finite logits")
    tiny_cpu = SliceProof(tcfg, device="cpu")
    tiny_cpu.load_state_dict({k: v.cpu() for k, v in tiny_gpu.state_dict().items()})
    tok = torch.randint(0, tcfg.vocab, (2, tcfg.seq_len),
                        generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        lg, lc = tiny_gpu(tok.to(device)).cpu(), tiny_cpu(tok)
        ng = float(tiny_gpu.evaluate_nll(tok.to(device)))
        nc = float(tiny_cpu.evaluate_nll(tok))
    logit_err = float((lg - lc).abs().max() / lc.abs().max())
    print(f"tiny cuda vs cpu: logits err/max {logit_err:.3e}, evaluate_nll "
          f"{ng:.6f} vs {nc:.6f}")
    if logit_err > 2e-2 or abs(ng - nc) > NLL_RTOL * abs(nc):
        fail("tiny model: CUDA and CPU paths disagree")

    cfg = SliceProofConfig.bench()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"bench model: {cfg}, init {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    gen = torch.Generator(device=device).manual_seed(1)
    batches = [torch.randint(0, cfg.vocab, (SCORE_BATCH, cfg.seq_len),
                             generator=gen, device=device)
               for _ in range(SCORE_BATCHES)]
    torch.cuda.synchronize()

    # The scoring path: counts cleared just before, read just after.
    LAUNCHES.clear()
    nlls, secs = [], []
    with torch.no_grad():
        for tokens in batches:
            t0 = time.perf_counter()
            nll = model.evaluate_nll(tokens)
            nlls.append(float(nll))  # waits for the device
            secs.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    print(f"scoring: evaluate_nll per batch {[round(s * 1e3, 3) for s in secs]} ms, "
          f"nll {nlls}, launches {launches}")
    if launches != {"fused_ce_fwd": SCORE_BATCHES}:
        fail(f"scoring launched {launches} in {SCORE_BATCHES} evaluate_nll "
             f"calls (want fused_ce_fwd once a call, nothing else)")
    if not all(math.isfinite(v) and v > 0 for v in nlls):
        fail(f"evaluate_nll values out of range: {nlls}")

    with torch.no_grad():
        want = float(model.loss_fn(batches[0]))
    print(f"evaluate_nll {nlls[0]:.6f} vs loss_fn {want:.6f} "
          f"(rel {abs(nlls[0] - want) / abs(want):.3e})")
    if abs(nlls[0] - want) > NLL_RTOL * abs(want):
        fail("evaluate_nll disagrees with the materializing loss_fn")

    steady = secs[1:]
    per_batch = sum(steady) / len(steady)
    tokens_per_s = SCORE_BATCH * cfg.seq_len / per_batch
    print(f"scoring: {tokens_per_s:.1f} tokens/s ({SCORE_BATCH}x{cfg.seq_len} "
          f"tokens per batch, {per_batch * 1e3:.3f} ms per batch, first batch "
          f"{secs[0] * 1e3:.3f} ms; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB)")

    if profile_dir:
        with torch.no_grad():
            profile_call(lambda: model.evaluate_nll(batches[0]), "scoring", profile_dir)
    return launches, model, batches[0]


def leaf_errors(names, got, want):
    """Worst (max|got - want| / max|want|, name) over the leaves."""
    import torch

    worst = (0.0, "")
    for name, g, w in zip(names, got, want):
        if not bool(torch.isfinite(g).all()):
            fail(f"grad {name} has non-finite values")
        err = float((g - w).abs().max() / w.abs().max().clamp(min=1e-6))
        worst = max(worst, (err, name))
    return worst


def phase_objective(model, tokens, profile_dir):
    """torch.autograd.grad of evaluate_nll at bench width: the path of the
    backward kernels. Returns the launch counts of that path."""
    import torch

    from k8s_dra_driver_tpu_torch.ops import LAUNCHES
    from k8s_dra_driver_tpu_torch.ops.fused_ce import _bwd_chunks

    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    for _ in range(OBJECTIVE_WARMUP):
        grads = torch.autograd.grad(model.evaluate_nll(tokens), params)
    del grads
    torch.cuda.synchronize()

    # The fused-objective path: counts cleared just before, read just after.
    LAUNCHES.clear()
    secs = []
    for _ in range(OBJECTIVE_CALLS):
        t0 = time.perf_counter()
        grads = torch.autograd.grad(model.evaluate_nll(tokens), params)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    # evaluate_nll pads its batch x (seq - 1) tokens to a multiple of 256.
    cfg = model.cfg
    t_dim = -(-SCORE_BATCH * (cfg.seq_len - 1) // 256) * 256
    chunks = len(_bwd_chunks(t_dim, cfg.vocab))
    want = {"fused_ce_fwd": OBJECTIVE_CALLS,
            **{k: OBJECTIVE_CALLS * chunks for k in BWD_KERNELS}}
    print(f"objective: grad(evaluate_nll) per call {[round(s * 1e3, 3) for s in secs]} "
          f"ms, launches {launches}")
    if launches != want:
        fail(f"{OBJECTIVE_CALLS} grad(evaluate_nll) calls launched {launches}, "
             f"want {want}")

    def loss_fn_grads():
        loss = model.loss_fn(tokens)
        return loss.detach(), torch.autograd.grad(loss, params)

    ref_secs = []
    for _ in range(OBJECTIVE_WARMUP + OBJECTIVE_CALLS):
        t0 = time.perf_counter()
        _, ref = loss_fn_grads()
        torch.cuda.synchronize()
        ref_secs.append(time.perf_counter() - t0)
    worst = leaf_errors(names, grads, ref)
    print(f"objective: grads vs loss_fn grads, worst leaf {worst[1]} at "
          f"{worst[0]:.3e} of max|leaf| (tolerance {GRAD_LEAF_ATOL})")
    if worst[0] > GRAD_LEAF_ATOL:
        fail("grad(evaluate_nll) disagrees with grad(loss_fn)")
    obj_ms = sum(secs) / len(secs) * 1e3
    ref_ms = sum(ref_secs[OBJECTIVE_WARMUP:]) / OBJECTIVE_CALLS * 1e3
    print(f"objective: {obj_ms:.3f} ms a grad(evaluate_nll) call vs {ref_ms:.3f} ms "
          f"for loss_fn value and grad (means of {OBJECTIVE_CALLS} calls after "
          f"{OBJECTIVE_WARMUP} warm-up calls each)")
    if profile_dir:
        profile_call(lambda: torch.autograd.grad(model.evaluate_nll(tokens), params),
                     "objective", profile_dir)
    return launches


def flash_model_like(model, cfg):
    """A SliceProof of ``cfg`` on the card holding ``model``'s weights."""
    from k8s_dra_driver_tpu_torch.models.flagship import SliceProof

    flash = SliceProof(cfg, device=next(model.parameters()).device)
    flash.load_state_dict(model.state_dict())
    return flash


def phase_flash_scoring(device, model, profile_dir):
    """evaluate_nll with attention="flash" at bench width, on the einsum
    model's weights and the scoring phase's batches. Returns the launch
    counts of the flash scoring path."""
    import dataclasses

    import torch

    from k8s_dra_driver_tpu_torch.ops import LAUNCHES

    cfg = dataclasses.replace(model.cfg, attention="flash")
    flash = flash_model_like(model, cfg)
    gen = torch.Generator(device=device).manual_seed(1)  # the scoring batches
    batches = [torch.randint(0, cfg.vocab, (SCORE_BATCH, cfg.seq_len),
                             generator=gen, device=device)
               for _ in range(SCORE_BATCHES)]
    torch.cuda.synchronize()

    # The flash scoring path: counts cleared just before, read just after.
    LAUNCHES.clear()
    nlls, secs = [], []
    with torch.no_grad():
        for tokens in batches:
            t0 = time.perf_counter()
            nlls.append(float(flash.evaluate_nll(tokens)))  # waits for the device
            secs.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    want = {"flash_fwd": cfg.n_layers * SCORE_BATCHES, "fused_ce_fwd": SCORE_BATCHES}
    print(f"flash scoring: evaluate_nll per batch {[round(s * 1e3, 3) for s in secs]} "
          f"ms, nll {nlls}, launches {launches}")
    if launches != want:
        fail(f"flash scoring launched {launches} in {SCORE_BATCHES} evaluate_nll "
             f"calls, want {want}")
    with torch.no_grad():
        einsum = [float(model.evaluate_nll(t)) for t in batches]
    worst = max(abs(a - b) / abs(b) for a, b in zip(nlls, einsum))
    print(f"flash scoring: nll vs einsum {einsum}, worst rel {worst:.3e} "
          f"(tolerance {NLL_RTOL})")
    if not all(math.isfinite(x) for x in nlls) or worst > NLL_RTOL:
        fail("flash evaluate_nll disagrees with the einsum model's")
    per_batch = sum(secs[1:]) / (len(secs) - 1)
    print(f"flash scoring: {SCORE_BATCH * cfg.seq_len / per_batch:.1f} tokens/s "
          f"({per_batch * 1e3:.3f} ms per batch, first batch {secs[0] * 1e3:.3f} ms)")
    if profile_dir:
        with torch.no_grad():
            profile_call(lambda: flash.evaluate_nll(batches[0]), "flash scoring",
                         profile_dir)
    return launches


def phase_flash_training(device, profile_dir):
    """The single-device training step at bench width with attention="flash":
    its first loss and grads held to the einsum model's at the same weights,
    then six steps (one warm-up) and a remat step. Returns the launch
    counts of the six steps."""
    import dataclasses

    import torch

    from k8s_dra_driver_tpu_torch.models.flagship import (
        SliceProofConfig,
        make_sharded_train_step,
        matmul_param_count,
    )
    from k8s_dra_driver_tpu_torch.ops import LAUNCHES

    cfg = dataclasses.replace(SliceProofConfig.bench(), attention="flash")
    step, state, batch = make_sharded_train_step(
        cfg, [device], batch_per_replica=TRAIN_BATCH, seed=0)
    model, tokens = state["params"], batch["tokens"]
    names = [n for n, _ in model.named_parameters()]
    einsum = flash_model_like(model, dataclasses.replace(cfg, attention="einsum"))
    loss_e = einsum.loss_fn(tokens)
    grads_e = torch.autograd.grad(loss_e, list(einsum.parameters()))
    del einsum
    loss_f = model.loss_fn(tokens)
    grads_f = torch.autograd.grad(loss_f, list(model.parameters()))
    loss_e, loss_f = float(loss_e.detach()), float(loss_f.detach())
    worst = leaf_errors(names, grads_f, grads_e)
    del grads_e, grads_f
    print(f"flash training: loss_fn {loss_f:.6f} vs einsum {loss_e:.6f} (rel "
          f"{abs(loss_f - loss_e) / abs(loss_e):.3e}); grads vs einsum, worst leaf "
          f"{worst[1]} at {worst[0]:.3e} of max|leaf| (tolerance {GRAD_LEAF_ATOL})")
    if abs(loss_f - loss_e) > NLL_RTOL * abs(loss_e) or worst[0] > GRAD_LEAF_ATOL:
        fail("the flash model's loss or grads disagree with the einsum model's")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # The flash training path: counts cleared just before, read just after.
    LAUNCHES.clear()
    losses, secs = [], []
    for _ in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))  # waits for the device
        secs.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps = 1 + TRAIN_STEPS
    want = {k: cfg.n_layers * steps for k in ("flash_fwd", "flash_dq", "flash_dkv")}
    print(f"flash training: losses {losses}, step ms {[round(s * 1e3, 3) for s in secs]}, "
          f"launches {launches}")
    if launches != want:
        fail(f"{steps} flash training steps launched {launches}, want {want}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"flash training losses not finite or not falling: {losses}")
    if abs(losses[0] - loss_f) > FIRST_LOSS_RTOL * abs(loss_f):
        fail(f"first flash step loss {losses[0]} != loss_fn at the initial weights {loss_f}")
    n_tok = tokens.numel()
    step_s = sum(secs[1:]) / TRAIN_STEPS
    flops = 6.0 * matmul_param_count(cfg) * n_tok
    print(f"flash training: {step_s * 1e3:.3f} ms a step (mean of {TRAIN_STEPS} after "
          f"the first, which took {secs[0] * 1e3:.3f} ms), {n_tok / step_s:.1f} tokens/s, "
          f"MFU {100 * flops / step_s / PEAK_BF16_FLOPS:.2f}%, peak {peak:.2f} GiB")
    if profile_dir:
        profile_call(lambda: step(state, batch)[1], "flash training step", profile_dir)
    del step, state, batch, loss, model
    torch.cuda.empty_cache()

    step_r, state_r, batch_r = make_sharded_train_step(
        dataclasses.replace(cfg, remat=True), [device],
        batch_per_replica=TRAIN_BATCH, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    LAUNCHES.clear()
    _, loss_r = step_r(state_r, batch_r)
    loss_r = float(loss_r)
    remat_launches = dict(LAUNCHES)
    peak_r = torch.cuda.max_memory_allocated() / 2**30
    print(f"flash training remat: first loss {loss_r} vs plain {losses[0]} (rel "
          f"{abs(loss_r - losses[0]) / abs(losses[0]):.3e}), launches {remat_launches}, "
          f"peak {peak_r:.2f} GiB vs plain {peak:.2f} GiB")
    if remat_launches.get("flash_fwd") != 2 * cfg.n_layers:
        fail(f"the flash remat step launched {remat_launches}: want flash_fwd "
             f"twice a layer (forward and recompute)")
    if abs(loss_r - losses[0]) > REMAT_RTOL * abs(losses[0]):
        fail("the flash remat step's loss differs from the plain step's")
    del step_r, state_r, batch_r
    torch.cuda.empty_cache()
    return launches


def phase_long_sequence(device):
    """One scoring point at seq 8192, batch 1, bench width: flash against
    einsum on the same weights and tokens, tokens/s for both."""
    import dataclasses

    import torch

    from k8s_dra_driver_tpu_torch.models.flagship import SliceProofConfig, init_params
    from k8s_dra_driver_tpu_torch.ops import LAUNCHES

    cfg = dataclasses.replace(SliceProofConfig.bench(), seq_len=LONG_SEQ)
    flash = init_params(dataclasses.replace(cfg, attention="flash"), seed=0)
    einsum = flash_model_like(flash, cfg)
    gen = torch.Generator(device=device).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (1, cfg.seq_len), generator=gen, device=device)
    torch.cuda.synchronize()
    result = {}
    for name, model in (("flash", flash), ("einsum", einsum)):
        with torch.no_grad():
            nll = float(model.evaluate_nll(tokens))  # warm-up
            torch.cuda.reset_peak_memory_stats()
            LAUNCHES.clear()
            t0 = time.perf_counter()
            for _ in range(LONG_CALLS):
                nll = float(model.evaluate_nll(tokens))
            secs = (time.perf_counter() - t0) / LONG_CALLS
        result[name] = (nll, secs, dict(LAUNCHES),
                        torch.cuda.max_memory_allocated() / 2**30)
        print(f"long sequence {name}: seq {cfg.seq_len}, nll {nll:.6f}, "
              f"{secs * 1e3:.3f} ms a call, {cfg.seq_len / secs:.1f} tokens/s, "
              f"launches {result[name][2]} in {LONG_CALLS} calls, peak "
              f"{result[name][3]:.2f} GiB")
    (nf, sf, lf, _), (ne, se, _, _) = result["flash"], result["einsum"]
    print(f"long sequence: flash {se / sf:.3f}x the einsum path's tokens/s, nll rel "
          f"{abs(nf - ne) / abs(ne):.3e} (tolerance {NLL_RTOL})")
    if lf.get("flash_fwd") != cfg.n_layers * LONG_CALLS or abs(nf - ne) > NLL_RTOL * abs(ne):
        fail("long-sequence flash scoring disagrees with einsum or skipped the kernel")


def phase_training(device, profile_dir):
    """The single-device training step at bench width."""
    import dataclasses

    import torch

    from k8s_dra_driver_tpu_torch.models.flagship import (
        SliceProofConfig,
        make_sharded_train_step,
        matmul_param_count,
    )
    from k8s_dra_driver_tpu_torch.ops import LAUNCHES

    cfg = SliceProofConfig.bench()
    step, state, batch = make_sharded_train_step(
        cfg, [device], batch_per_replica=TRAIN_BATCH, seed=0)
    tokens = batch["tokens"]
    with torch.no_grad():
        want0 = float(state["params"].loss_fn(tokens))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # The training path: counts cleared just before, read just after.
    LAUNCHES.clear()
    losses, secs = [], []
    for _ in range(1 + TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))  # waits for the device
        secs.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"training: losses {losses}, step ms {[round(s * 1e3, 3) for s in secs]}, "
          f"launches {launches}")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"training losses not finite or not falling: {losses}")
    if abs(losses[0] - want0) > FIRST_LOSS_RTOL * abs(want0):
        fail(f"first step loss {losses[0]} != loss_fn at the initial weights {want0}")
    n_tok = tokens.numel()
    step_s = sum(secs[1:]) / TRAIN_STEPS
    flops = 6.0 * matmul_param_count(cfg) * n_tok
    print(f"training: {step_s * 1e3:.3f} ms a step (mean of {TRAIN_STEPS} after the "
          f"first, which took {secs[0] * 1e3:.3f} ms), {n_tok / step_s:.1f} tokens/s, "
          f"MFU {100 * flops / step_s / PEAK_BF16_FLOPS:.2f}% (6*N*T = {flops:.4g} "
          f"FLOP, bound {flops / PEAK_BF16_FLOPS * 1e3:.2f} ms), peak {peak:.2f} GiB")
    if profile_dir:
        profile_call(lambda: step(state, batch)[1], "training step", profile_dir)
    del step, state, batch, loss
    torch.cuda.empty_cache()

    cfg_r = dataclasses.replace(cfg, remat=True)
    step_r, state_r, batch_r = make_sharded_train_step(
        cfg_r, [device], batch_per_replica=TRAIN_BATCH, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, loss_r = step_r(state_r, batch_r)
    loss_r = float(loss_r)
    secs_r = time.perf_counter() - t0
    peak_r = torch.cuda.max_memory_allocated() / 2**30
    print(f"training remat: first loss {loss_r} vs plain {losses[0]} (rel "
          f"{abs(loss_r - losses[0]) / abs(losses[0]):.3e}), step {secs_r * 1e3:.3f} ms "
          f"(first step, cold), peak {peak_r:.2f} GiB vs plain {peak:.2f} GiB")
    if abs(loss_r - losses[0]) > REMAT_RTOL * abs(losses[0]):
        fail("the remat step's loss differs from the plain step's")
    return launches


def rmsnorm_bound_ms(x, g):
    """Bytes: x read and y written once, the gain once; operations: about
    four f32 flops an element."""
    nbytes = 2.0 * x.numel() * x.element_size() + g.numel() * g.element_size()
    t_ops, t_bytes = 4.0 * x.numel() / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def matmul_bound_ms(m: int, n: int, k: int, dtype, ffma: bool = False):
    """Operations: one product at the bf16 tensor-core peak; in f32, the
    kernel's three TF32 products at the TF32 peak (``ffma``: one product at
    the FFMA cores' peak instead). Bytes: a, b read and c written once."""
    import torch

    if dtype == torch.bfloat16:
        t_ops = 2.0 * m * n * k / PEAK_BF16_FLOPS
    else:
        t_ops = 2.0 * m * n * k / PEAK_F32_FLOPS if ffma else 6.0 * m * n * k / PEAK_TF32_FLOPS
    size = torch.empty((), dtype=dtype).element_size()
    t_bytes = size * (m * k + k * n + m * n) / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_rmsnorm_case(name, x, g, timed: bool):
    """The rmsnorm kernel vs rmsnorm_plain on the same inputs; when
    ``timed``, the kernel's, plain version's and F.rms_norm's ms (back to
    back, and the kernel's and F.rms_norm's with the L2 emptied) and the
    bound."""
    import torch
    import torch.nn.functional as F

    from k8s_dra_driver_tpu_torch.ops import kernels as ok

    got = ok.rmsnorm(x, g)
    torch.cuda.synchronize()
    plain = ok.rmsnorm_plain(x, g)
    err = float((got.float() - plain.float()).abs().max())
    tol = RMS_TOL[str(x.dtype)]
    if (got.dtype != plain.dtype or got.shape != plain.shape
            or not bool(torch.isfinite(got).all())
            or not bool(torch.isclose(got.float(), plain.float(), **tol).all())):
        fail(f"rmsnorm kernel vs plain, {name}: {got.dtype} {tuple(got.shape)}, "
             f"max abs err {err:.3e} (tolerance {tol})")
    row = {"case": name, "shape": list(x.shape), "x": str(x.dtype), "gain": str(g.dtype),
           "max_abs_err": err}
    if timed:
        d = x.shape[-1]
        row["ms"] = time_ms(lambda: ok.rmsnorm(x, g), 50, queued=True)
        row["plain_ms"] = time_ms(lambda: ok.rmsnorm_plain(x, g), 20, queued=True)
        row["library_ms"] = time_ms(
            lambda: F.rms_norm(x, (d,), g, eps=1e-6), 50, queued=True)
        # Back to back, x and y of the smaller shapes stay in the 50 MB L2
        # (bf16 [4096, 2048]: 33.6 MB); cold, each call reads x from HBM.
        row["cold_ms"] = time_cold_ms(lambda: ok.rmsnorm(x, g), 20)
        row["library_cold_ms"] = time_cold_ms(lambda: F.rms_norm(x, (d,), g, eps=1e-6), 20)
        row["bound_ms"], row["bound_by"] = rmsnorm_bound_ms(x, g)
    print(f"kernel rmsnorm {json.dumps(row)}")
    return row


def check_matmul_case(name, a, b, timed: bool):
    """The tiled_matmul kernel vs tiled_matmul_plain on the same operands
    (strides included); when ``timed``, the kernel's, plain version's and
    torch.matmul's ms and the bound."""
    import torch

    from k8s_dra_driver_tpu_torch.ops import kernels as ok

    got = ok.tiled_matmul(a, b)
    torch.cuda.synchronize()
    plain = ok.tiled_matmul_plain(a, b)
    ct = torch.promote_types(a.dtype, b.dtype)
    err = float((got.float() - plain.float()).abs().max()) if plain.numel() else 0.0
    scale = float(plain.float().abs().max()) if plain.numel() else 0.0
    rel = err / scale if scale else err
    tol = MATMUL_REL_TOL[str(plain.dtype)]  # the output's dtype rounds last
    if (got.dtype != plain.dtype or got.shape != plain.shape
            or not bool(torch.isfinite(got).all()) or rel > tol):
        fail(f"tiled_matmul kernel vs plain, {name}: {got.dtype} {tuple(got.shape)}, "
             f"error {rel:.3e} of max|plain| (tolerance {tol})")
    (m, k), n = a.shape, b.shape[1]
    row = {"case": name, "M": m, "N": n, "K": k, "a": str(a.dtype), "b": str(b.dtype),
           "a_strides": list(a.stride()), "b_strides": list(b.stride()),
           "max_abs_err": err, "rel_err": rel}
    if timed:
        row["ms"] = time_ms(lambda: ok.tiled_matmul(a, b), 10, queued=True)
        row["plain_ms"] = time_ms(lambda: ok.tiled_matmul_plain(a, b), 3, warmup=1,
                                  queued=True)
        row["library_ms"] = time_ms(lambda: torch.matmul(a, b), 10, queued=True)
        row["bound_ms"], row["bound_by"] = matmul_bound_ms(m, n, k, ct)
        if ct == torch.float32:
            row["ffma_bound_ms"] = matmul_bound_ms(m, n, k, ct, ffma=True)[0]
        row["tflops"] = 2.0 * m * n * k / row["ms"] / 1e9
        row["library_tflops"] = 2.0 * m * n * k / row["library_ms"] / 1e9
    print(f"kernel tiled_matmul {json.dumps(row)}")
    return row


def phase_ops_kernels(device):
    """The rmsnorm and tiled_matmul kernels held to their plain versions at
    the standalone ops' bench shapes (timed) and at small, ragged,
    unaligned and empty shapes. Returns the rows of the kernels line's
    shapes (bf16 rmsnorm over [4, 1024, 2048]; the FFN's first product),
    with max_abs_err the worst over every case."""
    import torch

    print_ptxas("rmsnorm", "ops")
    print_ptxas("tiled_matmul", "ops")
    gen = torch.Generator(device=device).manual_seed(6)
    bf, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=device)).to(dtype)

    T, D, FF = OPS_TOKENS, OPS_D, OPS_FF
    rms = []
    for d in RMS_WIDTHS:
        for dt, tag in ((bf, "bf16"), (f32, "f32")):
            name = f"bench_{tag}" if d == D else f"d{d}_{tag}"
            rms.append(check_rmsnorm_case(name, randn(4, T // 4, d, dtype=dt),
                                          randn(d, dtype=dt), True))
    for name, shape, xd, gd in (("64x128", (64, 128), f32, f32),
                                ("3x7x128", (3, 7, 128), f32, bf),
                                ("3x7x128_bf16", (3, 7, 128), bf, f32),
                                ("d129", (33, 129), bf, bf),
                                ("d129_f32", (33, 129), f32, f32),
                                ("d7", (5, 7), bf, f32),
                                ("rows1", (1, D), bf, bf),
                                # lane groups of 4 and 8, a lane's chunks
                                # past the row, the block-a-row kernel
                                ("d8", (11, 8), bf, f32),
                                ("d40", (9, 40), bf, bf),
                                ("d264", (37, 264), bf, f32),
                                ("d2052_f32", (5, 2052), f32, f32)):
        rms.append(check_rmsnorm_case(name, randn(*shape, dtype=xd),
                                      1.0 + randn(shape[-1], dtype=gd, scale=0.1), False))

    h, w1, w2 = randn(T, D), randn(D, FF, scale=0.02), randn(FF, D, scale=0.02)
    g, dy = randn(T, FF), randn(T, FF)
    mm = [check_matmul_case("ffn_w1", h, w1, True),
          check_matmul_case("ffn_w2", g, w2, True),
          check_matmul_case("vjp_dA_dY_w1T", dy, w1.T, True),
          check_matmul_case("vjp_dB_hT_dY", h.T, dy, True)]
    del g, dy
    # f32 in the four orientations the VJP gives, each read in place: b
    # row-major and b = w^T (K-major), a row-major and a = h^T (MN-major).
    a32, b32 = randn(T, D, dtype=f32), randn(D, D, dtype=f32, scale=0.02)
    h32, w32 = randn(D, T, dtype=f32), randn(D, D, dtype=f32, scale=0.02)
    mm += [check_matmul_case("f32", a32, b32, True),
           check_matmul_case("f32_b_wT", a32, w32.T, True),
           check_matmul_case("f32_a_hT", h32.T, b32, True),
           check_matmul_case("f32_a_hT_b_wT", h32.T, w32.T, True)]
    del a32, b32, h32, w32
    mm.append(check_matmul_case(f"f32_long_k_{LONG_K}", randn(512, LONG_K, dtype=f32),
                                randn(LONG_K, 512, dtype=f32), False))
    for dt in (bf, f32):
        mm.append(check_matmul_case(f"13x7x9_ones_{dt}", torch.ones(13, 7, dtype=dt, device=device),
                                    torch.ones(7, 9, dtype=dt, device=device), False))
        mm.append(check_matmul_case(f"1000x999x1001_{dt}", randn(1000, 999, dtype=dt),
                                    randn(999, 1001, dtype=dt), False))
        mm.append(check_matmul_case(f"1000x999x1001_transposed_{dt}", randn(999, 1000, dtype=dt).T,
                                    randn(1001, 999, dtype=dt).T, False))
        # Leading dimensions that are multiples of 8 around ragged extents:
        # read in place, with boxes partly outside the matrix (TMA's zero
        # fill). K = 7, 999 and 1001 above go to the bf16 kernel through
        # the aligned copy, and 7 and 999 to the f32 kernel.
        mm.append(check_matmul_case(f"partial_chunks_{dt}", randn(1000, 1000, dtype=dt)[:, :999],
                                    randn(999, 1008, dtype=dt)[:, :1001], False))
        # M and N not multiples of the 128 x 256 tile (f32: 128 x 128), N a
        # multiple of 8: the bf16 kernel's TMA stores clip both edges of c.
        mm.append(check_matmul_case(f"ragged_tma_store_{dt}", randn(1000, 999, dtype=dt),
                                    randn(999, 1000, dtype=dt), False))
        # A pointer off its 16-byte boundary: the aligned copy.
        mm.append(check_matmul_case(f"unaligned_{dt}", randn(256, 257, dtype=dt)[:, 1:],
                                    randn(256, 384, dtype=dt), False))
        for m, k, n in ((0, 5, 7), (5, 0, 7), (5, 3, 0)):
            mm.append(check_matmul_case(f"empty_{m}x{k}x{n}_{dt}", randn(m, k, dtype=dt),
                                        randn(k, n, dtype=dt), False))
    mm.append(check_matmul_case("mixed_bf16_f32", randn(300, 200), randn(200, 100, dtype=f32),
                                False))
    rms_row = next(r for r in rms if r["case"] == "bench_bf16")
    rms_row["max_abs_err"] = max(r["max_abs_err"] for r in rms)
    mm[0]["max_abs_err"] = max(r["max_abs_err"] for r in mm)
    return {"rmsnorm": rms_row, "tiled_matmul": mm[0]}


def ffn_half_ops(x, ln2, w1, w2):
    """The FFN half of a Block built from the standalone entry points
    alone: x + tiled_matmul(gelu(tiled_matmul(rmsnorm(x, ln2), w1)), w2)."""
    import torch.nn.functional as F

    from k8s_dra_driver_tpu_torch.ops.kernels import rmsnorm, tiled_matmul

    h = tiled_matmul(rmsnorm(x, ln2), w1)
    return x + tiled_matmul(F.gelu(h, approximate="tanh"), w2)


def phase_standalone_ops(device):
    """The whole-op path at bench width: the FFN half of a Block through
    ``ffn_half_ops`` on seed-0 bench weights cast to bf16 and a bf16
    [4096, 2048] row block, forward and torch.autograd.grad to x, ln2, w1
    and w2, held to the model's own ``ffn_half`` (cuBLAS). Returns the
    launch counts of one forward and backward."""
    import torch
    import torch.nn.functional as F

    from k8s_dra_driver_tpu_torch.models.flagship import (
        SliceProofConfig,
        ffn_half,
        init_params,
    )
    from k8s_dra_driver_tpu_torch.ops import LAUNCHES

    model = init_params(SliceProofConfig.bench(), seed=0, device=device)
    layer = model.layers[0]
    leaves = [t.detach().to(torch.bfloat16).requires_grad_()
              for t in (layer.ln2, layer.w1, layer.w2)]
    del model, layer
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(7)
    x = torch.randn(OPS_TOKENS, OPS_D, generator=gen, device=device).to(
        torch.bfloat16).requires_grad_()
    dy = torch.randn(OPS_TOKENS, OPS_D, generator=gen, device=device).to(torch.bfloat16)
    inputs = [x, *leaves]
    names = ["x", "ln2", "w1", "w2"]
    grads = torch.autograd.grad(ffn_half_ops(*inputs), inputs, dy)  # warm-up
    torch.cuda.synchronize()

    # The standalone-ops path: counts cleared just before, read just after.
    LAUNCHES.clear()
    y = ffn_half_ops(*inputs)
    fwd_launches = dict(LAUNCHES)
    grads = torch.autograd.grad(y, inputs, dy)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    print(f"standalone ops: launches forward {fwd_launches}, forward and backward "
          f"{launches}")
    if fwd_launches != {"rmsnorm": 1, "tiled_matmul": 2}:
        fail(f"the FFN half's forward launched {fwd_launches}, want rmsnorm once "
             f"and tiled_matmul twice")
    if launches != {"rmsnorm": 1, "tiled_matmul": 6}:
        fail(f"the FFN half's forward and backward launched {launches}, want "
             f"rmsnorm once and tiled_matmul 2 + 4 times")

    y_ref = ffn_half(*inputs)
    grads_ref = torch.autograd.grad(y_ref, inputs, dy)
    y, y_ref = y.detach().float(), y_ref.detach().float()
    errs = {"y": float((y - y_ref).abs().max() / y_ref.abs().max())}
    for name, got, want in zip(names, grads, grads_ref):
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"grad {name}: {got.dtype} {tuple(got.shape)}, the model's "
                 f"{want.dtype} {tuple(want.shape)}")
        errs[f"d{name}"] = leaf_errors([name], [got.float()], [want.float()])[0]
    print(f"standalone ops: vs the model's ffn_half (cuBLAS), max|err| / max|value| "
          f"{ {k: float(f'{v:.3e}') for k, v in errs.items()} } (tolerance {GRAD_LEAF_ATOL})")
    if not bool(torch.isfinite(y).all()) or max(errs.values()) > GRAD_LEAF_ATOL:
        fail("the FFN half through the standalone ops disagrees with the model's")
    del y_ref, grads_ref, grads

    d = OPS_D
    ln2, w1, w2 = leaves

    def cublas_chain(x, ln2, w1, w2):
        h = F.rms_norm(x, (d,), ln2, eps=1e-6) @ w1
        return x + F.gelu(h, approximate="tanh") @ w2

    times = {}
    for label, fn in (("ops", ffn_half_ops), ("cublas", cublas_chain)):
        with torch.no_grad():
            times[f"{label}_forward_ms"] = time_ms(lambda: fn(*inputs), 10)
        out = fn(*inputs)
        times[f"{label}_backward_ms"] = time_ms(
            lambda: torch.autograd.grad(out, inputs, dy, retain_graph=True), 10)
        del out
    print(f"standalone ops: FFN half at [{OPS_TOKENS}, {OPS_D}] x d_ff {OPS_FF}, "
          f"{json.dumps(times)}")
    return launches


def profile_call(fn, label, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernel rows only: an aten op's row repeats the time of its kernels.
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in prof.key_averages() if e.device_type.name == "CUDA"),
                     reverse=True)
    busy_ms = sum(t for t, _, _ in kernels) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    fname = f"chip_smoke_profile_{label.replace(' ', '_')}.txt"
    with open(os.path.join(out_dir, fname), "w") as f:
        f.write(table)
    print(f"profile {label}: wall {wall * 1e3:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / (wall * 1e3):.3f}")
    for t, key, count in kernels[:16]:
        print(f"profile {label}:   {t / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="trace one scoring batch, one grad(evaluate_nll) call "
                             "and one training step and write the tables to DIR")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from k8s_dra_driver_tpu_torch import resolve_device
        from k8s_dra_driver_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here: {exc}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = resolve_device(None)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 1. build
    secs = _build.build_all()
    print(f"build: {secs:.2f} s into {_build.build_dir()}")
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"build {name}: {line.strip()}")

    # 2. kernels vs plain
    bench = phase_kernels(device)
    bwd = phase_bwd_kernels(device)
    flash = phase_flash_kernels(device)
    ops = phase_ops_kernels(device)

    # 3-9. the main paths
    launches, model, tokens = phase_scoring(device, args.profile)
    obj_launches = phase_objective(model, tokens, args.profile)
    phase_flash_scoring(device, model, args.profile)
    del model
    torch.cuda.empty_cache()
    phase_training(device, args.profile)
    flash_launches = phase_flash_training(device, args.profile)
    phase_long_sequence(device)
    ops_launches = phase_standalone_ops(device)

    # 10. device
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")

    kernels = [{
        "name": "fused_ce_fwd",
        "route": "cuda",
        "source": "k8s_dra_driver_tpu_torch/ops/csrc/fused_ce_fwd.cu",
        "replaces": "k8s_dra_driver_tpu/ops/fused_ce.py:50",
        "launches": launches.get("fused_ce_fwd", 0),
        "max_abs_err": bench["max_abs_err"],
        "ms": bench["ms"],
        "plain_ms": bench["plain_ms"],
        "bound_ms": bench["bound_ms"],
        "bound_by": bench["bound_by"],
        "library_ms": bench["library_ms"],
        "library_call": "F.cross_entropy((x @ w).float()) on the bf16 operands",
        "library_f32_ms": bench["library_f32_ms"],
        "tflops": bench["tflops"],
    }]
    # fused_ce_p replaces the logits recompute of both TPU backward kernels;
    # times are summed over a backward's chunks, and each library call
    # computes the kernel's function over the whole vocab on the same bf16
    # operands.
    for name, line, call in (
            ("fused_ce_p", "127,153", "torch.exp((x @ w).float() - lse), the label's "
                                      "1 taken off, times g, to bf16"),
            ("fused_ce_dx", 119, "torch.matmul(p, w.T) on the kernels' bf16 p"),
            ("fused_ce_dw", 144, "torch.matmul(x.T, p) on the kernels' bf16 p")):
        row = bwd[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"k8s_dra_driver_tpu_torch/ops/csrc/{name}.cu",
            "replaces": f"k8s_dra_driver_tpu/ops/fused_ce.py:{line}",
            "launches": obj_launches.get(name, 0),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_call": call,
        })
    # The library Pallas kernels, jax 0.9.0's flash_attention.py.
    lib = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    for name, line, call in (
            ("flash_fwd", 342, "F.scaled_dot_product_attention, is_causal"),
            ("flash_dq", 1146, "autograd backward of F.scaled_dot_product_attention, "
                               "dq, dk and dv together"),
            ("flash_dkv", 796, "autograd backward of F.scaled_dot_product_attention, "
                               "dq, dk and dv together")):
        row = flash[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"k8s_dra_driver_tpu_torch/ops/csrc/{name}.cu",
            "replaces": f"{lib}:{line}",
            "launches": flash_launches.get(name, 0),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_call": call,
        })
    for name, src_line, call in (("rmsnorm", 40, "F.rms_norm"),
                                 ("tiled_matmul", 121, "torch.matmul")):
        row = ops[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"k8s_dra_driver_tpu_torch/ops/csrc/{name}.cu",
            "replaces": f"k8s_dra_driver_tpu/ops/kernels.py:{src_line}",
            "launches": ops_launches.get(name, 0),
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_call": call,
        })
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
