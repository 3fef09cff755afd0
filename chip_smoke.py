#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile DIR]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
It imports the port only (never JAX) and fails with a non-zero exit code,
printing no result, when there is no card or no port beside it.

Phases, each fatal on failure:
 1. build: compile every CUDA source of the port with nvcc (sm_90a);
 2. kernels: hold each kernel to its plain PyTorch version (and the
    materializing reference) on the card at the shapes the main path gives
    it, and time kernel, plain version, one library call and the bound;
 3. scoring: the main path. SliceProof at the full width of
    SliceProofConfig.bench() with seeded random weights scores a few
    batches of 4x1024 tokens through evaluate_nll, with the launch counts
    cleared just before and read just after; the NLL is checked against
    the materializing loss_fn, and a tiny() model against itself on the CPU;
 4. device: the card's name and power limit from nvidia-smi.

The last three lines of standard output are the kernels' JSON record, the
nvidia-smi line and ``{"ok": true, "device": {...}}``. ``--profile DIR``
also traces one scoring batch with torch.profiler and writes the table of
device time by kernel to DIR.
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

SCORE_BATCH, SCORE_BATCHES = 4, 4
# Kernel vs plain version: both sum the same exact bf16 products in f32,
# in another order over D=2048 terms; the exp/log of the fold add ~1e-6
# relative on losses of ~9.
KERNEL_ATOL, KERNEL_RTOL = 1e-3, 1e-4
# evaluate_nll vs the materializing loss_fn at bench width: the repo's bf16
# tolerance (bench.py, check_fused_ce_numerics); the logits of loss_fn are
# rounded to bf16, the kernel's are not.
NLL_RTOL = 2e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel_case(name, x, w, labels, timed: bool):
    """Kernel vs plain version (and the materializing reference where every
    label is a class). Returns the max abs error and, when ``timed``, the
    kernel's, plain version's and library call's ms."""
    import torch
    import torch.nn.functional as F

    from k8s_dra_driver_tpu_torch.ops.fused_ce import (
        fused_ce_losses,
        fused_ce_losses_plain,
        reference_ce_losses,
    )

    got = fused_ce_losses(x, w, labels)
    torch.cuda.synchronize()
    plain = fused_ce_losses_plain(x, w, labels)
    err = float((got - plain).abs().max())
    bad = ~torch.isclose(got, plain, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    if got.shape != labels.shape or not bool(torch.isfinite(got).all()) or bool(bad.any()):
        fail(f"fused_ce kernel vs plain, {name}: max abs err {err:.3e}, "
             f"{int(bad.sum())} rows outside tolerance")
    real = labels >= 0
    if bool(real.all()):
        ref = reference_ce_losses(x, w, labels)
    else:  # a label of -1 matches no class: the loss is the logsumexp
        logits = x.float() @ w.float()
        ref = torch.logsumexp(logits, dim=1)
        ref[real] = reference_ce_losses(x[real], w, labels[real])
    ref_err = float((got - ref).abs().max())
    if not bool(torch.isclose(got, ref, rtol=KERNEL_RTOL, atol=KERNEL_ATOL).all()):
        fail(f"fused_ce kernel vs reference, {name}: max abs err {ref_err:.3e}")
    row = {"case": name, "T": x.shape[0], "D": x.shape[1], "V": w.shape[1],
           "max_abs_err_vs_plain": err, "max_abs_err_vs_reference": ref_err}
    if timed:
        row["ms"] = time_ms(lambda: fused_ce_losses(x, w, labels), 20)
        row["plain_ms"] = time_ms(lambda: fused_ce_losses_plain(x, w, labels), 5)
        row["library_ms"] = time_ms(lambda: F.cross_entropy(
            x.float() @ w.float(), labels, reduction="none"), 5)
    print(f"kernel fused_ce_fwd {json.dumps(row)}")
    return row


def bound_ms(T: int, D: int, V: int):
    flops = 2.0 * T * D * V
    # x and w in bf16, int32 labels read once; lse and picked f32 written.
    nbytes = 2.0 * (T * D + D * V) + 4.0 * T + 8.0 * T
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_kernels(device):
    import torch

    gen = torch.Generator(device=device).manual_seed(0)
    T, D, V = 4096, 2048, 8192  # evaluate_nll at bench: 4*1023 tokens pad to 4096

    def inputs(t, d, v):
        x = torch.randn(t, d, generator=gen, device=device).to(torch.bfloat16)
        w = (0.02 * torch.randn(d, v, generator=gen, device=device)).to(torch.bfloat16)
        labels = torch.randint(0, v, (t,), generator=gen, device=device)
        return x, w, labels

    rows = [check_kernel_case("bench", *inputs(T, D, V), timed=True)]
    rows.append(check_kernel_case("vocab_1000", *inputs(T, D, 1000), timed=False))
    x, w, labels = inputs(T, D, V)
    labels[::5] = -1
    labels[-4:] = -1  # the token padding evaluate_nll adds at bench width
    rows.append(check_kernel_case("label_minus_one", x, w, labels, timed=False))
    # V % 8 != 0 takes the element-wise loader instead of cp.async.
    rows.append(check_kernel_case("vocab_1001", *inputs(512, D, 1001), timed=False))
    return rows


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
    logit_err = float((lg - lc).abs().max() / lc.abs().max())
    ng = float(tiny_gpu.evaluate_nll(tok.to(device)))
    nc = float(tiny_cpu.evaluate_nll(tok))
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

    # The main path: counts cleared just before, read just after.
    LAUNCHES.clear()
    nlls, secs = [], []
    for tokens in batches:
        t0 = time.perf_counter()
        nll = model.evaluate_nll(tokens)
        nlls.append(float(nll))  # waits for the device
        secs.append(time.perf_counter() - t0)
    launches = dict(LAUNCHES)
    print(f"scoring: evaluate_nll per batch {[round(s * 1e3, 3) for s in secs]} ms, "
          f"nll {nlls}, launches {launches}")
    if launches.get("fused_ce_fwd", 0) != SCORE_BATCHES:
        fail(f"fused_ce_fwd launched {launches.get('fused_ce_fwd', 0)} times in "
             f"{SCORE_BATCHES} evaluate_nll calls")
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
        profile_batch(model, batches[0], profile_dir)
    return launches


def profile_batch(model, tokens, out_dir):
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    model.evaluate_nll(tokens)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model.evaluate_nll(tokens)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Kernel rows only: an aten op's row repeats the time of its kernels.
    kernels = sorted(((e.self_device_time_total, e.key, e.count)
                      for e in prof.key_averages() if e.device_type.name == "CUDA"),
                     reverse=True)
    busy_ms = sum(t for t, _, _ in kernels) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=40)
    with open(os.path.join(out_dir, "chip_smoke_profile.txt"), "w") as f:
        f.write(table)
    print(f"profile: wall {wall * 1e3:.3f} ms, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / (wall * 1e3):.3f}")
    for t, key, count in kernels[:12]:
        print(f"profile:   {t / 1e3:9.3f} ms  x{count:<4d} {key[:90]}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", metavar="DIR",
                        help="trace one scoring batch and write the table to DIR")
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
    rows = phase_kernels(device)

    # 3. the main path
    launches = phase_scoring(device, args.profile)

    # 4. device
    smi = subprocess.run(
        ["nvidia-smi", "-i", str(torch.cuda.current_device()),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")

    bench = rows[0]
    b_ms, b_by = bound_ms(bench["T"], bench["D"], bench["V"])
    kernels = [{
        "name": "fused_ce_fwd",
        "route": "cuda",
        "source": "k8s_dra_driver_tpu_torch/ops/csrc/fused_ce_fwd.cu",
        "replaces": "k8s_dra_driver_tpu/ops/fused_ce.py:50",
        "launches": launches.get("fused_ce_fwd", 0),
        "max_abs_err": max(r["max_abs_err_vs_plain"] for r in rows),
        "ms": bench["ms"],
        "plain_ms": bench["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": bench["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
