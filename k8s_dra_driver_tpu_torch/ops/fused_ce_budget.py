"""Time the fused-CE backward at several p_c budgets on one CUDA card.

    python -m k8s_dra_driver_tpu_torch.ops.fused_ce_budget [--mb 16 32 64]
        [--vocab 8192]

For each budget, ``fused_ce.P_BUDGET`` is set to it and the whole CUDA
backward (``fused_ce._launch_bwd``, dx and dw) runs on seeded random bf16
inputs: its chunk count and its device ms, a mean of 10 calls after 2 (CUDA
events), back to back. The shape is the flagship's bench shape (4096
tokens, d_model 2048) with vocab 8192, where ``fused_ce.P_BUDGET`` was
chosen, or ``--vocab``. Prints one JSON line with the card's name and
power limit as ``nvidia-smi`` gives them. Exits 2 without a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from k8s_dra_driver_tpu_torch.ops import fused_ce

# The fused CE's tokens and d_model at SliceProofConfig.bench() width:
# 4 x 1023 scored tokens padded to 4096.
TOKENS, D_MODEL = 4096, 2048


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms a call of ``fn``, mean of ``iters`` after ``warmup``."""
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


def sweep(tokens: int, d_model: int, vocab: int, budgets_mb) -> dict:
    """{budget in MB: {"chunks", "ms"}} of the whole backward at the shape."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(tokens, d_model, generator=gen, device="cuda").to(torch.bfloat16)
    w = (0.02 * torch.randn(d_model, vocab, generator=gen, device="cuda")).to(torch.bfloat16)
    labels = torch.randint(0, vocab, (tokens,), generator=gen, device="cuda")
    lse = torch.logsumexp(x.float() @ w.float(), dim=1)
    g = torch.full((tokens,), 1.0 / tokens, device="cuda")
    chosen = fused_ce.P_BUDGET
    out = {}
    try:
        for mb in budgets_mb:
            fused_ce.P_BUDGET = mb * 2 ** 20
            out[mb] = {"chunks": len(fused_ce._bwd_chunks(tokens, vocab)),
                       "ms": time_ms(lambda: fused_ce._launch_bwd(x, w, labels, lse, g))}
    finally:
        fused_ce.P_BUDGET = chosen
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--mb", type=int, nargs="+", default=[16, 32, 64])
    parser.add_argument("--vocab", type=int, default=8192)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("fused_ce_budget: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    result = sweep(TOKENS, D_MODEL, args.vocab, args.mb)
    print(json.dumps({"card": smi.stdout.strip().splitlines()[0] if smi.stdout else None,
                      "T": TOKENS, "D": D_MODEL, "V": args.vocab,
                      "chosen_mb": fused_ce.P_BUDGET / 2 ** 20, "budgets": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
