#!/usr/bin/env python3
"""Time the hand kernels of two checkouts of the port in one run on one
CUDA card, with one statistic for both: the paged-decode kernel (B3),
the flash-attention forward (B1) and backward (B2), and the fused
residual+norm (B4).

    python3 tools/kernel_ab.py OLD_ROOT NEW_ROOT

Each root is a directory that holds a ``tensorlink_tpu_torch`` package
and its ``chip_smoke.py`` (the repository root, or an unpacked
``git archive`` of an older commit). The roots run in turns, old, new,
new, old, each in a process of its own that imports the package and
``chip_smoke.py`` from its root, builds its kernels there, makes every
case's inputs with that root's ``chip_smoke`` builders from the same
seed, and times the case: B3 at the decode steps' form (T 1, B 8,
mixed lengths, with and without a validity mask) and at T 128 (eight
rows, and the prefill chunk's one row of 1503 keys); B2 at BERT-base's
training shape, Llama-3-8B's causal shape and a causal window of 256;
B1 at the same three shapes; B4 at the decode step's 8 rows x 4096 in
bf16, RMSNorm and LayerNorm with a bias. Each time is the mean and the
median of 20 launches, each timed with CUDA events after an L2 flush.
For B4 it also reports the host microseconds per wrapper call, ten
samples a turn: each the host clock over 200 calls enqueued behind a
~50 ms device sleep, so the launch queue never blocks. Prints one JSON line per process, then one
per case with each root's mean and median over its two turns, and the
card's name and power limit.
"""

import json
import os
import subprocess
import sys

PAGED_CASES = ((1, "mixed"), (1, "mask"), (128, "mixed"), (128, "one_row"))
FLASH_CASES = ("bert", "llama", "window")
NORM_CASES = (("rms", False), ("layer", True))  # 8 rows x 4096, bf16
HOST_CALLS, HOST_SAMPLES = 200, 10


def time_runs(fn, flush, iters: int = 20) -> list[float]:
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return times


def host_us(fn) -> list[float]:
    """HOST_SAMPLES samples of the host microseconds per call of ``fn``,
    each over HOST_CALLS calls enqueued behind a long device sleep."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(HOST_SAMPLES):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        samples.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return samples


def one_root(root: str) -> dict:
    """Every case's launch times (ms) with the kernels of ``root``, and B4's
    host us per call."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from tensorlink_tpu_torch.ops.decode_glue import fused_residual_norm
    from tensorlink_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_fwd_lse,
        flash_attention_fwd_lse_reference,
    )
    from tensorlink_tpu_torch.ops.paged_decode import paged_decode_attention

    flush = cs.L2Flush()
    out = {}
    for T, case in PAGED_CASES:
        args, kwargs = cs._paged_inputs(torch.Generator().manual_seed(1), T, case)
        out[f"B3 {case} T={T}"] = time_runs(
            lambda: paged_decode_attention(*args, **kwargs), flush)
    for name in FLASH_CASES:
        B, H, Hkv, T, D, causal, window, mask = cs.FLASH_CASES[name]
        q, k, v, do, kv = cs._flash_inputs(
            torch.Generator().manual_seed(5), B, H, Hkv, T, D, mask)
        kw = {"causal": causal, "window": window}
        o, lse = flash_attention_fwd_lse_reference(q, k, v, kv, **kw)
        out[f"B1 {name}"] = time_runs(
            lambda: flash_attention_fwd_lse(q, k, v, kv, **kw), flush)
        out[f"B2 {name}"] = time_runs(
            lambda: flash_attention_bwd(q, k, v, o, lse, do, kv, **kw), flush)
    g = torch.Generator().manual_seed(2)
    for kind, with_bias in NORM_CASES:
        x, res = (torch.randn((8, 4096), generator=g).to("cuda", torch.bfloat16)
                  for _ in range(2))
        scale = (1 + 0.1 * torch.randn(4096, generator=g)).to("cuda")
        bias = (0.1 * torch.randn(4096, generator=g)).to("cuda") if with_bias else None

        def call(x=x, res=res, scale=scale, bias=bias, kind=kind):
            return fused_residual_norm(x, res, scale, bias, eps=1e-5, kind=kind)

        out[f"B4 {kind} 8x4096"] = time_runs(call, flush)
        out[f"B4 {kind} 8x4096 host_us"] = host_us(call)
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(one_root(sys.argv[2])), flush=True)  # noqa: T201
        return 0
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)  # noqa: T201
        return 2
    import numpy as np

    roots = {"old": os.path.abspath(sys.argv[1]),
             "new": os.path.abspath(sys.argv[2])}
    runs = {"old": [], "new": []}
    for tag in ("old", "new", "new", "old"):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", roots[tag]],
            capture_output=True, text=True, cwd=roots[tag],
        )
        if res.returncode != 0:
            print(res.stdout, res.stderr, file=sys.stderr)  # noqa: T201
            return 1
        times = json.loads(res.stdout.strip().splitlines()[-1])
        runs[tag].append(times)
        print(json.dumps({"turn": tag, "root": roots[tag], "mean_ms": {
            c: float(np.mean(t)) for c, t in times.items()}}), flush=True)  # noqa: T201
    for case in runs["new"][0]:
        row = {"case": case}
        for tag in ("old", "new"):
            t = np.concatenate([r[case] for r in runs[tag]])
            row[tag] = {"mean_ms": float(t.mean()), "median_ms": float(np.median(t)),
                        "turn_means_ms": [float(np.mean(r[case])) for r in runs[tag]]}
        row["old_over_new_mean"] = row["old"]["mean_ms"] / row["new"]["mean_ms"]
        print(json.dumps(row), flush=True)  # noqa: T201
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)  # noqa: T201
    return 0


if __name__ == "__main__":
    sys.exit(main())
