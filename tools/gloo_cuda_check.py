#!/usr/bin/env python3
"""Check that gloo carries the collectives of CUDA tensors between two
processes that share one CUDA card, as ``chip_smoke.py``'s two-rank
tensor-parallel legs need (NCCL takes one rank a device), and time one.

    python3 tools/gloo_cuda_check.py

Spawns two ranks on cuda:0 joined over gloo with a file-store
rendezvous (no port). Each runs ``all_reduce``, ``all_gather`` and
``broadcast`` on bf16, f32 and int64 CUDA tensors and
``all_gather_into_tensor`` on int64, then times 20 all-reduces of 8 x
4096 bf16 (one decode step's hidden state at Llama-3-8B's width) after 3
warm-up calls. Rank 0 prints one JSON line: each dtype's result (or the
error it raised) and the mean microseconds of the timed all-reduce; then
the card's name and power limit. Exits non-zero without CUDA.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, world: int, store: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        out = {}
        for dt in (torch.bfloat16, torch.float32, torch.int64):
            try:
                x = torch.full((4, 8), rank + 1, dtype=dt, device="cuda")
                dist.all_reduce(x)
                parts = [torch.empty_like(x) for _ in range(world)]
                dist.all_gather(parts, x)
                y = torch.full((3,), rank, dtype=dt, device="cuda")
                dist.broadcast(y, src=world - 1)
                torch.cuda.synchronize()
                out[str(dt)] = {"all_reduce": float(x[0, 0]),
                                "all_gather": [float(p[0, 0]) for p in parts],
                                "broadcast": float(y[0])}
            except RuntimeError as e:
                out[str(dt)] = {"error": repr(e)[:300]}
        x = torch.full((2,), rank, dtype=torch.int64, device="cuda")
        o = torch.empty(2 * world, dtype=torch.int64, device="cuda")
        dist.all_gather_into_tensor(o, x)
        out["all_gather_into_tensor"] = o.tolist()
        x = torch.ones(8 * 4096, dtype=torch.bfloat16, device="cuda")
        for _ in range(3):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        out["all_reduce_8x4096_bf16_us"] = (time.perf_counter() - t0) / 20 * 1e6
        if rank == 0:
            print(json.dumps(out), flush=True)  # noqa: T201
    finally:
        dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)  # noqa: T201
        return 1
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(2, os.path.join(d, "store")), nprocs=2,
                           start_method="spawn", join=True)
    print(subprocess.run(  # noqa: T201
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
