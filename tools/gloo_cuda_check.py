#!/usr/bin/env python3
"""Check that gloo carries the collectives of CUDA tensors between two
processes that share one CUDA card, as ``chip_smoke.py``'s two-rank
tensor-parallel legs need (NCCL takes one rank a device), and time one.

    python3 tools/gloo_cuda_check.py

Spawns two ranks on cuda:0 joined over gloo with a file-store
rendezvous (no port). Each runs ``all_reduce``, ``all_gather`` and
``broadcast`` on bf16, f32 and int64 CUDA tensors and
``all_gather_into_tensor`` on int64, then the two calls sequence
parallelism moves its blocks with (``parallel/sp.py``): one
``batch_isend_irecv`` swap with the other rank and one
``all_to_all_single``, each on bf16 and f32 CUDA tensors, each checked
against the values the other rank sent, each call in a job of its own
(gloo aborts a process that hands it a CUDA pointer it cannot write).
The first job also times 20 all-reduces of 8 x 4096 bf16 (one decode
step's hidden state at Llama-3-8B's width) after 3 warm-up calls. Rank 0
prints one JSON line: each dtype's result (or the error it raised) and
the mean microseconds of the timed all-reduce; then one line with each
probe's result and ``"gloo_carries"`` (the calls whose CUDA tensors
arrived whole); then the card's name and power limit. Exits non-zero
without CUDA.
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


def _probe(rank: int, world: int, store: str, name: str, result: str) -> None:
    """One call of sequence parallelism on bf16 then f32 CUDA tensors, in
    a job of its own: gloo aborts the process (it cannot catch) where it
    writes a CUDA pointer to its socket."""
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        call = {"batch_isend_irecv": _swap, "all_to_all_single": _all_to_all}[name]
        got = {str(dt): call(rank, world, dt)
               for dt in (torch.bfloat16, torch.float32)}
        torch.cuda.synchronize()
        if rank == 0:
            with open(result, "w") as f:
                json.dump(got, f)
    finally:
        dist.destroy_process_group()


def _carried(d: str, name: str) -> dict:
    """-> {dtype: "equal" | "wrong values"} or {"error": why the job died}."""
    result = os.path.join(d, f"{name}.json")
    try:
        mp.start_processes(_probe, args=(2, os.path.join(d, f"store-{name}"),
                                         name, result),
                           nprocs=2, start_method="spawn", join=True)
    except Exception as e:  # noqa: BLE001 - a rank killed by gloo's abort
        return {"error": repr(e)[:300]}
    with open(result) as f:
        return {k: "equal" if ok else "wrong values" for k, ok in json.load(f).items()}


def _swap(rank: int, world: int, dt) -> bool:
    """One batch_isend_irecv: send to rank - 1, receive from rank + 1."""
    x = torch.arange(64, dtype=dt, device="cuda") + 100 * rank
    y = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (rank - 1) % world),
           dist.P2POp(dist.irecv, y, (rank + 1) % world)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    want = torch.arange(64, dtype=dt, device="cuda") + 100 * ((rank + 1) % world)
    return bool(torch.equal(y, want))


def _all_to_all(rank: int, world: int, dt) -> bool:
    """One all_to_all_single of [world, 32]: row j goes to rank j."""
    x = (torch.arange(32, dtype=dt, device="cuda")[None, :]
         + 10 * torch.arange(world, device="cuda")[:, None].to(dt) + 1000 * rank)
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    want = (torch.arange(32, dtype=dt, device="cuda")[None, :] + 10 * rank
            + 1000 * torch.arange(world, device="cuda")[:, None].to(dt))
    return bool(torch.equal(y, want))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)  # noqa: T201
        return 1
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(_rank, args=(2, os.path.join(d, "store")), nprocs=2,
                           start_method="spawn", join=True)
        probes = {name: _carried(d, name)
                  for name in ("batch_isend_irecv", "all_to_all_single")}
    carries = [n for n, r in probes.items()
               if set(r.values()) == {"equal"}]
    print(json.dumps({"probes": probes, "gloo_carries": carries}))  # noqa: T201
    print(subprocess.run(  # noqa: T201
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
