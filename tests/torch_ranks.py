"""Spawned gloo ranks for the PyTorch port's multi-rank tests.

``spawn_cpu_ranks(fn, world, *args, store_dir=...)`` runs
``fn(rank, world, *args)`` in ``world`` spawned processes joined into one
gloo group through ``initialize_distributed`` over a ``FileStore`` in
``store_dir``: no port, so any number of such jobs (one per pytest-xdist
worker) run at once. Each rank runs one thread.

Top level: torch and the port only. The spawned children import this
module and the test module that holds ``fn``, so neither may import JAX
at its top level.
"""

import os
import time

import torch

from tensorlink_tpu_torch.config import DistributedConfig
from tensorlink_tpu_torch.runtime.mesh import initialize_distributed, shutdown_distributed


def _rank_main(rank: int, fn, world: int, store: str, args: tuple) -> None:
    torch.set_num_threads(1)
    initialize_distributed(DistributedConfig(coordinator=f"file://{store}",
                                             num_processes=world, process_id=rank),
                           device="cpu")
    try:
        fn(rank, world, *args)
    finally:
        shutdown_distributed()


def spawn_cpu_ranks(fn, world: int, *args, store_dir: str,
                    timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned gloo ranks.
    ``fn`` must be importable (a module-level function). Raises if a rank
    raises or the job outlives ``timeout_s`` (its processes are then
    terminated)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(
        _rank_main, args=(fn, world, os.path.join(store_dir, "store"), args),
        nprocs=world, start_method="spawn", join=False)
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            raise TimeoutError(f"{world} ranks did not finish in {timeout_s} s")
