"""Captured decode work: the port's counterpart of ``jax.jit``'s program
cache and of donating the serving state.

``GraphCache.run(key, body)`` runs ``body`` (a function of no arguments
that reads and writes only preallocated device tensors, in place) as a
``torch.cuda.CUDAGraph`` replay. ``key`` holds every host value the body
bakes in (the shapes and host bounds it reads); the first call with a key
runs the body eagerly on a side stream (the warm-up, which is that call's
real work and also builds and loads the kernels' libraries and sets their
attributes), then captures it into the engine's one graph pool without
running it. Later calls with the key replay the graph.

The kernel wrappers count launches on the host, where they launch. A
replay runs no Python, and a capture launches nothing, so the cache takes
the capture's counter increments back out and credits them again on
every replay: the counters keep meaning "kernels that ran".

On the CPU (or with ``enabled=False``) the body simply runs: the CPU has
no graphs, so this is the device's path and not a fallback. On CUDA a
failed capture or replay raises.

Under a mesh (``InferenceEngine(mesh=)``) a body runs the model's
tensor-parallel collectives. A group of size 1 skips them, so at world 1
the captured body is the one-device body, and capture never touches the
NCCL communicator the mesh formed. Capture of NCCL collectives at world
> 1 is allowed but unmeasured (one card); a gloo group of size > 1
refuses capture (``check_capture_backend``). Replays credit the
``parallel.tp`` helpers' collective counts as they credit launches.

``run(key, body, after=)`` calls ``after`` once the call's device work
is enqueued on the current stream: after the replay, or after a first
call's warm-up and before its capture (which runs nothing, but holds
the host for up to a second). A timing event recorded there brackets
the work and not the capture.
"""

from __future__ import annotations

import time

import torch

from tensorlink_tpu_torch.ops.decode_glue import fused_residual_norm
from tensorlink_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_fwd_lse,
)
from tensorlink_tpu_torch.ops.paged_decode import paged_decode_attention
from tensorlink_tpu_torch.parallel import tp

# the kernel wrappers and the launch counters each keeps (an int, or a
# dict of ints by variant / form), and the tensor-parallel helpers'
# collective counts
COUNTED = (paged_decode_attention, fused_residual_norm,
           flash_attention_fwd_lse, flash_attention_bwd) + tp._COUNTED
COUNTER_ATTRS = ("launches", "launches_by_variant", "launches_by_form",
                 "collectives")


def counter_snapshot(fns=COUNTED) -> dict:
    """-> {(wrapper, attribute, key or None): count} of every counter."""
    snap = {}
    for fn in fns:
        for attr in COUNTER_ATTRS:
            val = getattr(fn, attr, None)
            if isinstance(val, dict):
                snap.update(((fn, attr, k), n) for k, n in val.items())
            elif val is not None:
                snap[(fn, attr, None)] = val
    return snap


def counter_delta(before: dict, after: dict) -> dict:
    """The counters that moved from ``before`` to ``after``, by how much."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def credit_counters(delta: dict, times: int = 1) -> None:
    """Add ``times`` x ``delta`` to the counters (the dicts are looked up
    anew, so a caller that rebinds one keeps counting)."""
    for (fn, attr, k), n in delta.items():
        if k is None:
            setattr(fn, attr, getattr(fn, attr) + times * n)
        else:
            d = getattr(fn, attr)
            d[k] = d.get(k, 0) + times * n


def check_capture_backend(device_type: str, backend: str | None, size: int,
                          cuda_graphs: bool) -> None:
    """Refuse capture of a body whose collectives cannot be captured: on
    CUDA with ``cuda_graphs=True``, a process group of size > 1 must be
    NCCL's (a gloo collective is a host call, which a graph cannot hold).
    A size-1 group issues no collective (``parallel.tp``), so its body is
    the one-device body and captures. The engine raises rather than run
    eager quietly."""
    if (cuda_graphs and device_type == "cuda" and size > 1
            and backend != "nccl"):
        raise ValueError(
            f"cuda_graphs=True cannot capture collectives of a {backend} "
            f"group of {size} ranks; pass cuda_graphs=False to run the "
            "decode steps eagerly, or form the mesh over NCCL")


class GraphCache:
    """Captured bodies keyed by the host values that fix their work.

    ``stats()`` gives the graphs held, graphs captured, seconds spent
    capturing (warm-up included), replays, and the bytes the captures
    added to the card's reserved memory (the graph pool)."""

    def __init__(self, device, *, enabled: bool = True):
        self.device = torch.device(device)
        self.enabled = bool(enabled) and self.device.type == "cuda"
        self._graphs: dict = {}
        self._pool = None
        self.captured = 0
        self.capture_s = 0.0
        self.replays = 0
        self.pool_bytes = 0
        self.cleared = 0  # graphs dropped by clear()

    def run(self, key, body, after=None) -> None:
        if not self.enabled:
            body()
            if after is not None:
                after()
            return
        entry = self._graphs.get(key)
        if entry is None:
            self._graphs[key] = self._capture(body, after)
            return
        graph, credit = entry
        graph.replay()
        if after is not None:
            after()
        credit_counters(credit)
        self.replays += 1

    def _capture(self, body, after=None):
        t0 = time.perf_counter()
        self._warm_up(body)  # this call's work, run eagerly
        if after is not None:
            after()
        before = counter_snapshot()
        graph = self._record(body)
        credit = counter_delta(before, counter_snapshot())
        credit_counters(credit, -1)  # a capture launches nothing
        self.captured += 1
        self.capture_s += time.perf_counter() - t0
        return graph, credit

    def _warm_up(self, body) -> None:
        """The body once, eagerly, on a side stream (as capture needs)."""
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            body()
        cur.wait_stream(side)

    def _record(self, body):
        """Capture the body into the shared pool; the capture runs nothing."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            body()
        torch.cuda.empty_cache()
        self.pool_bytes += max(torch.cuda.memory_reserved(self.device) - reserved, 0)
        return graph

    def clear(self) -> None:
        """Drop every captured graph and the pool they share (a serving
        engine's mode change, or an engine being released): the memory
        goes back to the caching allocator, and the next call of each key
        warms up and captures anew. The device is synchronized first, so
        no replay still runs on a graph being destroyed."""
        if self.device.type == "cuda" and self._graphs:
            torch.cuda.synchronize(self.device)
        self.cleared += len(self._graphs)
        self._graphs.clear()
        self._pool = None
        self.pool_bytes = 0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def stats(self) -> dict:
        return {
            "graphs": len(self._graphs), "captured": self.captured,
            "capture_s": self.capture_s, "replays": self.replays,
            "pool_bytes": self.pool_bytes, "cleared": self.cleared,
        }
