"""Batch loader + device prefetch (port of ``tensorlink_tpu/data/loader.py``).

- Static shapes: batches are drop-remainder, so every step sees one shape.
- Determinism: the epoch permutation derives from (seed, epoch) via
  numpy's PCG64, exactly as the reference derives it, so the same dataset
  and seed give the same order in both packages and across restarts.
- Process-local rows: with ``process_count`` P each process takes its
  B/P rows of the global batch, as in the reference. On a mesh
  (``mesh=``) P is the ``data`` axis and the index this rank's ``data``
  coordinate, not its global rank: every ``pipe`` and ``model`` rank of
  one data replica reads the same rows, which is what
  ``ShardedTrainer.train_step(batch, local=True)`` expects; no process
  ever assembles another's rows. ``prefetch_to_device`` serves one
  process.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Iterator, Mapping

import numpy as np
import torch

from tensorlink_tpu_torch import resolve_device


class ShardedLoader:
    """Iterates {name: np.ndarray} batches over an array-backed dataset.

    ``data`` maps column names to equal-length arrays. One iteration is
    one epoch of this process's shard; use ``epochs(n)`` or re-iterate for
    more. Batches are the process-local slice of the global batch
    (global_batch // process_count rows); ``mesh`` (a ``DeviceMesh``)
    takes P and the index from its ``data`` axis."""

    def __init__(
        self,
        data: Mapping[str, np.ndarray],
        global_batch: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_remainder: bool = True,
        process_index: int | None = None,
        process_count: int | None = None,
        transform: Callable[[dict], dict] | None = None,
        mesh=None,
    ):
        if not data:
            raise ValueError("empty dataset")
        lens = {k: len(v) for k, v in data.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"column lengths differ: {lens}")
        self.data = {k: np.asarray(v) for k, v in data.items()}
        self.n = next(iter(lens.values()))
        self.global_batch = int(global_batch)
        self.shuffle = shuffle
        self.seed = int(seed)
        self.drop_remainder = drop_remainder
        self.transform = transform
        if mesh is not None:
            if process_index is not None or process_count is not None:
                raise ValueError("pass a mesh or process_index/process_count")
            process_index = mesh.get_local_rank("data")
            process_count = mesh.size(list(mesh.mesh_dim_names).index("data"))
        self.pid = 0 if process_index is None else int(process_index)
        self.pcount = 1 if process_count is None else int(process_count)
        if self.global_batch % self.pcount:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"process_count {self.pcount}"
            )
        self.local_batch = self.global_batch // self.pcount
        if not drop_remainder:
            raise NotImplementedError(
                "static shapes only: pad the dataset instead of a ragged "
                "final batch"
            )
        self._epoch = 0

    def __len__(self) -> int:
        return self.n // self.global_batch

    def set_epoch(self, epoch: int) -> None:
        """Resume support: (seed, epoch) fully determines the order."""
        self._epoch = int(epoch)

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(self.n)
        return np.random.default_rng((self.seed, epoch)).permutation(self.n)

    def __iter__(self) -> Iterator[dict]:
        order = self._epoch_order(self._epoch)
        self._epoch += 1
        for s in range(self.n // self.global_batch):
            g0 = s * self.global_batch
            idx = order[
                g0 + self.pid * self.local_batch:
                g0 + (self.pid + 1) * self.local_batch
            ]
            batch = {k: v[idx] for k, v in self.data.items()}
            yield self.transform(batch) if self.transform else batch

    def epochs(self, n: int) -> Iterator[dict]:
        for _ in range(n):
            yield from self


def prefetch_to_device(
    it: Iterator[dict],
    device=None,
    *,
    size: int = 2,
) -> Iterator[dict]:
    """Batches of tensors on ``device`` (CUDA unless ``device="cpu"``),
    ``size`` ahead of the consumer. A worker thread assembles host batches
    (and runs any transform); on CUDA each batch is copied from pinned
    host memory on a side stream, and the consumer's stream waits for that
    copy only when it takes the batch, so the copy overlaps the step that
    runs meanwhile."""
    if size < 1:
        raise ValueError("prefetch size must be >= 1")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    side = torch.cuda.Stream(device=dev) if cuda else None

    def put(batch: dict):
        if not cuda:
            return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        with torch.cuda.stream(side):
            out = {
                k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(
                    dev, non_blocking=True)
                for k, v in batch.items()
            }
        done = torch.cuda.Event()
        done.record(side)
        return out, done

    q: collections.deque = collections.deque()
    lock = threading.Lock()
    have = threading.Semaphore(0)
    space = threading.Semaphore(size)
    stop = threading.Event()  # consumer abandoned: unblock + end producer
    _END = object()

    def producer():
        try:
            for b in it:
                # poll so an abandoned consumer can't strand us on a full
                # queue holding the dataset alive
                while not space.acquire(timeout=0.1):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                with lock:
                    q.append(b)
                have.release()
            with lock:
                q.append(_END)
        except BaseException as e:  # noqa: BLE001 — surfaced to consumer
            with lock:
                q.append(("__error__", e))
        have.release()

    def take():
        have.acquire()
        with lock:
            b = q.popleft()
        space.release()
        if isinstance(b, tuple) and len(b) == 2 and b[0] == "__error__":
            raise b[1]
        return b

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    inflight: collections.deque = collections.deque()
    ended = False
    try:
        while True:
            # keep `size` copies in flight ahead of the consumer
            while not ended and len(inflight) < size:
                b = take()
                if b is _END:
                    ended = True
                else:
                    inflight.append(put(b))
            if not inflight:
                return
            item = inflight.popleft()
            if not cuda:
                yield item
                continue
            out, done = item
            cur = torch.cuda.current_stream(dev)
            cur.wait_event(done)
            for v in out.values():
                v.record_stream(cur)
            yield out
    finally:
        stop.set()
