"""Step-indexed checkpoint/resume (port of
``tensorlink_tpu/runtime/checkpoint.py``).

The reference stores steps with Orbax; the port has no Orbax, so a step
is written in the port's own wire form instead. The layout:

    directory/
      tlt_meta.json        job re-attach sidecar (written atomically)
      <step>/index.json    {"format": 1, "shapes": {name: shape}}
      <step>/arrays.tlt    one ``p2p.serialization.pack_arrays`` blob,
                           codec "none": a msgpack manifest of names,
                           dtypes, shapes and offsets, the tensors' bytes
                           concatenated (bf16 as its bits, int8 as is),
                           and a CRC-32C checked on read

The names are ``p2p.serialization.tree_flatten_arrays``'s dotted keys; a
dataclass state flattens to its fields (a ``TrainState`` to ``params``,
``opt_state`` and ``step``). A step is written under a temporary name
and renamed into place (``os.replace``), so a step directory that exists
is whole. Saves are asynchronous by default: ``save`` takes host copies
of every tensor before it returns, and one background thread writes
them; ``wait_until_finished`` joins it.

``save_arrays_local`` / ``load_arrays_local`` keep the reference's npz
file format, so a file from either package loads in the other (f32 and
int8 trees; npz has no bfloat16).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil
import time
import uuid
from typing import Any, Mapping

import numpy as np
import torch

from tensorlink_tpu_torch.p2p.serialization import (
    pack_arrays,
    tree_flatten_arrays,
    tree_unflatten_arrays,
    unpack_arrays,
)

META_NAME = "tlt_meta.json"
INDEX_NAME = "index.json"
ARRAYS_NAME = "arrays.tlt"
FORMAT = 1


def _is_state(obj: Any) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def _as_tree(state: Any) -> Any:
    """A dataclass state (a ``TrainState``) as the dict of its fields;
    any other tree as it is."""
    if _is_state(state):
        return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    return state


def _host_copy(leaf):
    """A host snapshot of one leaf, taken now (later in-place writes to
    the source do not reach the checkpoint)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    return np.array(leaf, copy=True)


def _map_like(node, path: str, fn):
    """``node``'s structure with each leaf replaced by ``fn(name, leaf)``,
    the names ``tree_flatten_arrays`` gives them."""
    if isinstance(node, Mapping):
        return {k: _map_like(v, f"{path}.{k}" if path else str(k), fn)
                for k, v in node.items()}
    return fn(path, node)


class CheckpointManager:
    """Step-indexed checkpoints under ``directory/<step>/``.

    ``save()`` is asynchronous unless ``async_save=False``; call
    ``wait_until_finished()`` before reading a just-written step or
    exiting. ``max_to_keep`` newest steps are kept (None: all); a step off
    ``save_interval_steps``, or not past the latest, is skipped unless
    ``force``.
    """

    def __init__(
        self,
        directory: str | os.PathLike,
        max_to_keep: int | None = 3,
        save_interval_steps: int = 1,
        async_save: bool = True,
    ):
        self.directory = os.fspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._meta_path = os.path.join(self.directory, META_NAME)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self._pool = (concurrent.futures.ThreadPoolExecutor(max_workers=1)
                      if async_save else None)
        self._pending: list[concurrent.futures.Future] = []
        self._last_started: int | None = None  # committed or still in flight

    # -------------------------------------------------------------- save
    def _should_save(self, step: int) -> bool:
        last = max((s for s in (self.latest_step(), self._last_started)
                    if s is not None), default=None)
        if last is not None and step <= last:
            return False
        return self.save_interval_steps > 0 and step % self.save_interval_steps == 0

    def save(self, step: int, state: Any, metadata: Mapping[str, Any] | None = None,
             force: bool = False) -> bool:
        """Save a dataclass state (a ``TrainState``) or a (flat or nested)
        dict of tensors or arrays at ``step``. Returns True if a save started."""
        step = int(step)
        if not force and not self._should_save(step):
            return False
        if self._last_started is None or step > self._last_started:
            self._last_started = step
        flat = {k: _host_copy(v) for k, v in tree_flatten_arrays(_as_tree(state)).items()}
        if self._pool is None:
            self._write(step, flat)
        else:
            self._pending.append(self._pool.submit(self._write, step, flat))
        if metadata is not None:
            payload = dict(metadata)
            payload["step"] = step
            payload["saved_at"] = time.time()
            tmp = self._meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, sort_keys=True)
            os.replace(tmp, self._meta_path)
        return True

    def _write(self, step: int, flat: dict) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}-{uuid.uuid4().hex}")
        os.makedirs(tmp)
        index = {"format": FORMAT,
                 "shapes": {k: list(v.shape) for k, v in flat.items()}}
        with open(os.path.join(tmp, INDEX_NAME), "w") as f:
            json.dump(index, f, sort_keys=True)
        with open(os.path.join(tmp, ARRAYS_NAME), "wb") as f:
            f.write(pack_arrays(flat, codec="none"))
            f.flush()
            os.fsync(f.fileno())
        final = self._step_dir(step)
        if os.path.isdir(final):  # a forced save over an existing step
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._collect()

    def _collect(self) -> None:
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        for s in steps[:max(len(steps) - self.max_to_keep, 0)]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    # ----------------------------------------------------------- restore
    def _read(self, step: int) -> dict[str, torch.Tensor]:
        d = self._step_dir(step)
        with open(os.path.join(d, INDEX_NAME)) as f:
            shapes = json.load(f)["shapes"]
        with open(os.path.join(d, ARRAYS_NAME), "rb") as f:
            flat = unpack_arrays(f.read())
        return {k: v.reshape(shapes[k]) for k, v in flat.items()}

    def restore(self, target: Any = None, step: int | None = None) -> Any:
        """Restore the given (or latest) step.

        ``target``: a dataclass state (a ``TrainState``) or a dict of
        tensors of the saved structure; each tensor comes back on the
        target leaf's device in its dtype, in the target's structure. With
        no target the arrays come back on the host as CPU tensors, nested
        by their dotted names."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        flat = self._read(int(step))
        if target is None:
            return tree_unflatten_arrays(flat)
        names = {k for k in tree_flatten_arrays(_as_tree(target))
                 if not k.endswith("//empty")}
        saved = {k for k in flat if not k.endswith("//empty")}
        if names != saved:
            raise ValueError(
                f"checkpoint step {step} does not match the target: missing "
                f"{sorted(names - saved)[:5]}, unexpected {sorted(saved - names)[:5]}")

        def load(name, leaf):
            if isinstance(leaf, torch.Tensor):
                return flat[name].to(device=leaf.device, dtype=leaf.dtype)
            return flat[name].numpy()

        tree = _map_like(_as_tree(target), "", load)
        if _is_state(target):
            return dataclasses.replace(target, **tree)
        return tree

    def metadata(self) -> dict[str, Any] | None:
        """Job re-attach sidecar from the latest save. It is written when
        a save starts, so a process that died before the commit could
        leave it naming a step that never landed: ``step`` is reconciled
        against the committed steps on read."""
        try:
            with open(self._meta_path) as f:
                meta = json.load(f)
        except FileNotFoundError:
            return None
        latest = self.latest_step()
        if latest is not None and meta.get("step", 0) > latest:
            meta["step"] = latest
        return meta

    def all_steps(self) -> list[int]:
        """Committed steps, ascending (temporary directories excluded)."""
        return sorted(
            int(n) for n in os.listdir(self.directory)
            if n.isdigit() and os.path.isdir(os.path.join(self.directory, n))
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait_until_finished(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def close(self) -> None:
        self.wait_until_finished()
        if self._pool is not None:
            self._pool.shutdown()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _npz_leaf(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("npz has no bfloat16; save bf16 trees with "
                            "CheckpointManager")
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_arrays_local(path: str | os.PathLike, tree: Any) -> None:
    """Synchronous single-file npz for small host-local state (a worker
    stage's params during re-assignment), the reference's file format."""
    flat = {k: _npz_leaf(v) for k, v in tree_flatten_arrays(_as_tree(tree)).items()}
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # a file object: savez adds no ".npz"
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_arrays_local(path: str | os.PathLike) -> Any:
    """An npz written by either package -> nested dict of CPU tensors."""
    with np.load(os.fspath(path)) as z:
        flat = {k: (z[k] if k.endswith("//empty") else torch.from_numpy(z[k]))
                for k in z.files}
    return tree_unflatten_arrays(flat)
