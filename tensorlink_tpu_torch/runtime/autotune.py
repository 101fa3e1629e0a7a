"""Persistent autotune store: measured knobs survive restarts (port of
``tensorlink_tpu/runtime/autotune.py``; the JSON logic is a copy, the
fingerprints are the port's own).

The kernel-build cache (``runtime/compile_cache.py``) makes a restart
reuse built kernels; this store does the same for the measured
constants a process would otherwise pay a calibration sweep to learn
again:

- flash-attention block overrides (``ops/flash.py``
  ``set_flash_block_override``);
- a serving engine's prefill-bucket set (what it warms);
- the adaptive-speculation K prior (``parallel/speculative.py``
  ``AdaptiveKController``), so a restarted engine's first dispatch runs
  near the learned K;
- the measured draft pairing (``autopair_draft``'s verdict);
- the card's measured capability (``runtime/profiling.py``
  ``measure_capability(store=, key=)``).

A record is trusted only when its (torch version, CUDA version, chip,
model fingerprint, bucket set) all match the loading process
(``runtime_fingerprint`` is the compile cache's). Anything else — another
card, an upgraded torch, a resized model, a corrupt or truncated file —
reads as a clean miss, and the process starts cold exactly as with an
empty store: a tuning cache must never crash or mis-tune serving.

One JSON file per key, written atomically (temporary file, then
``os.replace``), so two processes racing a save leave one whole record.
The reference records flight events; here each store counts them
(``counts``: ``saved``, ``corrupt``, ``stale``), and a directory that
cannot be created counts in ``AutotuneStore.resolve_failures``.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from pathlib import Path

from tensorlink_tpu_torch.runtime.compile_cache import runtime_fingerprint

__all__ = [
    "GLOBAL_MODEL",
    "AutotuneStore",
    "apply_flash_overrides",
    "apply_paged_overrides",
    "model_fingerprint",
    "store_key",
]

ENV_VAR = "TL_AUTOTUNE_DIR"
SCHEMA = 1

# model-independent records (the card's capability, flash blocks tuned
# before any model is loaded) key on this sentinel fingerprint
GLOBAL_MODEL = "global"

# what ``save`` stamps on every record (``update`` drops them first)
_STAMPS = ("schema", "key", "torch", "cuda", "chip", "saved_at")


def model_fingerprint(model) -> str:
    """Structural fingerprint of a module (or a state dict): every
    entry's name, shape and dtype, no weight bytes read. Tuned constants
    depend on shapes, which this pins; an int8 sibling (``…w.q`` int8,
    ``…w.s`` f32) keys apart from its bf16 target."""
    state = model.state_dict() if hasattr(model, "state_dict") else model
    h = hashlib.sha256()
    for name in sorted(state):
        t = state[name]
        h.update(name.encode() + b"\0")
        h.update(str(tuple(getattr(t, "shape", ()))).encode())
        h.update(str(getattr(t, "dtype", "?")).encode())
    return h.hexdigest()[:16]


def store_key(model_fp: str, buckets) -> str:
    """One store key: hash of (torch, CUDA, chip, model fingerprint,
    bucket set) — the compile cache's facts plus the program-shape set
    the tuned values were measured against."""
    rt = runtime_fingerprint()
    h = hashlib.sha256()
    h.update(str(rt["torch"]).encode())
    h.update(str(rt["cuda"]).encode())
    h.update(str(rt["chip"]).encode())
    h.update(str(model_fp).encode())
    h.update(",".join(str(int(b)) for b in sorted(buckets)).encode())
    return h.hexdigest()[:24]


def apply_flash_overrides(record: dict) -> int:
    """Install a record's flash-block overrides (``[[seq, batch|null,
    block], ...]``); returns how many applied. An entry the registry
    refuses (a block that no longer divides seq, a tile the CUDA kernel
    does not take — the port's takes only 64) or a malformed row is
    skipped, not fatal: stale tuning degrades to the default tile."""
    from tensorlink_tpu_torch.ops.flash import set_flash_block_override

    applied = 0
    for entry in record.get("flash_blocks") or []:
        try:
            seq, batch, block = entry
            set_flash_block_override(
                int(seq), int(block),
                batch=None if batch is None else int(batch),
            )
            applied += 1
        except (TypeError, ValueError):
            continue
    return applied


def apply_paged_overrides(record: dict) -> int:
    """The reference installs persisted pages-per-superstep choices of
    its Pallas paged-decode kernel here. The port's B3
    (``ops/paged_decode.py``) has no such knob: its one tunable, the
    split count of ``partition_plan``, is derived from the table
    geometry and the card's SM count on every call. So this applies
    nothing and returns 0, whatever the record's ``paged_kernel`` rows
    hold (a record written by a store that had them loads all the
    same)."""
    return 0


class AutotuneStore:
    """Directory of per-key tuning records. ``resolve`` follows
    ``enable_compile_cache``'s directory rule: the argument, then
    ``$TL_AUTOTUNE_DIR``, else None (feature off)."""

    resolve_failures = 0  # directories resolve could not create

    def __init__(self, root: str):
        self.root = Path(root).expanduser()
        self.counts = {"saved": 0, "corrupt": 0, "stale": 0}

    @classmethod
    def resolve(cls, root: str | None = None) -> "AutotuneStore | None":
        d = root if root is not None else os.environ.get(ENV_VAR)
        if not d:
            return None
        store = cls(d)
        try:
            store.root.mkdir(parents=True, exist_ok=True)
        except OSError:
            AutotuneStore.resolve_failures += 1
            return None
        return store

    def path(self, key: str) -> Path:
        return self.root / f"tune-{key}.json"

    def load(self, key: str) -> dict | None:
        """The record for ``key``, or None for missing, unreadable,
        corrupt or stale (schema or key mismatch). Every None is a clean
        cold start."""
        p = self.path(key)
        try:
            raw = p.read_bytes()
        except OSError:
            return None
        try:
            rec = json.loads(raw.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            self.counts["corrupt"] += 1
            return None
        if not isinstance(rec, dict) or rec.get("schema") != SCHEMA \
                or rec.get("key") != key:
            self.counts["stale"] += 1
            return None
        return rec

    def update(self, key: str, patch: dict) -> Path:
        """Merge ``patch`` into the record under ``key`` (load, modify,
        save; a missing or stale record starts empty), so two writers
        that own different fields of one key (the capability and the
        flash blocks share the chip-global key) never drop each other's
        measurement."""
        rec = self.load(key) or {}
        for stamp in _STAMPS:
            rec.pop(stamp, None)
        rec.update(patch)
        return self.save(key, rec)

    def save(self, key: str, record: dict) -> Path:
        """Atomically persist ``record`` under ``key``, stamped with the
        schema, the key and the runtime facts a loader validates."""
        rec = dict(record)
        rec["schema"] = SCHEMA
        rec["key"] = key
        rec.update(runtime_fingerprint())
        rec["saved_at"] = time.time()
        p = self.path(key)
        tmp = p.with_suffix(f".tmp.{os.getpid()}")
        tmp.write_text(json.dumps(rec, sort_keys=True, indent=1))
        os.replace(tmp, p)
        self.counts["saved"] += 1
        return p
