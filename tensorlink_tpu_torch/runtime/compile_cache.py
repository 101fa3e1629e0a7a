"""Persistent kernel-build cache (port of
``tensorlink_tpu/runtime/compile_cache.py``).

The port has no XLA programs: what a restarted process pays for before
its first request is the ``nvcc`` build of each ``csrc/*.cu`` source
(``ops/_build.py``) and the ``g++`` build of ``native/wirecodec.cpp``.
Both already land under a name that carries the hash of everything that
decides the binary (sources, shared headers, the compiler's version text
and the target flags), so pointing them at a directory that outlives the
process, or that a second node on the same toolkit shares, turns the
builds into file loads. Captured CUDA graphs cannot outlive the process
that captured them (they hold device pointers of its allocations); a
restart captures them anew on its first chunks, and this cache does not
try to keep them.

- :func:`enable_compile_cache` resolves the directory from its argument
  or ``$TL_COMPILE_CACHE_DIR`` and points both build directories at it.
  The setting is process-global and the first directory wins: a later
  request for another directory is counted (``COUNTS["conflicts"]``),
  not honoured. A directory that cannot be created or written means
  "cache off" (``COUNTS["init_failed"]``), never a crash.
- :func:`cache_entries` counts the built libraries in a directory.
- :func:`runtime_fingerprint` is the (torch, CUDA, chip) half of every
  persisted-tuning key, shared with ``runtime/autotune.py`` so the
  built kernels and the measured constants that pick them key on the
  same facts.

Which libraries came from the cache is recorded where they are loaded
(``ops/_build.py`` ``BUILDS``, ``native.BUILD``); the serving engines
report it as ``stats()["compile"]``.
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

import torch

__all__ = [
    "COUNTS",
    "cache_entries",
    "compile_report",
    "enable_compile_cache",
    "runtime_fingerprint",
]

ENV_VAR = "TL_COMPILE_CACHE_DIR"

# process-wide outcomes of enable_compile_cache
COUNTS = {"conflicts": 0, "init_failed": 0}

_active_dir: str | None = None


def runtime_fingerprint() -> dict:
    """{"torch", "cuda", "chip"}: the facts a built kernel and a measured
    constant both depend on. ``chip`` is the first card's name, or
    ``"cpu"`` where there is none."""
    chip = torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"
    return {"torch": torch.__version__, "cuda": torch.version.cuda, "chip": chip}


def active_dir() -> str | None:
    return _active_dir


def _writable(d: Path) -> bool:
    try:
        d.mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=d, prefix=".probe-"):
            pass
    except OSError:
        return False
    return True


def enable_compile_cache(cache_dir: str | None = None) -> str | None:
    """Point the kernel and wire-codec builds at ``cache_dir`` (or
    ``$TL_COMPILE_CACHE_DIR``); returns the active directory, or None
    when no directory is configured or the one asked for is unusable.
    Idempotent; the first directory wins."""
    global _active_dir
    d = cache_dir if cache_dir is not None else os.environ.get(ENV_VAR)
    if not d:
        return _active_dir
    d = str(Path(d).expanduser().resolve())
    if _active_dir is not None:
        if _active_dir != d:
            COUNTS["conflicts"] += 1
        return _active_dir
    if not _writable(Path(d)):
        COUNTS["init_failed"] += 1
        return None
    from tensorlink_tpu_torch import native
    from tensorlink_tpu_torch.ops import _build

    _build.BUILD_DIR = d
    native.BUILD_DIR = d
    _active_dir = d
    return d


def cache_entries(cache_dir: str | None) -> int:
    """Built libraries (``*.so``) in ``cache_dir``; 0 when it is missing
    or None."""
    if not cache_dir:
        return 0
    try:
        return sum(1 for p in Path(cache_dir).iterdir()
                   if p.is_file() and p.name.endswith(".so"))
    except OSError:
        return 0


def compile_report() -> dict:
    """Every library this process has loaded, by source, with
    ``compile_cache_hit`` (it was on disk already, no compiler ran) and
    the seconds its build or load took; the cache directory and the
    counts of hits and misses."""
    from tensorlink_tpu_torch import native
    from tensorlink_tpu_torch.ops import _build

    libs = {src: dict(rec) for src, rec in _build.BUILDS.items()}
    if native.BUILD:
        libs["wirecodec.cpp"] = dict(native.BUILD)
    hits = sum(1 for r in libs.values() if r["compile_cache_hit"])
    return {
        "cache_dir": _active_dir,
        "libraries": libs,
        "compile_cache_hits": hits,
        "compile_cache_misses": len(libs) - hits,
        **{f"cache_{k}": n for k, n in COUNTS.items()},
    }
