"""Build the port's CUDA C++ kernels from the package's ``csrc/`` sources.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds, not minutes). Libraries land in
``tensorlink_tpu_torch/_build/`` (or the directory
``runtime/compile_cache.py`` points ``BUILD_DIR`` at) under a name that
carries the hash of the source, of the shared headers in ``csrc/``, of
the ``nvcc --version`` text and of the target flags: an edit to any of
them rebuilds, an unchanged source loads as is, and a directory shared
between hosts never hands one toolkit's build to another. Each build is
written to a temporary name and moved into place (``os.replace``), so a
process racing another on the same directory loads a whole library or
builds its own. ``BUILDS`` records, per source loaded in this process,
whether ``nvcc`` ran or the library was already on disk.

Nothing here runs at import: the first call that needs a kernel builds
it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_nvcc_version: str | None = None

# source -> {"path", "compile_cache_hit", "build_s"} for every library
# ``load`` has loaded in this process
BUILDS: dict[str, dict] = {}
nvcc_runs = 0  # nvcc invocations in this process


def nvcc_path() -> str:
    """``nvcc`` of the CUDA toolkit PyTorch itself would build with."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc is needed to build)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def nvcc_version() -> str:
    """``nvcc --version``'s text (asked once a process)."""
    global _nvcc_version
    if _nvcc_version is None:
        out = subprocess.run(
            [nvcc_path(), "--version"], capture_output=True, text=True,
            check=True,
        )
        _nvcc_version = out.stdout.strip()
    return _nvcc_version


def _toolkit_text() -> str:
    """The compiler part of a library's key: ``nvcc --version``, or a
    marker on a host without a toolkit (which can build nothing, so no
    library it names is ever loaded from a cache)."""
    try:
        return nvcc_version()
    except (RuntimeError, OSError, subprocess.CalledProcessError):
        return "no-nvcc"


def library_path(source: str) -> str:
    """Where ``csrc/<source>`` builds to: the name carries a hash of the
    source's bytes, of every shared header (``csrc/*.cuh``) it may
    include, of the compiler's version text and of ``ARCH_FLAGS``, so
    changing any of them rebuilds."""
    h = hashlib.sha256()
    h.update(_toolkit_text().encode() + b"\0")
    h.update(" ".join(ARCH_FLAGS).encode() + b"\0")
    names = [source] + sorted(
        n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh")
    )
    for name in names:
        h.update(name.encode() + b"\0")
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:12]}.so")


def build(source: str, *, verbose: bool = False) -> tuple[str, str, bool]:
    """Compile ``csrc/<source>`` unless its library exists. Returns
    (library path, compiler output — ``-Xptxas -v`` register and shared
    memory report when ``verbose`` —, whether ``nvcc`` ran)."""
    global nvcc_runs
    out_path = library_path(source)
    if os.path.exists(out_path) and not verbose:
        return out_path, "", False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [
        nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-I", CSRC_DIR, "-o", tmp,
        os.path.join(CSRC_DIR, source),
    ]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    nvcc_runs += 1
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {res.returncode}):\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out_path)
    return out_path, (res.stdout + res.stderr).strip(), True


def load(source: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<source>``'s library."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            t0 = time.perf_counter()
            path, _, ran = build(source)
            lib = _loaded[source] = ctypes.CDLL(path)
            BUILDS[source] = {"path": path, "compile_cache_hit": not ran,
                              "build_s": round(time.perf_counter() - t0, 4)}
        return lib
