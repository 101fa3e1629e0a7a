"""Build the port's CUDA C++ kernels from the package's ``csrc/`` sources.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds, not minutes). Libraries land in
``tensorlink_tpu_torch/_build/`` under a name that carries the hash of
the source and of the shared headers in ``csrc/``, so an edit to either
rebuilds and an unchanged source loads as is.
The ``nvcc --version`` each build used is recorded beside it.

Nothing here runs at import: the first call that needs a kernel builds
it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` of the CUDA toolkit PyTorch itself would build with."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc is needed to build)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def nvcc_version() -> str:
    out = subprocess.run(
        [nvcc_path(), "--version"], capture_output=True, text=True,
        check=True,
    )
    return out.stdout.strip()


def library_path(source: str) -> str:
    """Where ``csrc/<source>`` builds to: the name carries a hash of the
    source's bytes and of every shared header (``csrc/*.cuh``) it may
    include, so editing either rebuilds."""
    h = hashlib.sha256()
    names = [source] + sorted(
        n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh")
    )
    for name in names:
        h.update(name.encode() + b"\0")
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:12]}.so")


def build(source: str, *, verbose: bool = False) -> tuple[str, str]:
    """Compile ``csrc/<source>`` unless its library exists. Returns
    (library path, compiler output — ``-Xptxas -v`` register and shared
    memory report when ``verbose``)."""
    out_path = library_path(source)
    if os.path.exists(out_path) and not verbose:
        return out_path, ""
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
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {source} (exit {res.returncode}):\n"
            f"{res.stdout}\n{res.stderr}"
        )
    os.replace(tmp, out_path)
    with open(os.path.join(BUILD_DIR, "nvcc_version.txt"), "w") as f:
        f.write(nvcc_version() + "\n")
    return out_path, (res.stdout + res.stderr).strip()


def load(source: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<source>``'s library."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path, _ = build(source)
            lib = _loaded[source] = ctypes.CDLL(path)
        return lib
