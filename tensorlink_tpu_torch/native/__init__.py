"""Native (C++) wire codec, bound via ctypes (a copy of the
``crc32c`` / ``gather`` / ``HAVE_NATIVE`` API of
``tensorlink_tpu/native/__init__.py``).

``wirecodec.cpp`` is the JAX package's source: CRC-32C (Castagnoli) and a
single-pass gather of N buffers into one blob with the checksum computed
during the copy. It builds at first use with ``g++`` into
``tensorlink_tpu_torch/_build/`` (never next to the source; or the
directory ``runtime/compile_cache.py`` points ``BUILD_DIR`` at), under a
name that carries the hash of the source, so an edit rebuilds. ``BUILD``
records whether ``g++`` ran or the library was already on disk, and
``gxx_runs`` counts the compiler runs of this process.

Every entry point keeps the reference's pure-Python fallback for hosts
without a toolchain; callers use ``crc32c()`` / ``gather()`` and never
see which implementation ran. ``have_native()`` (and ``HAVE_NATIVE``,
resolved on first access) says which one is live. The fallback's CRC
runs at a few MB/s, so a disaggregated decode leg on a card must not
rely on it: a full-width KV payload is hundreds of MiB.

Buffers are CPU torch tensors or numpy arrays; their bytes are read in
place (a contiguous copy is taken only for a strided tensor).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time

import numpy as np
import torch

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "wirecodec.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False
# {"path", "compile_cache_hit", "build_s"} once the library is loaded
BUILD: dict = {}
gxx_runs = 0


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libwirecodec-{digest}.so")


def _load() -> "ctypes.CDLL | None":
    global _lib, _build_failed, gxx_runs
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            t0 = time.perf_counter()
            so = library_path()
            hit = os.path.exists(so)
            if not hit:
                # compile to a per-process temp path and os.replace into
                # place: concurrent processes racing a shared output path
                # could load a half-written library
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
                base = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                        "-o", tmp, _SRC]
                gxx_runs += 1
                try:
                    try:  # hardware CRC32C when the target supports it
                        subprocess.run(
                            base[:1] + ["-msse4.2"] + base[1:],
                            check=True, capture_output=True, timeout=120,
                        )
                    except subprocess.SubprocessError:
                        subprocess.run(
                            base, check=True, capture_output=True, timeout=120
                        )
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
            lib = ctypes.CDLL(so)
            lib.tl_crc32c.restype = ctypes.c_uint32
            lib.tl_crc32c.argtypes = [
                ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint32,
            ]
            lib.tl_gather.restype = ctypes.c_uint32
            lib.tl_gather.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_size_t,
                ctypes.c_int,
            ]
            lib.tl_abi_version.restype = ctypes.c_int
            if lib.tl_abi_version() != 1:
                raise OSError("wirecodec ABI mismatch")
            _lib = lib
            BUILD.update(path=so, compile_cache_hit=hit,
                         build_s=round(time.perf_counter() - t0, 4))
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
    return _lib


def have_native() -> bool:
    return _load() is not None


def __getattr__(name: str):
    # HAVE_NATIVE builds the library on first access, not at import
    if name == "HAVE_NATIVE":
        return have_native()
    raise AttributeError(name)


# ------------------------------------------------------ python fallback

_PY_TABLE: "np.ndarray | None" = None


def _py_table() -> np.ndarray:
    global _PY_TABLE
    if _PY_TABLE is None:
        poly = 0x82F63B78
        t = np.zeros(256, np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (poly ^ (c >> 1)) if (c & 1) else (c >> 1)
            t[i] = c
        _PY_TABLE = t
    return _PY_TABLE


def _py_crc32c(data: bytes, crc0: int = 0) -> int:
    table = _py_table()
    crc = ~crc0 & 0xFFFFFFFF
    for b in data:
        crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return ~crc & 0xFFFFFFFF


# ------------------------------------------------------------- public API


def _byte_view(buf) -> np.ndarray:
    """Contiguous uint8 numpy view of a CPU tensor or array (a copy only
    when the input is strided)."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise ValueError("wire buffers must be CPU tensors")
        return buf.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(buf).view(np.uint8).reshape(-1)


def crc32c(data: bytes | bytearray | memoryview, crc0: int = 0) -> int:
    """CRC-32C (Castagnoli), chainable via ``crc0``."""
    lib = _load()
    if lib is not None:
        view = np.frombuffer(data, np.uint8)
        return int(lib.tl_crc32c(view.ctypes.data, view.nbytes, crc0))
    return _py_crc32c(bytes(data), crc0)


def gather(buffers, with_crc: bool = True) -> tuple[bytearray, int]:
    """Concatenate the bytes of ``buffers`` (CPU tensors or arrays) into
    one blob, computing the CRC-32C in the same memory pass. Returns
    (blob, crc)."""
    views = [_byte_view(b) for b in buffers]
    total = sum(v.nbytes for v in views)
    out = bytearray(total)
    lib = _load()
    if lib is not None and views:
        # source pointers come straight from the buffers (kept alive by
        # `views` for the duration of the call)
        n = len(views)
        srcs = (ctypes.c_void_p * n)(*[v.ctypes.data for v in views])
        lens = (ctypes.c_size_t * n)(*[v.nbytes for v in views])
        dst = (ctypes.c_char * total).from_buffer(out)
        crc = int(lib.tl_gather(
            ctypes.addressof(dst), srcs, lens, n, 1 if with_crc else 0
        ))
        return out, crc
    off = 0
    for v in views:
        out[off:off + v.nbytes] = v.tobytes()
        off += v.nbytes
    crc = crc32c(bytes(out)) if with_crc else 0
    return out, crc
