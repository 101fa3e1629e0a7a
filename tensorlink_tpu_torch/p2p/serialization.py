"""Typed control messages and array blobs on the wire (the port's
``tensorlink_tpu/p2p/serialization.py``): ``encode_message`` /
``decode_message``, ``pack_arrays`` / ``unpack_arrays`` /
``packed_nbytes``, the chunked streams (``stream_manifest``,
``iter_array_chunks``, ``StreamAssembler``) and ``tree_flatten_arrays``
/ ``tree_unflatten_arrays``.

A blob is ``MAGIC + len(head) (4 bytes, big-endian) + head + body``:
``head`` is a msgpack map ``{"codec", "tensors": {name: {"dtype",
"shape", "offset", "nbytes"}}, "crc32c"}`` and ``body`` the tensors'
bytes, concatenated and checksummed in one native pass
(``tensorlink_tpu_torch/native``), then compressed with the codec. A
port blob is byte-identical to a JAX-package blob of the same arrays, so
either side reads the other's.

The msgpack codec is written here (``packb`` / ``unpackb``) for the
subset control messages and manifests use: nested maps and lists, str,
bin, nil, bool, float64 and ints from -2**63 to 2**64 - 1, each in
msgpack's smallest encoding, so the bytes equal
``msgpack.packb(..., use_bin_type=True)``'s; a message's map keys may be
ints too, as ``strict_map_key=False`` accepts. No ``msgpack`` and no
``ml_dtypes`` are needed: dtypes travel by numpy name, and a
``torch.bfloat16`` tensor travels as its bits under ``"bfloat16"``.
Codec ``"zstd"`` falls back to ``"zlib"`` where ``zstandard`` is missing,
as in the reference.

``pack_arrays`` takes CPU torch tensors (or numpy arrays);
``unpack_arrays`` returns CPU torch tensors that share one buffer.
"""

from __future__ import annotations

import struct
import threading
import zlib
from typing import Any, Mapping

import numpy as np
import torch

from tensorlink_tpu_torch.native import crc32c, gather

try:
    import zstandard as _zstd
except ImportError:  # the reference's fallback: zstd blobs become zlib
    _zstd = None

MAGIC = b"TLT1"

# zstd contexts hold streaming state and are not safe for concurrent
# use: one per thread
_TLS = threading.local()


def _zc():
    c = getattr(_TLS, "zc", None)
    if c is None:
        c = _TLS.zc = _zstd.ZstdCompressor(level=3)
    return c


def _zd():
    d = getattr(_TLS, "zd", None)
    if d is None:
        d = _TLS.zd = _zstd.ZstdDecompressor()
    return d


# ------------------------------------------------------- manifest codec


def _pack_into(out: bytearray, obj) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        if obj < -(1 << 63) or obj >= (1 << 64):
            raise OverflowError(f"int {obj} does not fit msgpack")
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xFF)
        elif obj >= 0:
            for lim, tag, fmt in ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"),
                                  (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")):
                if obj < lim:
                    out.append(tag)
                    out += struct.pack(fmt, obj)
                    break
        else:
            for lim, tag, fmt in ((1 << 7, 0xD0, ">b"), (1 << 15, 0xD1, ">h"),
                                  (1 << 31, 0xD2, ">i"), (1 << 63, 0xD3, ">q")):
                if obj >= -lim:
                    out.append(tag)
                    out += struct.pack(fmt, obj)
                    break
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _head(out, len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        raw = bytes(obj)
        _head(out, len(raw), None, 0, (0xC4, 0xC5, 0xC6))
        out += raw
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for item in obj:
            _pack_into(out, item)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack_into(out, k)
            _pack_into(out, v)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def _head(out: bytearray, n: int, fix: int | None, fix_lim: int, tags) -> None:
    """A length header: the fix form below ``fix_lim``, else the 8-, 16-
    or 32-bit form (``tags``; None where msgpack has no such form)."""
    if fix is not None and n < fix_lim:
        out.append(fix | n)
        return
    for lim, tag, fmt in zip((1 << 8, 1 << 16, 1 << 32), tags, (">B", ">H", ">I")):
        if tag is not None and n < lim:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset."""
    out = bytearray()
    _pack_into(out, obj)
    return bytes(out)


_FIXED = {  # tag -> (struct format, kind)
    0xCC: (">B", "num"), 0xCD: (">H", "num"), 0xCE: (">I", "num"),
    0xCF: (">Q", "num"), 0xD0: (">b", "num"), 0xD1: (">h", "num"),
    0xD2: (">i", "num"), 0xD3: (">q", "num"), 0xCA: (">f", "num"),
    0xCB: (">d", "num"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xDC: (">H", "list"), 0xDD: (">I", "list"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


# nesting bound of a decoded tree (msgpack's own unpacker refuses deeper
# input with a ValueError too): a hostile frame cannot exhaust the stack
_MAX_DEPTH = 512


def _unpack_at(data, i: int, strict: bool = True, depth: int = 0):
    if i >= len(data):
        raise ValueError("truncated msgpack data")
    if depth > _MAX_DEPTH:
        raise ValueError("msgpack data nested too deeply")
    b = data[i]
    i += 1
    if b < 0x80:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        kind, n = "list", b & 0x0F
    elif 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif b in (0xC0, 0xC2, 0xC3):
        return {0xC0: None, 0xC2: False, 0xC3: True}[b], i
    elif b in _FIXED:
        fmt, kind = _FIXED[b]
        size = struct.calcsize(fmt)
        if i + size > len(data):
            raise ValueError("truncated msgpack data")
        (n,) = struct.unpack_from(fmt, data, i)
        i += size
        if kind == "num":
            return n, i
    else:
        raise ValueError(f"msgpack type 0x{b:02x} is not part of the subset")
    if kind in ("str", "bin"):
        if i + n > len(data):
            raise ValueError("truncated msgpack data")
        raw = bytes(data[i:i + n])
        return (raw.decode("utf-8") if kind == "str" else raw), i + n
    if kind == "list":
        items = []
        for _ in range(n):
            v, i = _unpack_at(data, i, strict, depth + 1)
            items.append(v)
        return items, i
    out = {}
    for _ in range(n):
        k, i = _unpack_at(data, i, strict, depth + 1)
        if strict and not isinstance(k, (str, bytes)):
            raise ValueError(f"{type(k).__name__} is not allowed for map key")
        if isinstance(k, (list, dict)):
            raise ValueError("unhashable msgpack map key")
        out[k], i = _unpack_at(data, i, strict, depth + 1)
    return out, i


def unpackb(data, *, strict_map_key: bool = True) -> Any:
    """``msgpack.unpackb(data, raw=False, strict_map_key=...)`` for the
    subset: map keys are str or bytes unless ``strict_map_key`` is
    False. Raises ``ValueError`` on malformed or truncated input."""
    obj, end = _unpack_at(data, 0, strict_map_key)
    if end != len(data):
        raise ValueError("extra bytes after the msgpack data")
    return obj


# ---------------------------------------------------------------- messages


def encode_message(msg: Mapping[str, Any]) -> bytes:
    """Typed message -> bytes. Must contain a string 'type'."""
    if "type" not in msg or not isinstance(msg["type"], str):
        raise ValueError("message must carry a string 'type'")
    return packb(dict(msg))


def decode_message(data: bytes) -> dict[str, Any]:
    msg = unpackb(data, strict_map_key=False)
    if not isinstance(msg, dict) or not isinstance(msg.get("type"), str):
        raise ValueError("malformed message (no string 'type')")
    return msg


# ---------------------------------------------------------------- arrays

# numpy dtype name <-> torch dtype: the names the reference writes
_TORCH_BY_NAME = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
}
_NAME_BY_TORCH = {v: k for k, v in _TORCH_BY_NAME.items()}


def _compress(data: bytes, codec: str) -> bytes:
    if codec == "zstd" and _zstd is not None:
        return _zc().compress(data)
    if codec == "zlib":
        return zlib.compress(data, 6)
    return data


def _decompress(data: bytes, codec: str) -> bytes:
    if codec == "zstd":
        if _zstd is None:
            raise ValueError("zstd payload, but zstandard is not installed")
        return _zd().decompress(data)
    if codec == "zlib":
        return zlib.decompress(data)
    return data


def _wire_form(arr):
    """-> (dtype name, shape, buffer): a CPU tensor as is (its bits), a
    numpy array native-endian and contiguous. A 0-d value travels with
    shape [1], as ``np.ascontiguousarray`` makes it in the reference."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype not in _NAME_BY_TORCH:
            raise TypeError(f"no wire name for {arr.dtype}")
        return _NAME_BY_TORCH[arr.dtype], list(arr.shape) or [1], arr
    arr = np.ascontiguousarray(arr)
    if arr.dtype.byteorder == ">":  # the wire is native-endian
        arr = arr.astype(arr.dtype.newbyteorder("="))
    return arr.dtype.name, list(arr.shape), arr


def pack_arrays(arrays: Mapping[str, Any], codec: str = "zstd") -> bytes:
    """{name: tensor or array} -> MAGIC + msgpack(manifest) + blob. The
    tensor bytes are concatenated and checksummed in one native pass,
    and the CRC-32C rides the manifest, checked after decompression on
    the receiving side."""
    if codec == "zstd" and _zstd is None:
        codec = "zlib"
    manifest: dict[str, Any] = {"codec": codec, "tensors": {}}
    bufs = []
    offset = 0
    for name, arr in arrays.items():
        dtype, shape, buf = _wire_form(arr)
        nbytes = (buf.numel() * buf.element_size() if isinstance(buf, torch.Tensor)
                  else buf.nbytes)
        manifest["tensors"][name] = {
            "dtype": dtype, "shape": shape, "offset": offset, "nbytes": nbytes,
        }
        bufs.append(buf)
        offset += nbytes
    raw, crc = gather(bufs, with_crc=True)
    manifest["crc32c"] = crc
    body = _compress(raw, codec) if codec in ("zstd", "zlib") else raw
    head = packb(manifest)
    return MAGIC + len(head).to_bytes(4, "big") + head + bytes(body)


def _manifest(data) -> tuple[dict, int]:
    if bytes(data[:4]) != MAGIC:
        raise ValueError("bad array blob magic")
    hlen = int.from_bytes(data[4:8], "big")
    return unpackb(data[8:8 + hlen]), 8 + hlen


def packed_nbytes(data: bytes) -> int:
    """Total uncompressed tensor bytes in a packed blob, from the manifest
    alone (admission control must use this, not ``len(blob)``)."""
    manifest, _ = _manifest(data)
    return sum(int(m["nbytes"]) for m in manifest["tensors"].values())


def unpack_arrays(data: bytes) -> dict[str, torch.Tensor]:
    """Blob -> {name: CPU tensor}. Raises ``ValueError`` on a bad magic,
    an unknown dtype or a CRC-32C mismatch."""
    manifest, start = _manifest(data)
    body = bytearray(_decompress(bytes(data[start:]), manifest["codec"]))
    want = manifest.get("crc32c")
    if want is not None and crc32c(body) != want:
        raise ValueError("tensor blob CRC-32C mismatch (corrupt payload)")
    out = {}
    for name, meta in manifest["tensors"].items():
        dtype = _TORCH_BY_NAME.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"unknown wire dtype {meta['dtype']!r}")
        off, nbytes = int(meta["offset"]), int(meta["nbytes"])
        if off + nbytes > len(body):
            raise ValueError(f"tensor {name!r} runs past the blob body")
        if nbytes == 0:
            out[name] = torch.empty(meta["shape"], dtype=dtype)
            continue
        flat = torch.frombuffer(body, dtype=torch.uint8, count=nbytes, offset=off)
        if off % flat.new_empty((), dtype=dtype).element_size():
            flat = flat.clone()  # an aligned copy of a misaligned tensor
        out[name] = flat.view(dtype).reshape(meta["shape"])
    return out


# ---------------------------------------------------------------- streams
# Chunked array transfer: arrays are cut into per-tensor byte ranges, each
# chunk rides its own frame (the transport's compression and CRC-32C
# apply per chunk), and the receiver's assembler hands each tensor to a
# sink the moment its last byte lands, so host memory is bounded by the
# largest single tensor.

STREAM_CHUNK_BYTES = 8 << 20


def _flat_bytes(buf) -> np.ndarray:
    """A wire-form buffer's bytes as a flat uint8 array (no copy where
    the buffer is contiguous)."""
    if isinstance(buf, torch.Tensor):
        t = buf.detach().contiguous().reshape(-1)
        return t.view(torch.uint8).numpy() if t.numel() else np.zeros((0,), np.uint8)
    return buf.reshape(-1).view(np.uint8)


def stream_manifest(arrays: Mapping[str, Any]) -> dict[str, Any]:
    """Light manifest (no data): receiver admission control + assembly."""
    tensors = {}
    total = 0
    for name, arr in arrays.items():
        dtype, _, buf = _wire_form(arr)
        nbytes = _flat_bytes(buf).nbytes
        # a 0-d array keeps its shape here, as in the reference
        shape = list(arr.shape) if hasattr(arr, "shape") else list(np.shape(arr))
        tensors[name] = {"dtype": dtype, "shape": shape, "nbytes": nbytes}
        total += nbytes
    return {"tensors": tensors, "total": total}


def iter_array_chunks(arrays: Mapping[str, Any], chunk_bytes: int = STREAM_CHUNK_BYTES):
    """Yield (name, offset, data) byte-range chunks, tensor by tensor."""
    for name, arr in arrays.items():
        raw = _flat_bytes(_wire_form(arr)[2])
        if raw.nbytes == 0:
            yield name, 0, b""
            continue
        for off in range(0, raw.nbytes, chunk_bytes):
            yield name, off, raw[off:off + chunk_bytes].tobytes()


class StreamAssembler:
    """Order-independent chunk assembly against a ``stream_manifest``.

    ``sink(name, tensor)`` fires once per tensor (a CPU torch tensor) the
    moment its last byte lands; the staging buffer is then the tensor's."""

    def __init__(self, manifest: Mapping[str, Any], sink):
        self.manifest = manifest
        self.sink = sink
        self._buf: dict[str, bytearray] = {}
        self._got: dict[str, int] = {}
        self.received = 0
        self.completed = 0
        # chunk messages dispatch concurrently (worker threads): feed's
        # bookkeeping is serialized, or two chunks of one tensor race the
        # buffer allocation and the stream completes with holes
        self._lock = threading.Lock()

    @property
    def done(self) -> bool:
        with self._lock:
            return self.completed == len(self.manifest["tensors"])

    def feed(self, name: str, off: int, data: bytes) -> None:
        meta = self.manifest["tensors"].get(name)
        if meta is None:
            raise ValueError(f"chunk for unknown tensor {name!r}")
        nbytes = int(meta["nbytes"])
        if off < 0 or off + len(data) > nbytes:
            raise ValueError(f"chunk out of range for {name!r}")
        with self._lock:
            if name not in self._buf:
                if name in self._got:
                    raise ValueError(f"duplicate tensor {name!r} after completion")
                self._buf[name] = bytearray(nbytes)
                self._got[name] = 0
            buf = self._buf[name]
            buf[off:off + len(data)] = data
            self._got[name] += len(data)
            self.received += len(data)
            complete = self._got[name] >= nbytes
            if complete:
                del self._buf[name]
        if complete:
            dtype = _TORCH_BY_NAME.get(meta["dtype"])
            if dtype is None:
                raise ValueError(f"unknown wire dtype {meta['dtype']!r}")
            if nbytes:
                t = torch.frombuffer(buf, dtype=torch.uint8).view(dtype)
            else:
                t = torch.empty((0,), dtype=dtype)
            self.sink(name, t.reshape(meta["shape"]))
            # completion counts only after the sink returns: ``done`` gates
            # STREAM_END's finish, which must see every sink effect
            with self._lock:
                self.completed += 1


# ---------------------------------------------------------------- pytrees


def tree_flatten_arrays(tree: Any, prefix: str = "") -> dict[str, Any]:
    """Nested dict of arrays -> flat ``{dotted.path: leaf}``, keys sorted
    at each level and an empty dict kept as ``path + "//empty"`` (a
    0-length uint8 array), as the reference writes them. A torch tensor
    stays a tensor (bf16 has no numpy dtype); any other leaf becomes a
    numpy array. A flat state dict (``"a.b.c"`` keys) flattens to the
    same names as the nested tree it stands for."""
    flat: dict[str, Any] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            if not node:
                flat[path + "//empty"] = np.zeros((0,), np.uint8)
                return
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else str(k))
        else:
            flat[path] = node if isinstance(node, torch.Tensor) else np.asarray(node)

    walk(tree, prefix)
    return flat


def tree_unflatten_arrays(flat: Mapping[str, Any]) -> Any:
    """Inverse of ``tree_flatten_arrays``: dotted names -> nested dicts,
    ``//empty`` markers -> ``{}``."""
    tree: dict[str, Any] = {}
    saw_empty_root = False
    for name, arr in flat.items():
        empty = name.endswith("//empty")
        path = name[: -len("//empty")] if empty else name
        if empty and not path:
            saw_empty_root = True
            continue
        parts = path.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = {} if empty else arr
    if saw_empty_root and not tree:
        return {}
    return tree
