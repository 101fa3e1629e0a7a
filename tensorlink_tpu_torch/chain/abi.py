"""Minimal Solidity ABI codec for the registry contract surface.

The reference carries a 1.5 MB generated ABI JSON and lets web3.py do the
encoding (reference config/SmartNodes.json, src/p2p/smart_node.py:165-179).
The registry interface here needs only a handful of types, so this is a
direct implementation of the ABI v2 head/tail encoding for:

    uintN / int-free unsigned ints, bool, address, bytesN, string, bytes,
    and one-dimensional dynamic arrays T[] of those.

Values are Python ints / bools / str (0x-hex for address) / bytes / lists.

The port's copy of ``tensorlink_tpu/chain/abi.py``, which uses no
framework: the port keeps its own so that it never imports the JAX
package. Keep the two in step.
"""

from __future__ import annotations

_WORD = 32


def _is_dynamic(typ: str) -> bool:
    if typ.endswith("[]"):
        return True
    return typ in ("string", "bytes")


def _pad_right(b: bytes) -> bytes:
    rem = len(b) % _WORD
    return b if rem == 0 else b + b"\x00" * (_WORD - rem)


def _encode_static(typ: str, value) -> bytes:
    if typ.startswith("uint") or typ == "int" or typ.startswith("int"):
        v = int(value)
        if v < 0:
            v += 1 << 256  # two's complement
        return v.to_bytes(_WORD, "big")
    if typ == "bool":
        return int(bool(value)).to_bytes(_WORD, "big")
    if typ == "address":
        h = value[2:] if isinstance(value, str) and value.startswith("0x") else value
        raw = bytes.fromhex(h) if isinstance(h, str) else bytes(h)
        if len(raw) != 20:
            raise ValueError(f"address must be 20 bytes, got {len(raw)}")
        return raw.rjust(_WORD, b"\x00")
    if typ.startswith("bytes") and typ != "bytes":  # bytesN
        n = int(typ[5:])
        raw = bytes(value)
        if len(raw) != n:
            raise ValueError(f"{typ} needs exactly {n} bytes")
        return raw.ljust(_WORD, b"\x00")
    raise ValueError(f"unsupported static type {typ}")


def _encode_one(typ: str, value) -> bytes:
    """Encoding of one value as it appears in a tail (dynamic) or head (static)."""
    if typ.endswith("[]"):
        elem = typ[:-2]
        return len(value).to_bytes(_WORD, "big") + encode([elem] * len(value), list(value))
    if typ == "string":
        raw = value.encode("utf-8")
        return len(raw).to_bytes(_WORD, "big") + _pad_right(raw)
    if typ == "bytes":
        raw = bytes(value)
        return len(raw).to_bytes(_WORD, "big") + _pad_right(raw)
    return _encode_static(typ, value)


def encode(types: list[str], values: list) -> bytes:
    """ABI-encode a flat argument list (head/tail layout)."""
    if len(types) != len(values):
        raise ValueError("types/values length mismatch")
    heads: list[bytes] = []
    tails: list[bytes] = []
    head_len = _WORD * len(types)
    for typ, val in zip(types, values):
        if _is_dynamic(typ):
            offset = head_len + sum(len(t) for t in tails)
            heads.append(offset.to_bytes(_WORD, "big"))
            tails.append(_encode_one(typ, val))
        else:
            heads.append(_encode_static(typ, val))
    return b"".join(heads) + b"".join(tails)


def _decode_static(typ: str, word: bytes):
    if typ.startswith("uint"):
        return int.from_bytes(word, "big")
    if typ.startswith("int"):
        v = int.from_bytes(word, "big")
        return v - (1 << 256) if v >= 1 << 255 else v
    if typ == "bool":
        return bool(int.from_bytes(word, "big"))
    if typ == "address":
        return "0x" + word[-20:].hex()
    if typ.startswith("bytes") and typ != "bytes":
        return word[: int(typ[5:])]
    raise ValueError(f"unsupported static type {typ}")


def _decode_one(typ: str, data: bytes, at: int):
    """Decode one dynamic value whose data begins at `at`."""
    if at + _WORD > len(data):
        raise ValueError(
            f"truncated returndata: dynamic {typ} head at {at} past "
            f"{len(data)} bytes"
        )
    if typ.endswith("[]"):
        elem = typ[:-2]
        n = int.from_bytes(data[at:at + _WORD], "big")
        body = data[at + _WORD:]
        # check n against the remaining bytes BEFORE [elem] * n — a
        # garbage count would otherwise allocate a 2**256-entry list
        if n * _WORD > len(body):
            raise ValueError(
                f"truncated returndata: {typ} declares {n} elements, "
                f"{len(body)} bytes remain"
            )
        return decode([elem] * n, body)
    length = int.from_bytes(data[at:at + _WORD], "big")
    raw = data[at + _WORD:at + _WORD + length]
    if len(raw) < length:
        raise ValueError(
            f"truncated returndata: {typ} declares {length} bytes, "
            f"{len(raw)} present"
        )
    return raw.decode("utf-8") if typ == "string" else raw


def decode(types: list[str], data: bytes) -> list:
    """ABI-decode a flat result list (the inverse of `encode`).

    Length-checked: a wrong contract returning short/garbage non-empty
    data must raise, not silently decode to zeros (advisor finding r3 —
    int.from_bytes of a short slice yields a bogus value)."""
    if len(data) < _WORD * len(types):
        raise ValueError(
            f"truncated returndata: {len(types)} head words need "
            f"{_WORD * len(types)} bytes, got {len(data)}"
        )
    out = []
    for i, typ in enumerate(types):
        word = data[_WORD * i:_WORD * (i + 1)]
        if _is_dynamic(typ):
            out.append(_decode_one(typ, data, int.from_bytes(word, "big")))
        else:
            out.append(_decode_static(typ, word))
    return out
