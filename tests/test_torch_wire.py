"""PyTorch port, the KV wire (``native/``, ``p2p/serialization.py``,
``parallel/kvwire.py``), held against the JAX package's on the same
arrays:

- a port ``pack_arrays`` blob is byte-identical to the reference's for
  f32, int8, int32 scalars and bf16 (``torch.bfloat16`` here,
  ``ml_dtypes`` there), under codecs none, zlib and zstd, and blobs cross
  both ways;
- the manifest codec equals ``msgpack.packb(..., use_bin_type=True)``
  over generated manifests, and reads them back;
- the port's CRC-32C equals the reference's, native and fallback;
- a flipped body byte raises ``ValueError``;
- kvwire schemas 1 and 2 round-trip (and match the reference's blob
  byte for byte), an unknown schema is refused."""

import zlib

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tensorlink_tpu import native as jnative
from tensorlink_tpu.p2p import serialization as jser
from tensorlink_tpu.parallel import kvwire as jkv
from tensorlink_tpu_torch import native
from tensorlink_tpu_torch.p2p import serialization as ser
from tensorlink_tpu_torch.parallel import kvwire


def _arrays(seed=0):
    """The same values as (reference numpy dict, port tensor dict)."""
    r = np.random.default_rng(seed)
    f = r.standard_normal((3, 5)).astype(np.float32)
    i8 = r.integers(-127, 128, (2, 4, 3)).astype(np.int8)
    b = r.standard_normal((4, 7)).astype(np.float32)
    ref = {"f": f, "i8": i8, "s": np.asarray(7, np.int32),
           "n": np.asarray(-3, np.int32), "b": b.astype(ml_dtypes.bfloat16)}
    port = {"f": torch.from_numpy(f), "i8": torch.from_numpy(i8),
            "s": torch.tensor(7, dtype=torch.int32),
            "n": torch.tensor(-3, dtype=torch.int32),
            "b": torch.from_numpy(b).to(torch.bfloat16)}
    return ref, port


def _same(port: torch.Tensor, ref: np.ndarray) -> None:
    ref = np.asarray(ref)
    if port.dtype == torch.bfloat16:
        np.testing.assert_array_equal(port.float().numpy(), ref.astype(np.float32))
    else:
        np.testing.assert_array_equal(port.numpy().reshape(ref.shape), ref)


@pytest.mark.parametrize("codec", ["none", "zlib", "zstd"])
def test_pack_arrays_byte_identical_to_the_reference(codec):
    ref, port = _arrays()
    blob = ser.pack_arrays(port, codec=codec)
    assert blob == jser.pack_arrays(ref, codec=codec)
    assert ser.packed_nbytes(blob) == jser.packed_nbytes(blob)


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_blobs_cross_both_ways(codec):
    ref, port = _arrays(1)
    mine = ser.unpack_arrays(jser.pack_arrays(ref, codec=codec))
    theirs = jser.unpack_arrays(ser.pack_arrays(port, codec=codec))
    assert set(mine) == set(theirs) == set(ref)
    for name in ref:
        _same(mine[name], ref[name])
        _same(port[name], theirs[name])
    assert mine["b"].dtype == torch.bfloat16
    assert theirs["b"].dtype == ml_dtypes.bfloat16


_keys = st.text(min_size=0, max_size=40)
_leaf = (st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
         | st.text(max_size=300) | st.binary(max_size=300) | st.none()
         | st.booleans() | st.floats(allow_nan=False))
_manifest = st.recursive(
    _leaf,
    lambda kids: st.lists(kids, max_size=20) | st.dictionaries(_keys, kids, max_size=20),
    max_leaves=60,
)


@settings(max_examples=200, deadline=None)
@given(_manifest)
def test_manifest_codec_equals_msgpack(obj):
    raw = ser.packb(obj)
    assert raw == msgpack.packb(obj, use_bin_type=True)
    assert ser.unpackb(raw) == msgpack.unpackb(raw, raw=False, strict_map_key=False)


def test_manifest_codec_long_forms():
    """The 16- and 32-bit headers: long strings, bins, lists and maps."""
    for obj in ("x" * 70000, b"y" * 70000, list(range(70000)),
                {str(i): i for i in range(70000)}):
        raw = ser.packb(obj)
        assert raw == msgpack.packb(obj, use_bin_type=True)
        assert ser.unpackb(raw) == obj
    with pytest.raises(ValueError, match="extra bytes"):
        ser.unpackb(ser.packb(1) + b"\x00")


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 65537])
def test_crc32c_equals_the_reference_native_and_fallback(n):
    data = np.random.default_rng(n).integers(0, 256, n).astype(np.uint8).tobytes()
    want = jnative._py_crc32c(data)
    assert native.have_native()
    assert native.crc32c(data) == want == jnative.crc32c(data)
    assert native._py_crc32c(data) == want
    # chained
    half = n // 2
    assert native.crc32c(data[half:], native.crc32c(data[:half])) == want


def test_gather_equals_the_reference_native_and_fallback(monkeypatch):
    ref, port = _arrays(2)
    want = jnative.gather([v.view(np.uint8) if v.dtype == ml_dtypes.bfloat16 else v
                           for v in ref.values()])
    got = native.gather(list(port.values()))
    assert bytes(got[0]) == bytes(want[0]) and got[1] == want[1]
    monkeypatch.setattr(native, "_load", lambda: None)  # no toolchain
    slow = native.gather(list(port.values()))
    assert bytes(slow[0]) == bytes(want[0]) and slow[1] == want[1]
    assert native.crc32c(bytes(want[0])) == want[1]


@pytest.mark.parametrize("codec", ["none", "zlib"])
def test_flipped_body_byte_is_refused(codec):
    _, port = _arrays(3)
    blob = bytearray(ser.pack_arrays(port, codec=codec))
    blob[-3] ^= 0xFF
    if codec == "none":
        with pytest.raises(ValueError, match="CRC-32C"):
            ser.unpack_arrays(bytes(blob))
    else:  # the codec's own check fires first, as in the reference
        with pytest.raises((zlib.error, ValueError)):
            ser.unpack_arrays(bytes(blob))
    with pytest.raises(ValueError, match="magic"):
        ser.unpack_arrays(b"XXXX" + bytes(blob[4:]))


def _payload(quant: bool, seed=0):
    """One payload as (reference numpy form, port tensor form)."""
    r = np.random.default_rng(seed)
    n, bs, hkv, d = 3, 4, 2, 8
    ids = r.integers(0, 128, (10,)).astype(np.int32)
    ref = {"prompt_ids": ids, "layers": [], "n_valid": 10, "tok0": 5,
           "seed": 11, "remaining": 4, "block_size": bs,
           "prefix_digest": bytes(range(20))}
    port = dict(ref, prompt_ids=torch.from_numpy(ids), layers=[])
    for _ in range(2):
        if quant:
            k = r.integers(-127, 128, (n, bs, hkv, d)).astype(np.int8)
            v = r.integers(-127, 128, (n, bs, hkv, d)).astype(np.int8)
            ks = r.random((n, bs, hkv)).astype(np.float32)
            vs = r.random((n, bs, hkv)).astype(np.float32)
            ref["layers"].append({"k": k, "v": v, "k_scale": ks, "v_scale": vs})
            port["layers"].append({key: torch.from_numpy(a) for key, a in
                                   {"k": k, "v": v, "k_scale": ks, "v_scale": vs}.items()})
        else:
            k = r.standard_normal((n, bs, hkv, d)).astype(np.float32)
            v = r.standard_normal((n, bs, hkv, d)).astype(np.float32)
            ref["layers"].append({"k": k.astype(ml_dtypes.bfloat16),
                                  "v": v.astype(ml_dtypes.bfloat16)})
            port["layers"].append({"k": torch.from_numpy(k).to(torch.bfloat16),
                                   "v": torch.from_numpy(v).to(torch.bfloat16)})
    if quant:
        ref["kv_quant"] = port["kv_quant"] = "int8"
    return ref, port


@pytest.mark.parametrize("quant", [False, True], ids=["schema1", "schema2"])
def test_kvwire_round_trip_and_identity(quant):
    ref, port = _payload(quant)
    blob = kvwire.pack_kv_payload(port, codec="none")
    assert blob == jkv.pack_kv_payload(ref, codec="none")
    schema = kvwire.KV_WIRE_INT8_SCHEMA if quant else kvwire.KV_WIRE_SCHEMA
    assert int(kvwire.flatten_kv_payload(port)["schema"]) == schema
    back = kvwire.unpack_kv_payload(blob)
    jback = jkv.unpack_kv_payload(blob)
    for key in ("n_valid", "tok0", "seed", "remaining", "block_size", "prefix_digest"):
        assert back[key] == jback[key] == ref[key]
    assert back.get("kv_quant") == ref.get("kv_quant")
    np.testing.assert_array_equal(back["prompt_ids"].numpy(), ref["prompt_ids"])
    for lb, lr in zip(back["layers"], ref["layers"]):
        assert set(lb) == set(lr)
        for key in lr:
            _same(lb[key], lr[key])


def test_kvwire_refuses_an_unknown_schema_and_missing_scales():
    _, port = _payload(False)
    flat = kvwire.flatten_kv_payload(port)
    flat["schema"] = torch.tensor(99, dtype=torch.int64)
    with pytest.raises(ValueError, match="schema 99"):
        kvwire.unpack_kv_payload(ser.pack_arrays(flat, codec="none"))
    _, qport = _payload(True)
    qflat = kvwire.flatten_kv_payload(qport)
    del qflat["L1.vs"]
    with pytest.raises(ValueError, match="missing scales"):
        kvwire.unflatten_kv_payload(qflat)
    with pytest.raises(ValueError, match="kv_quant"):
        kvwire.flatten_kv_payload(dict(port, kv_quant="fp8"))
