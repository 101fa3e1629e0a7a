"""Paged KV blocks as the wire unit of disaggregated prefill/decode (a copy
of ``tensorlink_tpu/parallel/kvwire.py``).

A prefill leg runs chunked prefill into its local pools and ships only
the request's filled blocks plus their logical metadata; the decode leg
grafts the blocks into its own pools through the block table and decodes
as if it had prefilled locally. This module is the byte format between
the two legs:

- the payload is ``{per-layer k/v block stacks, prompt ids, scalars}``
  where every k/v stack is ``[n_blocks, block_size, Hkv, D]``: block
  granularity, never a contiguous cache. int8 pools (``kv_quant="int8"``)
  ship their int8 stacks plus the per-(slot, kv-head) f32 scales under
  ``KV_WIRE_INT8_SCHEMA``; a float payload stays schema 1;
- bytes ride the CRC-framed gather (``p2p/serialization.py
  pack_arrays``): one memory pass concatenates and checksums, and the
  receiver rejects a corrupt blob with ``ValueError``;
- the scalars (logical length, first sampled token, seed, remaining
  budget, block size, schema) and the prefix digest travel as arrays
  inside the same blob, so the CRC covers them too.

In the port a payload's layers hold CPU torch tensors (the reference's
hold numpy arrays); the blob is byte-identical to the reference's for
the same values, so either package reads the other's.
``serving.PagedContinuousBatchingEngine.prefill_export`` produces the
payload; ``import_prefill`` consumes it.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorlink_tpu_torch.p2p.serialization import pack_arrays, unpack_arrays

# bump when the payload schema changes: an old decode worker must reject
# a new prefill worker's blob with a typed error, not misread it
KV_WIRE_SCHEMA = 1
# int8 payloads stamp this version instead: a float payload stays
# byte-identical to schema 1, a quantized one fails a pre-int8 peer's
# schema check
KV_WIRE_INT8_SCHEMA = 2

_SCALARS = (
    "schema", "n_valid", "tok0", "seed", "remaining", "block_size",
)


def _tensor(a, dtype: torch.dtype | None = None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    t = t.detach().cpu()
    return t if dtype is None else t.to(dtype)


def flatten_kv_payload(payload: dict) -> dict[str, torch.Tensor]:
    """Payload dict -> flat ``{name: tensor}`` for the CRC-framed gather:
    every field becomes a tensor, so one checksum covers the payload."""
    quant = payload.get("kv_quant")
    if quant not in (None, "int8"):
        raise ValueError(f"unknown payload kv_quant {quant!r}")
    schema = KV_WIRE_INT8_SCHEMA if quant == "int8" else KV_WIRE_SCHEMA
    flat: dict[str, torch.Tensor] = {
        "prompt_ids": _tensor(payload["prompt_ids"], torch.int32).reshape(-1),
    }
    for name in _SCALARS:
        value = schema if name == "schema" else int(payload[name])
        flat[name] = torch.tensor(value, dtype=torch.int64)
    digest = payload.get("prefix_digest")
    if digest:
        flat["prefix_digest"] = torch.frombuffer(bytearray(digest), dtype=torch.uint8)
    for i, layer in enumerate(payload["layers"]):
        flat[f"L{i}.k"] = _tensor(layer["k"])
        flat[f"L{i}.v"] = _tensor(layer["v"])
        if quant == "int8":
            # int8 block bytes + f32 scale siblings, never a dequantized
            # intermediate
            flat[f"L{i}.ks"] = _tensor(layer["k_scale"], torch.float32)
            flat[f"L{i}.vs"] = _tensor(layer["v_scale"], torch.float32)
    return flat


def _scalar(v) -> int:
    return int(_tensor(v).reshape(-1)[0])


def unflatten_kv_payload(flat: dict) -> dict:
    schema = _scalar(flat["schema"]) if "schema" in flat else -1
    if schema not in (KV_WIRE_SCHEMA, KV_WIRE_INT8_SCHEMA):
        raise ValueError(
            f"kv wire schema {schema} not in "
            f"({KV_WIRE_SCHEMA}, {KV_WIRE_INT8_SCHEMA}) (peer runs an "
            "incompatible build)"
        )
    quant = schema == KV_WIRE_INT8_SCHEMA
    layers = []
    for i in range(len(flat)):
        k = flat.get(f"L{i}.k")
        if k is None:
            break
        layer = {"k": _tensor(k), "v": _tensor(flat[f"L{i}.v"])}
        if quant:
            try:
                layer["k_scale"] = _tensor(flat[f"L{i}.ks"])
                layer["v_scale"] = _tensor(flat[f"L{i}.vs"])
            except KeyError as e:
                raise ValueError(
                    f"int8 kv wire payload layer {i} missing scales"
                ) from e
        layers.append(layer)
    if not layers:
        raise ValueError("kv wire payload carries no layer blocks")
    out = {
        "prompt_ids": _tensor(flat["prompt_ids"], torch.int32).reshape(-1),
        "layers": layers,
    }
    if quant:
        out["kv_quant"] = "int8"
    for name in _SCALARS[1:]:
        out[name] = _scalar(flat[name])
    if "prefix_digest" in flat:
        out["prefix_digest"] = bytes(
            _tensor(flat["prefix_digest"], torch.uint8).numpy().tobytes()
        )
    return out


def pack_kv_payload(payload: dict, codec: str = "zstd") -> bytes:
    """Payload -> one CRC-framed blob (native gather and checksum in one
    memory pass, then the codec)."""
    return pack_arrays(flatten_kv_payload(payload), codec=codec)


def unpack_kv_payload(data: bytes) -> dict:
    """Blob -> payload. Raises ``ValueError`` on a CRC mismatch (a corrupt
    block must never reach a pool) or an unknown schema."""
    return unflatten_kv_payload(unpack_arrays(data))
