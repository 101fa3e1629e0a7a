"""HuggingFace checkpoint import (port of
``tensorlink_tpu/models/hf_import.py``).

Model code is native and only weights move: a flat ``{name: tensor}``
state dict, read from a ``.safetensors`` file by ``load_safetensors`` or
taken from a torch ``state_dict()``, is remapped onto the port's
modules. torch Linear weights are [out, in] and transposed; GPT-2 Conv1D
weights are already [in, out]. Each ``*_params_from_hf`` takes torch
tensors or numpy arrays and returns a flat f32 state dict (on the
tensors' device; numpy arrays give CPU tensors) whose names are the JAX
param tree's keys joined by "." (load it with
``model.load_state_dict``): the reference's key names, transposes, tie
fallbacks and f32 result, key for key.

``load_safetensors`` is the port's own reader of the format (an 8-byte
little-endian header length, a JSON header of each tensor's dtype,
shape and ``data_offsets``, then the raw bytes), with ``json`` and
``torch.frombuffer``: it needs neither ``safetensors`` nor ``ml_dtypes``,
and keeps BF16 tensors as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Mapping

import numpy as np
import torch

from tensorlink_tpu_torch.convert import _to_tensor
from tensorlink_tpu_torch.models.bert import BertConfig
from tensorlink_tpu_torch.models.gpt2 import GPT2Config
from tensorlink_tpu_torch.models.llama import LlamaConfig
from tensorlink_tpu_torch.models.vit import ViTConfig

# safetensors dtype names -> torch dtypes
SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def _a(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else _to_tensor(x)


def _t(x) -> torch.Tensor:  # torch Linear -> our [in, out]
    return _a(x).T


def load_safetensors(path: str) -> dict[str, torch.Tensor]:
    """Read a ``.safetensors`` file -> {name: CPU tensor}, each in its
    stored dtype (BF16 as ``torch.bfloat16``). Raises ``ValueError`` on a
    header that is short, malformed or past the file's end, on an unknown
    dtype, and on data offsets out of bounds or disagreeing with the
    tensor's shape."""
    with open(path, "rb") as f:
        raw = bytearray(os.fstat(f.fileno()).st_size)  # one buffer, no copy
        f.readinto(raw)
    if len(raw) < 8:
        raise ValueError(f"{path}: {len(raw)} bytes, too short for a "
                         "safetensors header length")
    (n,) = struct.unpack("<Q", bytes(raw[:8]))
    if n > len(raw) - 8:
        raise ValueError(f"{path}: header of {n} bytes past the file's end "
                         f"({len(raw)} bytes)")
    try:
        header = json.loads(bytes(raw[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: malformed safetensors header ({e})") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: the safetensors header is not an object")
    base, size = 8 + n, len(raw) - 8 - n
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        try:
            dtype = SAFETENSORS_DTYPES.get(info["dtype"])
            shape = [int(d) for d in info["shape"]]
            begin, end = (int(o) for o in info["data_offsets"])
        except (KeyError, TypeError, ValueError) as e:
            raise ValueError(f"{path}: {name} has a malformed entry ({e!r})") from None
        if dtype is None:
            raise ValueError(f"{path}: {name} has unknown dtype {info['dtype']!r}")
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= begin <= end <= size or end - begin != count * itemsize:
            raise ValueError(
                f"{path}: {name} data_offsets [{begin}, {end}) out of bounds "
                f"or not {count} x {itemsize} bytes (data section {size} bytes)")
        t = (torch.frombuffer(raw, dtype=dtype, count=count, offset=base + begin)
             if count else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def strip_prefix(sd: Mapping[str, Any], prefix: str) -> dict[str, Any]:
    return {
        (k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()
    }


def bert_params_from_hf(sd: Mapping[str, Any], cfg: BertConfig) -> dict:
    """Map an HF BertModel state dict onto the native `Bert` parameters."""
    p: dict = {
        "tok_emb": {"table": _a(sd["embeddings.word_embeddings.weight"])},
        "pos_emb": {"table": _a(sd["embeddings.position_embeddings.weight"])},
        "type_emb": {"table": _a(sd["embeddings.token_type_embeddings.weight"])},
        "emb_norm": {
            "scale": _a(sd["embeddings.LayerNorm.weight"]),
            "bias": _a(sd["embeddings.LayerNorm.bias"]),
        },
        "emb_drop": {},
        "encoder": {},
        "pooler": {
            "w": _t(sd["pooler.dense.weight"]),
            "b": _a(sd["pooler.dense.bias"]),
        },
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}."
        p["encoder"][str(i)] = {
            "attn": {
                "q": {
                    "w": _t(sd[pre + "attention.self.query.weight"]),
                    "b": _a(sd[pre + "attention.self.query.bias"]),
                },
                "k": {
                    "w": _t(sd[pre + "attention.self.key.weight"]),
                    "b": _a(sd[pre + "attention.self.key.bias"]),
                },
                "v": {
                    "w": _t(sd[pre + "attention.self.value.weight"]),
                    "b": _a(sd[pre + "attention.self.value.bias"]),
                },
                "o": {
                    "w": _t(sd[pre + "attention.output.dense.weight"]),
                    "b": _a(sd[pre + "attention.output.dense.bias"]),
                },
            },
            "norm1": {
                "scale": _a(sd[pre + "attention.output.LayerNorm.weight"]),
                "bias": _a(sd[pre + "attention.output.LayerNorm.bias"]),
            },
            "mlp": {
                "up": {
                    "w": _t(sd[pre + "intermediate.dense.weight"]),
                    "b": _a(sd[pre + "intermediate.dense.bias"]),
                },
                "down": {
                    "w": _t(sd[pre + "output.dense.weight"]),
                    "b": _a(sd[pre + "output.dense.bias"]),
                },
                "drop": {},
            },
            "norm2": {
                "scale": _a(sd[pre + "output.LayerNorm.weight"]),
                "bias": _a(sd[pre + "output.LayerNorm.bias"]),
            },
            "drop": {},
        }
    return _to_state(p)


def gpt2_params_from_hf(sd: Mapping[str, Any], cfg: GPT2Config) -> dict:
    """Map an HF GPT2Model state dict onto the native `GPT2` parameters."""
    p: dict = {
        "wte": {"table": _a(sd["wte.weight"])},
        "wpe": {"table": _a(sd["wpe.weight"])},
        "drop": {},
        "blocks": {},
        "ln_f": {
            "scale": _a(sd["ln_f.weight"]),
            "bias": _a(sd["ln_f.bias"]),
        },
    }
    D = cfg.dim
    for i in range(cfg.num_layers):
        pre = f"h.{i}."
        c_attn_w = _a(sd[pre + "attn.c_attn.weight"])  # [in, 3D] (Conv1D)
        c_attn_b = _a(sd[pre + "attn.c_attn.bias"])
        qw, kw, vw = c_attn_w[:, :D], c_attn_w[:, D : 2 * D], c_attn_w[:, 2 * D :]
        qb, kb, vb = c_attn_b[:D], c_attn_b[D : 2 * D], c_attn_b[2 * D :]
        p["blocks"][str(i)] = {
            "norm1": {
                "scale": _a(sd[pre + "ln_1.weight"]),
                "bias": _a(sd[pre + "ln_1.bias"]),
            },
            "norm2": {
                "scale": _a(sd[pre + "ln_2.weight"]),
                "bias": _a(sd[pre + "ln_2.bias"]),
            },
            "attn": {
                "q": {"w": qw, "b": qb},
                "k": {"w": kw, "b": kb},
                "v": {"w": vw, "b": vb},
                "o": {
                    "w": _a(sd[pre + "attn.c_proj.weight"]),
                    "b": _a(sd[pre + "attn.c_proj.bias"]),
                },
            },
            "mlp": {
                "up": {
                    "w": _a(sd[pre + "mlp.c_fc.weight"]),
                    "b": _a(sd[pre + "mlp.c_fc.bias"]),
                },
                "down": {
                    "w": _a(sd[pre + "mlp.c_proj.weight"]),
                    "b": _a(sd[pre + "mlp.c_proj.bias"]),
                },
                "drop": {},
            },
            "drop": {},
        }
    return _to_state(p)


def vit_params_from_hf(sd: Mapping[str, Any], cfg: "ViTConfig") -> dict:
    """Map an HF ViTModel state dict onto the native `ViT` parameters.

    The HF conv patch projection weight is [D, C, P, P]; our unfold+matmul
    layout wants [P*P*C, D] with patch pixels varying fastest in
    (row, col, channel) order — matching PatchEmbed's reshape.
    """
    conv_w = _a(sd["embeddings.patch_embeddings.projection.weight"])
    D, C, P_, _ = conv_w.shape
    patch_w = conv_w.permute(2, 3, 1, 0).reshape(P_ * P_ * C, D)
    p: dict = {
        "cls_token": _a(sd["embeddings.cls_token"]),
        "pos_emb": _a(sd["embeddings.position_embeddings"]),
        "patch": {
            "w": patch_w,
            "b": _a(sd["embeddings.patch_embeddings.projection.bias"]),
        },
        "emb_drop": {},
        "encoder": {},
        "final_norm": {
            "scale": _a(sd["layernorm.weight"]),
            "bias": _a(sd["layernorm.bias"]),
        },
    }
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}."
        p["encoder"][str(i)] = {
            "norm1": {
                "scale": _a(sd[pre + "layernorm_before.weight"]),
                "bias": _a(sd[pre + "layernorm_before.bias"]),
            },
            "norm2": {
                "scale": _a(sd[pre + "layernorm_after.weight"]),
                "bias": _a(sd[pre + "layernorm_after.bias"]),
            },
            "attn": {
                "q": {
                    "w": _t(sd[pre + "attention.attention.query.weight"]),
                    "b": _a(sd[pre + "attention.attention.query.bias"]),
                },
                "k": {
                    "w": _t(sd[pre + "attention.attention.key.weight"]),
                    "b": _a(sd[pre + "attention.attention.key.bias"]),
                },
                "v": {
                    "w": _t(sd[pre + "attention.attention.value.weight"]),
                    "b": _a(sd[pre + "attention.attention.value.bias"]),
                },
                "o": {
                    "w": _t(sd[pre + "attention.output.dense.weight"]),
                    "b": _a(sd[pre + "attention.output.dense.bias"]),
                },
            },
            "mlp": {
                "up": {
                    "w": _t(sd[pre + "intermediate.dense.weight"]),
                    "b": _a(sd[pre + "intermediate.dense.bias"]),
                },
                "down": {
                    "w": _t(sd[pre + "output.dense.weight"]),
                    "b": _a(sd[pre + "output.dense.bias"]),
                },
                "drop": {},
            },
            "drop": {},
        }
    return _to_state(p)


def llama_params_from_hf(sd: Mapping[str, Any], cfg: "LlamaConfig") -> dict:
    """Map an HF ``LlamaForCausalLM`` state dict onto the native `Llama`
    parameters. Expects full-model keys (``model.embed_tokens...`` +
    ``lm_head.weight``). Tied-embedding checkpoints (e.g. llama-3.2-1b)
    may omit ``lm_head.weight``; the embedding is reused then.

    ``MistralForCausalLM`` shares this exact layout (Mistral = Llama
    trunk + sliding window, which is config not weights — set
    ``LlamaConfig.attn_window``); windowed-logit parity vs HF is pinned
    in tests/test_models.py::test_mistral_parity_vs_hf."""
    p: dict = {
        "tok_emb": {"table": _a(sd["model.embed_tokens.weight"])},
        "blocks": {},
        "norm_f": {"scale": _a(sd["model.norm.weight"])},
        "lm_head": {
            "w": _t(sd.get("lm_head.weight", sd["model.embed_tokens.weight"]))
        },
    }
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        p["blocks"][str(i)] = {
            "norm1": {"scale": _a(sd[pre + "input_layernorm.weight"])},
            "norm2": {"scale": _a(sd[pre + "post_attention_layernorm.weight"])},
            "attn": {
                "q": {"w": _t(sd[pre + "self_attn.q_proj.weight"])},
                "k": {"w": _t(sd[pre + "self_attn.k_proj.weight"])},
                "v": {"w": _t(sd[pre + "self_attn.v_proj.weight"])},
                "o": {"w": _t(sd[pre + "self_attn.o_proj.weight"])},
            },
            "mlp": {
                "up": {"w": _t(sd[pre + "mlp.up_proj.weight"])},
                "gate": {"w": _t(sd[pre + "mlp.gate_proj.weight"])},
                "down": {"w": _t(sd[pre + "mlp.down_proj.weight"])},
                "drop": {},
            },
            "drop": {},
        }
    return _to_state(p)


def t5_params_from_hf(sd: Mapping[str, Any], cfg) -> dict:
    """Map an HF T5ForConditionalGeneration state dict onto the native
    `T5` param tree (models/t5.py). The FF is the shared FeedForward:
    v1.0 maps HF `wi` -> `up`; v1.1 gated maps HF `wi_0` (the activated
    branch) -> `gate` and `wi_1` (the linear multiplier) -> `up`."""

    def block(side: str, i: int, cross: bool) -> dict:
        pre = f"{side}.block.{i}.layer."
        ff_l = 2 if cross else 1
        ffp = pre + f"{ff_l}.DenseReluDense."
        out: dict = {
            "norm1": {"scale": _a(sd[pre + "0.layer_norm.weight"])},
            "attn": {
                "q": {"w": _t(sd[pre + "0.SelfAttention.q.weight"])},
                "k": {"w": _t(sd[pre + "0.SelfAttention.k.weight"])},
                "v": {"w": _t(sd[pre + "0.SelfAttention.v.weight"])},
                "o": {"w": _t(sd[pre + "0.SelfAttention.o.weight"])},
            },
            "norm2": {"scale": _a(sd[pre + f"{ff_l}.layer_norm.weight"])},
            "ff": (
                {
                    "gate": {"w": _t(sd[ffp + "wi_0.weight"])},
                    "up": {"w": _t(sd[ffp + "wi_1.weight"])},
                    "down": {"w": _t(sd[ffp + "wo.weight"])},
                    "drop": {},
                }
                if cfg.gated_ff
                else {
                    "up": {"w": _t(sd[ffp + "wi.weight"])},
                    "down": {"w": _t(sd[ffp + "wo.weight"])},
                    "drop": {},
                }
            ),
            "drop": {},
        }
        if cross:
            out["norm_x"] = {"scale": _a(sd[pre + "1.layer_norm.weight"])}
            out["xattn"] = {
                "q": {"w": _t(sd[pre + "1.EncDecAttention.q.weight"])},
                "k": {"w": _t(sd[pre + "1.EncDecAttention.k.weight"])},
                "v": {"w": _t(sd[pre + "1.EncDecAttention.v.weight"])},
                "o": {"w": _t(sd[pre + "1.EncDecAttention.o.weight"])},
            }
        return out

    p: dict = {
        "shared": {"table": _a(sd["shared.weight"])},
        "enc_rel": {"w": _a(sd[
            "encoder.block.0.layer.0.SelfAttention."
            "relative_attention_bias.weight"
        ])},
        "dec_rel": {"w": _a(sd[
            "decoder.block.0.layer.0.SelfAttention."
            "relative_attention_bias.weight"
        ])},
        "enc_norm": {"scale": _a(sd["encoder.final_layer_norm.weight"])},
        "dec_norm": {"scale": _a(sd["decoder.final_layer_norm.weight"])},
        "drop": {},
    }
    for i in range(cfg.num_layers):
        p[f"enc{i}"] = block("encoder", i, cross=False)
        p[f"dec{i}"] = block("decoder", i, cross=True)
    if not cfg.tie_word_embeddings:
        p["lm_head"] = {"w": _t(sd["lm_head.weight"])}
    return _to_state(p)


def _to_state(tree, prefix: str = "", out=None) -> dict[str, torch.Tensor]:
    """Nested param tree -> flat f32 state dict (dotted names; empty
    subtrees, the Dropouts', vanish as in ``convert.params_from_jax``)."""
    out = {} if out is None else out
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            _to_state(v, name, out)
        else:
            out[name] = v.to(torch.float32).contiguous()
    return out


def torch_state_dict_to_numpy(model) -> dict[str, np.ndarray]:
    """torch nn.Module -> {name: numpy} (cpu)."""
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}
