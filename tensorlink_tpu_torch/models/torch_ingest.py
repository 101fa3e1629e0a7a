"""Torch model ingestion: structural conversion to the port's modules
(port of ``tensorlink_tpu/models/torch_ingest.py``).

For the long tail of container-style models: walk a ``torch.nn`` tree
built from standard layers and emit the port's equivalent native
``Sequential`` holding the same weights, laid out as the reference lays
its param tree out. The result partitions, ships (``config()`` ->
``module_from_config``) and trains on a fleet (``UserNode.request_job``)
like any native model. Known families go through ``models/hf_import.py``
instead.

Supported leaves: Linear, ReLU, GELU, SiLU, Tanh, Sigmoid, LayerNorm,
Dropout, Embedding, Flatten, Identity, nested Sequential,
MultiheadAttention (self-attention, ``batch_first``),
TransformerEncoderLayer (pre- and post-LN) and TransformerEncoder, which
convert to the port's ``MultiHeadAttention`` / ``TransformerBlock`` with
q/k/v unpacked from torch's one [3E, E] ``in_proj``. Attention is
``attn_impl="reference"``, as in the reference. Anything else raises
``UnsupportedTorchModule`` with the module path (the reference's
messages).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn as tn
import torch.nn.functional as F

from tensorlink_tpu_torch import resolve_device
from tensorlink_tpu_torch.nn.attention import MultiHeadAttention
from tensorlink_tpu_torch.nn.layers import Dense, Dropout, Embedding, LayerNorm
from tensorlink_tpu_torch.nn.module import (
    _ACTIVATION_FNS,
    Lambda,
    Module,
    Sequential,
)
from tensorlink_tpu_torch.nn.transformer import TransformerBlock


class UnsupportedTorchModule(ValueError):
    pass


def _act(name: str) -> Lambda:
    return Lambda(_ACTIVATION_FNS[name], name=name)


def _w(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu()


def _convert_leaf(mod: Any, path: str) -> tuple[Module, dict] | None:
    """-> (native module, flat params relative to it) or None to skip
    (Identity)."""
    if isinstance(mod, tn.Linear):
        dense = Dense(mod.in_features, mod.out_features,
                      use_bias=mod.bias is not None, device="cpu")
        p = {"w": _w(mod.weight).T}
        if mod.bias is not None:
            p["b"] = _w(mod.bias)
        return dense, p
    if isinstance(mod, tn.Embedding):
        emb = Embedding(mod.num_embeddings, mod.embedding_dim, device="cpu")
        return emb, {"table": _w(mod.weight)}
    if isinstance(mod, tn.LayerNorm):
        if len(mod.normalized_shape) != 1:
            raise UnsupportedTorchModule(
                f"{path}: only last-dim LayerNorm supported"
            )
        if mod.weight is None or mod.bias is None:
            raise UnsupportedTorchModule(
                f"{path}: non-affine / bias-free LayerNorm not supported"
            )
        ln = LayerNorm(mod.normalized_shape[0], eps=mod.eps, device="cpu")
        return ln, {"scale": _w(mod.weight), "bias": _w(mod.bias)}
    if isinstance(mod, tn.Dropout):
        return Dropout(mod.p), {}
    if isinstance(mod, tn.ReLU):
        return _act("relu"), {}
    if isinstance(mod, tn.GELU):
        # torch GELU(approximate="none") is the erf form
        return _act("gelu" if mod.approximate == "tanh" else "gelu_exact"), {}
    if isinstance(mod, tn.SiLU):
        return _act("silu"), {}
    if isinstance(mod, tn.Tanh):
        return _act("tanh"), {}
    if isinstance(mod, tn.Sigmoid):
        return _act("sigmoid"), {}
    if isinstance(mod, tn.Flatten):
        if mod.start_dim != 1 or mod.end_dim != -1:
            raise UnsupportedTorchModule(f"{path}: only Flatten(1, -1)")
        # the registered fn: workers rebuild Lambdas from config BY NAME
        return _act("flatten"), {}
    if isinstance(mod, tn.Identity):
        return None
    if isinstance(mod, tn.MultiheadAttention):
        return _convert_mha(mod, path)
    if isinstance(mod, tn.TransformerEncoderLayer):
        return _convert_encoder_layer(mod, path)
    raise UnsupportedTorchModule(
        f"{path}: {type(mod).__name__} has no native equivalent; "
        "re-implement the architecture and import weights instead "
        "(models/hf_import.py pattern)"
    )


def _convert_mha(mod: Any, path: str,
                 allow_attn_dropout: bool = False) -> tuple[Module, dict]:
    """torch nn.MultiheadAttention (self-attention use) -> the port's
    MultiHeadAttention + params: q/k/v from the packed in_proj [3E, E],
    each transposed to [in, out]. batch_first=True is required (the
    native layout is [B, T, D]); attention-probability dropout has no
    native form, so mod.dropout must be 0 (a TransformerEncoderLayer
    opts in: its dropout= knob fans into the MHA, and the block's
    residual dropout carries the rate)."""
    if not getattr(mod, "batch_first", False):
        raise UnsupportedTorchModule(
            f"{path}: MultiheadAttention needs batch_first=True "
            "(native layout is [B, T, D])"
        )
    if getattr(mod, "dropout", 0.0) and not allow_attn_dropout:
        raise UnsupportedTorchModule(
            f"{path}: attention-probability dropout is not supported "
            "natively; set MultiheadAttention(dropout=0)"
        )
    if mod.in_proj_weight is None:
        raise UnsupportedTorchModule(
            f"{path}: separate kdim/vdim projections not supported "
            "(self-attention with one packed in_proj only)"
        )
    if getattr(mod, "bias_k", None) is not None or getattr(
        mod, "add_zero_attn", False
    ):
        raise UnsupportedTorchModule(
            f"{path}: add_bias_kv / add_zero_attn have no native "
            "equivalent (their learned bias_k/bias_v and the zero "
            "column would be silently dropped)"
        )
    E = mod.embed_dim
    native = MultiHeadAttention(
        E, mod.num_heads, use_bias=mod.in_proj_bias is not None,
        causal=False, attn_impl="reference", device="cpu",
    )
    w = _w(mod.in_proj_weight)  # [3E, E]
    params = {"q.w": w[:E].T, "k.w": w[E:2 * E].T, "v.w": w[2 * E:].T,
              "o.w": _w(mod.out_proj.weight).T}
    if mod.in_proj_bias is not None:
        b = _w(mod.in_proj_bias)
        params.update({"q.b": b[:E], "k.b": b[E:2 * E], "v.b": b[2 * E:],
                       "o.b": _w(mod.out_proj.bias)})
    return native, params


def _convert_encoder_layer(mod: Any, path: str) -> tuple[Module, dict]:
    """torch nn.TransformerEncoderLayer -> the port's TransformerBlock.

    torch wiring (batch_first): self_attn -> dropout1 -> +residual ->
    norm1 -> linear1 -> act -> dropout -> linear2 -> dropout2 ->
    +residual -> norm2 (post-LN), or the norm_first pre-LN variant:
    TransformerBlock's two styles, norm1 attention-side and norm2
    MLP-side in both."""
    act_mod = getattr(mod, "activation", None)
    if callable(act_mod) and not isinstance(act_mod, tn.Module):
        act = {F.relu: "relu", F.gelu: "gelu_exact"}.get(act_mod)
    else:
        if isinstance(act_mod, tn.GELU):
            act = "gelu" if act_mod.approximate == "tanh" else "gelu_exact"
        else:
            act = {tn.ReLU: "relu"}.get(type(act_mod))
    if act is None:
        raise UnsupportedTorchModule(
            f"{path}: unsupported encoder-layer activation {act_mod!r}"
        )
    _, attn_params = _convert_mha(
        mod.self_attn, f"{path}.self_attn", allow_attn_dropout=True
    )
    E = mod.self_attn.embed_dim
    block = TransformerBlock(
        dim=E,
        num_heads=mod.self_attn.num_heads,
        hidden_dim=mod.linear1.out_features,
        norm_style="pre" if getattr(mod, "norm_first", False) else "post",
        norm="layer",
        norm_eps=mod.norm1.eps,
        activation=act,
        use_bias=mod.linear1.bias is not None,
        causal=False,
        dropout=float(mod.dropout1.p),
        attn_impl="reference",
        device="cpu",
    )
    params = {
        "norm1.scale": _w(mod.norm1.weight), "norm1.bias": _w(mod.norm1.bias),
        "norm2.scale": _w(mod.norm2.weight), "norm2.bias": _w(mod.norm2.bias),
        **{f"attn.{k}": v for k, v in attn_params.items()},
        "mlp.up.w": _w(mod.linear1.weight).T,
        "mlp.down.w": _w(mod.linear2.weight).T,
    }
    if mod.linear1.bias is not None:
        params["mlp.up.b"] = _w(mod.linear1.bias)
        params["mlp.down.b"] = _w(mod.linear2.bias)
    return block, params


def _expand(m):
    """Container -> child list, or None for leaves. TransformerEncoder is
    a chain of encoder layers (+ optional final norm): structurally a
    Sequential."""
    if isinstance(m, tn.Sequential):
        return list(m)
    if isinstance(m, tn.TransformerEncoder):
        out = list(m.layers)
        if m.norm is not None:
            out.append(m.norm)
        return out
    return None


def _collect(module: Any, path: str) -> list[tuple[Module, dict]]:
    top = _expand(module)
    if top is None:  # a single leaf
        conv = _convert_leaf(module, path)
        return [] if conv is None else [conv]
    out = []
    for i, child in enumerate(top):
        cpath = f"{path}.{i}"
        if _expand(child) is not None:
            out.extend(_collect(child, cpath))
            continue
        conv = _convert_leaf(child, cpath)
        if conv is not None:
            out.append(conv)
    return out


def from_torch(module: Any, path: str = "root", *, device=None
               ) -> tuple[Sequential, dict[str, torch.Tensor]]:
    """torch nn.Sequential (possibly nested), TransformerEncoder or a
    supported leaf -> (native ``Sequential``, params). Nested containers
    flatten into one chain, children "0".."N-1" as in the reference. The
    model holds the torch module's weights on ``device`` (CUDA unless told
    otherwise) in their dtype; params is its flat state dict
    (``"0.w"``, ``"2.attn.q.w"``, ...), sharing the model's tensors, ready
    for ``partition_sequential`` / ``UserNode.request_job``."""
    dev = resolve_device(device)
    convs = _collect(module, path)
    model = Sequential([m for m, _ in convs])
    state = {f"{i}.{k}": v for i, (_, p) in enumerate(convs) for k, v in p.items()}
    names = dict(model.named_parameters())
    if set(names) != set(state):
        raise RuntimeError(f"ingest layout mismatch: {sorted(set(names) ^ set(state))}")
    for name, p in names.items():
        # a copy: the ingested model never shares storage with the torch one
        p.data = state[name].to(device=dev, copy=True,
                                memory_format=torch.contiguous_format)
    return model, dict(model.named_parameters())
