"""Stage-sliced decoders for pipeline-sharded serving (port of
``tensorlink_tpu/nn/staging.py``).

A :class:`StageSlice` views a contiguous run ``[lo, hi)`` of a decoder's
transformer layers as a compute unit of its own: stage 0 also owns the
embedding, the last stage the final norm and the LM head (GPT-2's tied
head is its ``wte``, which therefore lives on both ends). The slice calls
the model's own modules, with the same mask / positions / cache contract
as the whole model's forward, so chaining the stages' outputs reproduces
the one-device forward. It references the model's parameters; it never
copies a weight.

Two decoder layouts are supported:

- GPT-2: ``wte``/``wpe``/``drop``/``blocks``/``ln_f``, tied head
  (``wte.attend``); its blocks take no positions (learned position
  table), as ``GPT2.forward`` calls them.
- Llama: ``tok_emb``/``blocks``/``norm_f``/``lm_head`` (RoPE rides
  ``positions`` into the blocks).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "StageSlice",
    "layer_param_bytes",
    "param_bytes",
    "stage_spans",
]


def param_bytes(tree) -> int:
    """Total bytes of every array leaf of a (nested) param tree, tensors
    and numpy arrays alike."""
    total = 0
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif hasattr(t, "nbytes"):
            total += int(t.nbytes)
        elif hasattr(t, "dtype") and hasattr(t, "size"):
            total += int(np.dtype(t.dtype).itemsize) * int(t.size)
    return total


def _blocks_tree(params) -> dict:
    """``params["blocks"]`` of a nested tree, or the ``blocks.<i>.*``
    entries of a flat state dict regrouped by layer."""
    if "blocks" in params:
        return params["blocks"]
    out: dict = {}
    for name, t in params.items():
        if name.startswith("blocks."):
            layer, rest = name[len("blocks."):].split(".", 1)
            out.setdefault(layer, {})[rest] = t
    return out


def layer_param_bytes(params) -> list[int]:
    """Per-transformer-layer parameter bytes, in layer order: the load
    vector :func:`stage_spans` partitions. ``params`` is a nested tree, a
    flat state dict, or a model."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    blocks = _blocks_tree(params)
    return [param_bytes(blocks[str(i)]) for i in range(len(blocks))]


def stage_spans(loads: list[int] | list[float],
                capacities: list[float]) -> list[tuple[int, int]]:
    """Partition ``len(loads)`` layers into ``len(capacities)`` contiguous
    spans ``[lo, hi)``, one per stage, with each stage's load in
    proportion to its capacity. Every stage gets at least one layer."""
    n, k = len(loads), len(capacities)
    if k <= 0:
        raise ValueError("need at least one stage")
    if n < k:
        raise ValueError(f"{n} layers cannot fill {k} stages")
    if any(c <= 0 for c in capacities):
        raise ValueError("stage capacities must be positive")
    total_cap = float(sum(capacities))
    total_load = float(sum(loads)) or 1.0
    spans: list[tuple[int, int]] = []
    lo, acc = 0, 0.0
    cap_acc = 0.0
    for s in range(k - 1):
        cap_acc += capacities[s]
        target = total_load * (cap_acc / total_cap)
        hi = lo
        while hi < n and (acc + loads[hi] <= target or hi == lo):
            # always take one layer; stop once the cumulative load would
            # overshoot this stage's share
            acc += loads[hi]
            hi += 1
        # leave enough layers for the remaining stages
        hi = min(hi, n - (k - 1 - s))
        hi = max(hi, lo + 1)
        spans.append((lo, hi))
        lo = hi
    spans.append((lo, n))
    return spans


class StageSlice:
    """A contiguous layer span of a decoder, plus (by position) the
    embedding front or the norm + head tail."""

    def __init__(self, model, lo: int, hi: int):
        kids = dict(model.named_children())
        if "wte" in kids and "ln_f" in kids:
            self.kind = "gpt2"
        elif "tok_emb" in kids and "norm_f" in kids:
            self.kind = "llama"
        else:
            raise ValueError(
                "StageSlice supports GPT-2-style (wte/wpe/blocks/ln_f) and "
                "Llama-style (tok_emb/blocks/norm_f/lm_head) decoders; got "
                f"children {sorted(kids)}"
            )
        blocks = model.blocks.blocks()
        n = len(blocks)
        if not (0 <= lo < hi <= n):
            raise ValueError(f"layer span [{lo}, {hi}) invalid for {n} layers")
        self.model = model
        self.lo, self.hi = lo, hi
        self.num_layers = n
        self.first = lo == 0
        self.last = hi == n
        self.blocks = blocks[lo:hi]

    # ------------------------------------------------------------ params
    def param_keys(self) -> list[str]:
        keys = ["blocks"]
        if self.kind == "gpt2":
            if self.first:
                keys += ["wte", "wpe", "drop"]
            if self.last:
                keys += ["ln_f"]
                if "wte" not in keys:
                    keys.append("wte")  # tied head
        else:
            if self.first:
                keys.append("tok_emb")
            if self.last:
                keys += ["norm_f", "lm_head"]
        return keys

    def slice_params(self, params) -> dict:
        """This stage's part of a nested param tree (its ``blocks`` keep
        their global layer keys) or of a flat state dict (the names under
        its keys); the values are the caller's own tensors."""
        keys = self.param_keys()
        if "blocks" in params:
            out: dict = {}
            for k in keys:
                if k == "blocks":
                    out["blocks"] = {str(i): params["blocks"][str(i)]
                                     for i in range(self.lo, self.hi)}
                elif k in params:
                    out[k] = params[k]
            return out
        layers = {str(i) for i in range(self.lo, self.hi)}
        out = {}
        for name, t in params.items():
            head, _, rest = name.partition(".")
            if head == "blocks":
                if rest.split(".", 1)[0] in layers:
                    out[name] = t
            elif head in keys:
                out[name] = t
        return out

    def stage_params(self) -> dict[str, torch.Tensor]:
        """This stage's parameters by state-dict name (the model's own
        tensors)."""
        return self.slice_params(dict(self.model.named_parameters()))

    def stage_param_bytes(self, params=None) -> int:
        return param_bytes(self.stage_params() if params is None
                           else self.slice_params(params))

    # ----------------------------------------------------------- compute
    def embed(self, ids: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Stage-0 front: token ids -> hidden states, the whole model's
        embedding path (GPT-2 adds ``wpe`` and runs its inference-identity
        dropout; Llama embeds only)."""
        if not self.first:
            raise ValueError("embed() is a stage-0 operation")
        m = self.model
        if self.kind == "gpt2":
            return m.drop(m.wte(ids) + m.wpe(positions), train=False)
        return m.tok_emb(ids)

    def body(self, x, caches, *, mask, positions):
        """This stage's layers, threading stage-local per-layer caches
        (index 0 is global layer ``lo``) as the model's stack does;
        -> (x, new caches)."""
        pos = None if self.kind == "gpt2" else positions
        new_caches = []
        for j, blk in enumerate(self.blocks):
            cache = caches[j] if caches is not None else None
            if cache is None:
                x = blk(x, mask=mask, positions=pos)
                new_caches.append(None)
            else:
                x, c = blk(x, mask=mask, cache=cache, positions=pos)
                new_caches.append(c)
        return x, new_caches

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """Last-stage tail: hidden states -> logits."""
        if not self.last:
            raise ValueError("head() is a last-stage operation")
        m = self.model
        if self.kind == "gpt2":
            return m.wte.attend(m.ln_f(x))
        return m.head(m.norm_f(x))

    # ------------------------------------------------------------ caches
    def init_paged_caches(self, num_blocks: int, block_size: int, batch: int,
                          max_blocks: int, *, dtype, device=None) -> list:
        """Stage-local paged KV caches, one per layer in ``[lo, hi)``,
        over this stage's own block pool."""
        return [
            blk.attn.init_paged_cache(num_blocks, block_size, batch, max_blocks,
                                      dtype=dtype, device=device)
            for blk in self.blocks
        ]

    @property
    def hidden_dim(self) -> int:
        return int(self.model.cfg.dim)
