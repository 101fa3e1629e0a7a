"""Rank bodies of ``tests/test_torch_tp_serving.py``: the port's serving
engines on a mesh of spawned gloo ranks (``torch_ranks.spawn_cpu_ranks``).

Each job builds its mesh once and runs every case of that mesh shape;
every rank saves what it saw (tokens, logits, the collectives counted a
model call, its weight bytes, the shapes of its blocks and caches) to
``rank<r>.pt`` in the job's directory, and the test compares.

Top level: torch, numpy and the port only (the spawned ranks import this
module, which must not import JAX).
"""

import os

import numpy as np
import torch

from tensorlink_tpu_torch.config import MeshConfig
from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel import tp
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from tensorlink_tpu_torch.parallel.speculative import SpecConfig, default_draft_candidates
from tensorlink_tpu_torch.runtime.mesh import make_mesh

F32 = {"cache_dtype": torch.float32, "param_dtype": torch.float32, "device": "cpu"}
# the serving geometry every engine case shares
CONT_KW = {"decode_chunk": 3, "prefill_block": 4}
PAGED_KW = {"slots": 2, "decode_chunk": 3, "block_size": 4, "prefill_chunk": 4}
# a speculative engine's counts, in both packages' ``stats()["spec"]``
SPEC_KEYS = ("weight_passes", "accepted_total", "proposed_total",
             "fallback_total", "emitted_tokens")


def build(kind: str, cfg_kw: dict):
    """A model of ``kind`` ("llama" or "gpt2") from config keywords, on
    the CPU, unfilled (the engine loads the state it is given)."""
    if kind == "gpt2":
        return GPT2(GPT2Config(**cfg_kw), device="cpu", seed=None)
    return Llama(LlamaConfig(**cfg_kw), device="cpu", seed=None)


def engine(kind, cfg_kw, state, mesh=None, **kw):
    return InferenceEngine(build(kind, cfg_kw), state, mesh=mesh,
                           **{"max_len": 32, **F32, **kw})


def serve(eng, prompts, max_new: int, paged: bool, **kw):
    """Every prompt through a contiguous or paged engine on ``eng``, all
    submitted first (more requests than slots queue), then collected:
    -> (tokens a request, the engine)."""
    cls = PagedContinuousBatchingEngine if paged else ContinuousBatchingEngine
    base = PAGED_KW if paged else {"slots": 2, **CONT_KW}
    sch = cls(eng, gen=GenerationConfig(max_new_tokens=max_new), **{**base, **kw})
    rids = [sch.submit(p) for p in prompts]
    outs = [np.asarray(sch.result(r)) for r in rids]
    sch.run_until_idle()
    return outs, sch


def spec_counts(sch) -> list:
    return [sch.stats()["spec"][k] for k in SPEC_KEYS]


def served_flops(sch) -> float:
    """The flops every receipt of an idle engine bills."""
    return sum(m["flops"] for m in sch.drain_meters(limit=1 << 20))


def call_collectives(eng, ids) -> tuple[torch.Tensor, int]:
    """Logits of one teacher-forced model call over ``ids`` and the
    collectives it issued."""
    tp.reset_collectives()
    with torch.no_grad(), eng.parallel():
        logits = eng.model(torch.as_tensor(ids))
    return logits, sum(tp.collective_counts().values())


def generate(eng, ids, pad, max_new: int) -> tuple[np.ndarray, int]:
    """``generate``'s tokens and the collectives of the whole call."""
    tp.reset_collectives()
    out = eng.generate(ids, GenerationConfig(max_new_tokens=max_new), pad_mask=pad)
    return out, sum(tp.collective_counts().values())


def blocks(eng) -> dict:
    return {k: tuple(v.shape) for k, v in eng.model.state_dict().items()}


def refused(fn) -> tuple[str, str] | None:
    """(exception type, message) of what ``fn()`` raised; None if it
    returned."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def _save(out_dir: str, rank: int, res: dict) -> None:
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def data_spec(eng, prompts, max_new) -> dict:
    """n-gram and self-draft speculation on the contiguous engine with 4
    slots (split over data on a data-2 mesh): mode -> tokens and counts."""
    res = {}
    for mode in ("ngram", "self"):
        outs, sch = serve(eng, prompts, max_new, False, slots=4,
                          speculative=SpecConfig(k=3, rounds=2),
                          **({"draft": eng} if mode == "self" else {}))
        res[mode] = {"outs": outs, "counts": spec_counts(sch)}
    return res


def job_data_model(rank, world, out_dir, cfg_kw, state, ids, pad, prompts, max_new):
    """data 2 x model 2: ``generate`` (batch over data), the contiguous
    engine with 4 slots split over data, and its speculation."""
    mesh = make_mesh(MeshConfig(data=2, model=2), device="cpu")
    eng = engine("llama", cfg_kw, state, mesh)
    res = {"blocks": blocks(eng), "weight_bytes": eng.weight_bytes}
    res["generate"], res["generate_collectives"] = generate(eng, ids, pad, max_new)
    res["logits"], res["call_collectives"] = call_collectives(eng, ids)
    res["contiguous"], sch = serve(eng, prompts, max_new, False, slots=4)
    res["served_flops"] = served_flops(sch)
    res["local_slots"] = sch.local_slots
    res["cache_shape"] = tuple(sch._kv[0][0].shape)
    res["spec"] = data_spec(eng, prompts, max_new)
    res["refusals"] = {"paged_data": refused(lambda: PagedContinuousBatchingEngine(eng))}
    _save(out_dir, rank, res)


def job_model4(rank, world, out_dir, cfg_kw, state, ids, pad, prompts, max_new):
    """model 4 at one KV head a rank: ``generate`` and the paged engine."""
    mesh = make_mesh(MeshConfig(model=4), device="cpu")
    eng = engine("llama", cfg_kw, state, mesh)
    res = {"blocks": blocks(eng), "weight_bytes": eng.weight_bytes}
    res["generate"], res["generate_collectives"] = generate(eng, ids, pad, max_new)
    res["logits"], res["call_collectives"] = call_collectives(eng, ids)
    res["paged"], sch = serve(eng, prompts, max_new, True)
    res["pool_shape"] = tuple(sch._pools[0]["k"].shape)
    # 2 KV heads over a model axis of 4
    narrow = {**cfg_kw, "num_heads": 4, "num_kv_heads": 2}
    res["refusals"] = {"kv_heads": refused(
        lambda: engine("llama", narrow, None, mesh))}
    _save(out_dir, rank, res)


def model2_cases(mesh, cases: dict, ids, pad, prompts, max_new) -> dict:
    """Every model-2 case (or, ``mesh=None``, its world-1 twin): name ->
    what the case produced."""
    res = {}
    c = cases["int8"]
    eng = engine("llama", c["cfg"], c["state"], mesh, quantize="int8")
    res["int8"] = {"generate": generate(eng, ids, pad, max_new)[0],
                   "call": call_collectives(eng, ids), "weight_bytes": eng.weight_bytes,
                   "blocks": blocks(eng)}
    c = cases["fused"]
    eng = engine("llama", c["cfg"], c["state"], mesh)
    res["fused"] = {"generate": generate(eng, ids, pad, max_new)[0],
                    "contiguous": serve(eng, prompts, max_new, False)[0],
                    "paged": serve(eng, prompts, max_new, True)[0],
                    "call": call_collectives(eng, ids), "weight_bytes": eng.weight_bytes,
                    "blocks": blocks(eng)}
    c = cases["ring"]
    eng = engine("llama", c["cfg"], c["state"], mesh, rolling_cache=True, max_len=48)
    gen = GenerationConfig(max_new_tokens=c["max_new"])
    tp.reset_collectives()
    res["ring"] = {"generate": eng.generate(ids, gen, pad_mask=pad),
                   "collectives": sum(tp.collective_counts().values()),
                   "weight_bytes": eng.weight_bytes, "blocks": blocks(eng)}
    c = cases["spec"]
    eng = engine("llama", c["cfg"], c["state"], mesh)
    # the int8 sibling of a mesh engine: quantized from its blocks, on its mesh
    sibling = default_draft_candidates(eng)[0][1]()
    spec = {}
    for paged in (False, True):
        for mode in ("ngram", "self", "int8-sibling"):
            kw = {"speculative": SpecConfig(k=3, rounds=2)}
            if mode != "ngram":
                kw["draft"] = eng if mode == "self" else sibling
            outs, sch = serve(eng, prompts, max_new, paged, **kw)
            spec[("paged" if paged else "contiguous", mode)] = {
                "outs": outs, "counts": spec_counts(sch)}
    res["spec"] = spec
    c = cases["gpt2"]
    eng = engine("gpt2", c["cfg"], c["state"], mesh)
    res["gpt2"] = {"contiguous": serve(eng, prompts, max_new, False)[0],
                   "call": call_collectives(eng, ids), "weight_bytes": eng.weight_bytes,
                   "blocks": blocks(eng)}
    return res


def disagg(eng, prompts, payloads, max_new: int) -> dict:
    """Disaggregated serving on ``eng``'s paged engines: each prompt's
    prefill exported by one and imported by another (here -> here), and
    ``payloads`` exported elsewhere imported here: -> the payloads this
    engine exported and the tokens of both imports."""
    gen = GenerationConfig(max_new_tokens=max_new)
    leg = PagedContinuousBatchingEngine(eng, gen=gen, **PAGED_KW)
    mine = [leg.prefill_export(p) for p in prompts]
    dec = PagedContinuousBatchingEngine(eng, gen=gen, **PAGED_KW)
    return {"payloads": mine,
            "here": [np.asarray(dec.result(dec.import_prefill(pl))) for pl in mine],
            "imported": [np.asarray(dec.result(dec.import_prefill(pl)))
                         for pl in payloads]}


def job_model2(rank, world, out_dir, cases, ids, pad, prompts, max_new):
    """model 2: int8, the fused q/k/v layout, the ring, n-gram and
    self-draft speculation in both engines, GPT-2 through the contiguous
    engine; disaggregation 2 -> 2 and 1 -> 2 (the world-1 payloads of
    ``cases["disagg"]``)."""
    mesh = make_mesh(MeshConfig(model=2), device="cpu")
    res = model2_cases(mesh, cases, ids, pad, prompts, max_new)
    c = cases["spec"]
    res["disagg"] = disagg(engine("llama", c["cfg"], c["state"], mesh), prompts,
                           cases["disagg"]["payloads"], max_new)
    seq = make_mesh(MeshConfig(seq=2), device="cpu")
    ring = cases["ring"]["cfg"]
    sharded = engine("llama", c["cfg"], None, seq, kv_seq_shard=True)
    res["refusals"] = {
        "moe": refused(lambda: engine("llama", cases["moe"]["cfg"], None, mesh)),
        "seq_ring": refused(lambda: engine("llama", ring, None, seq, rolling_cache=True,
                                           kv_seq_shard=True)),
        "seq_contiguous": refused(lambda: ContinuousBatchingEngine(sharded)),
        "seq_paged": refused(lambda: PagedContinuousBatchingEngine(sharded)),
    }
    _save(out_dir, rank, res)
