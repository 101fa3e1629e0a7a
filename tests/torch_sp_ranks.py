"""Rank bodies of ``tests/test_torch_sp.py``: sequence parallelism in the
port on spawned gloo ranks (``torch_ranks.spawn_cpu_ranks``).

- ``job_seq4`` (mesh seq 4): the ring (einsum and flash, whose blocks
  take B1/B2's plain versions on the CPU) and Ulysses, forward and the
  gradients of the whole inputs, on every case the test hands it; the
  refusals that need a bound seq group; and ``InferenceEngine(
  kv_seq_shard=True)``'s ``generate`` with its per-rank cache bytes;
- ``job_trainers`` (mesh pipe 2 x seq 2): one ``ShardedTrainer`` step of
  each case, the gathered state on rank 0.

Every rank saves what it saw to ``rank<r>.pt`` in the job's directory.
Top level: torch, numpy and the port only (the spawned ranks import this
module, which must not import JAX).
"""

import os

import numpy as np
import torch

from tensorlink_tpu_torch.config import MeshConfig, TrainConfig
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.parallel import sp
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.runtime.mesh import make_mesh


def refused(fn) -> tuple[str, str] | None:
    """(exception type, message) of what ``fn()`` raised; None if it
    returned."""
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


def attention(kind: str, case: dict, mesh) -> dict:
    """One attention case through the global entry ``kind`` ("einsum",
    "flash" or "ulysses"): -> the whole output and the gradients of
    mean((out * q_valid)^2) with respect to the whole q, k, v."""
    q, k, v = (torch.from_numpy(case[n]).requires_grad_() for n in "qkv")
    mask = None if case["mask"] is None else torch.from_numpy(case["mask"])
    if kind == "ulysses":
        out = sp.ulysses_attention(q, k, v, mesh, causal=case["causal"], mask=mask)
    else:
        kk, vv = k, v
        if kind == "einsum" and k.shape[2] != q.shape[2]:  # GQA: repeat first
            kk = k.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
            vv = v.repeat_interleave(q.shape[2] // k.shape[2], dim=2)
        out = sp.ring_attention(q, kk, vv, mesh, causal=case["causal"], mask=mask,
                                use_flash=kind == "flash")
    ((out * torch.from_numpy(case["q_valid"])) ** 2).mean().backward()
    return {"out": out.detach(), "grads": [x.grad for x in (q, k, v)]}


def job_seq4(rank, world, out_dir, att_cases, gen):
    mesh = make_mesh(MeshConfig(seq=4), device="cpu")
    res = {"attention": {(name, kind): attention(kind, case, mesh)
                         for name, (kinds, case) in att_cases.items() for kind in kinds}}
    group = mesh.get_group("seq")
    z = torch.zeros(1, 8, 2, 16)
    two_heads = torch.ones(1, 2, 1, 32, dtype=torch.bool)
    with sp.seq_parallel(group):
        res["refusals"] = {
            "ring_mask_heads": refused(lambda: sp.ring_attention_impl(
                z, z, z, mask=two_heads)),
            "ulysses_mask_heads": refused(lambda: sp.ulysses_attention_impl(
                torch.zeros(1, 8, 4, 16), z, z, mask=two_heads)),
            "ulysses_heads": refused(lambda: sp.ulysses_attention_local(z, z, z)),
            "ring_global_mask": refused(lambda: sp.ring_attention_impl(
                z, z, z, mask=torch.ones(1, 1, 1, 8, dtype=torch.bool))),
            "ulysses_global_mask": refused(lambda: sp.ulysses_attention_impl(
                torch.zeros(1, 8, 4, 16), z, z,
                mask=torch.ones(1, 1, 1, 8, dtype=torch.bool))),
        }
    model = Llama(LlamaConfig(**gen["cfg"]), device="cpu", seed=None)
    eng = InferenceEngine(model, gen["state"], mesh=mesh, kv_seq_shard=True,
                          max_len=gen["max_len"], cache_dtype=torch.float32,
                          param_dtype=torch.float32, device="cpu")
    res["generate"] = eng.generate(gen["ids"], GenerationConfig(
        max_new_tokens=gen["max_new"]), pad_mask=gen["pad"])
    caches = eng._gen_state["caches"]
    res["cache_bytes"] = sum(c["attn"][n].numel() * c["attn"][n].element_size()
                             for c in caches for n in ("k", "v"))
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def job_trainers(rank, world, out_dir, cases, steps):
    """pipe 2 x seq 2: ``steps`` steps of each case (model kind, port
    state, batch, TrainConfig keywords), the losses and pre-clip norms,
    and rank 0's gathered state."""
    import test_torch_engine as E
    from tensorlink_tpu_torch.parallel.engine import ShardedTrainer

    mesh = make_mesh(MeshConfig(pipe=2, seq=2), device="cpu")
    res = {}
    for name, (kind, mcfg, state, batch, cfg_kw) in cases.items():
        _, parts = E._port_model(kind, mcfg, state, False)
        tr = ShardedTrainer(mesh, TrainConfig(**E._train_cfg(cfg_kw)), parts,
                            E._loss_fn(kind), device="cpu")
        st = tr.init_state()
        losses, norms = [], []
        for _ in range(steps):
            st, stats = tr.train_step(st, batch)
            losses.append(float(stats["loss"]))
            norms.append(float(stats["grad_norm"]))
        g = tr.gather_state(st)
        res[name] = {"losses": losses, "grad_norms": norms,
                     "params": None if g is None else g.params}
    gpt2 = E._port_model("gpt2", E.GPT2_TINY, None, False)[1]
    bert = E._port_model("bert", {**E.BERT_TINY, "attn_impl": "ulysses"}, None, False)[1]
    res["refusals"] = {
        "needs_ring": refused(lambda: ShardedTrainer(
            mesh, TrainConfig(**E._train_cfg({})), gpt2, E._loss_fn("gpt2"),
            device="cpu")),
        "head_per_token": refused(lambda: ShardedTrainer(
            mesh, TrainConfig(**E._train_cfg({"pp_schedule": "1f1b"})), bert,
            E._loss_fn("bert"), device="cpu")),
    }
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))


def np_case(seed: int, B: int, T: int, H: int, Hkv: int, D: int, causal: bool,
            padded: bool) -> dict:
    """q, k, v (f32, from ``seed``), a padding mask (row 0's tail and row
    1's head padded) or None, and the loss weights that leave out the
    query rows with no key to attend (undefined: the ring gives 0, plain
    attention the mean of v)."""
    r = np.random.default_rng(seed)
    case = {"q": r.standard_normal((B, T, H, D), np.float32),
            "k": r.standard_normal((B, T, Hkv, D), np.float32),
            "v": r.standard_normal((B, T, Hkv, D), np.float32),
            "causal": causal, "mask": None}
    q_valid = np.ones((B, T, 1, 1), np.float32)
    if padded:
        mask = np.ones((B, 1, 1, T), bool)
        mask[0, ..., 3 * T // 4:] = False
        mask[1, ..., :5] = False
        case["mask"] = mask
        if causal:
            q_valid[1, :5] = 0.0
    case["q_valid"] = q_valid
    return case
