"""PyTorch port: what lets a decode chunk run as one captured CUDA graph,
held on the CPU.

- ``runtime/graphs.py``'s launch credit, with a stub graph: a capture's
  counter increments are taken back out and every replay credits them,
  also into counter dicts rebound between replays; the cache is keyed
  and counts captures and replays.
- ``nn/attention.py``'s paged write without a host sync: dropped writes
  go to the scratch block, and every real block ends up bit-identical to
  the former ``nonzero``-filtered write (bf16 and int8 pools, T 1 and 3,
  sentinel entries and rows past their table).
- ``sample_logits_at``: the same bits as a pure-Python reference of its
  hash; a draw depends on (seed, position) alone, whatever the row and
  the co-tenants; its draws over many seeds fit the filtered softmax
  (chi-square, p > 1e-3).
- No host read in any chunk body: the contiguous (full-width and
  blockwise) and paged serving chunks, their speculative chunks (n-gram
  and draft, sampled, adaptive K) and ``generate``'s monotone and ring
  steps run whole requests with every tensor-to-host path patched to
  raise inside the body.
"""

import contextlib

import numpy as np
import pytest
import torch
from scipy import stats
from torch.utils._python_dispatch import TorchDispatchMode

import tensorlink_tpu_torch.nn.attention as tattn
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.nn.attention import (
    MultiHeadAttention,
    paged_write,
    paged_write_slots,
)
from tensorlink_tpu_torch.ops.decode_glue import FORMS, fused_residual_norm
from tensorlink_tpu_torch.ops.quant import quantize_kv_int8
from tensorlink_tpu_torch.parallel.inference import (
    GenerationConfig,
    InferenceEngine,
    _filter_logits,
    counter_bits,
    sample_logits_at,
)
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine,
    PagedContinuousBatchingEngine,
)
from tensorlink_tpu_torch.runtime import graphs

# ------------------------------------------------------------ launch credit


class _StubGraph:
    def __init__(self, log):
        self.log = log

    def replay(self):
        self.log.append("replay")  # the device runs; no Python runs


class _StubCache(graphs.GraphCache):
    """The CUDA parts stubbed: the warm-up runs the body (real launches),
    the capture runs it too (the wrappers count, nothing launches)."""

    def __init__(self, log, **kw):
        super().__init__("cpu", **kw)
        self.enabled = True
        self.log = log

    def _warm_up(self, body):
        self.log.append("warm-up")
        body()

    def _record(self, body):
        self.log.append("capture")
        body()
        return _StubGraph(self.log)


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(fused_residual_norm, "launches", 0)
    monkeypatch.setattr(fused_residual_norm, "launches_by_form",
                        dict.fromkeys(FORMS, 0))


def _body(calls):
    def body():
        calls.append(1)
        fused_residual_norm.launches += 2  # as two wrapper launches would
        fused_residual_norm.launches_by_form["rms"] += 2
    return body


def test_capture_is_taken_out_and_every_replay_credited(counters):
    log, calls = [], []
    gc = _StubCache(log)
    gc.run("a", _body(calls))
    # the warm-up's two launches ran; the capture's two did not
    assert log == ["warm-up", "capture"] and len(calls) == 2
    assert fused_residual_norm.launches == 2
    assert fused_residual_norm.launches_by_form["rms"] == 2
    for _ in range(3):
        gc.run("a", _body(calls))
    assert log[2:] == ["replay"] * 3 and len(calls) == 2  # no Python ran
    assert fused_residual_norm.launches == 8
    # a caller that rebinds the dict (as chip_smoke.py zeroes its
    # counters) keeps being credited
    fused_residual_norm.launches_by_form = dict.fromkeys(FORMS, 0)
    gc.run("a", _body(calls))
    assert fused_residual_norm.launches_by_form == {**dict.fromkeys(FORMS, 0), "rms": 2}
    assert gc.stats()["replays"] == 4 and gc.stats()["captured"] == 1


def test_after_follows_the_work_and_precedes_the_capture(counters):
    """``after`` (where a timing event is recorded) runs once a call, after
    its work is enqueued: after the warm-up and before the capture, or
    after the replay; on the CPU after the body."""
    log, calls = [], []
    gc = _StubCache(log)
    for _ in range(2):
        gc.run("a", _body(calls), after=lambda: log.append("after"))
    assert log == ["warm-up", "after", "capture", "replay", "after"]
    out = []
    graphs.GraphCache("cpu").run("a", lambda: out.append("body"),
                                 after=lambda: out.append("after"))
    assert out == ["body", "after"]


def test_cache_is_keyed(counters):
    log, calls = [], []
    gc = _StubCache(log)
    for key in ("a", "b", "a", "c", "b"):
        gc.run(key, _body(calls))
    # a, b, c captured (warm-up + capture each), then a and b replayed
    assert log.count("capture") == 3 and log.count("replay") == 2
    assert gc.stats() == {"graphs": 3, "captured": 3, "capture_s": gc.capture_s,
                          "replays": 2, "pool_bytes": 0, "cleared": 0}
    assert fused_residual_norm.launches == 2 * 5


def test_counter_delta_and_credit():
    before = graphs.counter_snapshot()
    assert all(fn in graphs.COUNTED for fn, _, _ in before)
    after = dict(before)
    key = (fused_residual_norm, "launches_by_form", "layer+bias")
    after[key] = before[key] + 3
    delta = graphs.counter_delta(before, after)
    assert delta == {key: 3}
    n = fused_residual_norm.launches_by_form["layer+bias"]
    graphs.credit_counters(delta, 2)
    graphs.credit_counters(delta, -2)
    assert fused_residual_norm.launches_by_form["layer+bias"] == n


def test_cpu_cache_runs_the_body():
    calls = []
    gc = graphs.GraphCache("cpu")
    assert not gc.enabled
    gc.run("a", lambda: calls.append(1))
    gc.run("a", lambda: calls.append(1))
    assert len(calls) == 2 and gc.stats()["captured"] == 0


# -------------------------------------------------------- paged write

NB, BS, MB, HKV, D = 6, 4, 3, 2, 8


def _nonzero_write(cache, k, v, index, bt, T):
    """The former write: keep only the writes whose block is real (a
    ``nonzero`` filter, one host sync), drop the rest."""
    tpos = index.long()[:, None] + torch.arange(T)[None, :]
    bslot = tpos // BS
    blk = torch.gather(bt.long(), 1, bslot.clamp(max=MB - 1))
    blk = torch.where(bslot >= MB, NB, blk)
    rows, toks = ((blk >= 0) & (blk < NB)).nonzero(as_tuple=True)
    b, o = blk[rows, toks], (tpos % BS)[rows, toks]
    if "k_scale" in cache:
        qk, sk = quantize_kv_int8(k)
        qv, sv = quantize_kv_int8(v)
        cache["k"][b, o], cache["v"][b, o] = qk[rows, toks], qv[rows, toks]
        cache["k_scale"][b, o] = sk[rows, toks]
        cache["v_scale"][b, o] = sv[rows, toks]
    else:
        cache["k"][b, o] = k[rows, toks].to(cache["k"].dtype)
        cache["v"][b, o] = v[rows, toks].to(cache["v"].dtype)


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("quant", [None, "int8"], ids=["bf16", "int8"])
def test_scratch_write_matches_the_filtered_write(quant, T):
    """Rows: fully mapped; a sentinel entry under its index; crossing the
    end of its table; all sentinel (retired) and past its table. Real
    blocks bit-identical, the scratch row the only other row touched."""
    g = torch.Generator().manual_seed(T)
    attn = MultiHeadAttention(16, 4, num_kv_heads=HKV, head_dim=D)
    cache = attn.init_paged_cache(NB, BS, 4, MB, dtype=torch.bfloat16, quant=quant)
    assert cache["k"].shape[0] == NB + 1
    for name in ("k", "v"):
        if quant:
            cache[name].copy_(torch.randint(-127, 128, cache[name].shape, generator=g))
        else:
            cache[name].copy_(torch.randn(cache[name].shape, generator=g))
    bt = torch.full((4, MB), NB, dtype=torch.int32)
    bt[0] = torch.tensor([2, 0, 5])
    bt[1, :1] = 1  # index 4: a sentinel entry
    bt[2] = torch.tensor([3, 4, 2])  # index 11: at T 3, runs past its table
    # row 3 (retired, all sentinel) at index 12: past its table
    index = torch.tensor([5, 4, 11, 12], dtype=torch.int32)
    k = torch.randn(4, T, HKV, D, generator=g)
    v = torch.randn(4, T, HKV, D, generator=g)
    ref = {n: t.clone() for n, t in cache.items()}
    _nonzero_write(ref, k, v, index, bt, T)
    paged_write(cache, k, v, paged_write_slots(index, bt, T, NB, BS))
    for name in ("k", "v") + (("k_scale", "v_scale") if quant else ()):
        assert torch.equal(cache[name][:NB], ref[name][:NB]), name
    touched = (cache["k"][NB] != ref["k"][NB]).any()
    assert bool(touched)  # the dropped writes landed in the scratch row


# ------------------------------------------------------------ sampler

M32 = 0xFFFFFFFF


def _mix32_py(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _bits_py(seed: int, position: int, v: int) -> int:
    row = _mix32_py(_mix32_py(seed & M32) ^ (position & M32))
    return _mix32_py(row ^ _mix32_py(v ^ 0x9E3779B9))


def test_counter_bits_match_a_python_reference():
    seeds = [0, 1, 7, 2**31 - 1, 2**32 + 5, -3, 123456789]
    positions = [0, 1, 5, 4095, 2**31, 17, 2**40 + 2]
    V = 37
    bits = counter_bits(torch.tensor(seeds), torch.tensor(positions), V)
    ref = [[_bits_py(s, p, v) for v in range(V)] for s, p in zip(seeds, positions)]
    assert bits.dtype == torch.int64
    np.testing.assert_array_equal(bits.numpy(), np.asarray(ref, np.int64))


def test_uniforms_stay_inside_the_open_interval(monkeypatch):
    """The extreme hash values give uniforms strictly inside (0, 1), so
    the Gumbel noise is finite and a masked logit is never drawn."""
    import tensorlink_tpu_torch.parallel.inference as inf

    logits = torch.tensor([[0.0, float("-inf"), 1.0, float("-inf")]])
    for extreme in (0, M32):
        monkeypatch.setattr(inf, "counter_bits", lambda s, p, v, e=extreme:
                            torch.full((1, v), e, dtype=torch.int64))
        tok = sample_logits_at(logits, torch.tensor([0]), torch.tensor([0]), 1.0)
        assert int(tok[0]) in (0, 2)


def test_draw_depends_on_seed_and_position_only():
    r = np.random.default_rng(0)
    logits = torch.from_numpy(r.normal(size=(1, 50)).astype(np.float32))
    seed, pos = torch.tensor([11]), torch.tensor([40])
    alone = sample_logits_at(logits, seed, pos, 1.0, 10, 0.9)
    # the same row among co-tenants, in another row, gives the same draw
    others = torch.from_numpy(r.normal(size=(4, 50)).astype(np.float32))
    batch = torch.cat([others[:2], logits, others[2:]])
    seeds = torch.tensor([3, 4, 11, 5, 6])
    poss = torch.tensor([1, 2, 40, 9, 9])
    tok = sample_logits_at(batch, seeds, poss, 1.0, 10, 0.9)
    assert tok[2] == alone[0]
    draws = {int(sample_logits_at(logits, torch.tensor([s]), pos, 1.0)[0])
             for s in range(40)}
    assert len(draws) > 5  # the seed does matter
    assert int(sample_logits_at(logits, seed, pos, 0.0)[0]) == int(logits.argmax())


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (4, 1.0), (0, 0.8)])
def test_draws_fit_the_filtered_softmax(top_k, top_p):
    """20000 draws of one row over seeds 0..19999 (positions varied too):
    counts against the filtered softmax, chi-square p > 1e-3; tokens the
    filter masks are never drawn."""
    logits = torch.tensor([[1.0, 0.5, 0.0, -0.5, 2.0, -1.0, 0.3, 1.2]])
    n = 20000
    f = _filter_logits(logits, 0.7, top_k, top_p)[0]
    probs = torch.softmax(f, dim=-1).double().numpy()
    toks = sample_logits_at(logits.expand(n, -1), torch.arange(n),
                            torch.arange(n) % 97, 0.7, top_k, top_p)
    counts = np.bincount(toks.numpy(), minlength=logits.shape[1])
    keep = probs > 0
    assert counts[~keep].sum() == 0
    p = stats.chisquare(counts[keep], probs[keep] / probs[keep].sum() * n).pvalue
    assert p > 1e-3, (counts, probs * n)


# ------------------------------------------------------- no host read


class _NoSync(TorchDispatchMode):
    BANNED = {"nonzero", "_local_scalar_dense", "masked_select", "nonzero_static"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        # boolean indexing reaches its nonzero below this mode
        masked = name.startswith("index") and any(
            isinstance(t, torch.Tensor) and t.dtype == torch.bool
            for a in args if isinstance(a, (list, tuple)) for t in a)
        if name in self.BANNED or masked:
            raise AssertionError(f"host read in a chunk body: aten.{func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _no_host_reads():
    """Every path from a tensor to the host raises: the methods a
    Python caller would use, and (under a dispatch mode) the ATen ops
    that read a device value back, boolean indexing's ``nonzero``
    included."""
    def banned(name):
        def f(*a, **k):
            raise AssertionError(f"host read in a chunk body: Tensor.{name}")
        return f

    names = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
             "__float__", "__index__", "nonzero")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    saved_nz = torch.nonzero
    try:
        for n in names:
            setattr(torch.Tensor, n, banned(n))
        torch.nonzero = banned("torch.nonzero")
        with _NoSync():
            yield
    finally:
        for n, f in saved.items():
            setattr(torch.Tensor, n, f)
        torch.nonzero = saved_nz


def _guard(obj, name, runs):
    inner = getattr(obj, name)

    def guarded(*a, **k):
        runs.append(name)
        with _no_host_reads():
            return inner(*a, **k)

    setattr(obj, name, guarded)


def test_the_patch_catches_host_reads():
    t = torch.tensor([1, 0, 2])
    for read in (lambda: t.sum().item(), lambda: bool(t[0]), lambda: t[t > 0],
                 lambda: int(t[1]), lambda: t.tolist(), lambda: t.nonzero()):
        with pytest.raises(AssertionError, match="host read"):
            with _no_host_reads():
                read()


def _llama(window=None):
    cfg = LlamaConfig.tiny() if window is None else LlamaConfig.mistral_tiny()
    return Llama(cfg, device="cpu", seed=1)


SAMPLED = GenerationConfig(max_new_tokens=7, temperature=0.8, top_k=20, top_p=0.9)


@pytest.mark.parametrize("kind", ["contiguous", "blockwise", "paged", "paged-int8"])
def test_serving_chunk_body_reads_nothing_back(kind, monkeypatch):
    big = kind == "blockwise"
    if big:  # 512 cache slots, blockwise read from 128 up
        monkeypatch.setattr(tattn, "DECODE_BLOCKWISE_MIN_WINDOWLESS", 128)
    eng = InferenceEngine(_llama(), max_len=512 if big else 32, device="cpu",
                          cache_dtype=torch.float32, param_dtype=torch.float32)
    kw = {"slots": 2, "decode_chunk": 3, "gen": SAMPLED}
    if kind.startswith("paged"):
        sch = PagedContinuousBatchingEngine(
            eng, block_size=4, prefill_chunk=4,
            kv_quant="int8" if kind.endswith("int8") else None, **kw)
    else:
        sch = ContinuousBatchingEngine(eng, prefill_block=4, **kw)
    runs, keys = [], []
    _guard(sch, "_chunk_body", runs)
    key = sch._chunk_key
    sch._chunk_key = lambda frontier: keys.append(key(frontier)) or keys[-1]
    r = np.random.default_rng(3)
    rids = [sch.submit(r.integers(0, 128, (n,)), seed=n) for n in (5, 9, 3)]
    outs = [sch.result(rid) for rid in rids]
    assert len(runs) >= 3 and all(len(o) == 7 for o in outs)
    # one graph key: the paged chunk reads no host value, the full-width
    # one none, the blockwise one the first block of the 512-slot cache
    layers = len(eng.model.blocks.blocks())
    paged = kind.startswith("paged")
    assert set(keys) == {() if paged else ((0, 1) if big else None,) * layers}


@pytest.mark.parametrize("kind", ["paged", "paged-int8", "paged-ngram"])
def test_disagg_chunk_bodies_read_nothing_back(kind):
    """The decode leg's chunks (plain or n-gram spec) with imported rows
    decoding and, on the prefill leg, a held row prefilled beside rows
    that decode: no host read in any body, one graph key, and the
    imported streams equal the colocated ones."""
    from tensorlink_tpu_torch.parallel.kvwire import pack_kv_payload, unpack_kv_payload
    from tensorlink_tpu_torch.parallel.speculative import SpecConfig

    eng = InferenceEngine(_llama(), max_len=32, device="cpu",
                          cache_dtype=torch.float32, param_dtype=torch.float32)
    kw = {"slots": 3, "decode_chunk": 3, "gen": SAMPLED, "block_size": 4,
          "prefill_chunk": 4, "kv_quant": "int8" if kind.endswith("int8") else None}
    if kind.endswith("ngram"):
        kw["speculative"] = SpecConfig(k=2, rounds=1, adaptive=False)
    body = "_spec_chunk_body" if kind.endswith("ngram") else "_chunk_body"
    P, D, colo = (PagedContinuousBatchingEngine(eng, **kw) for _ in range(3))
    runs, keys = [], []
    for sch in (P, D):
        _guard(sch, body, runs)
        name = "_spec_key" if kind.endswith("ngram") else "_chunk_key"
        key = getattr(sch, name)
        setattr(sch, name, lambda frontier, key=key: keys.append(key(frontier)) or keys[-1])
    r = np.random.default_rng(5)
    prompts = [r.integers(0, 128, (n,)) for n in (5, 9, 10)]
    busy = P.submit(prompts[0], seed=1)
    P.step()
    P.step()
    rids = []
    for n, p in enumerate(prompts[1:]):
        blob = pack_kv_payload(P.prefill_export(p, seed=n + 2))
        rids.append(D.import_prefill(unpack_kv_payload(blob)))
        D.step()
    P.result(busy)
    outs = [D.result(rid) for rid in rids]
    refs = [colo.result(colo.submit(p, seed=n + 2)) for n, p in enumerate(prompts[1:])]
    for out, ref in zip(outs, refs):
        np.testing.assert_array_equal(out, ref)
    assert len(runs) >= 4 and len(set(keys)) == 1


@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("kind", ["contiguous", "blockwise", "paged"])
def test_spec_chunk_body_reads_nothing_back(kind, mode, monkeypatch):
    """The speculative chunk (draft or n-gram proposals, the verify pass,
    the sampled accept/reject, rollback) under adaptive K, which moves
    the effective K between dispatches: no host read, and one graph key."""
    from tensorlink_tpu_torch.parallel.speculative import SpecConfig

    big = kind == "blockwise"
    if big:
        monkeypatch.setattr(tattn, "DECODE_BLOCKWISE_MIN_WINDOWLESS", 128)
    eng = InferenceEngine(_llama(), max_len=512 if big else 32, device="cpu",
                          cache_dtype=torch.float32, param_dtype=torch.float32)
    draft = None
    if mode == "draft":
        draft = InferenceEngine(Llama(LlamaConfig.tiny(), device="cpu", seed=2),
                                max_len=32, device="cpu",
                                cache_dtype=torch.float32, param_dtype=torch.float32)
    kw = {"slots": 2, "gen": SAMPLED, "draft": draft,
          "speculative": SpecConfig(k=3, rounds=2, adaptive=True,
                                    entropy_exit=6.0)}
    if kind == "paged":
        sch = PagedContinuousBatchingEngine(eng, block_size=4, prefill_chunk=4, **kw)
    else:
        sch = ContinuousBatchingEngine(eng, prefill_block=4, **kw)
    runs, keys = [], []
    _guard(sch, "_spec_chunk_body", runs)
    key = sch._spec_key
    sch._spec_key = lambda frontier: keys.append(key(frontier)) or keys[-1]
    r = np.random.default_rng(3)
    rids = [sch.submit(r.integers(0, 128, (n,)), seed=n) for n in (5, 9, 3)]
    outs = [sch.result(rid) for rid in rids]
    assert len(runs) >= 3 and all(len(o) == 7 for o in outs)
    assert len(set(keys)) == 1


@pytest.mark.parametrize("kind", ["monotone", "blockwise", "ring"])
def test_generate_step_reads_nothing_back(kind, monkeypatch):
    if kind == "blockwise":
        monkeypatch.setattr(tattn, "DECODE_BLOCKWISE_MIN_WINDOWLESS", 128)
    ring = kind == "ring"
    eng = InferenceEngine(_llama(window=8 if ring else None),
                          max_len=512 if kind == "blockwise" else 32,
                          rolling_cache=ring, device="cpu",
                          cache_dtype=torch.float32, param_dtype=torch.float32)
    runs = []
    _guard(eng, "_decode_step", runs)
    ids = np.random.default_rng(4).integers(0, 128, (2, 6))
    gen = GenerationConfig(max_new_tokens=12 if ring else 7, temperature=0.8,
                           top_k=20, top_p=0.9)
    out = eng.generate(ids, gen, seed=3)
    assert out.shape == (2, gen.max_new_tokens) and len(runs) == gen.max_new_tokens - 1
    if ring:
        assert eng._gen_state["key"][3]  # the ring took the writes
