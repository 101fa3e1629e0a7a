#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tensorlink_tpu_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: card, power limit and toolchain versions;
2. build: compiles the three CUDA sources (paged decode, fused
   residual+norm, flash attention; one nvcc each, sm_90a, all started
   together), prints ptxas's register lines and the number of HGMMA
   (wgmma) instructions in the flash forward's kernels, then times an
   empty kernel ("[floor]": the launch floor the norm rows print);
   the builds land in a fresh ``TL_COMPILE_CACHE_DIR`` (the kernel-build
   cache), and "[compile cache]" has a child process load the three
   CUDA libraries and the g++-built wire codec from it with no compiler
   run, printing cold build s against warm load s;
3. paged-decode kernel vs its plain PyTorch version at Llama-3-8B head
   shapes (T = 1 and T = 128; mixed lengths with sentinel-tailed block
   tables, a validity mask with a retired row, a window, int8 pools, the
   one-row form of a prefill chunk, decode over rows of whole pages, and
   the one-row chunk at lengths 128, 1024 and 2048; then f32 tensors on
   the general variant, D 64 with a mask per query, T = 4 decode rows
   with a mask per query, and the speculative verify pass at T = 4 and 5,
   B 8, no mask, lengths to 2000, on the variant ``kernel_variant``
   names), each held to the variant it must launch, with its relative
   error, the fraction of its bound it reached and SDPA on the gathered
   view;
4. fused-norm kernel vs its plain version (rms and layer with bias at
   8 x 4096; LayerNorm of f32 rows whose mean is 1e3 beside a spread of
   ~1.4; D 4100 and 4097, which the 16-byte vector does not divide; 64
   rows x 5120; 4 rows x 32768 f32, split over a cluster of 4 blocks;
   GPT-2-medium's decode step, 8 x 1024 LayerNorm + bias), each with its
   host us per call, the launch floor and the
   time of torch.add + F.rms_norm / F.layer_norm as a two-call reference;
5. flash: the flash-attention forward (B1) and backward (B2) kernels vs
   their plain versions in bf16 at the paths' shapes (BERT-base with a
   padding mask, Llama-3-8B causal GQA, a causal window, a ragged length
   with a fully masked row), each timed beside its plain version, its
   bound and SDPA and its first design's time; B1 with its host us per
   call;
5a. capability: ``measure_capability`` at a size that fills the card (a
   chained 8192-square bf16 matmul, a 1 GiB HBM read), printed with the
   card's name and power limit: the peaks MFU, MBU and the receipt
   auditor are held against;
6. serving: Llama-3-8B at full width and depth (random bf16 weights
   from a seed) served by ``PagedContinuousBatchingEngine`` over
   ``InferenceEngine``: 12 greedy requests, launch counts checked against
   the path (decode steps on B3's decode variant, prefill chunks on its
   prefill variant, none on the general one), and a teacher-forced check
   of every emitted token against the port's no-cache forward (which runs
   B1 for the long prompts); ``[timer slice]`` prints
   ``stats()["device_time"]`` (the CUDA-event timer: per program count,
   busy and gap s, host-gap share, device tokens/s, MFU, MBU) and
   ``[metering slice]`` gates the meters: their busy seconds sum to the
   timer's within 1%, each has its prompt tokens, 32 emitted tokens and
   KV block-seconds, and each signs into a receipt that verifies and a
   ``ReceiptAuditor`` holding the capability accepts with no anomaly;
   the timer's decode busy a step is within 20% of the profiled
   model-step wall (``[timer slice vs profile]``);
6a. disagg: the same 12 requests split over a prefill leg P and a
   decode leg D (two engines of the [slice] geometry on one model):
   ``prefill_export``, ``pack_kv_payload(codec="none")``,
   ``unpack_kv_payload``, ``import_prefill`` with ``D.step()`` between
   imports, so grafts land with chunks in flight. Tokens equal the
   [slice] run's exactly; P launches B3 only in its prefill variant, D
   B3 decode and B4 once a layer a decode step, no prefill; every D chunk
   but the first a replay; the legs' export/import counts; the native
   codec built. Prints export, pack, unpack and import times and rates,
   blob bytes a prompt token and the zlib ratio on one request; then the
   timer and metering gates on P and D (P's meters bill prefill and emit
   0; D's carry the blob's bytes) and the profiled decode on D;
6b. disagg int8: 4 of those requests (prompts <= 600) int8 -> int8,
   token-identical to an int8 colocated engine, blobs under 0.6 of the
   float blob, B3's decode variant on int8 pools; then float -> int8 and
   int8 -> float, teacher-forced, with the share of tokens equal to the
   importing engine's colocated run;
7. static: the same model through ``InferenceEngine.generate`` (the
   default path of ``examples/serve_llm.py``): 4 left-padded prompts of
   700 to 2000 tokens, 64 greedy tokens, decode on the blockwise path over
   2304 cache slots; B4 once a layer a decode step, B1 never, every token
   teacher-forced; prefill seconds, decode ms a step and its kernel time,
   and a second call of the same shape;
7a. spec paged: the same Llama-3-8B on the paged engine with speculative
   decoding: 8 greedy requests of 32 tokens (half the prompts repeat a
   64-token phrase), first without speculation, then n-gram
   (``SpecConfig(k=4, rounds=2)``), the target as its own draft (k 3)
   and adaptive K (``SpecConfig.auto(k=4)``, the same draft); B3 once a
   layer a verify pass (on the variant ``kernel_variant`` names for
   T = K+1) and a prefill chunk, none on the general variant; B4 once a
   layer a draft step and never in n-gram mode; one graph, every spec
   chunk but its first a replay; the self-draft above one token a weight
   pass; acceptance, tokens a weight pass, the spec chunk's wall, kernel
   ms and busy share, TTFT, decode tokens/s and the share of tokens equal
   to the run without speculation;
7b. overload: the paged Llama-3-8B engine with a pool of 88 blocks for 4
   requests needing 96, max_queue 2, priorities BATCH, STANDARD,
   INTERACTIVE, BATCH: preemption takes the least protected class first
   (BATCH before STANDARD before INTERACTIVE), every stream is
   teacher-forced and equal to an unpressured run; a queued BATCH request
   is displaced by an INTERACTIVE arrival (``OverloadedError``,
   ``retry_after_s`` > 0); an unmeetable deadline is refused at submit;
   ``result(deadline_s=)`` cancels a request with 2 chunks in flight and
   the pool's free count returns to what it was;
7c. int8: the [slice] requests on Llama-3-8B's weight-only int8 sibling
   (``default_draft_candidates``: quantized one ``Dense`` at a time into
   a meta-built model, no float copy) behind
   ``InferenceEngine(quantize="int8")``, captured: launches on the path,
   every token teacher-forced against the int8 model, the mean KL of
   int8 against bf16 logits on teacher-forced rows under 0.02 nats;
   weight bytes, the model step, the dequantize's share of it, MBU at
   int8 bytes; then 4 requests eagerly;
7d. fused qkv: the [slice] requests on a ``qkv_fused`` Llama-3-8B made
   from the same weights by ``fuse_qkv_params``, teacher-forced against
   the unfused model, its model step against [slice]'s;
7e. autopair: ``autopair_draft`` on the bf16 target (non-spec, the int8
   sibling, n-gram): the verdict, tokens/s per mode, and the burst's
   peak memory under the target plus one sibling;
7f. autotune: an adaptive engine saves to a temporary store (with the
   autopair verdict), a second engine warm-starts from it with the same
   record and K prior, and ``measure_capability(store=, key=)`` loads
   its record on the second call;
7g. chaos: the [overload] script twice under a plan of dispatch slows
   and a drain stall: streams equal to the unfaulted run, INTERACTIVE
   requests complete, the two logs equal; the disarmed hooks' cost;
7h. self-heal: a 2-layer random-weight draft with ``self_heal_accept``
   0.3: the engine downgrades itself, its graphs are dropped and
   re-captured, launches on the path, tokens teacher-forced before and
   after;
7i. async: 8 requests through ``asubmit``/``aresult`` (two at a time)
   equal to ``submit``/``result``;
8. contiguous: GPT-2-medium (random bf16 weights) served by the contiguous
   ``ContinuousBatchingEngine`` (the ``--continuous`` path): 16 greedy
   requests of 1 to 900 tokens, B4 in its LayerNorm + bias form on every
   decode step, every token teacher-forced; TTFT and tokens/s;
8a. spec contiguous: GPT-2-medium on the contiguous engine with n-gram
   speculation (k 4, 2 rounds): the verify pass is per-row T = 5 through
   the plain attention, so no kernel launches in decode (B4 0);
9. rolling: Mistral-7B's width at 4 of its 32 layers through
   ``InferenceEngine(rolling_cache=True).generate`` (the ``--window``
   path): 2 prompts, 4200 greedy tokens, so the ring of prompt + window
   slots wraps; B4 on every decode step, every token teacher-forced
   against the windowed no-cache forward (B1 with its window), and the
   full cache's engine beside it for its tokens and bytes;
10. training: BERT-base fine-tuning at batch 8 x seq 512 (f32 master
   params from a seed, bf16 compute, Adam, dropout 0.1) through
   ``Trainer``: 30 steps with a falling loss, B1/B2 launch counts, one
   step's gradients against the plain attention path, step time, MFU, a
   profiled step, and the batch 32 x seq 128 headline shape under "auto"
   and "flash".

Legs 6-9, 7a, 7b and 8a run their decode as CUDA-graph replays (the engines' default)
with ``pipeline_depth`` 2 chunks in flight on the serving engines; the
launch gates hold through the graphs' replay credit, and each leg checks
that every decode chunk (or step) but each graph's first was a replay
and prints a ``[... graphs]`` line (graphs, captures, capture s,
replays, pool bytes). Each leg then runs the same requests on an eager
engine of the same class (``cuda_graphs=False``) under the same gates
and prints ``[... eager vs captured]`` (the share of equal tokens and
each run's worst teacher-forced gap over the first decode chunk) and
``[... step]`` (each run's model-step wall, kernel ms and busy share
from a profiled window of steady-state steps, and its whole wall).
Before them, ``[sampler]`` checks the counter sampler's hash bits on the
card against the CPU's.

Each leg's launch counts are set to 0 just before it runs and read just
after; B4's count in the kernels line sums the four serving legs, the
captured speculative draft runs, the disaggregated decode legs (float
and int8) and the legs 7c-7i, B3's the paged leg, the captured
speculative runs, both disaggregated runs (prefill variant on P, decode
on D) and the paged legs 7c-7i. The
last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Nothing of JAX or ``tensorlink_tpu``
is imported.
"""

import asyncio
import concurrent.futures
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from tensorlink_tpu_torch import native
from tensorlink_tpu_torch.config import TrainConfig
from tensorlink_tpu_torch.models.bert import BertClassifier, BertConfig
from tensorlink_tpu_torch.models.gpt2 import GPT2, GPT2Config
from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.nn.attention import (
    DECODE_BLOCK,
    DECODE_BLOCKWISE_MIN_WINDOWLESS,
    fuse_qkv_params,
)
from tensorlink_tpu_torch.ops import _build
from tensorlink_tpu_torch.ops.decode_glue import (
    FORMS,
    fused_residual_norm,
    fused_residual_norm_reference,
    launch_geometry,
)
from tensorlink_tpu_torch.ops.flash_attention import (
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd_lse,
    flash_attention_fwd_lse_reference,
)
from tensorlink_tpu_torch.ops.paged_decode import (
    VARIANTS,
    kernel_variant,
    paged_decode_attention,
    paged_decode_reference,
)
from tensorlink_tpu_torch.parallel.inference import (
    GenerationConfig,
    InferenceEngine,
    counter_bits,
    sample_logits_at,
)
from tensorlink_tpu_torch.p2p.crypto import HAVE_CRYPTOGRAPHY, Identity
from tensorlink_tpu_torch.p2p.serialization import packed_nbytes
from tensorlink_tpu_torch.parallel.kvwire import pack_kv_payload, unpack_kv_payload
from tensorlink_tpu_torch.parallel.serving import (
    ContinuousBatchingEngine,
    DeadlineExceededError,
    OverloadedError,
    PagedContinuousBatchingEngine,
    Priority,
    SpecConfig,
)
from tensorlink_tpu_torch.parallel.speculative import autopair_draft, default_draft_candidates
from tensorlink_tpu_torch.runtime import chaos, compile_cache
from tensorlink_tpu_torch.runtime.autotune import GLOBAL_MODEL, AutotuneStore, store_key
from tensorlink_tpu_torch.runtime.chaos import ChaosPlan
from tensorlink_tpu_torch.runtime.ledger import (
    ReceiptAuditor,
    build_receipt,
    verify_receipt,
)
from tensorlink_tpu_torch.runtime.profiling import measure_capability
from tensorlink_tpu_torch.train.trainer import Trainer, softmax_cross_entropy

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
PAGED_ATOL, PAGED_RTOL = 2e-2, 1e-2  # bf16 outputs, f32 accumulation both sides
# and, per case, the relative Frobenius error of the whole output: the
# atol alone is half a typical |o| over a long row, so a fault confined to
# one partition could pass it; bf16 rounding of o and of P gives ~3e-3
PAGED_REL = 1e-2
NORM_ATOL, NORM_RTOL = 1e-2, 1e-2  # bf16 outputs of an f32 row reduction
LOGIT_GAP_TOL = 0.5  # teacher-forced: emitted token within this of the row max
# flash: o is a bf16 output of f32 sums whose P operand is rounded to bf16
# (as in B3: atol + rtol elementwise, and the relative Frobenius error of
# the whole output, since over a long row the atol is half a typical |o|);
# lse is f32 math on the same scores; each gradient is a bf16 output of f32
# sums over up to T terms whose P / dS operands are rounded to bf16:
# relative Frobenius error
FLASH_O_ATOL, FLASH_O_RTOL = 2e-2, 1e-2
FLASH_O_REL = 1e-2
FLASH_LSE_ATOL = 1e-3
FLASH_GRAD_REL = 1e-2
# training: kernel vs plain attention gradients of one bf16 step. A leaf
# passes at cosine >= 0.99 with the plain path; where the plain bf16 path
# is itself farther than cosine 0.999 from the f32 gradient (a leaf whose
# gradient sits near bf16's rounding noise), the kernel path must be no
# farther from the f32 gradient than NOISE_RATIO times the plain path
TRAIN_COSINE_MIN = 0.99
TRAIN_SIGNAL_COSINE = 0.999
TRAIN_NOISE_RATIO = 2.0
TRAIN_LOSS_TOL = 1e-2
CLASSES = 3  # the reference bench's classifier width
DEV = "cuda"


def say(*parts) -> None:
    print(*parts, flush=True)  # noqa: T201


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


class L2Flush:
    """Overwrites a buffer larger than the 50 MB L2 before each timed
    launch, so a kernel reads its inputs from HBM as on the main path."""

    def __init__(self):
        self.buf = torch.empty(128 << 20, dtype=torch.uint8, device=DEV)

    def __call__(self):
        self.buf.zero_()


def time_runs(fn, flush: L2Flush, iters: int = 20) -> np.ndarray:
    """Device ms of ``iters`` launches of ``fn``, each timed with CUDA
    events after an L2 flush. A ~1 ms device sleep ahead of the first
    event lets the host enqueue the launch before the card gets there, so
    host launch overhead stays out of the device time."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return np.asarray(times)


def time_ms(fn, flush: L2Flush, iters: int = 20) -> float:
    """Mean device ms of ``fn`` (see ``time_runs``): every reported
    ``ms`` is this mean."""
    return float(time_runs(fn, flush, iters).mean())


def time_mean_median(fn, flush: L2Flush, iters: int = 20) -> tuple[float, float]:
    """(mean, median) device ms of ``fn`` over the same launches; the
    median is printed beside the mean, since one launch delayed by
    something else on the machine can carry the mean with it."""
    t = time_runs(fn, flush, iters)
    return float(t.mean()), float(np.median(t))


# --------------------------------------------------------------- phases
def host_us(fn, calls: int = 200, samples: int = 5) -> float:
    """Host microseconds per call of ``fn``, the median of ``samples``
    samples: each ``calls`` calls enqueued behind a ~50 ms device sleep,
    so the launch queue never blocks and the host clock reads the
    wrapper's own cost."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(samples):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def phase_device() -> tuple[str, str]:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    name_power = smi()
    say(f"[device] {name_power} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {_build.nvcc_version().splitlines()[-1]}")
    return torch.cuda.get_device_name(0), name_power


CUDA_SOURCES = ("paged_decode.cu", "decode_glue.cu", "flash_attention.cu")


def hgmma_counts(lib_path: str) -> dict:
    """{kernel: number of HGMMA instructions} in the library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        if "Function : " in ln:
            fn = ln.split("Function : ")[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in ln:
            counts[fn] += 1
    return counts


def phase_build() -> dict:
    def build_cuda(source):
        t0 = time.perf_counter()
        path, log, _ = _build.build(source, verbose=True)
        return time.perf_counter() - t0, path, log

    t_all = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(CUDA_SOURCES)) as ex:
        fcs = {src: ex.submit(build_cuda, src) for src in CUDA_SOURCES}
        built = {src: f.result() for src, f in fcs.items()}
    wall = time.perf_counter() - t_all
    for src, (cuda_s, path, log) in built.items():
        say(f"[build] {src} nvcc {cuda_s:.1f} s -> {path}")
        for ln in log.splitlines():
            # and any wgmma serialization ptxas reports (C75xx)
            if any(w in ln for w in ("registers", "Compiling entry", "spill",
                                     "Performance Loss")):
                say(f"[build]   ptxas: {ln.strip()}")
    fwd = {k: n for k, n in hgmma_counts(built["flash_attention.cu"][1]).items()
           if "flash_fwd_kernel" in k}
    for k, n in fwd.items():
        say(f"[build] HGMMA {n} in {k}")
    check(bool(fwd) and min(fwd.values()) > 0,
          f"a flash forward kernel has no HGMMA instruction: {fwd}")
    return {"wall_s": wall, **{src: b[0] for src, b in built.items()}}


def phase_floor(flush) -> float:
    """Mean device ms of an empty kernel (torch.cuda._sleep(0)), timed as
    every kernel here is: the least any launch reads."""
    t = time_runs(lambda: torch.cuda._sleep(0), flush)
    floor = {"floor_ms": float(t.mean()), "median_ms": float(np.median(t))}
    say(f"[floor] {json.dumps(floor)}")
    return floor["floor_ms"]


def phase_sampler() -> None:
    """The counter sampler on the card against the CPU for a few (seed,
    position) rows at Llama-3's vocabulary: the same hash bits (gated,
    exact) and the draws they give (printed)."""
    seeds = torch.tensor([0, 1, 11, 2**31 + 7, -5, 123456789, 42, 7])
    pos = torch.tensor([0, 1, 300, 4095, 2**33 + 1, 17, 2048, 99])
    V = 128256
    bits_cpu = counter_bits(seeds, pos, V)
    bits_gpu = counter_bits(seeds.to(DEV), pos.to(DEV), V).cpu()
    logits = torch.randn(len(seeds), V, generator=torch.Generator().manual_seed(5))
    kw = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
    tok_cpu = sample_logits_at(logits, seeds, pos, **kw)
    tok_gpu = sample_logits_at(logits.to(DEV), seeds.to(DEV), pos.to(DEV), **kw).cpu()
    same = bool(torch.equal(bits_cpu, bits_gpu))
    say(f"[sampler] {len(seeds)} (seed, position) rows x {V}: hash bits equal "
        f"CPU/CUDA {same}; draws equal {int((tok_cpu == tok_gpu).sum())}/{len(seeds)}")
    # the draws also pass through log and the filter's softmax, whose last
    # bits may differ between devices: printed, not gated
    check(same, "sampler: CUDA hash bits differ from the CPU's")


def _paged_inputs(g, T, case):
    """Llama-3-8B head shapes: H 32, Hkv 8, D 128, bs 16, MB 128, B 8;
    D 64 for "d64_qmask", f32 q and pools for "f32"."""
    B, H, Hkv, bs, MB = 8, 32, 8, 16, 128
    D = 64 if case == "d64_qmask" else 128
    dt = torch.float32 if case == "f32" else torch.bfloat16
    NB = B * MB + 64
    dev = DEV
    if case == "full_pages":
        lengths = torch.tensor([16, 128, 256, 512, 1024, 1536, 2032, 2048],
                               dtype=torch.int32)
    elif case == "verify":
        # the speculative verify pass: K + 1 queries a row, no mask, rows
        # of mixed lengths up to 2000
        lengths = torch.tensor([T + 40, 300, 517, 811, 1024, 1500, 1777, 2000],
                               dtype=torch.int32)
    elif case.startswith("chunk_"):
        lengths = torch.full((B,), int(case[len("chunk_"):]), dtype=torch.int32)
    else:
        lengths = torch.tensor(
            [T, 17 + T, 130 + T, 511, 1000, 1503, 1919, 2048], dtype=torch.int32
        ).clamp(max=MB * bs)
    perm = torch.randperm(NB, generator=g)
    bt = torch.full((B, MB), NB, dtype=torch.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // bs)  # live blocks; the tail stays sentinel
        bt[b, :n] = perm[b * MB:b * MB + n].int()
    q = torch.randn((B, T, H, D), generator=g).to(dev, dt)
    mask = None
    window = None
    k_scale = v_scale = None
    if case == "int8":
        k = torch.randint(-127, 128, (NB, bs, Hkv, D), generator=g,
                          dtype=torch.int8).to(dev)
        v = torch.randint(-127, 128, (NB, bs, Hkv, D), generator=g,
                          dtype=torch.int8).to(dev)
        k_scale = (torch.rand((NB, bs, Hkv), generator=g) / 64).to(dev)
        v_scale = (torch.rand((NB, bs, Hkv), generator=g) / 64).to(dev)
    else:
        k = torch.randn((NB, bs, Hkv, D), generator=g).to(dev, dt)
        v = torch.randn((NB, bs, Hkv, D), generator=g).to(dev, dt)
    if case == "mask":
        # validity mask over the view (the decode steps' form), with
        # holes, and row 0 retired: sentinel table, nothing valid
        kpos = torch.arange(MB * bs)
        valid = kpos[None, :] < lengths[:, None]
        valid &= torch.rand((B, MB * bs), generator=g) > 0.1
        valid[0] = False
        bt[0] = NB
        mask = valid[:, None, None, :].to(dev)
    if case == "full_pages":
        # the decode steps' validity mask over rows that end on a page
        # boundary: every live key valid
        mask = (torch.arange(MB * bs)[None, :] < lengths[:, None])[:, None, None, :].to(dev)
    if case.endswith("qmask"):
        # a mask per query [B, 1, T, Lv] over the view, with holes
        kpos = torch.arange(MB * bs)
        valid = kpos[None, None, :] < lengths[:, None, None]
        valid = valid & (torch.rand((B, T, MB * bs), generator=g) > 0.1)
        mask = valid[:, None].to(dev)
    if case == "window":
        window = 100
    if case == "one_row" or case.startswith("chunk_"):
        # the engine's prefill-chunk form: one row (here 1503 tokens, or
        # the chunk's own length)
        q, bt, lengths = q[5:6].contiguous(), bt[5:6], lengths[5:6]
    args = (q, k, v, bt.to(dev), lengths.to(dev))
    kwargs = {"k_scale": k_scale, "v_scale": v_scale, "mask": mask,
              "window": window}
    return args, kwargs


def _paged_cost(args, kwargs):
    """(bytes, flops) the call needs on this data: q and out once, each
    KV slot some query of its row attends once (with its scale), the
    table, lengths and mask once; 4*D flops per attended (query, key)."""
    q, k, v, bt, lengths = args
    B, T, H, D = q.shape
    bs, Hkv = k.shape[1], k.shape[2]
    Lv = bt.shape[1] * bs
    kpos = torch.arange(Lv, device=q.device)[None, None, :]
    qpos = (lengths.long()[:, None] - T + torch.arange(T, device=q.device))[:, :, None]
    keep = kpos <= qpos
    if kwargs["window"] is not None:
        keep &= kpos > qpos - kwargs["window"]
    if kwargs["mask"] is not None:
        keep &= kwargs["mask"][:, 0]
    keys_read = int(keep.any(dim=1).sum())
    pairs = int(keep.sum()) * H
    per_key = 2 * Hkv * D * k.element_size()
    if kwargs["k_scale"] is not None:
        per_key += 2 * Hkv * 4
    nbytes = (2 * q.numel() * q.element_size() + keys_read * per_key
              + bt.numel() * 4 + lengths.numel() * 4
              + (0 if kwargs["mask"] is None else kwargs["mask"].numel()))
    return nbytes, 4 * D * pairs


def _paged_library_fn(args, kwargs):
    """F.scaled_dot_product_attention over the gathered, dequantized,
    GQA-repeated view — a yardstick only; the port never calls it."""
    q, k, v, bt, lengths = args
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    NB = k.shape[0]
    btc = bt.long().clamp(max=NB - 1)
    kk = k[btc].reshape(B, -1, Hkv, D)
    vv = v[btc].reshape(B, -1, Hkv, D)
    if kwargs["k_scale"] is not None:
        kk = kk.float() * kwargs["k_scale"][btc].reshape(B, -1, Hkv, 1)
        vv = vv.float() * kwargs["v_scale"][btc].reshape(B, -1, Hkv, 1)
    kk = kk.to(q.dtype).repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    vv = vv.to(q.dtype).repeat_interleave(H // Hkv, dim=2).transpose(1, 2).contiguous()
    qq = q.transpose(1, 2).contiguous()
    Lv = kk.shape[2]
    kpos = torch.arange(Lv, device=q.device)[None, None, None, :]
    qpos = (lengths.long()[:, None] - T + torch.arange(T, device=q.device))[:, None, :, None]
    keep = kpos <= qpos
    if kwargs["window"] is not None:
        keep = keep & (kpos > qpos - kwargs["window"])
    if kwargs["mask"] is not None:
        keep = keep & kwargs["mask"]
    return lambda: F.scaled_dot_product_attention(qq, kk, vv, attn_mask=keep)


# (T, case, variant it must launch): the first design's ten cases, the
# decode form over whole pages, the prefill chunk (one row) at three
# lengths, then the variants' other branches: f32 q and pools (general),
# D 64 with a mask per query (prefill), and 4 queries a row with a mask
# per query (decode: T x group = 16 rows); last the speculative verify
# pass at K = 3 and K = 4 (T 4 and 5, no mask), whose variant
# ``kernel_variant`` names (None here): Llama-3-8B's group of 4 gives 16
# and 20 query rows, so decode at T 4 and prefill at T 5
PAGED_CASES = (
    [(T, case, "decode" if T == 1 else "prefill") for T in (1, 128)
     for case in ("mixed", "mask", "window", "int8", "one_row")]
    + [(1, "full_pages", "decode"), (128, "chunk_128", "prefill"),
       (128, "chunk_1024", "prefill"), (128, "chunk_2048", "prefill"),
       (1, "f32", "general"), (128, "d64_qmask", "prefill"),
       (4, "qmask", "decode"), (4, "verify", None), (5, "verify", None)]
)


def phase_paged(flush) -> dict:
    g = torch.Generator().manual_seed(1)
    worst = worst_rel = 0.0
    main = None
    verify = {}
    for T, case, want in PAGED_CASES:
        args, kwargs = _paged_inputs(g, T, case)
        if want is None:
            q, k = args[0], args[1]
            want = kernel_variant(q.dtype, k.dtype, T, q.shape[2], k.shape[2],
                                  q.shape[3], args[3].shape[1] * k.shape[1],
                                  kwargs["mask"] is not None)
        before = dict(paged_decode_attention.launches_by_variant)
        out = paged_decode_attention(*args, **kwargs)
        variant = [k for k, n in paged_decode_attention.launches_by_variant.items()
                   if n != before[k]]
        ref = paged_decode_reference(*args, **kwargs)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ok = bool((err <= PAGED_ATOL + PAGED_RTOL * ref.float().abs()).all())
        check(bool(torch.isfinite(out.float()).all()), f"paged {case} T={T}: non-finite")
        mx = float(err.max())
        rel = _rel(out, ref)
        worst, worst_rel = max(worst, mx), max(worst_rel, rel)
        ms, median_ms = time_mean_median(
            lambda: paged_decode_attention(*args, **kwargs), flush)
        plain_ms = time_ms(lambda: paged_decode_reference(*args, **kwargs), flush, iters=5)
        lib_ms, lib_median_ms = time_mean_median(
            _paged_library_fn(args, kwargs), flush, iters=10)
        nbytes, flops = _paged_cost(args, kwargs)
        bound, bound_by = _bound(nbytes, flops)
        row = {
            "T": T, "case": case, "variant": variant, "max_abs_err": mx,
            "rel_frobenius": rel, "ms": ms, "median_ms": median_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_median_ms": lib_median_ms,
            "bound_ms": bound, "bound_by": bound_by,
            "frac_of_bound": bound / ms, "bytes": nbytes, "flops": flops,
        }
        say(f"[paged] {json.dumps(row)}")
        check(ok, f"paged {case} T={T}: max abs err {mx} beyond "
              f"atol {PAGED_ATOL} + rtol {PAGED_RTOL}")
        check(rel <= PAGED_REL, f"paged {case} T={T}: relative Frobenius "
              f"error {rel} beyond {PAGED_REL}")
        check(variant == [want], f"paged {case} T={T}: ran {variant}, not {want}")
        if T == 1 and case == "mask":
            main = row  # the decode steps' form
        if case == "verify":
            verify[T] = row
    main = dict(main, max_abs_err=worst, verify=verify)
    say(f"[paged] all cases within atol {PAGED_ATOL} + rtol {PAGED_RTOL} and "
        f"relative Frobenius error {PAGED_REL}; worst max abs err {worst}, "
        f"worst relative {worst_rel}")
    return main


# (kind, bias, rows, D, dtype, mean offset): the decode step's two forms
# at Llama-3-8B's width, then LayerNorm of f32 rows whose mean (2e3) dwarfs
# their spread (~1.4), where a one-pass variance cancels; D 4100 (8-byte
# vectors) and 4097 (scalar), which the 16-byte vector does not divide; 64
# rows x 5120; rows of 32768 f32, which a cluster of 4 blocks splits; and
# GPT-2-medium's decode step, 8 slots x 1024 with LayerNorm + bias
NORM_CASES = (
    ("rms", False, 8, 4096, torch.bfloat16, 0.0),
    ("layer", True, 8, 4096, torch.bfloat16, 0.0),
    ("layer", True, 8, 4096, torch.float32, 1e3),
    ("layer", True, 8, 4100, torch.bfloat16, 0.0),
    ("rms", False, 8, 4097, torch.bfloat16, 0.0),
    ("rms", False, 64, 5120, torch.bfloat16, 0.0),
    ("layer", True, 4, 32768, torch.float32, 0.0),
    ("layer", True, 8, 1024, torch.bfloat16, 0.0),
)


def phase_norm(flush, floor_ms: float) -> dict:
    g = torch.Generator().manual_seed(2)
    main = None
    worst = 0.0
    for kind, with_bias, rows, D, dt, offset in NORM_CASES:
        x = (torch.randn((rows, D), generator=g) + offset).to(DEV, dt)
        res = (torch.randn((rows, D), generator=g) + offset).to(DEV, dt)
        scale = (1 + 0.1 * torch.randn(D, generator=g)).to(DEV)
        bias = (0.1 * torch.randn(D, generator=g)).to(DEV) if with_bias else None
        kw = {"eps": 1e-5, "kind": kind}
        r, y = fused_residual_norm(x, res, scale, bias, **kw)
        r0, y0 = fused_residual_norm_reference(x, res, scale, bias, **kw)
        torch.cuda.synchronize()
        errs = []
        for a, b in ((r, r0), (y, y0)):
            e = (a.float() - b.float()).abs()
            check(bool((e <= NORM_ATOL + NORM_RTOL * b.float().abs()).all()),
                  f"fused norm {kind} {rows}x{D} {dt}: err {float(e.max())} "
                  f"beyond tolerance")
            errs.append(float(e.max()))
        mx = max(errs)
        worst = max(worst, mx)
        call = lambda: fused_residual_norm(x, res, scale, bias, **kw)  # noqa: E731
        sc, bs = scale.to(dt), None if bias is None else bias.to(dt)
        if kind == "rms":
            two = lambda: F.rms_norm(torch.add(x, res), (D,), sc, 1e-5)  # noqa: E731
        else:
            two = lambda: F.layer_norm(torch.add(x, res), (D,), sc, bs, 1e-5)  # noqa: E731
        el = x.element_size()
        nbytes = 4 * rows * D * el + D * 4 * (2 if with_bias else 1)
        b_ms, bound_by = _bound(nbytes, rows * D * 8, F32_FLOPS)
        row = {"kind": kind, "bias": with_bias, "rows": rows, "D": D,
               "dtype": str(dt).replace("torch.", ""), "mean_offset": offset,
               "geometry": dict(zip(("C", "threads", "vec", "nv"),
                                    launch_geometry(D, el, 4))),
               "max_abs_err": mx, **_timed("", call, flush),
               "plain_ms": time_ms(lambda: fused_residual_norm_reference(
                   x, res, scale, bias, **kw), flush),
               "library_ms": None, "two_call_ms": time_ms(two, flush),
               "bound_ms": b_ms, "bound_by": bound_by, "floor_ms": floor_ms,
               "host_us": host_us(call)}
        say(f"[norm] {json.dumps(row)}")
        if main is None:
            main = row  # Llama's decode form
    return dict(main, max_abs_err=worst)


# The first designs: B1's (mma.sync, synchronous loads, one 64-row tile)
# and B2's (two S/dP passes in the dq kernel, synchronous loads, 32-row
# dkv tiles), the mean of 20 launches on NVIDIA H100 80GB HBM3, 700.00 W,
# as this script measured them in other runs (PERF.md, kernel table),
# printed beside the current mean; tools/kernel_ab.py times both designs
# in one run
B1_FIRST_DESIGN_MS = {"bert": 0.0678, "llama": 0.276, "window": 0.0547}
B2_FIRST_DESIGN_MS = {"bert": 0.277, "llama": 1.78, "window": 0.259}

# name: (B, H, Hkv, T, D, causal, window, mask)
FLASH_CASES = {
    # BERT-base's training shape: rows of 512, 480, 300, 129 valid keys,
    # the rest all valid
    "bert": (8, 12, 12, 512, 64, False, None, "bert"),
    # Llama-3-8B's no-cache forward
    "llama": (1, 32, 8, 2048, 128, True, None, None),
    "window": (1, 32, 8, 1024, 128, True, 256, None),
    # a length no tile divides, with a fully masked row
    "ragged": (2, 12, 12, 300, 64, False, None, "ragged"),
}


def _flash_inputs(g, B, H, Hkv, T, D, mask):
    def rnd(*shape):
        return torch.randn(shape, generator=g).to(DEV, torch.bfloat16)

    # [B, T, heads, D] storage read as [B, heads, T, D] views: the layout
    # the training path hands the kernels
    q, k, v, do = (rnd(B, T, h, D).transpose(1, 2) for h in (H, Hkv, Hkv, H))
    kv = None
    if mask == "bert":
        lens = torch.tensor([512, 480, 300, 129] + [T] * (B - 4))
        kv = (torch.arange(T)[None] < lens[:, None]).to(DEV)
    elif mask == "ragged":
        kv = torch.rand((B, T), generator=g) > 0.3
        kv[1] = False
        kv = kv.to(DEV)
    return q, k, v, do, kv


def _flash_keep(B, T, kv, causal, window):
    """[B, T, T] attended (query, key) pairs of one head."""
    qp = torch.arange(T, device=DEV)[:, None]
    kp = torch.arange(T, device=DEV)[None, :]
    keep = torch.ones((T, T), dtype=torch.bool, device=DEV)
    if causal:
        keep &= kp <= qp
    if window is not None:
        keep &= kp > qp - window
        if not causal:
            keep &= kp < qp + window
    keep = keep[None].expand(B, T, T)
    if kv is not None:
        keep = keep & kv[:, None, :]
    return keep


def _sdpa_fn(q, k, v, do, keep, is_causal: bool, grad: bool):
    """One F.scaled_dot_product_attention call (forward, or forward and
    backward) on the same inputs, with GQA pre-repeated and the boolean
    keep mask — a yardstick only; the port never calls it. The first
    backend (flash, cuDNN, memory-efficient, math) that accepts the call
    is the one timed. -> (fn, backend name)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    H = q.shape[1]
    rep = H // k.shape[1]
    qq = q.contiguous().requires_grad_(grad)
    kk = k.repeat_interleave(rep, dim=1).contiguous().requires_grad_(grad)
    vv = v.repeat_interleave(rep, dim=1).contiguous().requires_grad_(grad)
    gg = do.contiguous()
    kw = ({"is_causal": True} if is_causal
          else {"attn_mask": keep[:, None].contiguous()})

    def call():
        out = F.scaled_dot_product_attention(qq, kk, vv, **kw)
        if grad:
            torch.autograd.grad(out, (qq, kk, vv), gg)

    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        def fn(be=be):
            with sdpa_kernel([be]):
                call()
        try:
            fn()
            torch.cuda.synchronize()
        except RuntimeError:
            continue
        return fn, be.name
    raise RuntimeError("no SDPA backend accepted the call")


def _bound(nbytes, flops, peak=BF16_FLOPS):
    """(least ms for these bytes and operations, which of the two binds)."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    f_ms = flops / peak * 1e3
    return max(b_ms, f_ms), ("bytes" if b_ms >= f_ms else "operations")


def _timed(prefix: str, fn, flush, iters: int = 20) -> dict:
    """{prefix + "ms": mean, prefix + "median_ms": median} of ``fn``."""
    mean, median = time_mean_median(fn, flush, iters)
    return {f"{prefix}ms": mean, f"{prefix}median_ms": median}


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def phase_flash(flush) -> dict:
    """B1 and B2 against their plain versions on the card, in bf16, at the
    paths' shapes; each timed beside its plain version, its bound and
    SDPA. Returns the BERT case's rows (the training path's shape), with
    the worst errors over every case."""
    g = torch.Generator().manual_seed(5)
    rows = {}
    worst_f = worst_b = worst_rel_o = 0.0
    for name, (B, H, Hkv, T, D, causal, window, mask) in FLASH_CASES.items():
        q, k, v, do, kv = _flash_inputs(g, B, H, Hkv, T, D, mask)
        kw = {"causal": causal, "window": window}
        o, lse = flash_attention_fwd_lse(q, k, v, kv, **kw)
        ro, rlse = flash_attention_fwd_lse_reference(q, k, v, kv, **kw)
        grads = flash_attention_bwd(q, k, v, ro, rlse, do, kv, **kw)
        rgrads = flash_attention_bwd_reference(q, k, v, ro, rlse, do, kv, **kw)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x.float()).all()) for x in (o, lse, *grads)),
              f"flash {name}: non-finite output")
        e_o = (o.float() - ro.float()).abs()
        o_ok = bool((e_o <= FLASH_O_ATOL + FLASH_O_RTOL * ro.float().abs()).all())
        rel_o = _rel(o, ro)
        e_lse = float((lse - rlse).abs().max())
        rel = {n: _rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, rgrads)}
        e_g = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(grads, rgrads))

        keep = _flash_keep(B, T, kv, causal, window)
        pairs = int(keep.sum()) * H
        el = q.element_size()
        qo = B * T * H * D * el  # q, o, do, dq
        kv_b = B * T * Hkv * D * el  # k, v, dk, dv
        m_b = 0 if kv is None else B * T
        # forward reads q, k, v (and the mask), writes o and lse; backward
        # reads q, k, v, do and lse (and the mask), writes dq, dk, dv
        fwd_bytes = 2 * qo + 2 * kv_b + m_b + B * H * T * 4
        bwd_bytes = 3 * qo + 4 * kv_b + m_b + B * H * T * 4
        fb, fby = _bound(fwd_bytes, 4 * D * pairs)
        bb, bby = _bound(bwd_bytes, 10 * D * pairs)
        is_causal = causal and window is None and kv is None
        lib_f, be_f = _sdpa_fn(q, k, v, do, keep, is_causal, grad=False)
        lib_b, be_b = _sdpa_fn(q, k, v, do, keep, is_causal, grad=True)
        row = {
            "case": name, "B": B, "H": H, "Hkv": Hkv, "T": T, "D": D,
            "causal": causal, "window": window, "mask": mask,
            "pairs": pairs,
            "fwd": {
                "max_abs_err": float(e_o.max()), "rel_frobenius": rel_o,
                "lse_max_abs_err": e_lse,
                **_timed("", lambda: flash_attention_fwd_lse(q, k, v, kv, **kw), flush),
                "host_us": host_us(lambda: flash_attention_fwd_lse(q, k, v, kv, **kw)),
                "first_design_mean_ms": B1_FIRST_DESIGN_MS.get(name),
                "plain_ms": time_ms(lambda: flash_attention_fwd_lse_reference(
                    q, k, v, kv, **kw), flush, iters=5),
                **_timed("library_", lib_f, flush, iters=10), "library": be_f,
                "bound_ms": fb, "bound_by": fby,
                "bytes": fwd_bytes, "flops": 4 * D * pairs,
            },
            "bwd": {
                "max_abs_err": e_g, "rel_frobenius": rel,
                **_timed("", lambda: flash_attention_bwd(
                    q, k, v, ro, rlse, do, kv, **kw), flush),
                "plain_ms": time_ms(lambda: flash_attention_bwd_reference(
                    q, k, v, ro, rlse, do, kv, **kw), flush, iters=5),
                "first_design_mean_ms": B2_FIRST_DESIGN_MS.get(name),
                **_timed("library_", lib_b, flush, iters=10),
                "library": f"{be_b} forward+backward",
                "bound_ms": bb, "bound_by": bby,
                "bytes": bwd_bytes, "flops": 10 * D * pairs,
            },
        }
        say(f"[flash] {json.dumps(row)}")
        check(o_ok, f"flash {name}: o beyond atol {FLASH_O_ATOL} + rtol {FLASH_O_RTOL}")
        check(rel_o <= FLASH_O_REL, f"flash {name}: o relative Frobenius "
              f"error {rel_o} beyond {FLASH_O_REL}")
        check(e_lse <= FLASH_LSE_ATOL, f"flash {name}: lse err {e_lse}")
        check(max(rel.values()) <= FLASH_GRAD_REL,
              f"flash {name}: gradient relative error {rel}")
        worst_f = max(worst_f, float(e_o.max()))
        worst_rel_o = max(worst_rel_o, rel_o)
        worst_b = max(worst_b, e_g)
        rows[name] = row
        del q, k, v, do, o, ro, grads, rgrads, lib_f, lib_b
    say(f"[flash] all cases within tolerance; worst max abs err: o {worst_f}, "
        f"gradients {worst_b}; worst o relative Frobenius {worst_rel_o}")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {
        "fwd": dict({k: rows["bert"]["fwd"][k] for k in keys}, max_abs_err=worst_f),
        "bwd": dict({k: rows["bert"]["bwd"][k] for k in keys}, max_abs_err=worst_b),
    }


def _teacher_forced(tag: str, model, prompts, outs, first: int = 8) -> dict:
    """Teacher-forced check of every emitted token: the port's no-cache
    forward over prompt plus output must rank each emitted token within
    LOGIT_GAP_TOL of its row's maximum. Each sequence is padded at its
    end to a multiple of 128, so the reference's routing rule (_tile_ok
    lengths, T >= 512) sends the long ones to B1 (with the model's window,
    if it has one); causal attention keeps the pad out of the checked
    rows. Fails the run on a wider gap, or unless B1 ran once a layer for
    each sequence of >= 512. Also returns the worst gap over the first
    decode chunk (tokens 1 .. ``first``: token 0 is the prefill's)."""
    gaps, exact, n_flash, head = [], 0, 0, []
    flash_attention_fwd_lse.launches = 0
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            ids = np.concatenate([p, o[:-1]])
            n = len(ids)
            ids = np.concatenate([ids, np.zeros(-n % 128, ids.dtype)])
            n_flash += len(ids) >= 512
            hidden = model(torch.from_numpy(ids).to(DEV)[None], logits=False)
            logits = model.head(hidden[0, len(p) - 1:n]).float()
            check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
            tok = torch.from_numpy(np.asarray(o)).to(DEV)
            gap = logits.max(dim=-1).values - logits.gather(1, tok[:, None])[:, 0]
            gaps.append(float(gap.max()))
            head.append(float(gap[1:1 + first].max()) if len(o) > 1 else 0.0)
            exact += int((gap == 0).sum())
    n_tok = sum(len(o) for o in outs)
    k_flash = flash_attention_fwd_lse.launches
    L = len(model.blocks.blocks())
    say(f"[{tag}] teacher-forced: worst logit gap {max(gaps):.4f} "
        f"(tolerance {LOGIT_GAP_TOL}; first decode chunk {max(head):.4f}); "
        f"{exact}/{n_tok} tokens are the exact argmax; "
        f"flash_attention_fwd_lse launches {k_flash} (expected "
        f"{n_flash} sequences of >= 512 x {L} layers)")
    check(max(gaps) <= LOGIT_GAP_TOL, f"{tag}: teacher-forced check failed")
    check(k_flash == n_flash * L and k_flash > 0,
          f"{tag}: no-cache forward: flash launch count off the path")
    return {"worst_gap": max(gaps), "first_chunk_gap": max(head),
            "exact": exact, "tokens": n_tok, "sequences_ge_512": n_flash}


def _agreement(tag: str, captured, eager, tf_c: dict, tf_e: dict) -> None:
    """Print (not gate: on random bf16 weights greedy tokens part where
    logit gaps are hundredths) the share of tokens the eager run emits
    equal to the captured run's, and each run's worst teacher-forced gap
    over the first decode chunk."""
    same = sum(int((np.asarray(a) == np.asarray(b)).sum())
               for a, b in zip(captured, eager))
    total = sum(len(a) for a in captured)
    res = {"tokens_equal": same, "tokens": total, "share": same / total,
           "first_chunk_gap_captured": tf_c["first_chunk_gap"],
           "first_chunk_gap_eager": tf_e["first_chunk_gap"]}
    say(f"[{tag} eager vs captured] {json.dumps(res)}")


def _graph_line(tag: str, st: dict) -> None:
    say(f"[{tag} graphs] {json.dumps(st)}")


def _requests(vocab: int):
    """12 prompts, 1..1500 tokens across chunk (128) and block (16)
    edges; six share a 256-token prefix (requests 0, 1 and 8..11, so the
    late ones find it resident)."""
    r = np.random.default_rng(3)
    lengths = [300, 513, 15, 129, 127, 1, 1023, 777, 1500, 260, 1100, 640]
    shared = {0, 1, 8, 9, 10, 11}
    prefix = r.integers(0, vocab, (256,))
    out = []
    for i, n in enumerate(lengths):
        if i in shared:
            p = np.concatenate([prefix, r.integers(0, vocab, (n - 256,))])
        else:
            p = r.integers(0, vocab, (n,))
        out.append(p)
    return out


def _slice_engine(model: Llama, max_new: int, cuda_graphs: bool = True,
                  capability: dict | None = None, eng: InferenceEngine | None = None,
                  **kw):
    """A paged engine of the [slice] geometry (its own pools and graphs)
    over ``eng``, or a fresh ``InferenceEngine`` of ``model``."""
    if eng is None:
        eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=DEV)
    return PagedContinuousBatchingEngine(
        eng, slots=8, block_size=16, prefill_chunk=128, decode_chunk=8,
        gen=GenerationConfig(max_new_tokens=max_new), cuda_graphs=cuda_graphs,
        capability=capability, **kw,
    )


def _serve_paged(model: Llama, prompts, max_new: int, cuda_graphs: bool,
                 capability: dict | None = None, eng: InferenceEngine | None = None,
                 tag: str = "slice"):
    """The 12 requests through a fresh paged engine (over ``eng`` when
    given); launch counts set to 0 just before and read just after, then
    checked against the path. -> (engine, request ids, outputs, wall s,
    counts)."""
    cfg = model.cfg
    t0 = time.perf_counter()
    sch = _slice_engine(model, max_new, cuda_graphs, capability, eng=eng)
    torch.cuda.synchronize()
    mode = "captured" if cuda_graphs else "eager"
    say(f"[{tag}] Llama-3-8B {cfg.num_layers} layers dim {cfg.dim} "
        f"vocab {cfg.vocab_size}, {mode} decode, pipeline depth "
        f"{sch.pipeline_depth}: engine ready in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    _zero_counts()
    t_run = time.perf_counter()
    rids = [sch.submit(p) for p in prompts]
    sch.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    k1, k2 = paged_decode_attention.launches, fused_residual_norm.launches
    by_variant = dict(paged_decode_attention.launches_by_variant)
    outs = [sch.result(rid) for rid in rids]
    st = sch.stats()
    check(all(len(o) == max_new for o in outs), f"{tag}: a request did not finish")
    _check_paged_launches(f"{tag} {mode}", st, k1, k2, by_variant, cfg.num_layers)
    check(st["prefix_matched_tokens"] > 0, f"{tag}: no prefix was shared")
    if cuda_graphs:
        g = st["graphs"]
        check(g["captured"] == 1 and g["replays"] == st["decode_steps"] // 8 - 1,
              f"{tag}: every decode chunk but the first must be a replay: {g}")
    return sch, rids, outs, wall, {"paged": k1, "norm": k2}


def _check_paged_launches(tag: str, st: dict, k1: int, k2: int, by_variant: dict,
                          L: int) -> None:
    """A non-speculative paged run: B3 once a layer a decode step (decode
    variant) and a prefill chunk (prefill variant), none on the general
    one; B4 once a layer a decode step."""
    exp1 = L * (st["decode_steps"] + st["prefill_chunks"])
    exp2 = L * st["decode_steps"]
    exp_var = {"general": 0, "decode": L * st["decode_steps"],
               "prefill": L * st["prefill_chunks"]}
    say(f"[{tag}] launches: paged_decode {k1} (expected {exp1}; by "
        f"variant {by_variant}, expected {exp_var}), "
        f"fused_norm {k2} (expected {exp2}); decode steps "
        f"{st['decode_steps']}, prefill chunks {st['prefill_chunks']}")
    check(k1 == exp1 and k1 > 0, f"{tag}: paged-decode launch count off the path")
    check(by_variant == exp_var and min(by_variant["decode"], by_variant["prefill"]) > 0,
          f"{tag}: paged-decode launches off the decode/prefill variants")
    check(k2 == exp2 and k2 > 0, f"{tag}: fused-norm launch count off the path")


def phase_slice(name_power: str, model: Llama, cap: dict) -> dict:
    cfg = model.cfg
    max_new = 32
    prompts = _requests(cfg.vocab_size)
    sch, rids, outs, wall, k = _serve_paged(model, prompts, max_new, True, cap)
    st = sch.stats()
    _graph_line("slice", st["graphs"])
    tf = _teacher_forced("slice", model, prompts, outs)
    n_long = sum(len(p) >= 513 for p in prompts)
    check(tf["sequences_ge_512"] == n_long,
          f"{n_long} prompts of >= 513 tokens, {tf['sequences_ge_512']} "
          "teacher-forced sequences of >= 512")

    ttft = [sch.timings(rid)["ttft_s"] for rid in rids]
    tps = sch.decode_only_tokens / sch.decode_only_s if sch.decode_only_s else None
    res = {
        "requests": len(rids), "tokens": tf["tokens"], "wall_s": wall,
        "ttft_s_mean": float(np.mean(ttft)), "ttft_s_p50": float(np.median(ttft)),
        "ttft_s_max": float(np.max(ttft)),
        "decode_tokens_per_s": tps,
        "decode_only_steps_tokens": sch.decode_only_tokens,
        "output_tokens_per_s": tf["tokens"] / wall,
        "kv_blocks_peak": st["peak_blocks_in_use"],
        "kv_block_bytes": sch.kv_block_bytes,
        "prefix_matched_tokens": st["prefix_matched_tokens"],
        "preemptions": st["preemptions"],
        "card": name_power,
    }
    say(f"[slice] {json.dumps(res)}")
    _timer_line("slice", sch, name_power)
    _check_meters("slice", sch, rids, prompts, max_new, Identity.generate(), cap,
                  name_power)
    prof = _profile_decode(sch, cfg.vocab_size, name_power)
    _check_timer_vs_profile("slice", sch, prof, name_power)
    del sch
    gc.collect()
    torch.cuda.empty_cache()

    esch, _, eouts, ewall, _ = _serve_paged(model, prompts, max_new, False)
    tf_e = _teacher_forced("slice eager", model, prompts, eouts)
    _agreement("slice", outs, eouts, tf, tf_e)
    eprof = _profile_decode(esch, cfg.vocab_size, name_power, tag="profile eager")
    _step_line("slice", prof, eprof, wall, ewall)
    del esch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches_paged": k["paged"], "launches_norm": k["norm"],
            "prompts": prompts, "outs": outs, "prof": prof}


PROFILE_STEPS = 4  # scheduler steps in each timed window
PROFILE_NEW = 160  # tokens a profiling request: 20 chunks of 8, so all 8
# rows still decode through both windows after the paged chunked prefills


def _model_steps(sch) -> int:
    """Model passes a scheduler step dispatches: ``decode_chunk`` T == 1
    steps, or under speculation ``rounds`` verify passes plus, in draft
    mode, ``rounds * (k + 1)`` draft steps."""
    if sch.spec is None:
        return sch.decode_chunk
    cfg = sch.spec.cfg
    return cfg.rounds * (1 + (cfg.k + 1 if sch.spec.mode == "draft" else 0))


def _profile_decode(sch, vocab: int, name_power: str, tag: str = "profile",
                    max_new: int = PROFILE_NEW, cancel_after: bool = False) -> dict:
    """Where a decode step's time goes: 8 fresh requests are prefilled,
    one pure-decode scheduler step warms the pipeline, then a window of
    PROFILE_STEPS steps runs between two device syncs plainly and the
    next under ``torch.profiler`` (CUPTI sees the kernels of graph
    replays, not the per-op CPU rows). The wall a model step is the plain
    window over its model steps (``_model_steps``); the busy share is the
    device's kernel time over the profiled window's wall. A profiler that
    records no device time is reported, not fatal: the line is
    diagnosis, not a check. ``cancel_after`` cancels the profiling
    requests after the windows instead of decoding them to the end."""
    from torch.profiler import ProfilerActivity, profile

    r = np.random.default_rng(4)
    rids = [sch.submit(r.integers(0, vocab, (64,)), max_new=max_new)
            for _ in range(8)]
    while getattr(sch, "_pending", None):  # the paged engine's chunked prefill
        sch.step()
    sch.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        sch.step()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            sch.step()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    if cancel_after:
        for rid in rids:
            sch.cancel(rid)
    sch.run_until_idle()
    if not cancel_after:
        for rid in rids:
            sch.result(rid)

    # kernels only: a CPU op's device time repeats its kernels' time
    kernels = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    n_model = PROFILE_STEPS * _model_steps(sch)
    norm_us = sum(e.self_device_time_total for e in kernels if "norm" in e.key.lower())
    # PyTorch's elementwise kernels: the glue, and under weight-only int8
    # the materialised dequantize (the int8 -> bf16 cast and the scale)
    elem_us = sum(e.self_device_time_total for e in kernels
                  if "elementwise" in e.key.lower())
    res = {
        "decode_step_s": plain_s / PROFILE_STEPS, "model_steps": _model_steps(sch),
        "model_step_ms": plain_s / n_model * 1e3,
        "profiled_step_s": prof_s / PROFILE_STEPS,
        "kernel_ms_per_model_step": busy_us / 1e3 / n_model if busy_us else "not measured",
        "kernel_ms_per_step": busy_us / 1e3 / PROFILE_STEPS if busy_us else "not measured",
        "device_busy_share": busy_us / 1e6 / prof_s if busy_us else "not measured",
        "norm_kernel_share": norm_us / busy_us if busy_us else "not measured",
        "elementwise_ms_per_model_step": (elem_us / 1e3 / n_model if busy_us
                                          else "not measured"),
        "pipeline_depth": sch.pipeline_depth,
        "top_kernels_ms": {
            e.key[:48]: [e.self_device_time_total / 1e3, e.count] for e in top[:8]
        },
        "card": name_power,
    }
    say(f"[{tag}] {json.dumps(res)}")
    return res


def _step_line(tag: str, cap: dict, eager: dict, wall_c: float, wall_e: float) -> None:
    """Captured against eager: the decode step's wall and busy share, and
    each whole run's wall, on one line."""
    keys = ("model_step_ms", "kernel_ms_per_model_step", "device_busy_share")
    res = {"captured": {k: cap[k] for k in keys}, "eager": {k: eager[k] for k in keys},
           "run_wall_s": {"captured": wall_c, "eager": wall_e}}
    say(f"[{tag} step] {json.dumps(res)}")


# ------------------------------------ timer, metering, disaggregation
# [capability]: sized so the card is filled (the reference's defaults, a
# 512 matmul and 64 MB, read an H100 far below its peak, and the receipt
# auditor would then flag honest prefill receipts as overclaims)
CAP_MATMUL_DIM = 8192
CAP_HBM_MB = 1024
CAP_REPS = 10
TIMER_TOL = 0.2  # decode busy EWMA a step vs the profiled model-step wall
METER_TOL = 0.01  # meters' summed busy_s vs the timer's device busy
INT8_BLOB_MAX = 0.6  # an int8 blob against the float blob of its prompt
DISAGG_INT8_PICK = (0, 1, 5, 9)  # [slice] requests of <= 600 tokens
ZLIB_PICK = 3  # the [slice] request (129 tokens) the zlib ratio is read on


def phase_capability(name_power: str) -> dict:
    cap = measure_capability(matmul_dim=CAP_MATMUL_DIM, hbm_mb=CAP_HBM_MB,
                             reps=CAP_REPS)
    say(f"[capability] {json.dumps({**cap, 'card': name_power})}")
    check(cap["peak_tflops"] > 0 and cap["hbm_gbps"] > 0,
          "capability: no matmul or HBM rate measured")
    return cap


def _timer_line(tag: str, sch, name_power: str) -> dict:
    """``stats()["device_time"]`` on one line: per program the count, busy
    and gap seconds, host-gap share, device tokens/s, MFU and MBU."""
    dt = sch.stats()["device_time"]
    progs = {}
    for name, r in dt["programs"].items():
        both = r["gap_s"] + r["busy_s"]
        progs[name] = {
            "count": r["count"], "busy_s": r["busy_s"], "gap_s": r["gap_s"],
            "host_gap_frac": r["gap_s"] / both if both else 0.0,
            "busy_ewma_s": r["busy_ewma_s"],
            "device_tokens_per_s": r.get("device_tokens_per_sec", 0.0),
            "mfu": r.get("mfu", "not measured"), "mbu": r.get("mbu", "not measured"),
        }
    res = {"programs": progs, "device_busy_s": dt["device_busy_s"],
           "host_gap_s": dt["host_gap_s"], "host_gap_frac": dt["host_gap_frac"],
           "pending": dt["pending"], "card": name_power}
    say(f"[timer {tag}] {json.dumps(res)}")
    check(dt["pending"] == 0, f"timer {tag}: dispatches left unfinalized")
    return dt


def _check_meters(tag: str, sch, rids, prompts, emitted: int, identity, cap: dict,
                  name_power: str, wire=None) -> dict:
    """Gates 2-4 once the engine has drained: the busy seconds of every
    meter it wrote sum to the timer's device busy (every chunk and every
    prefill billed some request); each request's meter has its prompt
    tokens, ``emitted`` tokens, KV block-seconds and (``wire``) the blob
    it was imported from; each signs into a receipt that verifies and
    that an auditor holding ``cap`` accepts without an anomaly."""
    dt = sch.stats()["device_time"]
    timer_busy = sum(r["busy_s"] for r in dt["programs"].values())
    written = sch.drain_meters(limit=1 << 20)
    billed = sum(m["busy_s"] for m in written)
    meters = [sch.meter(rid) for rid in rids]
    check(all(m is not None for m in meters), f"metering {tag}: a meter is missing")
    bad = [i for i, (m, p) in enumerate(zip(meters, prompts))
           if m["prompt_tokens"] != len(p) or m["emitted_tokens"] != emitted
           or m["kv_block_s"] <= 0 or m["busy_s"] <= 0
           or (wire is not None and m["wire_bytes"] != wire[i])]
    aud = ReceiptAuditor(capability_for=lambda worker: cap)
    verdicts = []
    for m in written:
        r = build_receipt(m, identity)
        ok, why = verify_receipt(r)
        check(ok, f"metering {tag}: receipt of rid {m['rid']} fails to verify: {why}")
        verdicts.append(aud.ingest(r))
    refused = [v for v in verdicts if not v["accepted"] or v["anomalies"]]
    res = {
        "meters": len(written), "kind": sch.meter_kind,
        "billed_busy_s": billed, "timer_busy_s": timer_busy,
        "billed_over_timer": billed / timer_busy if timer_busy else None,
        "receipts_accepted": aud.accepted_total, "anomalies": dict(aud.anomaly_counts),
        "identity": "rsa" if HAVE_CRYPTOGRAPHY else "dev (no cryptography package)",
        "busy_s_per_request_mean": float(np.mean([m["busy_s"] for m in meters])),
        "kv_block_s_mean": float(np.mean([m["kv_block_s"] for m in meters])),
        "achieved_tflops_per_request_mean": float(np.mean(
            [m["flops"] / m["busy_s"] / 1e12 for m in meters])),
        "wire_bytes_mean": float(np.mean([m["wire_bytes"] for m in meters])),
        "card": name_power,
    }
    say(f"[metering {tag}] {json.dumps(res)}")
    check(timer_busy > 0 and abs(billed / timer_busy - 1) <= METER_TOL,
          f"metering {tag}: meters bill {billed} s of {timer_busy} s device busy")
    check(not bad, f"metering {tag}: meters of requests {bad} off their counts")
    check(not refused, f"metering {tag}: receipts refused or flagged: {refused}")
    return res


def _check_timer_vs_profile(tag: str, sch, prof: dict, name_power: str) -> None:
    """Gate 1: the timer's decode busy EWMA a T == 1 step against the
    model-step wall the profiled window measured on the same engine."""
    rec = sch.stats()["device_time"]["programs"]["decode"]
    per_step_ms = rec["busy_ewma_s"] / sch.decode_chunk * 1e3
    ratio = per_step_ms / prof["model_step_ms"]
    say(f"[timer {tag} vs profile] " + json.dumps({
        "timer_decode_busy_ewma_ms_per_step": per_step_ms,
        "profile_model_step_ms": prof["model_step_ms"], "ratio": ratio,
        "tolerance": TIMER_TOL, "card": name_power}))
    check(abs(ratio - 1) <= TIMER_TOL,
          f"timer {tag}: decode busy {per_step_ms:.3f} ms a step against a "
          f"{prof['model_step_ms']:.3f} ms model-step wall")


def _import_when_free(D, payload, wire_bytes: int) -> tuple[int, float, tuple, int]:
    """``D.import_prefill``, stepping D while it answers with a typed
    ``OverloadedError`` (no free decode slot yet). -> (rid, host seconds
    and CUDA events of the call that succeeded, refused calls)."""
    refused = 0
    while True:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        try:
            rid = D.import_prefill(payload, wire_bytes=wire_bytes)
        except OverloadedError:
            refused += 1
            check(D.step(), "disagg: decode leg full and idle")
            continue
        b.record()
        return rid, time.perf_counter() - t0, (a, b), refused


def _disagg_run(P, D, prompts) -> dict:
    """Each prompt: ``P.prefill_export``, pack (codec none), unpack,
    ``D.import_prefill``; one ``D.step()`` after each import so the next
    graft lands with chunks in flight. -> the decode leg's rids and
    outputs and the per-request times and sizes."""
    gather_s, stage_s = [], []

    def timed(fn, into):
        def wrapped(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            into.append(time.perf_counter() - t0)
            return out
        return wrapped

    # the export's gather (index_select, copy to pinned memory, its one
    # sync) and the import's host staging (pinned copy, upload enqueued)
    P._gather_blocks = timed(P._gather_blocks, gather_s)
    D._stage_graft = timed(D._stage_graft, stage_s)
    rec = {"prefill_export_s": [], "pack_s": [], "unpack_s": [], "import_host_s": [],
           "blob_bytes": [], "payload_bytes": [], "import_events": [], "import_refused": 0}
    rids = []
    for p in prompts:
        t0 = time.perf_counter()
        payload = P.prefill_export(p)
        rec["prefill_export_s"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        blob = pack_kv_payload(payload, codec="none")
        rec["pack_s"].append(time.perf_counter() - t0)
        del payload
        t0 = time.perf_counter()
        back = unpack_kv_payload(blob)
        rec["unpack_s"].append(time.perf_counter() - t0)
        rec["blob_bytes"].append(len(blob))
        rec["payload_bytes"].append(packed_nbytes(blob))
        del blob
        rid, host_s, events, refused = _import_when_free(D, back, rec["blob_bytes"][-1])
        rids.append(rid)
        rec["import_host_s"].append(host_s)
        rec["import_events"].append(events)
        rec["import_refused"] += refused
        del back
        D.step()
    D.run_until_idle()
    P.run_until_idle()
    torch.cuda.synchronize()
    del P._gather_blocks, D._stage_graft
    rec["export_gather_s"] = gather_s
    rec["import_staging_s"] = stage_s
    rec["import_device_s"] = [a.elapsed_time(b) / 1e3 for a, b in rec.pop("import_events")]
    rec["outs"] = [D.result(rid) for rid in rids]
    rec["rids"] = rids
    return rec


def _ms(xs) -> dict:
    return {"mean": float(np.mean(xs)) * 1e3, "max": float(np.max(xs)) * 1e3}


def _gbps(nbytes, secs) -> dict:
    rates = [n / s / 1e9 for n, s in zip(nbytes, secs)]
    return {"mean": float(np.mean(rates)), "max": float(np.max(rates))}


def phase_disagg(name_power: str, model: Llama, prompts, slice_outs, cap: dict) -> dict:
    """[disagg]: the [slice] requests split over a prefill leg P and a
    decode leg D (two engines on one model, each with its own pools and
    graphs), blocks crossing the packed wire in between; then the timer
    and metering gates on D and P and the profiled decode on D."""
    cfg = model.cfg
    L = cfg.num_layers
    check(native.have_native(),
          "disagg: the native wire codec did not build (the Python CRC "
          "fallback would take minutes on these payloads)")
    P = _slice_engine(model, 32, capability=cap)
    D = _slice_engine(model, 32, capability=cap)
    P.meter_kind, D.meter_kind = "prefill_leg", "decode_leg"
    torch.cuda.synchronize()
    _zero_counts()
    t_run = time.perf_counter()
    rec = _disagg_run(P, D, prompts)
    wall = time.perf_counter() - t_run
    by_variant = dict(paged_decode_attention.launches_by_variant)
    k_norm = fused_residual_norm.launches
    outs = rec["outs"]
    same = [bool(np.array_equal(a, b)) for a, b in zip(outs, slice_outs)]
    sp, sd = P.stats(), D.stats()
    exp_var = {"general": 0, "prefill": L * sp["prefill_chunks"],
               "decode": L * sd["decode_steps"]}
    say(f"[disagg] launches: paged_decode by variant {by_variant} (expected "
        f"{exp_var}), fused_norm {k_norm} (expected {L * sd['decode_steps']}); "
        f"P prefill chunks {sp['prefill_chunks']} decode steps {sp['decode_steps']}, "
        f"D prefill chunks {sd['prefill_chunks']} decode steps {sd['decode_steps']}")
    _graph_line("disagg D", sd["graphs"])
    check(all(same), f"disagg: requests {[i for i, x in enumerate(same) if not x]} "
          "differ from the [slice] run's tokens")
    check(by_variant == exp_var and min(exp_var["prefill"], exp_var["decode"]) > 0,
          "disagg: paged-decode launches off the legs' variants")
    check(k_norm == L * sd["decode_steps"] and sp["decode_steps"] == 0
          and sd["prefill_chunks"] == 0, "disagg: fused-norm launches off the path")
    g = sd["graphs"]
    check(g["captured"] == 1 and g["replays"] == sd["decode_steps"] // 8 - 1,
          f"disagg: every D chunk but the first must be a replay: {g}")
    n_tok = [len(p) for p in prompts]
    for st, side in ((sp["disagg"], "export"), (sd["disagg"], "import")):
        check(st[f"{side}s"] == len(prompts) and st[f"{side}_tokens"] == sum(n_tok)
              and st[f"{side}_blocks"] == sum(-(-n // 16) for n in n_tok),
              f"disagg: {side} counts off: {st}")
    # the zlib ratio on one request (its own export, after the run)
    pz = P.prefill_export(prompts[ZLIB_PICK])
    raw_len = len(pack_kv_payload(pz, codec="none"))
    t0 = time.perf_counter()
    z_len = len(pack_kv_payload(pz, codec="zlib"))
    z_s = time.perf_counter() - t0
    del pz
    res = {
        "requests": len(prompts), "tokens_equal_slice": int(sum(same)),
        "wall_s": wall,
        "prefill_export_ms": _ms(rec["prefill_export_s"]),
        "export_gather_ms": _ms(rec["export_gather_s"]),
        "pack_gbps": _gbps(rec["payload_bytes"], rec["pack_s"]),
        "unpack_gbps": _gbps(rec["payload_bytes"], rec["unpack_s"]),
        "import_host_ms": _ms(rec["import_host_s"]),
        "import_staging_host_ms": _ms(rec["import_staging_s"]),
        "import_device_span_ms": _ms(rec["import_device_s"]),
        "imports_refused_no_slot": rec["import_refused"],
        # over the whole run: a short prompt ships a whole block, so a
        # mean of per-request ratios would weigh the 1-token prompt 16x
        "blob_bytes_per_prompt_token": sum(rec["blob_bytes"]) / sum(n_tok),
        "blob_bytes_per_block_slot": sum(rec["blob_bytes"]) / (16 * sd["disagg"]["import_blocks"]),
        "blob_bytes_total": int(sum(rec["blob_bytes"])),
        "zlib_ratio": {"request": ZLIB_PICK, "tokens": n_tok[ZLIB_PICK],
                       "none_bytes": raw_len, "zlib_bytes": z_len,
                       "ratio": z_len / raw_len, "zlib_s": z_s},
        "native_codec": native.have_native(),
        "P_disagg": sp["disagg"], "D_disagg": sd["disagg"],
        "card": name_power,
    }
    say(f"[disagg] {json.dumps(res)}")
    _timer_line("disagg P", P, name_power)
    _timer_line("disagg D", D, name_power)
    _check_meters("disagg P", P, list(range(len(prompts))), prompts, 0,
                  Identity.generate(), cap, name_power)
    _check_meters("disagg D", D, rec["rids"], prompts, 32, Identity.generate(), cap,
                  name_power, wire=rec["blob_bytes"])
    prof = _profile_decode(D, cfg.vocab_size, name_power, tag="disagg D profile")
    _check_timer_vs_profile("disagg D", D, prof, name_power)
    del P, D
    _free_cuda()
    return {"paged": sum(by_variant.values()), "norm": k_norm,
            "float_blob_bytes": rec["blob_bytes"]}


def _share_equal(outs, refs) -> float:
    same = sum(int((np.asarray(a) == np.asarray(b)).sum()) for a, b in zip(outs, refs))
    return same / sum(len(a) for a in outs)


def phase_disagg_int8(name_power: str, model: Llama, prompts, slice_outs,
                      float_blob_bytes) -> dict:
    """[disagg int8]: 4 of the [slice] requests (prompts <= 600 tokens)
    int8 -> int8 (both legs ``kv_quant="int8"``, token-identical to an
    int8 colocated engine, blobs under INT8_BLOB_MAX of the float blob of
    the same prompt, B3's decode variant on int8 pools), then float ->
    int8 and int8 -> float, each teacher-forced, with the share of
    tokens equal to the importing engine's colocated run."""
    L = model.cfg.num_layers
    pick = list(DISAGG_INT8_PICK)
    ps = [prompts[i] for i in pick]
    check(all(len(p) <= 600 for p in ps), "disagg int8: a prompt over 600")
    C8 = _slice_engine(model, 32, kv_quant="int8")
    rids = [C8.submit(p) for p in ps]
    C8.run_until_idle()
    colo8 = [C8.result(r) for r in rids]
    del C8
    _free_cuda()
    P8 = _slice_engine(model, 32, kv_quant="int8")
    D8 = _slice_engine(model, 32, kv_quant="int8")
    _zero_counts()
    rec = _disagg_run(P8, D8, ps)
    by_variant = dict(paged_decode_attention.launches_by_variant)
    k_norm = fused_residual_norm.launches
    sp, sd = P8.stats(), D8.stats()
    exp_var = {"general": 0, "prefill": L * sp["prefill_chunks"],
               "decode": L * sd["decode_steps"]}
    ratio = [b / float_blob_bytes[i] for b, i in zip(rec["blob_bytes"], pick)]
    same = [bool(np.array_equal(a, b)) for a, b in zip(rec["outs"], colo8)]
    pool_dtype = str(D8._pools[0]["k"].dtype)
    res = {"requests": len(ps), "prompt_tokens": [len(p) for p in ps],
           "int8_int8_tokens_equal_int8_colocated": int(sum(same)),
           "blob_over_float_blob": ratio, "decode_pool_dtype": pool_dtype,
           "launches_by_variant": by_variant, "expected": exp_var,
           "fused_norm": k_norm,
           "export_gather_ms": _ms(rec["export_gather_s"]),
           "import_device_span_ms": _ms(rec["import_device_s"]),
           "card": name_power}
    say(f"[disagg int8] {json.dumps(res)}")
    check(all(same), "disagg int8: int8 -> int8 tokens differ from the int8 "
          "colocated engine's")
    check(max(ratio) < INT8_BLOB_MAX, f"disagg int8: blob ratios {ratio}")
    check(pool_dtype == "torch.int8" and by_variant == exp_var
          and exp_var["decode"] > 0, "disagg int8: B3 launches off the int8 path")
    check(k_norm == L * sd["decode_steps"], "disagg int8: fused-norm launches off the path")
    _check_replays("disagg int8 D", sd)
    del D8
    _free_cuda()
    # float -> int8, then int8 -> float (P8 keeps its warm prefixes)
    PF = _slice_engine(model, 32)
    D8b = _slice_engine(model, 32, kv_quant="int8")
    f2q = _disagg_run(PF, D8b, ps)["outs"]
    del PF, D8b
    _free_cuda()
    DF = _slice_engine(model, 32)
    q2f = _disagg_run(P8, DF, ps)["outs"]
    del P8, DF
    _free_cuda()
    tf1 = _teacher_forced("disagg float->int8", model, ps, f2q)
    tf2 = _teacher_forced("disagg int8->float", model, ps, q2f)
    res = {"float_to_int8_share_equal_int8_colocated": _share_equal(f2q, colo8),
           "int8_to_float_share_equal_float_colocated":
               _share_equal(q2f, [slice_outs[i] for i in pick]),
           "worst_gap": {"float_to_int8": tf1["worst_gap"],
                         "int8_to_float": tf2["worst_gap"]},
           "card": name_power}
    say(f"[disagg int8 cross-form] {json.dumps(res)}")
    return {"paged": sum(by_variant.values()), "norm": k_norm}


# ------------------------------------------------------ contiguous-cache legs
# [static]: examples/serve_llm.py's default path, InferenceEngine.generate on
# a static left-padded batch; T0 + new rounds up to 2304 cache slots, above
# the 2048 where decode takes the blockwise loop
STATIC_LENS = (700, 1200, 1650, 2000)
STATIC_NEW = 64
STATIC_MAX_LEN = 4096
STATIC_PROFILE_STEP = 40  # decode steps 40..47 run under the profiler
# [contiguous]: the --continuous path, 16 requests of 1..900 tokens (eight
# submitted after the first scheduler step); GPT-2's position table ends at
# 1024, so max_len does too
CONT_LENS = (1, 37, 900, 128, 512, 255, 700, 64, 3, 800, 333, 129, 31, 600, 450, 96)
CONT_NEW = 64
CONT_MAX_LEN = 1024
# [rolling]: the --window path at Mistral-7B's width, depth cut to 4 layers:
# the ring (T0 + window = 4352 slots) wraps only after more than 4096 decode
# steps, which 32 layers would take ~8x the chip time to reach
ROLL_LENS = (256, 200)
ROLL_NEW = 4200
ROLL_MAX_LEN = 4608
ROLL_LAYERS = 4
# after the ring's first wrap (step 4097), and both windows (steps 4104..4119)
# inside one block range of the full cache's blockwise read (4096..4351)
ROLL_PROFILE_STEP = 4112


def _zero_counts() -> None:
    """Every kernel's launch count to 0, just before a path runs."""
    paged_decode_attention.launches = 0
    paged_decode_attention.launches_by_variant = dict.fromkeys(VARIANTS, 0)
    fused_residual_norm.launches = 0
    fused_residual_norm.launches_by_form = dict.fromkeys(FORMS, 0)
    flash_attention_fwd_lse.launches = 0
    flash_attention_bwd.launches = 0


def _counts() -> dict:
    return {
        "paged_decode": paged_decode_attention.launches,
        "fused_norm": fused_residual_norm.launches,
        "fused_norm_by_form": dict(fused_residual_norm.launches_by_form),
        "flash_fwd": flash_attention_fwd_lse.launches,
        "flash_bwd": flash_attention_bwd.launches,
    }


def _check_decode_launches(tag: str, c: dict, expected: int, form: str) -> None:
    """B4 once a layer a decode step, all in ``form``; no other kernel
    (the prefill masks are general, so B1 stays off, as in the JAX
    package; the contiguous cache has no block table for B3)."""
    say(f"[{tag}] launches: {json.dumps(c)}; expected fused_norm {expected} "
        f"({form}), none of the others")
    check(c["fused_norm"] == expected > 0
          and c["fused_norm_by_form"][form] == expected,
          f"{tag}: fused-norm launches off the path")
    check(c["flash_fwd"] == c["flash_bwd"] == c["paged_decode"] == 0,
          f"{tag}: an attention kernel ran on the contiguous path")


def _left_padded(lens, vocab: int, seed: int):
    """(prompts, ids [B, T0], pad mask): prompts of ``lens`` tokens,
    left-padded to the longest."""
    r = np.random.default_rng(seed)
    prompts = [r.integers(0, vocab, (n,)) for n in lens]
    T0 = max(lens)
    ids = np.zeros((len(lens), T0), np.int64)
    pad = np.zeros_like(ids)
    for b, p in enumerate(prompts):
        ids[b, T0 - len(p):] = p
        pad[b, T0 - len(p):] = 1
    return prompts, ids, pad


def _cache_bytes(eng, B: int, slots: int) -> int:
    attn = eng.model.blocks.blocks()[0].attn
    item = torch.empty((), dtype=eng.cache_dtype).element_size()
    return (2 * len(eng.model.blocks.blocks()) * B * slots
            * attn.num_kv_heads * attn.head_dim * item)


def _generate_traced(tag: str, eng, ids, pad, max_new: int, first: int,
                     name_power: str, active: int = 8) -> dict:
    """``eng.generate`` of ``max_new`` greedy tokens, with the engine's
    step hook (called before decode step i, on the host, replay or not):
    at step 1 a device sync stamps the prefill's end; steps first -
    active .. first - 1 run between two syncs (the plain window, ms a
    step), steps first .. first + active - 1 under torch.profiler between
    two syncs (kernel ms a step; the busy share is that over the plain
    step). -> the tokens, host seconds in all and to the prefill's end,
    and ms a decode step."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    stamps = {}

    def hook(i):
        if i in (1, first - active, first, first + active):
            torch.cuda.synchronize()
            stamps[i] = time.perf_counter()
        if i == first:
            prof.start()
        elif i == first + active:
            prof.stop()

    eng.step_hook = hook
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = eng.generate(ids, GenerationConfig(max_new_tokens=max_new),
                           pad_mask=pad)
        total_s = time.perf_counter() - t0
    finally:
        eng.step_hook = None
    check(first + active in stamps, f"{tag}: the profiled window did not close")
    decode_ms = (stamps[first] - stamps[first - active]) / active * 1e3
    window_s = stamps[first + active] - stamps[first]
    kernels = {
        e.key: e.self_device_time_total / active / 1e3
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    }
    busy = sum(kernels.values())
    norm = sum(v for k, v in kernels.items() if "norm" in k.lower())
    top = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:8]
    res = {
        "model_step_ms": decode_ms,
        "profiled_window_ms_per_step": window_s / active * 1e3,
        "kernel_ms_per_model_step": busy if busy > 0 else "not measured",
        "device_busy_share": busy / decode_ms if busy > 0 else "not measured",
        "norm_kernel_share": norm / busy if busy > 0 else "not measured",
        "top_kernels_ms_per_step": {k[:48]: v for k, v in top},
        "card": name_power,
    }
    say(f"[{tag} profile] {json.dumps(res)}")
    return {"out": out, "total_s": total_s, "prefill_s": stamps[1] - t0,
            "decode_ms": decode_ms, "profile": res}


def _second_call_s(eng, ids, pad, max_new: int) -> float:
    """Host seconds of a second ``generate`` of the same shape (its graphs
    and cache kept from the first)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(ids, GenerationConfig(max_new_tokens=max_new), pad_mask=pad)
    return time.perf_counter() - t0


def phase_static(name_power: str, model: Llama) -> dict:
    """Llama-3-8B (the model phase_slice served) through
    ``InferenceEngine.generate``: 4 left-padded prompts, greedy, decode
    steps as graph replays, then the same call again (graphs kept) and
    the same call on an eager engine; B4 on every decode step of every
    layer, B1 never; every token of both runs within LOGIT_GAP_TOL of the
    teacher-forced row maximum."""
    cfg = model.cfg
    prompts, ids, pad = _left_padded(STATIC_LENS, cfg.vocab_size, seed=6)
    B, T0 = ids.shape
    steps = STATIC_NEW - 1
    runs = {}
    for mode in ("captured", "eager"):
        eng = InferenceEngine(model, max_len=STATIC_MAX_LEN,
                              cache_dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=DEV,
                              cuda_graphs=mode == "captured")
        slots, rolling = eng.cache_plan(T0, STATIC_NEW)
        check(not rolling and slots > DECODE_BLOCKWISE_MIN_WINDOWLESS
              and slots % DECODE_BLOCK == 0,
              f"static: {slots} cache slots do not take the blockwise decode")
        tag = "static" if mode == "captured" else "static eager"
        _zero_counts()
        run = _generate_traced(tag, eng, ids, pad, STATIC_NEW,
                               STATIC_PROFILE_STEP, name_power)
        run["counts"] = c = _counts()
        _check_decode_launches(tag, c, cfg.num_layers * steps, "rms")
        check(run["out"].shape == (B, STATIC_NEW),
              f"{tag}: tokens of shape {run['out'].shape}")
        run["tf"] = _teacher_forced(tag, model, prompts, list(run["out"]))
        if mode == "captured":
            g = eng.graph_stats()
            _graph_line("static", g)
            # one graph a block range: 8 blocks of 256 up to slot 2048, 9 after
            check(g["captured"] == 2 and g["replays"] == steps - 2,
                  f"static: decode steps off the graphs: {g}")
            run["second_call_s"] = _second_call_s(eng, ids, pad, STATIC_NEW)
            run["cache_bytes"] = _cache_bytes(eng, B, slots)
        runs[mode] = run
        eng._gen_state = None  # free the 1.2 GB cache before the next engine
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    cap, eag = runs["captured"], runs["eager"]
    _agreement("static", list(cap["out"]), list(eag["out"]), cap["tf"], eag["tf"])
    _step_line("static", cap["profile"], eag["profile"], cap["total_s"], eag["total_s"])
    res = {
        "model": "Llama-3-8B", "layers": cfg.num_layers, "batch": B, "T0": T0,
        "prompt_lens": list(STATIC_LENS), "new_tokens": STATIC_NEW,
        "cache_slots": slots, "cache_bytes": cap["cache_bytes"],
        "prefill_s": cap["prefill_s"], "generate_s": cap["total_s"],
        "generate_s_second_call": cap["second_call_s"],
        "decode_ms_per_step": cap["decode_ms"],
        "eager_decode_ms_per_step": eag["decode_ms"],
        "tokens_per_s": B * STATIC_NEW / cap["total_s"],
        "tokens_per_s_second_call": B * STATIC_NEW / cap["second_call_s"],
        "decode_tokens_per_s": B * steps / (cap["total_s"] - cap["prefill_s"]),
        "launches_fused_norm": cap["counts"]["fused_norm"], "card": name_power,
    }
    say(f"[static] {json.dumps(res)}")
    return {"launches_norm": cap["counts"]["fused_norm"],
            "worst_gap": cap["tf"]["worst_gap"]}


def _serve_contiguous(model, prompts, cuda_graphs: bool):
    """The 16 requests through a fresh contiguous engine (eight submitted
    after the first scheduler step); B4's launches checked against the
    decode steps. -> (engine, request ids, outputs, wall s, counts)."""
    gcfg = model.cfg
    eng = InferenceEngine(model, max_len=CONT_MAX_LEN, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    sch = ContinuousBatchingEngine(
        eng, slots=8, decode_chunk=8, prefill_block=32,
        gen=GenerationConfig(max_new_tokens=CONT_NEW), cuda_graphs=cuda_graphs,
    )
    tag = "contiguous" if cuda_graphs else "contiguous eager"
    _zero_counts()
    t_run = time.perf_counter()
    rids = [sch.submit(p) for p in prompts[:8]]
    sch.step()
    rids += [sch.submit(p) for p in prompts[8:]]
    sch.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    c = _counts()
    st = sch.stats()
    outs = [sch.result(rid) for rid in rids]
    check(all(len(o) == CONT_NEW for o in outs), f"{tag}: a request did not finish")
    _check_decode_launches(tag, c, gcfg.num_layers * st["decode_steps"],
                           "layer+bias")
    if cuda_graphs:
        g = st["graphs"]
        check(g["captured"] == 1 and g["replays"] == st["decode_steps"] // 8 - 1,
              f"{tag}: every decode chunk but the first must be a replay: {g}")
    return sch, rids, outs, wall, c


def phase_contiguous(name_power: str) -> dict:
    """GPT-2-medium (random bf16 weights from seed 0) served by the
    contiguous ``ContinuousBatchingEngine``: 16 greedy requests, eight of
    them submitted after the first scheduler step, decode chunks as graph
    replays, then the same requests eagerly; B4 in its LayerNorm + bias
    form on every decode step of every layer."""
    gcfg = GPT2Config.medium()
    t0 = time.perf_counter()
    model = GPT2(gcfg, device=DEV, dtype=torch.bfloat16, seed=0)
    r = np.random.default_rng(7)
    prompts = [r.integers(0, gcfg.vocab_size, (n,)) for n in CONT_LENS]
    sch, rids, outs, wall, c = _serve_contiguous(model, prompts, True)
    st = sch.stats()
    say(f"[contiguous] GPT-2-medium {gcfg.num_layers} layers dim {gcfg.dim} "
        f"vocab {gcfg.vocab_size}: params + run in "
        f"{time.perf_counter() - t0:.1f} s, cache {sch.kv_bytes} bytes, "
        f"pipeline depth {sch.pipeline_depth}")
    _graph_line("contiguous", st["graphs"])
    tf = _teacher_forced("contiguous", model, prompts, outs)
    ttft = [sch.timings(rid)["ttft_s"] for rid in rids]
    res = {
        "model": "GPT-2-medium", "requests": len(rids), "tokens": tf["tokens"],
        "wall_s": wall, "ttft_s_mean": float(np.mean(ttft)),
        "ttft_s_p50": float(np.median(ttft)), "ttft_s_max": float(np.max(ttft)),
        "decode_tokens_per_s": (sch.decode_only_tokens / sch.decode_only_s
                                if sch.decode_only_s else None),
        "decode_only_steps_tokens": sch.decode_only_tokens,
        "output_tokens_per_s": tf["tokens"] / wall,
        "decode_steps": st["decode_steps"], "prefills": st["prefill_chunks"],
        "cache_bytes": sch.kv_bytes, "card": name_power,
    }
    say(f"[contiguous] {json.dumps(res)}")
    prof = _profile_decode(sch, gcfg.vocab_size, name_power, tag="contiguous profile")
    del sch
    gc.collect()
    torch.cuda.empty_cache()
    esch, _, eouts, ewall, _ = _serve_contiguous(model, prompts, False)
    tf_e = _teacher_forced("contiguous eager", model, prompts, eouts)
    _agreement("contiguous", outs, eouts, tf, tf_e)
    eprof = _profile_decode(esch, gcfg.vocab_size, name_power,
                            tag="contiguous profile eager")
    _step_line("contiguous", prof, eprof, wall, ewall)
    return {"launches_norm": c["fused_norm"], "worst_gap": tf["worst_gap"]}


def phase_rolling(name_power: str) -> dict:
    """Mistral-7B's width at 4 layers (random bf16 weights from seed 0)
    through ``InferenceEngine(rolling_cache=True).generate``: 2
    left-padded prompts, greedy, long enough that the ring wraps, decode
    steps as graph replays, then the same call on an eager engine; B4 on
    every decode step; every token of both runs within LOGIT_GAP_TOL of
    the no-cache windowed forward's row maximum; the full cache's engine
    (captured too) run beside it for its tokens and bytes."""
    mcfg = dataclasses.replace(LlamaConfig.mistral_7b(), num_layers=ROLL_LAYERS)
    model = Llama(mcfg, device=DEV, dtype=torch.bfloat16, seed=0)
    kw = {"max_len": ROLL_MAX_LEN, "cache_dtype": torch.bfloat16,
          "param_dtype": torch.bfloat16, "device": DEV}
    ring = InferenceEngine(model, rolling_cache=True, **kw)
    full = InferenceEngine(model, **kw)
    prompts, ids, pad = _left_padded(ROLL_LENS, mcfg.vocab_size, seed=8)
    B, T0 = ids.shape
    slots, rolling = ring.cache_plan(T0, ROLL_NEW)
    full_slots, _ = full.cache_plan(T0, ROLL_NEW)
    check(rolling and slots == T0 + mcfg.attn_window < full_slots,
          f"rolling: plan {slots} slots (ring {rolling}), full {full_slots}")
    made = []  # the caches generate allocates, to read the ring back

    def init_caches(*a, **k):
        made.append(Llama.init_caches(model, *a, **k))
        return made[-1]

    steps = ROLL_NEW - 1
    model.init_caches = init_caches
    try:
        _zero_counts()
        run = _generate_traced("rolling", ring, ids, pad, ROLL_NEW,
                               ROLL_PROFILE_STEP, name_power)
        c = _counts()
    finally:
        del model.init_caches
    _check_decode_launches("rolling", c, ROLL_LAYERS * steps, "rms")
    g = ring.graph_stats()
    _graph_line("rolling", g)
    check(g["captured"] == 1 and g["replays"] == steps - 1,
          f"rolling: decode steps off the graph: {g}")
    cache = made[-1][0]["attn"]
    writes = T0 + c["fused_norm"] // ROLL_LAYERS  # the prompt, then a slot a step
    check("rolling" in cache and cache["k"].shape[1] == slots < writes,
          f"rolling: the ring of {cache['k'].shape[1]} slots took {writes} writes")
    out = run["out"]
    run_full = _generate_traced("rolling full-cache", full, ids, pad,
                                ROLL_NEW, ROLL_PROFILE_STEP, name_power)
    _graph_line("rolling full-cache", full.graph_stats())
    full._gen_state = None
    tf = _teacher_forced("rolling", model, prompts, list(out))
    eager = InferenceEngine(model, rolling_cache=True, cuda_graphs=False, **kw)
    _zero_counts()
    run_e = _generate_traced("rolling eager", eager, ids, pad, ROLL_NEW,
                             ROLL_PROFILE_STEP, name_power)
    _check_decode_launches("rolling eager", _counts(), ROLL_LAYERS * steps, "rms")
    tf_e = _teacher_forced("rolling eager", model, prompts, list(run_e["out"]))
    _agreement("rolling", list(out), list(run_e["out"]), tf, tf_e)
    _step_line("rolling", run["profile"], run_e["profile"], run["total_s"],
               run_e["total_s"])
    res = {
        "model": f"Mistral-7B width, {ROLL_LAYERS} of 32 layers",
        "batch": B, "T0": T0, "prompt_lens": list(ROLL_LENS),
        "new_tokens": ROLL_NEW, "window": mcfg.attn_window,
        "ring_slots": slots, "ring_writes": writes,
        "ring_cache_bytes": _cache_bytes(ring, B, slots),
        "full_cache_slots": full_slots,
        "full_cache_bytes": _cache_bytes(full, B, full_slots),
        "prefill_s": run["prefill_s"], "ring_generate_s": run["total_s"],
        "ring_decode_ms_per_step": run["decode_ms"],
        "ring_eager_decode_ms_per_step": run_e["decode_ms"],
        "full_prefill_s": run_full["prefill_s"],
        "full_generate_s": run_full["total_s"],
        "full_decode_ms_per_step": run_full["decode_ms"],
        "tokens_equal_to_full_cache": int((out == run_full["out"]).sum()),
        "tokens": int(out.size), "card": name_power,
    }
    say(f"[rolling] {json.dumps(res)}")
    return {"launches_norm": c["fused_norm"], "worst_gap": tf["worst_gap"]}


# ------------------------------------------------------- speculation legs
# [spec paged]: 8 greedy requests of SPEC_NEW tokens on Llama-3-8B; the
# even ones hold a repeated 64-token phrase (prompt lookup finds matches,
# as on code and documents); three of the prompts are long enough for B1
# in the teacher-forced check
SPEC_LENS = (300, 700, 200, 560, 260, 900, 160, 640)
SPEC_NEW = 32
SPEC_PHRASE = 64
SPEC_PROFILE_NEW = 128  # a profiling request: rows still decode through
# both windows at up to rounds * (k + 1) = 10 tokens a step; they are
# cancelled after the windows
SPEC_RUNS = (  # (tag, SpecConfig, the target as its own draft)
    ("ngram", SpecConfig(k=4, rounds=2), False),
    ("draft", SpecConfig(k=3, rounds=2), True),
    ("adaptive", SpecConfig.auto(k=4), True),
)
# [overload]: 4 requests whose budgets need 96 blocks of 16 from a pool
# of 88 (their prompts take 80), with mixed priorities; the first is long
# enough for B1 in the teacher-forced check
OVER_LENS = (480, 280, 260, 240)
OVER_PRIOS = (Priority.BATCH, Priority.STANDARD, Priority.INTERACTIVE,
              Priority.BATCH)
OVER_NEW = 64
OVER_BLOCKS = 88


def _spec_requests(vocab: int):
    r = np.random.default_rng(11)
    phrase = r.integers(0, vocab, (SPEC_PHRASE,))
    out = []
    for i, n in enumerate(SPEC_LENS):
        p = r.integers(0, vocab, (n,))
        if i % 2 == 0:
            # 16 tokens of its own, then the phrase over and over
            p[16:] = np.tile(phrase, -(-n // SPEC_PHRASE))[:n - 16]
        out.append(p)
    return out


def _check_spec_launches(tag: str, c: dict, by_variant: dict, sch, cfg, k: int,
                         draft_layers: int) -> None:
    """B3 once a target layer a prefill chunk (prefill variant), a verify
    pass (at T = K+1, on the variant ``kernel_variant`` names) and a plain
    decode step (decode variant), none on the general one; B4 once a draft
    layer a draft step and once a target layer a plain decode step (none
    in n-gram decode); no B1 or B2 in serving. The counts are the
    engine's own, so a run whose mode changed midway (self-healing) is
    held to the same rule."""
    layers = cfg.num_layers
    exp = dict.fromkeys(VARIANTS, 0)
    exp["prefill"] += layers * sch.prefill_chunks
    exp["decode"] += layers * sch.decode_steps
    if sch.verify_passes:
        vvar = kernel_variant(torch.bfloat16, torch.bfloat16, k + 1, cfg.num_heads,
                              cfg.num_kv_heads, cfg.dim // cfg.num_heads, 2048, False)
        exp[vvar] += layers * sch.verify_passes
    exp_norm = draft_layers * sch.draft_steps + layers * sch.decode_steps
    say(f"[{tag}] launches: paged_decode {c['paged_decode']} by variant "
        f"{by_variant} (expected {exp}); fused_norm {c['fused_norm']} "
        f"(expected {exp_norm}); flash {c['flash_fwd']} / {c['flash_bwd']}")
    check(by_variant == exp and c["paged_decode"] == sum(exp.values()) > 0,
          f"{tag}: paged-decode launches off the path")
    check(c["fused_norm"] == exp_norm, f"{tag}: fused-norm launches off the path")
    check(c["flash_fwd"] == c["flash_bwd"] == 0, f"{tag}: flash ran in serving")


def _check_replays(tag: str, st: dict) -> None:
    """One graph; every chunk but its first a replay."""
    g = st["graphs"]
    sp = st.get("spec")
    chunks = (st["decode_steps"] // 8 if sp is None
              else sp["verify_passes"] // sp["rounds"])
    _graph_line(tag, g)
    check(g["graphs"] == 1 and g["captured"] == 1 and g["replays"] == chunks - 1,
          f"{tag}: every chunk but the first must be a replay of one graph: {g}")


def _serve_spec(tag: str, model, prompts, spec_cfg, self_draft: bool,
                cuda_graphs: bool):
    """The requests through a fresh paged engine (speculative unless
    ``spec_cfg`` is None), launch counts set to 0 just before and read
    just after, checked against the path. -> (engine, request ids,
    outputs, wall s, counts)."""
    cfg = model.cfg
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    sch = PagedContinuousBatchingEngine(
        eng, slots=8, block_size=16, prefill_chunk=128, decode_chunk=8,
        gen=GenerationConfig(max_new_tokens=SPEC_NEW), cuda_graphs=cuda_graphs,
        draft=eng if self_draft else None, speculative=spec_cfg,
    )
    _zero_counts()
    t0 = time.perf_counter()
    rids = [sch.submit(p) for p in prompts]
    sch.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    by_variant = dict(paged_decode_attention.launches_by_variant)
    st = sch.stats()
    outs = [sch.result(rid) for rid in rids]
    check(all(len(o) == SPEC_NEW for o in outs), f"{tag}: a request did not finish")
    _check_spec_launches(tag, c, by_variant, sch, cfg, spec_cfg.k if spec_cfg else 0,
                         cfg.num_layers if self_draft else 0)
    if cuda_graphs:
        _check_replays(tag, st)
    return sch, rids, outs, wall, c


def _spec_line(tag: str, sch, rids, outs, plain_outs, wall: float, prof: dict,
               name_power: str) -> dict:
    sp = sch.stats()["spec"]
    ttft = [sch.timings(rid)["ttft_s"] for rid in rids]
    same = None if plain_outs is None else sum(
        int((np.asarray(a) == np.asarray(b)).sum()) for a, b in zip(outs, plain_outs))
    res = {
        "mode": sp["mode"], "k": sp["k"], "rounds": sp["rounds"],
        "adaptive": sp["adaptive"], "k_mean": sp.get("k_mean"),
        "acceptance_rate": sp["acceptance_rate"],
        "tokens_per_weight_pass": sp["accepted_tokens_per_weight_pass"],
        "weight_passes": sp["weight_passes"], "verify_passes": sp["verify_passes"],
        "draft_steps": sp["draft_steps"], "idle_draft_steps": sp["idle_draft_steps"],
        "fallbacks": sp["fallback_total"],
        "spec_chunk_ms": prof["decode_step_s"] * 1e3 if prof else "not measured",
        "kernel_ms_per_chunk": prof["kernel_ms_per_step"] if prof else "not measured",
        "device_busy_share": prof["device_busy_share"] if prof else "not measured",
        "decode_tokens_per_s": (sch.decode_only_tokens / sch.decode_only_s
                                if sch.decode_only_s else None),
        "ttft_s_mean": float(np.mean(ttft)), "ttft_s_p50": float(np.median(ttft)),
        "ttft_s_max": float(np.max(ttft)), "wall_s": wall,
        "tokens_equal_to_nonspec": same, "tokens": sum(len(o) for o in outs),
        "card": name_power,
    }
    say(f"[{tag}] {json.dumps(res)}")
    return res


def _free_cuda() -> None:
    """Return what a dropped engine held (its pools, caches, graphs)."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_spec_paged(name_power: str, model: Llama) -> dict:
    """Speculative decoding on the paged engine at Llama-3-8B: the
    non-spec run of the requests, then n-gram (k 4), the target as its
    own draft (k 3) and adaptive K (``SpecConfig.auto(k=4)``, the same
    draft), each captured and then eager, under the launch, replay and
    teacher-forced gates; the self-draft must emit more than one token a
    weight pass, and adaptive K must keep one graph."""
    cfg = model.cfg
    prompts = _spec_requests(cfg.vocab_size)
    sch, _, plain_outs, _, _ = _serve_spec(
        "spec paged nonspec", model, prompts, None, False, True)
    del sch
    _free_cuda()
    launches = {"paged": 0, "norm": 0}
    for name, spec_cfg, self_draft in SPEC_RUNS:
        tag = f"spec paged {name}"
        sch, rids, outs, wall, c = _serve_spec(tag, model, prompts, spec_cfg,
                                               self_draft, True)
        launches["paged"] += c["paged_decode"]
        launches["norm"] += c["fused_norm"]
        tf = _teacher_forced(tag, model, prompts, outs)
        prof = _profile_decode(sch, cfg.vocab_size, name_power,
                               tag=f"{tag} profile", max_new=SPEC_PROFILE_NEW,
                               cancel_after=True)
        res = _spec_line(tag, sch, rids, outs, plain_outs, wall, prof, name_power)
        if self_draft and not spec_cfg.adaptive:
            check(res["tokens_per_weight_pass"] > 1.0,
                  f"{tag}: the self-draft emitted no more than one token a pass")
        del sch
        _free_cuda()
        esch, erids, eouts, ewall, _ = _serve_spec(f"{tag} eager", model, prompts,
                                                   spec_cfg, self_draft, False)
        tf_e = _teacher_forced(f"{tag} eager", model, prompts, eouts)
        _agreement(tag, outs, eouts, tf, tf_e)
        eres = _spec_line(f"{tag} eager", esch, erids, eouts, plain_outs, ewall,
                          None, name_power)
        if self_draft and not spec_cfg.adaptive:
            check(eres["tokens_per_weight_pass"] > 1.0,
                  f"{tag} eager: the self-draft emitted no more than one token a pass")
        del esch
        _free_cuda()
    return launches


def phase_spec_contiguous(name_power: str) -> dict:
    """GPT-2-medium on the contiguous engine with n-gram speculation (k 4,
    2 rounds): the verify pass is per-row T = 5 through the plain
    attention, so no attention kernel runs and B4 never (no T == 1 step);
    the [contiguous] leg's 16 requests, captured then eager, with every
    token teacher-forced."""
    gcfg = GPT2Config.medium()
    model = GPT2(gcfg, device=DEV, dtype=torch.bfloat16, seed=0)
    r = np.random.default_rng(7)
    prompts = [r.integers(0, gcfg.vocab_size, (n,)) for n in CONT_LENS]
    spec_cfg = SpecConfig(k=4, rounds=2)
    runs = {}
    for graphs in (True, False):
        tag = "spec contiguous" + ("" if graphs else " eager")
        eng = InferenceEngine(model, max_len=CONT_MAX_LEN, cache_dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=DEV)
        sch = ContinuousBatchingEngine(
            eng, slots=8, decode_chunk=8, prefill_block=32,
            gen=GenerationConfig(max_new_tokens=CONT_NEW), cuda_graphs=graphs,
            speculative=spec_cfg,
        )
        _zero_counts()
        t0 = time.perf_counter()
        rids = [sch.submit(p) for p in prompts[:8]]
        sch.step()
        rids += [sch.submit(p) for p in prompts[8:]]
        sch.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = _counts()
        st = sch.stats()
        outs = [sch.result(rid) for rid in rids]
        check(all(len(o) == CONT_NEW for o in outs), f"{tag}: a request did not finish")
        say(f"[{tag}] launches: {json.dumps(c)}; expected none (verify passes "
            f"{st['spec']['verify_passes']})")
        check(c["fused_norm"] == c["paged_decode"] == c["flash_fwd"]
              == c["flash_bwd"] == 0 and st["spec"]["verify_passes"] > 0,
              f"{tag}: a kernel ran on the n-gram contiguous path")
        if graphs:
            _check_replays(tag, st)
        tf = _teacher_forced(tag, model, prompts, outs)
        prof = (_profile_decode(sch, gcfg.vocab_size, name_power,
                                tag=f"{tag} profile", max_new=SPEC_PROFILE_NEW,
                                cancel_after=True)
                if graphs else None)
        _spec_line(tag, sch, rids, outs, None, wall, prof, name_power)
        runs[graphs] = (outs, tf)
        del sch, eng
        _free_cuda()
    _agreement("spec contiguous", runs[True][0], runs[False][0], runs[True][1],
               runs[False][1])
    return {"worst_gap": runs[True][1]["worst_gap"]}


def _overload_run(tag: str, eng, prompts, cuda_graphs: bool, ref_outs):
    """Priority preemption under a pool too small for the budgets, then
    displacement, deadline refusal and a cancel with chunks in flight,
    on one paged engine."""
    gen = GenerationConfig(max_new_tokens=OVER_NEW)
    sch = PagedContinuousBatchingEngine(
        eng, slots=4, block_size=16, num_blocks=OVER_BLOCKS, prefill_chunk=128,
        decode_chunk=8, max_queue=2, pipeline_depth=2, gen=gen,
        cuda_graphs=cuda_graphs)
    # each preemption: (rid, its priority, the priorities it could have
    # been chosen from: every other running request but the one whose
    # block growth forced it)
    pre, protect = [], [None]
    inner_preempt, inner_alloc = sch._preempt, sch._alloc_with_preemption

    def alloc(n, slot):
        protect[0] = slot
        try:
            return inner_alloc(n, slot)
        finally:
            protect[0] = None

    def preempt(slot):
        req = sch._slot_req[slot]
        others = [int(r.priority) for s, r in enumerate(sch._slot_req)
                  if r is not None and s != protect[0]] or [int(req.priority)]
        pre.append((req.rid, int(req.priority), others))
        return inner_preempt(slot)

    sch._preempt, sch._alloc_with_preemption = preempt, alloc
    rids = [sch.submit(p, priority=q) for p, q in zip(prompts, OVER_PRIOS)]
    sch.run_until_idle()
    outs = [sch.result(rid) for rid in rids]
    say(f"[{tag}] preemptions (rid, priority, candidates' priorities): {pre}")
    check(pre and pre[0][1] == int(Priority.BATCH),
          f"{tag}: the first preemption must take a BATCH stream: {pre}")
    check(all(p == max(others) for _, p, others in pre),
          f"{tag}: a preemption passed over a less protected class: {pre}")
    same = [bool((np.asarray(o) == np.asarray(rf)).all())
            for o, rf in zip(outs, ref_outs)]
    preempted = sorted({rid for rid, _, _ in pre})
    # displacement: four fillers take the slots, two BATCH requests fill
    # the queue, an INTERACTIVE arrival displaces the newer one
    fill = [sch.submit(p, max_new=16) for p in prompts]
    qb = [sch.submit(p, max_new=16, priority="batch") for p in prompts[:2]]
    ri = sch.submit(prompts[2], max_new=16, priority="interactive")
    sch.run_until_idle()
    try:
        sch.result(qb[1])
        displaced = None
    except OverloadedError as e:
        displaced = (e.reason, e.retry_after_s)
    check(displaced is not None and displaced[0] == "displaced" and displaced[1] > 0,
          f"{tag}: the queued BATCH request was not displaced: {displaced}")
    check(all(len(sch.result(r)) == 16 for r in fill + [qb[0], ri]),
          f"{tag}: a request beside the displacement did not finish")
    # a deadline the measured TPOT cannot meet is refused at submit
    tpot = sch.stats()["admission"]["tpot_ewma_s"]
    try:
        sch.submit(prompts[0], max_new=OVER_NEW, deadline_s=1e-3)
        refused = False
    except DeadlineExceededError:
        refused = True
    check(refused, f"{tag}: an unmeetable deadline was admitted (TPOT {tpot})")
    # result(deadline_s=) cancels a running request with chunks in flight
    free0 = sch.pool.available
    rid = sch.submit(prompts[1], max_new=OVER_NEW)
    while sch.stats()["inflight_chunks"] < 2:
        sch.step()
    try:
        sch.result(rid, deadline_s=1e-6)
        cancelled = False
    except DeadlineExceededError:
        cancelled = True
    st = sch.stats()
    freed = {"cancelled": cancelled, "free_before": free0,
             "free_after": sch.pool.available, "busy_slots": st["busy_slots"],
             "inflight": st["inflight_chunks"]}
    check(cancelled and sch.pool.available == free0 and st["busy_slots"] == 0,
          f"{tag}: the cancelled request's blocks did not come back: {freed}")
    res = {"preempted_rids": preempted, "preemptions": len(pre),
           "streams_equal_to_unpressured": same, "displaced": displaced,
           "deadline_refused_with_tpot_s": tpot, "cancel": freed,
           "admission": st["admission"], "graphs": st["graphs"]}
    say(f"[{tag}] {json.dumps(res)}")
    return sch, outs, same


def phase_overload(name_power: str, model: Llama) -> dict:
    """Admission control on the paged Llama-3-8B engine: an unpressured
    run of 4 requests, then the same requests (BATCH, STANDARD,
    INTERACTIVE, BATCH) from a pool of OVER_BLOCKS blocks, captured and
    eager: BATCH is preempted first and INTERACTIVE never while a lower
    class runs; every stream passes the teacher-forced gate and equals
    the unpressured run; then displacement, deadline refusal and a
    cancel with chunks in flight."""
    cfg = model.cfg
    r = np.random.default_rng(13)
    prompts = [r.integers(0, cfg.vocab_size, (n,)) for n in OVER_LENS]
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    ref = PagedContinuousBatchingEngine(
        eng, slots=4, block_size=16, prefill_chunk=128, decode_chunk=8,
        gen=GenerationConfig(max_new_tokens=OVER_NEW))
    ref_outs = [ref.result(rid) for rid in [ref.submit(p) for p in prompts]]
    check(ref.preemptions == 0, "overload: the unpressured run preempted")
    del ref
    _free_cuda()
    same_all = []
    for graphs in (True, False):
        tag = "overload" + ("" if graphs else " eager")
        sch, outs, same = _overload_run(tag, eng, prompts, graphs, ref_outs)
        _teacher_forced(tag, model, prompts, outs)
        same_all.append(same)
        del sch
        _free_cuda()
    check(all(all(s) for s in same_all),
          f"overload: a preempted stream parted from the unpressured run: {same_all}")
    return {"streams_equal": same_all, "prompts": prompts, "ref_outs": ref_outs}

# --------------------- slice 9: warm start, int8, fused q/k/v, autopair,
# autotune, chaos, self-healing, the async API
KL_BOUND = 0.02  # nats: the reference bench's int8 quality bound
KL_REQUESTS = 4  # [slice] requests whose teacher-forced rows the KL reads
INT8_EAGER = 4  # requests of the short eager int8 comparison
# what a burst holds beside its candidate: the target's and the draft's
# contiguous caches (2 slots x 2048 slots x 32 layers, 0.54 GB each), the
# sibling's materialised dequantize (up to its 1 GB bf16 head, held in a
# graph pool), graph pools and activations; a float copy of the model
# (16 GB) or a second sibling (7.5 GB) would not fit under it
AUTOPAIR_SLACK = 3 * 2**30
HEAL_DRAFT_LAYERS = 2
ASYNC_NEW = 16

_CACHE_CHILD = """
import json, time
t0 = time.perf_counter()
from tensorlink_tpu_torch import native
from tensorlink_tpu_torch.ops import _build
from tensorlink_tpu_torch.runtime.compile_cache import compile_report, enable_compile_cache
d = enable_compile_cache()
t1 = time.perf_counter()
for src in %r:
    _build.load(src)
ok = native.have_native()
print(json.dumps({"dir": d, "nvcc_compiles": _build.nvcc_runs,
                  "gxx_compiles": native.gxx_runs, "native": ok,
                  "load_s": time.perf_counter() - t1,
                  "import_s": t1 - t0, "report": compile_report()}))
"""


def phase_compile_cache(name_power: str, build: dict) -> dict:
    """The kernel-build cache: ``phase_build`` compiled the three CUDA
    sources into a fresh ``TL_COMPILE_CACHE_DIR``; the wire codec's g++
    build lands there too. A child process on the same directory then
    loads all four libraries with no compiler run (its key still asks
    ``nvcc --version`` once)."""
    d = compile_cache.active_dir()
    check(d is not None and d == os.environ.get(compile_cache.ENV_VAR),
          f"compile cache: not active on the fresh directory ({d})")
    t0 = time.perf_counter()
    ok = native.have_native()
    gxx_s = time.perf_counter() - t0
    check(ok and native.gxx_runs == 1 and not native.BUILD["compile_cache_hit"],
          "compile cache: the wire codec did not build into the fresh directory")
    entries = compile_cache.cache_entries(d)
    check(entries == len(CUDA_SOURCES) + 1,
          f"compile cache: {entries} libraries in {d}, expected {len(CUDA_SOURCES) + 1}")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _CACHE_CHILD % (CUDA_SOURCES,)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ), cwd=os.path.dirname(os.path.abspath(__file__)))
    child_s = time.perf_counter() - t0
    check(res.returncode == 0, f"compile cache: the child failed: {res.stderr[-2000:]}")
    child = json.loads(res.stdout.strip().splitlines()[-1])
    libs = child["report"]["libraries"]
    hits = all(r["compile_cache_hit"] for r in libs.values())
    out = {"cold_build_s": {"nvcc_parallel_wall": build["wall_s"],
                            **{k: v for k, v in build.items() if k != "wall_s"},
                            "gxx_wirecodec": gxx_s},
           "warm_load_s": child["load_s"], "child_process_s": child_s,
           "child_import_s": child["import_s"],
           "nvcc_compiles": child["nvcc_compiles"], "gxx_compiles": child["gxx_compiles"],
           "libraries_loaded": len(libs), "all_hits": hits,
           "cache_entries": entries, "card": name_power}
    say(f"[compile cache] {json.dumps(out)}")
    check(child["dir"] == d and child["native"] and len(libs) == len(CUDA_SOURCES) + 1
          and hits and child["nvcc_compiles"] == 0 and child["gxx_compiles"] == 0,
          f"compile cache: the warm process rebuilt or missed: {child}")
    return out


def _state_bytes(model) -> int:
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def _dense_int8_bytes(model) -> int:
    """What an int8 sibling allocates: every quantized weight's q and s."""
    return sum(t.numel() * t.element_size() for n, t in model.state_dict().items()
               if n.endswith((".w.q", ".w.s")))


def _kl_rows(model, model_q, prompts, outs) -> float:
    """Mean KL (nats) of ``model_q``'s next-token distribution from
    ``model``'s over the teacher-forced rows of the emitted tokens."""
    kls = []
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            ids = torch.from_numpy(np.concatenate([p, o[:-1]])).to(DEV)[None]
            rows = slice(len(p) - 1, ids.shape[1])
            lp = torch.log_softmax(model.head(model(ids, logits=False)[0, rows]).float(), -1)
            lq = torch.log_softmax(model_q.head(model_q(ids, logits=False)[0, rows]).float(), -1)
            kls.append((lp.exp() * (lp - lq)).sum(-1))
    return float(torch.cat(kls).mean())


def _serve_short(tag: str, eng, prompts, max_new: int, cuda_graphs: bool, **kw):
    """``prompts`` through a fresh [slice]-shaped engine over ``eng``,
    launch counts from 0. -> (engine, outputs, counts, B3 by variant)."""
    sch = _slice_engine(eng.model, max_new, cuda_graphs, eng=eng, **kw)
    _zero_counts()
    rids = [sch.submit(p) for p in prompts]
    sch.run_until_idle()
    torch.cuda.synchronize()
    c = _counts()
    by_variant = dict(paged_decode_attention.launches_by_variant)
    outs = [sch.result(r) for r in rids]
    check(all(len(o) == max_new for o in outs), f"{tag}: a request did not finish")
    return sch, outs, c, by_variant


def phase_int8(name_power: str, model: Llama, prompts, slice_outs, slice_prof: dict,
               cap: dict) -> dict:
    """Weight-only int8 at Llama-3-8B: the int8 sibling
    (``default_draft_candidates``: a meta-built model into which the bf16
    weights are quantized one ``Dense`` at a time, every other tensor
    shared) behind ``InferenceEngine(quantize="int8")``, serving the
    [slice] requests captured, then a short eager comparison. Gates: B3
    and B4 launches on the path, every token teacher-forced against the
    int8 model, and the mean KL of int8 against bf16 logits on
    teacher-forced rows under 0.02 nats."""
    cfg = model.cfg
    base = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16, device=DEV)
    t0 = time.perf_counter()
    (_, make_sibling), = default_draft_candidates(base)
    eng8 = make_sibling()
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    model8 = eng8.model
    sizes = {"state_bytes_int8": _state_bytes(model8), "state_bytes_bf16": _state_bytes(model),
             "weight_pass_bytes_int8": eng8.weight_bytes,
             "weight_pass_bytes_bf16": base.weight_bytes,
             "int8_dense_bytes": _dense_int8_bytes(model8), "quantize_s": quant_s,
             "card": name_power}
    say(f"[int8] weights: {json.dumps(sizes)}")
    check(eng8.quantize == "int8"
          and sizes["weight_pass_bytes_int8"] < 0.6 * sizes["weight_pass_bytes_bf16"],
          "int8: the sibling is not quantized")
    sch, rids, outs, wall, k = _serve_paged(model8, prompts, 32, True, cap, eng=eng8,
                                            tag="int8")
    _graph_line("int8", sch.stats()["graphs"])
    tf = _teacher_forced("int8", model8, prompts, outs)
    kl = _kl_rows(model, model8, prompts[:KL_REQUESTS], slice_outs[:KL_REQUESTS])
    same = sum(int((np.asarray(a) == np.asarray(b)).sum()) for a, b in zip(outs, slice_outs))
    dt = _timer_line("int8", sch, name_power)
    prof = _profile_decode(sch, cfg.vocab_size, name_power, tag="int8 profile")
    elem8, elem = prof["elementwise_ms_per_model_step"], slice_prof["elementwise_ms_per_model_step"]
    k8 = prof["kernel_ms_per_model_step"]
    dequant = ((elem8 - elem) / k8 if isinstance(k8, float) and isinstance(elem, float)
               else "not measured")
    res = {"kl_nats_mean": kl, "kl_bound": KL_BOUND,
           "tokens_equal_to_slice": same, "tokens": tf["tokens"],
           "model_step_ms": prof["model_step_ms"],
           "slice_model_step_ms": slice_prof["model_step_ms"],
           "kernel_ms_per_model_step": k8, "device_busy_share": prof["device_busy_share"],
           "dequantize_share_of_step_kernels": dequant,
           "decode_mbu": dt["programs"].get("decode", {}).get("mbu", "not measured"),
           "decode_mfu": dt["programs"].get("decode", {}).get("mfu", "not measured"),
           "wall_s": wall, "card": name_power}
    say(f"[int8] {json.dumps(res)}")
    check(kl < KL_BOUND, f"int8: mean KL {kl} nats is over the {KL_BOUND} bound")
    del sch
    _free_cuda()
    esch, eouts, ec, ebv = _serve_short("int8 eager", eng8, prompts[:INT8_EAGER], 32, False)
    _check_paged_launches("int8 eager", esch.stats(), ec["paged_decode"], ec["fused_norm"],
                          ebv, cfg.num_layers)
    tf_e = _teacher_forced("int8 eager", model8, prompts[:INT8_EAGER], eouts)
    _agreement("int8", outs[:INT8_EAGER], eouts, tf, tf_e)
    del esch, eng8, model8, make_sibling, base
    _free_cuda()
    return {"paged": k["paged"], "norm": k["norm"],
            "int8_dense_bytes": sizes["int8_dense_bytes"]}


def _fused_llama(model: Llama) -> Llama:
    """``model``'s function in the fused q/k/v layout: each layer's q, k
    and v weights go through ``fuse_qkv_params`` into one ``qkv`` weight
    (the only new memory), every other tensor is ``model``'s own."""
    cfg = dataclasses.replace(model.cfg, qkv_fused=True)
    H, G = cfg.num_heads, cfg.num_kv_heads
    src = model.state_dict()
    state = {n: t for n, t in src.items()
             if not any(f".attn.{x}." in n for x in "qkv")}
    for i in range(cfg.num_layers):
        pre = f"blocks.{i}.attn."
        attn = {x: {"w": src[f"{pre}{x}.w"]} for x in "qkvo"}
        state[pre + "qkv.w"] = fuse_qkv_params(attn, H, G, cfg.dim // H)["qkv"]["w"]
    fused = Llama(cfg, device="meta", seed=None)
    fused.load_state_dict(state, strict=True, assign=True)
    return fused


def phase_fused(name_power: str, model: Llama, prompts, slice_outs, slice_prof: dict,
                cap: dict) -> dict:
    """The [slice] requests on a ``qkv_fused=True`` Llama-3-8B made from
    the same weights through ``fuse_qkv_params``, captured: launch and
    replay gates, every token teacher-forced against the unfused model
    (bitwise equality is not expected: the GEMM's shape changes), and the
    model step against [slice]'s."""
    fused = _fused_llama(model)
    eng = InferenceEngine(fused, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    sch, rids, outs, wall, k = _serve_paged(fused, prompts, 32, True, cap, eng=eng,
                                            tag="fused qkv")
    _graph_line("fused qkv", sch.stats()["graphs"])
    tf = _teacher_forced("fused qkv", model, prompts, outs)
    same = sum(int((np.asarray(a) == np.asarray(b)).sum()) for a, b in zip(outs, slice_outs))
    prof = _profile_decode(sch, model.cfg.vocab_size, name_power, tag="fused qkv profile")
    res = {"tokens_equal_to_slice": same, "tokens": tf["tokens"],
           "worst_gap_vs_unfused": tf["worst_gap"],
           "model_step_ms": prof["model_step_ms"],
           "slice_model_step_ms": slice_prof["model_step_ms"],
           "step_ratio": prof["model_step_ms"] / slice_prof["model_step_ms"],
           "kernel_ms_per_model_step": prof["kernel_ms_per_model_step"],
           "device_busy_share": prof["device_busy_share"], "wall_s": wall,
           "card": name_power}
    say(f"[fused qkv] {json.dumps(res)}")
    del sch, eng, fused
    _free_cuda()
    return {"paged": k["paged"], "norm": k["norm"]}


def phase_autopair(name_power: str, model: Llama, sibling_bytes: int) -> dict:
    """``autopair_draft`` on the bf16 target with the default candidate
    (its int8 sibling): non-spec, the sibling as draft, then n-gram, each
    a captured burst on a contiguous engine. Gate: the memory allocated
    at the burst's peak stays under the target plus one sibling (plus
    AUTOPAIR_SLACK for the burst engines' caches and graph pools)."""
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    _free_cuda()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    v = autopair_draft(eng, GenerationConfig())
    torch.cuda.synchronize()
    c = _counts()
    peak = torch.cuda.max_memory_allocated()
    res = {"verdict": v["mode"], "name": v["name"], "tokens_per_s": v["measured"],
           "baseline_tokens_per_s": v["baseline_tokens_per_sec"],
           "calibration_s": v["calibration_s"], "skipped": v["skipped"],
           "peak_above_target_bytes": peak - base, "sibling_bytes": sibling_bytes,
           "bound_bytes": sibling_bytes + AUTOPAIR_SLACK, "launches": c,
           "card": name_power}
    say(f"[autopair] {json.dumps(res)}")
    check(peak - base < sibling_bytes + AUTOPAIR_SLACK,
          f"autopair: {peak - base} bytes above the target at peak: more than one sibling")
    check(set(v["measured"]) >= {"nonspec", "int8-sibling"} and c["fused_norm"] > 0,
          f"autopair: a mode was not measured or no decode ran: {v['measured']} {c}")
    persist = v["persistable"]
    del v, eng
    _free_cuda()
    return {"persistable": persist, "norm": c["fused_norm"], "paged": c["paged_decode"]}


def phase_autotune(name_power: str, model: Llama, persistable: dict) -> dict:
    """The autotune store in a temporary directory: an adaptive n-gram
    engine serves four requests and saves (with the autopair verdict as
    ``draft_pair``); a second engine on the directory warm-starts with
    that record and K prior; ``measure_capability(store=, key=)`` measures
    once and loads the record the second time."""
    d = tempfile.mkdtemp(prefix="autotune-", dir=os.path.join(_build.PKG_DIR, "_build"))
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    spec = SpecConfig(k=4, rounds=2, adaptive=True)
    prompts = _spec_requests(model.cfg.vocab_size)[:4]
    sch = _slice_engine(model, 16, eng=eng, speculative=spec, autotune_dir=d)
    check(sch.autotune_warm_start_s is None, "autotune: a fresh directory warm-started")
    for r in [sch.submit(p) for p in prompts]:
        sch.result(r)
    path = sch.save_autotune(draft_pair=persistable)
    blob = open(path, "rb").read()
    rec = json.loads(blob)
    del sch
    _free_cuda()
    sch2 = _slice_engine(model, 16, eng=eng, speculative=spec, autotune_dir=d)
    prior2 = sch2._kctl.prior()
    warm_s = sch2.autotune_warm_start_s
    same_file = open(path, "rb").read() == blob
    check(sch2.autotune_warm_start_s is not None and sch2._autotune_record == rec
          and prior2 == rec["k_prior"] and rec["draft_pair"] == persistable and same_file,
          f"autotune: the warm start did not read what was saved: {rec} {prior2}")
    del sch2, eng
    _free_cuda()
    store = AutotuneStore.resolve(d)
    key = store_key(GLOBAL_MODEL, ())
    t0 = time.perf_counter()
    c1 = measure_capability(matmul_dim=CAP_MATMUL_DIM, hbm_mb=CAP_HBM_MB, reps=CAP_REPS,
                            store=store, key=key)
    t1 = time.perf_counter()
    c2 = measure_capability(matmul_dim=CAP_MATMUL_DIM, hbm_mb=CAP_HBM_MB, reps=CAP_REPS,
                            store=store, key=key)
    t2 = time.perf_counter()
    res = {"autotune_warm_start_s": warm_s,
           "k_prior": rec["k_prior"], "draft_pair": rec["draft_pair"],
           "record_keys": sorted(rec), "capability_first_s": t1 - t0,
           "capability_second_s": t2 - t1, "second_cached": bool(c2.get("cached")),
           "card": name_power}
    say(f"[autotune] {json.dumps(res)}")
    check(not c1.get("cached") and c2.get("cached")
          and c2["peak_tflops"] == c1["peak_tflops"] and c2["hbm_gbps"] == c1["hbm_gbps"],
          "autotune: the second capability call measured again")
    return res


CHAOS_PLAN = (ChaosPlan(seed=0)
              .fault("serving.dispatch", "slow", every=4, delay_s=0.002, jitter_s=0.002)
              .fault("serving.drain", "slow", at=5, delay_s=0.25))


def phase_chaos(name_power: str, model: Llama, over: dict) -> dict:
    """The [overload] script twice under a plan that slows every 4th
    dispatch (2-4 ms, seeded jitter) and stalls the 5th drain 250 ms.
    Gates: every completed stream equals the unfaulted run's token for
    token (a stall changes timing, not shapes), every INTERACTIVE request
    completes (``_overload_run``'s own gates), and the two runs' harness
    logs are equal. Prints what the disarmed hooks cost a chunk."""
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    logs, counts = [], {"paged": 0, "norm": 0}
    for run in range(2):
        h = chaos.arm(CHAOS_PLAN)
        _zero_counts()
        try:
            sch, outs, same = _overload_run(f"chaos run {run}", eng, over["prompts"], True,
                                            over["ref_outs"])
        finally:
            chaos.disarm()
        c = _counts()
        counts["paged"] += c["paged_decode"]
        counts["norm"] += c["fused_norm"]
        logs.append(list(h.log))
        check(all(same), f"chaos run {run}: a stream parted from the unfaulted run: {same}")
        interactive = [i for i, q in enumerate(OVER_PRIOS) if q == Priority.INTERACTIVE]
        check(all(len(outs[i]) == OVER_NEW for i in interactive),
              f"chaos run {run}: an INTERACTIVE request did not complete")
        del sch
        _free_cuda()
    n = 1_000_000
    t0 = time.perf_counter()
    for _ in range(n):
        if chaos.ACTIVE is not None:
            pass
    guard_ns = (time.perf_counter() - t0) / n * 1e9
    res = {"faults_fired": len(logs[0]), "log_head": logs[0][:6],
           "logs_equal": logs[0] == logs[1],
           "disarmed_guard_ns": guard_ns, "disarmed_cost_ns_per_chunk": 2 * guard_ns,
           "card": name_power}
    say(f"[chaos] {json.dumps(res)}")
    check(logs[0] == logs[1] and logs[0], "chaos: two runs of one plan logged differently")
    del eng
    _free_cuda()
    return counts


def phase_self_heal(name_power: str, model: Llama, prompts, slice_outs) -> dict:
    """Llama-3-8B paged with a same-vocabulary 2-layer random-weight draft
    and ``SpecConfig(k=3, self_heal_accept=0.3)``: four [slice] requests
    in draft mode (near-zero acceptance), after which the engine
    downgrades itself at the idle point; four more in the new mode.
    Gates: the downgrade, its graph dropped and one captured for the new
    mode, launches on the path, and every token before and after
    teacher-forced (the verify pass runs B3 at T = K+1, whose bf16
    rounding differs from T = 1, so tokens equal to [slice]'s are printed,
    not gated)."""
    cfg = model.cfg
    dmodel = Llama(dataclasses.replace(cfg, num_layers=HEAL_DRAFT_LAYERS), device=DEV,
                   dtype=torch.bfloat16, seed=1)
    deng = InferenceEngine(dmodel, max_len=2048, cache_dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16, device=DEV)
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    sch = _slice_engine(model, 32, eng=eng, draft=deng,
                        speculative=SpecConfig(k=3, self_heal_accept=0.3))
    _zero_counts()
    pre, post = prompts[:4], prompts[4:8]
    outs1 = [sch.result(r) for r in [sch.submit(p) for p in pre]]
    sch.run_until_idle()
    st1 = sch.stats()
    healed = st1.get("spec_self_healed")
    outs2 = [sch.result(r) for r in [sch.submit(p) for p in post]]
    sch.run_until_idle()
    torch.cuda.synchronize()
    c = _counts()
    by_variant = dict(paged_decode_attention.launches_by_variant)
    st2 = sch.stats()
    g1, g2 = st1["graphs"], st2["graphs"]
    res = {"healed": healed, "heals": st2.get("spec_self_heal_total", 0),
           "mode_after": st2["spec"]["mode"] if "spec" in st2 else "nonspec",
           "graphs_before": g1, "graphs_after": g2,
           "verify_passes": sch.verify_passes, "draft_steps": sch.draft_steps,
           "decode_steps": sch.decode_steps,
           "tokens_equal_to_slice": sum(int((np.asarray(a) == np.asarray(b)).sum())
                                        for a, b in zip(outs1 + outs2, slice_outs[:8])),
           "tokens": sum(len(o) for o in outs1 + outs2), "card": name_power}
    say(f"[self-heal] {json.dumps(res)}")
    check(healed is not None and healed["from"] == "draft" and healed["acceptance"] < 0.3,
          f"self-heal: the engine did not downgrade itself: {healed}")
    check(g1["cleared"] == 1 and g1["graphs"] == 0 and g2["captured"] >= 2,
          f"self-heal: graphs not dropped and re-captured: {g1} {g2}")
    _check_spec_launches("self-heal", c, by_variant, sch, cfg, 3, HEAL_DRAFT_LAYERS)
    _teacher_forced("self-heal before", model, pre, outs1)
    _teacher_forced("self-heal after", model, post, outs2)
    del sch, eng, deng, dmodel
    _free_cuda()
    return {"paged": c["paged_decode"], "norm": c["fused_norm"]}


def phase_async(name_power: str, model: Llama, prompts) -> dict:
    """Eight requests through ``asubmit``/``aresult`` from one event loop,
    two ``aresult`` calls at a time (pump threads take turns on the
    scheduler lock, and a graph capture never overlaps another thread's
    launches), against ``submit``/``result`` on a twin engine."""
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    ps = prompts[:8]
    ref_sch, ref, _, _ = _serve_short("async reference", eng, ps, ASYNC_NEW, True)
    del ref_sch
    _free_cuda()
    sch = _slice_engine(model, ASYNC_NEW, eng=eng)
    _zero_counts()

    async def run():
        rids = [await sch.asubmit(p) for p in ps]
        outs = []
        for i in range(0, len(rids), 2):
            outs += await asyncio.gather(sch.aresult(rids[i]), sch.aresult(rids[i + 1]))
        return outs

    t0 = time.perf_counter()
    outs = asyncio.run(run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = _counts()
    by_variant = dict(paged_decode_attention.launches_by_variant)
    st = sch.stats()
    equal = [bool((np.asarray(a) == np.asarray(b)).all()) for a, b in zip(outs, ref)]
    say(f"[async] {json.dumps({'requests': len(ps), 'equal_to_sync': equal, 'wall_s': wall, 'graphs': st['graphs'], 'card': name_power})}")
    _check_paged_launches("async", st, c["paged_decode"], c["fused_norm"], by_variant,
                          model.cfg.num_layers)
    check(all(equal), f"async: tokens differ from submit/result: {equal}")
    del sch, eng
    _free_cuda()
    return {"paged": c["paged_decode"], "norm": c["fused_norm"]}


def _bert_loss(module, params, batch, rng):
    logits = functional_call(
        module, params, (batch["input_ids"],),
        {"attention_mask": batch["attention_mask"], "rng": rng,
         "train": rng is not None},
    )
    return softmax_cross_entropy(logits, batch["labels"])


def _bert_batch(B, T, vocab, lens=None, seed=0):
    r = np.random.default_rng(seed)
    am = np.ones((B, T), np.int32)
    for b, n in enumerate(lens or []):
        am[b, n:] = 0
    return {
        "input_ids": torch.from_numpy(r.integers(0, vocab, (B, T))).to(DEV),
        "attention_mask": torch.from_numpy(am).to(DEV),
        "labels": torch.from_numpy(r.integers(0, CLASSES, (B,))).to(DEV),
    }


def _timed_steps(trainer, state, batch, gen, n, warm=3):
    """n steps from ``state`` (each ended by a device read of its loss);
    -> (final state, losses, per-step seconds after ``warm`` steps)."""
    losses, secs = [], []
    for i in range(n):
        t0 = time.perf_counter()
        state, st = trainer.train_step(state, batch, gen)
        losses.append(float(st["loss"]))
        if i >= warm:
            secs.append(time.perf_counter() - t0)
    return state, losses, secs


# kernel-name groups of a training step's profile (first match wins)
KERNEL_GROUPS = (
    ("flash_fwd (B1)", ("flash_fwd_kernel",)),
    ("flash_bwd (B2)", ("flash_bwd_",)),
    ("gemm (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma")),
    ("optimizer (foreach)", ("multi_tensor_apply",)),
    ("embedding backward", ("indexing_backward", "embedding_backward")),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def _profile_step(trainer, state, batch, gen) -> dict:
    """One training step under torch.profiler: kernel time over the
    step's wall time is the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, st = trainer.train_step(state, batch, gen)
        float(st["loss"])
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    groups: dict[str, float] = {}
    for e in kernels:
        group = next((g for g, keys in KERNEL_GROUPS if any(k in e.key for k in keys)),
                     "other")
        groups[group] = groups.get(group, 0.0) + e.self_device_time_total / 1e3
    return {
        "profiled_step_s": wall,
        "device_busy_s": busy_us / 1e6 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e6 / wall if busy_us else "not measured",
        "kernel_ms_by_group": groups,
        # the host side of the same step: CPU time of every op, kernel
        # launches, tensor allocations
        "host_cpu_ms": sum(e.self_cpu_time_total for e in host) / 1e3,
        "kernel_launches": sum(e.count for e in host if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")),
        "tensor_allocations": sum(e.count for e in host if e.key in (
            "aten::empty", "aten::empty_strided")),
        "top_kernels_ms": {
            e.key[:60]: [e.self_device_time_total / 1e3, e.count] for e in top[:10]
        },
    }


def _grad_agreement(kernel, plain, f32) -> dict:
    """Per-leaf agreement of (loss, grads) triples; see TRAIN_* above."""
    (lk, gk), (lp, gp), (lf, gf) = kernel, plain, f32

    def cos(a, b):
        a, b = a.flatten().double(), b.flatten().double()
        return float(a @ b / (a.norm() * b.norm()))

    direct, floor, failed, k_bias = {}, {}, [], {}
    for name, g in gp.items():
        if name.endswith("attn.k.b"):
            # zero in exact arithmetic (a softmax row is invariant to a
            # shift common to all its keys): both paths hold rounding noise
            k_bias[name] = float(gk[name].norm())
            continue
        if float(g.norm()) == 0:
            continue
        c = cos(gk[name], g)
        if c >= TRAIN_COSINE_MIN:
            direct[name] = c
            continue
        e_k = float((gk[name].double() - gf[name].double()).norm())
        e_p = float((g.double() - gf[name].double()).norm())
        floor[name] = {"cos_kernel_plain": c, "cos_plain_f32": cos(g, gf[name]),
                       "err_kernel_f32": e_k, "err_plain_f32": e_p}
        if cos(g, gf[name]) >= TRAIN_SIGNAL_COSINE or e_k > TRAIN_NOISE_RATIO * e_p:
            failed.append(name)
    return {
        "loss_kernel": float(lk), "loss_plain": float(lp), "loss_f32": float(lf),
        "leaves": len(direct) + len(floor),
        "cosine_ge_0.99": len(direct),
        "min_cosine_direct": min(direct.values()) if direct else None,
        "near_noise_floor": floor,
        "min_cos_kernel_f32": min(cos(gk[n], gf[n]) for n in direct),
        "min_cos_plain_f32": min(cos(gp[n], gf[n]) for n in direct),
        "k_bias_max_norm_kernel": max(k_bias.values()) if k_bias else None,
        "failed": failed,
    }


def phase_train(name_power: str) -> dict:
    """BERT-base fine-tuning through the port's Trainer at batch 8 x seq
    512, where attention runs B1 forward and B2 backward."""
    cfg = BertConfig.base()
    B, T, steps = 8, 512, 30
    model = BertClassifier(cfg, CLASSES, device=DEV, seed=0)  # f32 params
    tcfg = TrainConfig(batch_size=B, micro_batches=1, optimizer="adam",
                       learning_rate=1e-4, dtype="bfloat16", grad_clip_norm=1.0)
    trainer = Trainer(model, _bert_loss, tcfg, device=DEV)
    state0 = trainer.init_state()
    n_params = sum(p.numel() for p in state0.params.values())
    batch = _bert_batch(B, T, cfg.vocab_size, lens=[512, 480, 300, 129])
    gen = torch.Generator(device=DEV).manual_seed(0)
    L = cfg.num_layers

    flash_attention_fwd_lse.launches = 0
    flash_attention_bwd.launches = 0
    state, losses, secs = _timed_steps(trainer, state0, batch, gen, steps)
    k1, k2 = flash_attention_fwd_lse.launches, flash_attention_bwd.launches
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    step_s = float(np.median(secs))
    flops = 6.0 * n_params * B * T + 12.0 * L * B * T * T * cfg.dim
    res = {
        "model": "BERT-base classifier", "params": n_params, "batch": B,
        "seq": T, "steps": steps, "loss_first5_mean": first,
        "loss_last5_mean": last, "losses": losses,
        "launches_fwd": k1, "launches_bwd": k2,
        "expected_launches": L * steps,
        "step_ms_median": step_s * 1e3, "step_ms_min": min(secs) * 1e3,
        "step_ms_max": max(secs) * 1e3,
        "samples_per_s": B / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / BF16_FLOPS,
        "peak_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
        "card": name_power,
    }
    say(f"[train] {json.dumps(res)}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(last < first, f"loss did not fall: {first} -> {last}")
    check(k1 == L * steps and k2 == L * steps,
          f"flash launches {k1}/{k2}, expected {L * steps} each")

    # the first step's gradients through the kernels against the plain
    # attention path, same params and batch, dropout off; both held
    # against the f32 gradient of the plain path
    grads = {}
    for tag, impl, dtype in (("kernel", None, None),
                             ("plain", "reference", None),
                             ("f32", "reference", "float32")):
        tr = trainer
        if impl is not None:
            tr = Trainer(
                BertClassifier(dataclasses.replace(cfg, attn_impl=impl),
                               CLASSES, device=DEV, seed=None),
                _bert_loss,
                tcfg if dtype is None else dataclasses.replace(tcfg, dtype=dtype),
                device=DEV,
            )
        grads[tag] = tr.loss_and_grads(state0.params, batch)
        del tr
    gres = _grad_agreement(*(grads[t] for t in ("kernel", "plain", "f32")))
    say(f"[train] first-step gradients vs plain attention: {json.dumps(gres)}")
    check(not gres["failed"], f"gradient disagreement: {gres['failed']}")
    check(abs(gres["loss_kernel"] - gres["loss_plain"]) <= TRAIN_LOSS_TOL,
          "loss differs")
    del grads

    prof = _profile_step(trainer, state, batch, gen)
    prof["card"] = name_power
    say(f"[train] profile: {json.dumps(prof)}")

    # the headline shape, batch 32 x seq 128: "auto" takes the plain
    # attention path below MIN_KERNEL_SEQ_AUTO, "flash" forces the kernels
    # (in turns: auto, flash, flash, auto; 3 warm-up + 10 timed steps each)
    hb = _bert_batch(32, 128, cfg.vocab_size, seed=1)
    trainers = {"auto": trainer, "flash": Trainer(
        BertClassifier(dataclasses.replace(cfg, attn_impl="flash"), CLASSES,
                       device=DEV, seed=None),
        _bert_loss, tcfg, device=DEV)}
    head = {impl: {"step_ms_runs": [], "flash_launches": 0, "loss_finite": True}
            for impl in trainers}
    for impl in ("auto", "flash", "flash", "auto"):
        flash_attention_fwd_lse.launches = 0
        _, hl, hs = _timed_steps(trainers[impl], state, hb, gen, 13)
        h = head[impl]
        h["step_ms_runs"].append(float(np.median(hs)) * 1e3)
        h["flash_launches"] += flash_attention_fwd_lse.launches
        h["loss_finite"] &= bool(np.isfinite(hl).all())
    hflops = 6.0 * n_params * 32 * 128 + 12.0 * L * 32 * 128 * 128 * cfg.dim
    for h in head.values():
        ms = float(np.mean(h["step_ms_runs"]))
        h.update(step_ms=ms, samples_per_s=32e3 / ms,
                 mfu=hflops / (ms / 1e3) / BF16_FLOPS)
    head["card"] = name_power
    say(f"[train] headline batch 32 x seq 128: {json.dumps(head)}")
    check(head["auto"]["flash_launches"] == 0, "auto at seq 128 ran the kernel")
    check(head["flash"]["flash_launches"] == 2 * 13 * L,
          "flash at seq 128 skipped the kernel")
    check(head["auto"]["loss_finite"] and head["flash"]["loss_finite"],
          "non-finite loss at the headline shape")
    return {"launches_fwd": k1, "launches_bwd": k2}


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, name_power = phase_device()
    # the kernel-build cache: a fresh directory every run, so the builds
    # below are cold and [compile cache] reads a warm load beside them
    build_root = os.path.join(_build.PKG_DIR, "_build")
    os.makedirs(build_root, exist_ok=True)
    os.environ[compile_cache.ENV_VAR] = tempfile.mkdtemp(prefix="compile-cache-",
                                                         dir=build_root)
    compile_cache.enable_compile_cache()
    build = phase_build()
    phase_compile_cache(name_power, build)
    phase_sampler()
    flush = L2Flush()
    floor_ms = phase_floor(flush)
    paged = phase_paged(flush)
    norm = phase_norm(flush, floor_ms)
    flash = phase_flash(flush)
    cap = phase_capability(name_power)
    model = Llama(LlamaConfig.llama3_8b(), device=DEV, dtype=torch.bfloat16,
                  seed=0)
    launches = phase_slice(name_power, model, cap)
    disagg = phase_disagg(name_power, model, launches["prompts"], launches["outs"], cap)
    disagg8 = phase_disagg_int8(name_power, model, launches["prompts"], launches["outs"],
                                disagg["float_blob_bytes"])
    static = phase_static(name_power, model)
    spec = phase_spec_paged(name_power, model)
    over = phase_overload(name_power, model)
    int8 = phase_int8(name_power, model, launches["prompts"], launches["outs"],
                      launches["prof"], cap)
    fused = phase_fused(name_power, model, launches["prompts"], launches["outs"],
                        launches["prof"], cap)
    pair = phase_autopair(name_power, model, int8["int8_dense_bytes"])
    phase_autotune(name_power, model, pair["persistable"])
    chaos_k = phase_chaos(name_power, model, over)
    heal = phase_self_heal(name_power, model, launches["prompts"], launches["outs"])
    asyn = phase_async(name_power, model, launches["prompts"])
    del model
    gc.collect()
    torch.cuda.empty_cache()
    contiguous = phase_contiguous(name_power)
    gc.collect()
    torch.cuda.empty_cache()
    phase_spec_contiguous(name_power)
    gc.collect()
    torch.cuda.empty_cache()
    rolling = phase_rolling(name_power)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    train = phase_train(name_power)
    norm_paths = {"paged serving": launches["launches_norm"],
                  "static": static["launches_norm"],
                  "contiguous": contiguous["launches_norm"],
                  "rolling": rolling["launches_norm"],
                  "spec paged (draft steps)": spec["norm"],
                  "disagg decode leg": disagg["norm"],
                  "disagg int8 decode leg": disagg8["norm"],
                  "int8 weights": int8["norm"], "fused qkv": fused["norm"],
                  "autopair bursts": pair["norm"], "chaos (2 overload runs)": chaos_k["norm"],
                  "self-heal": heal["norm"], "async": asyn["norm"]}
    paged_paths = {"paged serving": launches["launches_paged"],
                   "spec paged (verify passes, prefill chunks)": spec["paged"],
                   "disagg (both legs)": disagg["paged"],
                   "disagg int8 (both legs)": disagg8["paged"],
                   "int8 weights": int8["paged"], "fused qkv": fused["paged"],
                   "chaos (2 overload runs)": chaos_k["paged"],
                   "self-heal": heal["paged"], "async": asyn["paged"]}
    say(f"[launches] fused_residual_norm by path: {json.dumps(norm_paths)}")
    say(f"[launches] paged_decode_attention by path: {json.dumps(paged_paths)}")
    kernels = [
        {
            "name": "paged_decode_attention", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/paged_decode.cu",
            "replaces": "tensorlink_tpu/ops/pallas/paged_decode.py:285",
            "launches": sum(paged_paths.values()),
            **{k: paged[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "fused_residual_norm", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/decode_glue.cu",
            "replaces": "tensorlink_tpu/ops/pallas/decode_glue.py:90",
            "launches": sum(norm_paths.values()),
            **{k: norm[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "flash_attention_fwd_lse", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tensorlink_tpu/ops/pallas/flash_attention.py:247",
            "launches": train["launches_fwd"],
            **{k: flash["fwd"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "flash_attention_bwd", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/flash_attention.cu",
            "replaces": "tensorlink_tpu/ops/pallas/flash_attention.py:470",
            "launches": train["launches_bwd"],
            **{k: flash["bwd"][k] for k in ("max_abs_err", "ms", "plain_ms",
                                            "bound_ms", "bound_by", "library_ms")},
        },
    ]
    say(smi())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
