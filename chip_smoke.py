#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``tensorlink_tpu_torch``) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: card, power limit and toolchain versions;
2. build: compiles the CUDA paged-decode kernel (nvcc, sm_90a) and
   JIT-compiles the Triton fused residual+norm kernel, in parallel;
3. paged-decode kernel vs its plain PyTorch version at Llama-3-8B head
   shapes (T = 1 and T = 128; mixed lengths with sentinel-tailed block
   tables, a validity mask with a retired row, a window, int8 pools, and
   the one-row form of a prefill chunk);
4. fused-norm kernel vs its plain version (rms, and layer with bias);
5. the slice: Llama-3-8B at full width and depth (random bf16 weights
   from a seed) served by ``PagedContinuousBatchingEngine`` over
   ``InferenceEngine``: 12 greedy requests, launch counts checked against
   the path, and a teacher-forced check of every emitted token against
   the port's no-cache forward.

The last two lines are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``. Nothing of JAX or ``tensorlink_tpu``
is imported.
"""

import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
from tensorlink_tpu_torch.ops import _build
from tensorlink_tpu_torch.ops.decode_glue import (
    fused_residual_norm,
    fused_residual_norm_reference,
)
from tensorlink_tpu_torch.ops.paged_decode import (
    paged_decode_attention,
    paged_decode_reference,
)
from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine
from tensorlink_tpu_torch.parallel.serving import PagedContinuousBatchingEngine

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
PAGED_ATOL, PAGED_RTOL = 2e-2, 1e-2  # bf16 outputs, f32 accumulation both sides
NORM_ATOL, NORM_RTOL = 1e-2, 1e-2  # bf16 outputs of an f32 row reduction
LOGIT_GAP_TOL = 0.5  # teacher-forced: emitted token within this of the row max
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


def time_ms(fn, flush: L2Flush, iters: int = 20) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches, each timed with
    CUDA events after an L2 flush. A ~1 ms device sleep ahead of the
    first event lets the host enqueue the launch before the card gets
    there, so host launch overhead stays out of the device time."""
    for _ in range(3):
        fn()
    total = 0.0
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


# --------------------------------------------------------------- phases
def phase_device() -> tuple[str, str]:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import triton

    name_power = smi()
    say(f"[device] {name_power} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | triton {triton.__version__} | "
        f"{_build.nvcc_version().splitlines()[-1]}")
    return torch.cuda.get_device_name(0), name_power


def phase_build() -> None:
    def build_cuda():
        t0 = time.perf_counter()
        path, log = _build.build("paged_decode.cu", verbose=True)
        return time.perf_counter() - t0, path, log

    def build_triton():
        t0 = time.perf_counter()
        x = torch.zeros((1, 8), dtype=torch.bfloat16, device=DEV)
        fused_residual_norm(x, x, torch.ones(8, device=DEV), kind="rms")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        fc, ft = ex.submit(build_cuda), ex.submit(build_triton)
        cuda_s, path, log = fc.result()
        triton_s = ft.result()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    say(f"[build] paged_decode.cu nvcc {cuda_s:.1f} s -> {path}")
    for ln in regs:
        say(f"[build]   ptxas: {ln}")
    say(f"[build] decode_glue triton jit {triton_s:.1f} s")


def _paged_inputs(g, T, case):
    """Llama-3-8B head shapes: H 32, Hkv 8, D 128, bs 16, MB 128, B 8."""
    B, H, Hkv, D, bs, MB = 8, 32, 8, 128, 16, 128
    NB = B * MB + 64
    dev = DEV
    lengths = torch.tensor(
        [T, 17 + T, 130 + T, 511, 1000, 1503, 1919, 2048], dtype=torch.int32
    ).clamp(max=MB * bs)
    perm = torch.randperm(NB, generator=g)
    bt = torch.full((B, MB), NB, dtype=torch.int32)
    for b in range(B):
        n = -(-int(lengths[b]) // bs)  # live blocks; the tail stays sentinel
        bt[b, :n] = perm[b * MB:b * MB + n].int()
    q = torch.randn((B, T, H, D), generator=g).to(dev, torch.bfloat16)
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
        k = torch.randn((NB, bs, Hkv, D), generator=g).to(dev, torch.bfloat16)
        v = torch.randn((NB, bs, Hkv, D), generator=g).to(dev, torch.bfloat16)
    if case == "mask":
        # validity mask over the view (the decode steps' form), with
        # holes, and row 0 retired: sentinel table, nothing valid
        kpos = torch.arange(MB * bs)
        valid = kpos[None, :] < lengths[:, None]
        valid &= torch.rand((B, MB * bs), generator=g) > 0.1
        valid[0] = False
        bt[0] = NB
        mask = valid[:, None, None, :].to(dev)
    if case == "window":
        window = 100
    if case == "one_row":
        # the engine's prefill-chunk form: one row (here 1503 tokens)
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


def phase_paged(flush) -> dict:
    g = torch.Generator().manual_seed(1)
    worst = 0.0
    main = None
    for T in (1, 128):
        for case in ("mixed", "mask", "window", "int8", "one_row"):
            args, kwargs = _paged_inputs(g, T, case)
            out = paged_decode_attention(*args, **kwargs)
            ref = paged_decode_reference(*args, **kwargs)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            ok = bool((err <= PAGED_ATOL + PAGED_RTOL * ref.float().abs()).all())
            check(bool(torch.isfinite(out.float()).all()), f"paged {case} T={T}: non-finite")
            mx = float(err.max())
            worst = max(worst, mx)
            ms = time_ms(lambda: paged_decode_attention(*args, **kwargs), flush)
            plain_ms = time_ms(lambda: paged_decode_reference(*args, **kwargs), flush, iters=5)
            lib_ms = time_ms(_paged_library_fn(args, kwargs), flush, iters=10)
            nbytes, flops = _paged_cost(args, kwargs)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            f_ms = flops / BF16_FLOPS * 1e3
            row = {
                "T": T, "case": case, "max_abs_err": mx, "ms": ms,
                "plain_ms": plain_ms, "library_ms": lib_ms,
                "bound_ms": max(b_ms, f_ms),
                "bound_by": "bytes" if b_ms >= f_ms else "operations",
                "bytes": nbytes, "flops": flops,
            }
            say(f"[paged] {json.dumps(row)}")
            check(ok, f"paged {case} T={T}: max abs err {mx} beyond "
                  f"atol {PAGED_ATOL} + rtol {PAGED_RTOL}")
            if T == 1 and case == "mask":
                main = row  # the decode steps' form
    main = dict(main, max_abs_err=worst)
    say(f"[paged] all cases within atol {PAGED_ATOL} + rtol {PAGED_RTOL}; "
        f"worst max abs err {worst}")
    return main


def phase_norm(flush) -> dict:
    g = torch.Generator().manual_seed(2)
    rows, D = 8, 4096
    main = None
    worst = 0.0
    for kind, with_bias in (("rms", False), ("layer", True)):
        x = torch.randn((rows, D), generator=g).to(DEV, torch.bfloat16)
        res = torch.randn((rows, D), generator=g).to(DEV, torch.bfloat16)
        scale = (1 + 0.1 * torch.randn(D, generator=g)).to(DEV)
        bias = (0.1 * torch.randn(D, generator=g)).to(DEV) if with_bias else None
        r, y = fused_residual_norm(x, res, scale, bias, eps=1e-5, kind=kind)
        r0, y0 = fused_residual_norm_reference(x, res, scale, bias, eps=1e-5, kind=kind)
        torch.cuda.synchronize()
        errs = []
        for a, b in ((r, r0), (y, y0)):
            e = (a.float() - b.float()).abs()
            check(bool((e <= NORM_ATOL + NORM_RTOL * b.float().abs()).all()),
                  f"fused norm {kind}: err {float(e.max())} beyond tolerance")
            errs.append(float(e.max()))
        mx = max(errs)
        worst = max(worst, mx)
        ms = time_ms(lambda: fused_residual_norm(x, res, scale, bias, eps=1e-5, kind=kind), flush)
        plain_ms = time_ms(lambda: fused_residual_norm_reference(
            x, res, scale, bias, eps=1e-5, kind=kind), flush)
        nbytes = 4 * rows * D * 2 + D * 4 * (2 if with_bias else 1)
        flops = rows * D * 8
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        f_ms = flops / BF16_FLOPS * 1e3
        row = {"kind": kind, "bias": with_bias, "rows": rows, "D": D,
               "max_abs_err": mx, "ms": ms, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": max(b_ms, f_ms),
               "bound_by": "bytes" if b_ms >= f_ms else "operations"}
        say(f"[norm] {json.dumps(row)}")
        if kind == "rms":
            main = row  # Llama's form
    return dict(main, max_abs_err=worst)


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


def phase_slice(name_power: str, cfg: LlamaConfig) -> dict:
    t0 = time.perf_counter()
    model = Llama(cfg, device=DEV, dtype=torch.bfloat16, seed=0)
    eng = InferenceEngine(model, max_len=2048, cache_dtype=torch.bfloat16,
                          param_dtype=torch.bfloat16, device=DEV)
    max_new = 32
    sch = PagedContinuousBatchingEngine(
        eng, slots=8, block_size=16, prefill_chunk=128, decode_chunk=8,
        gen=GenerationConfig(max_new_tokens=max_new),
    )
    torch.cuda.synchronize()
    say(f"[slice] Llama-3-8B {cfg.num_layers} layers dim {cfg.dim} "
        f"vocab {cfg.vocab_size}: params + engine ready in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    prompts = _requests(cfg.vocab_size)
    paged_decode_attention.launches = 0
    fused_residual_norm.launches = 0
    t_run = time.perf_counter()
    rids = [sch.submit(p) for p in prompts]
    sch.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    k1, k2 = paged_decode_attention.launches, fused_residual_norm.launches
    outs = [sch.result(rid) for rid in rids]
    st = sch.stats()
    check(all(len(o) == max_new for o in outs), "a request did not finish")
    L = cfg.num_layers
    exp1 = L * (st["decode_steps"] + st["prefill_chunks"])
    exp2 = L * st["decode_steps"]
    say(f"[slice] launches: paged_decode {k1} (expected {exp1}), "
        f"fused_norm {k2} (expected {exp2}); decode steps "
        f"{st['decode_steps']}, prefill chunks {st['prefill_chunks']}")
    check(k1 == exp1 and k1 > 0, "paged-decode launch count off the path")
    check(k2 == exp2 and k2 > 0, "fused-norm launch count off the path")
    check(st["prefix_matched_tokens"] > 0, "no prefix was shared")

    # teacher-forced: the no-cache forward (plain attention) over prompt
    # plus output must rank each emitted token within LOGIT_GAP_TOL of
    # its row's maximum
    gaps, exact = [], 0
    with torch.no_grad():
        for p, o in zip(prompts, outs):
            ids = np.concatenate([p, o[:-1]])
            logits = model(torch.from_numpy(ids).to(DEV)[None])[0, len(p) - 1:].float()
            check(bool(torch.isfinite(logits).all()), "non-finite logits")
            tok = torch.from_numpy(o).to(DEV)
            gap = logits.max(dim=-1).values - logits.gather(1, tok[:, None])[:, 0]
            gaps.append(float(gap.max()))
            exact += int((gap == 0).sum())
    n_tok = sum(len(o) for o in outs)
    say(f"[slice] teacher-forced: worst logit gap {max(gaps):.4f} "
        f"(tolerance {LOGIT_GAP_TOL}); {exact}/{n_tok} tokens are the exact argmax")
    check(max(gaps) <= LOGIT_GAP_TOL, "teacher-forced check failed")

    ttft = [sch.timings(rid)["ttft_s"] for rid in rids]
    tps = sch.decode_only_tokens / sch.decode_only_s if sch.decode_only_s else None
    res = {
        "requests": len(rids), "tokens": n_tok, "wall_s": wall,
        "ttft_s_mean": float(np.mean(ttft)), "ttft_s_p50": float(np.median(ttft)),
        "ttft_s_max": float(np.max(ttft)),
        "decode_tokens_per_s": tps,
        "decode_only_steps_tokens": sch.decode_only_tokens,
        "output_tokens_per_s": n_tok / wall,
        "kv_blocks_peak": st["peak_blocks_in_use"],
        "kv_block_bytes": sch.kv_block_bytes,
        "prefix_matched_tokens": st["prefix_matched_tokens"],
        "preemptions": st["preemptions"],
        "card": name_power,
    }
    say(f"[slice] {json.dumps(res)}")
    _profile_decode(sch, cfg.vocab_size, name_power)
    return {"launches_paged": k1, "launches_norm": k2}


def _profile_decode(sch, vocab: int, name_power: str) -> None:
    """Where a decode step's time goes: 8 fresh 64-token requests are
    prefilled, then one scheduler step of pure decode (8 model steps)
    runs plainly and the next under ``torch.profiler``; the device's
    kernel time over the profiled step's wall time is its busy share.
    A profiler that records no device time is reported, not fatal: the
    line is diagnosis, not a check."""
    from torch.profiler import ProfilerActivity, profile

    r = np.random.default_rng(4)
    rids = [sch.submit(r.integers(0, vocab, (64,)), max_new=25) for _ in range(8)]
    while sch._pending:
        sch.step()
    t0 = time.perf_counter()
    sch.step()
    plain_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sch.step()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    sch.run_until_idle()
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
    res = {
        "decode_step_s": plain_s, "model_steps": sch.decode_chunk,
        "profiled_step_s": prof_s,
        "device_busy_s": busy_us / 1e6 if busy_us else "not measured",
        "device_busy_share": busy_us / 1e6 / prof_s if busy_us else "not measured",
        "top_kernels_ms": {
            e.key[:48]: [e.self_device_time_total / 1e3, e.count] for e in top[:8]
        },
        "card": name_power,
    }
    say(f"[profile] {json.dumps(res)}")


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind, name_power = phase_device()
    phase_build()
    flush = L2Flush()
    paged = phase_paged(flush)
    norm = phase_norm(flush)
    cfg = LlamaConfig.llama3_8b()
    launches = phase_slice(name_power, cfg)
    kernels = [
        {
            "name": "paged_decode_attention", "route": "cuda",
            "source": "tensorlink_tpu_torch/csrc/paged_decode.cu",
            "replaces": "tensorlink_tpu/ops/pallas/paged_decode.py:285",
            "launches": launches["launches_paged"],
            **{k: paged[k] for k in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
        },
        {
            "name": "fused_residual_norm", "route": "triton",
            "source": "tensorlink_tpu_torch/ops/decode_glue.py",
            "replaces": "tensorlink_tpu/ops/pallas/decode_glue.py:90",
            "launches": launches["launches_norm"],
            **{k: norm[k] for k in ("max_abs_err", "ms", "plain_ms",
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
