#!/usr/bin/env python3
"""Build B1/B2 (``csrc/flash_attention.cu``: bf16 and f16;
``csrc/flash_attention_f32.cu``: f32) and hold every form against its
plain version on one CUDA card.

    python3 tools/flash_check.py [bf16] [f32] [f16]

Prints ptxas's register and spill lines, then for each form (all three
when none is named) and case (BERT-base's training shape with a padding
mask, Llama-3-8B's causal GQA shape, a causal window, a ragged length
with a fully masked row, a non-causal window at GQA 4, and
``chip_smoke.FLASH_D_CASES``' head dims: 96 and 80, which the wrappers
zero-pad to 128, 256, which the kernels are built for, and 160, padded
to 256) the worst error of o, lse,
dq, dk and dv (and of the gradients of the ``delta_in`` form) against
the plain version fed the same tensors, and the mean ms of 10
back-to-back launches of each kernel (no L2 flush: ``chip_smoke.py``'s
``[flash]`` and ``[flash f32]`` are the timed measurements) beside
``bound_ms`` as ``chip_smoke.py``'s ``_flash_bounds`` reckons it. The
f16 form also runs B2 at BERT's and Llama's shapes with dO scaled by
2^-16 and 2^-24 (``chip_smoke.F16_DO_SCALES``), gated as
``chip_smoke._f16_grad_ok`` gates them. Tolerances are
``chip_smoke.py``'s: bf16 relative Frobenius (``FLASH_O_REL``,
``FLASH_GRAD_REL``), f32 and f16 relative to max |plain|. Exits
non-zero unless every case is within them.
"""

import sys

sys.path.insert(0, ".")

import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from tensorlink_tpu_torch.ops import _build  # noqa: E402
from tensorlink_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_fwd_lse,
    flash_attention_fwd_lse_reference,
)

# name: (B, H, Hkv, T, D, causal, window, mask)
CASES = {
    "bert": (8, 12, 12, 512, 64, False, None, "bert"),
    "llama": (1, 32, 8, 2048, 128, True, None, None),
    "window": (1, 32, 8, 1024, 128, True, 256, None),
    "ragged": (2, 12, 12, 300, 64, False, None, "ragged"),
    "window_noncausal_gqa": (1, 8, 2, 333, 128, False, 100, None),
    **cs.FLASH_D_CASES,
}
FORMS = {"bf16": torch.bfloat16, "f32": torch.float32, "f16": torch.float16}


def _ms(fn, n=10):
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(True), torch.cuda.Event(True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def _inputs(g, B, H, Hkv, T, D, mask, dtype):
    q, k, v, do = (torch.randn((B, T, h, D), generator=g).to("cuda", dtype)
                   .transpose(1, 2) for h in (H, Hkv, Hkv, H))
    kv = None
    if mask == "bert":
        lens = torch.tensor([512, 480, 300, 129] + [T] * (B - 4))
        kv = (torch.arange(T)[None] < lens[:, None]).cuda()
    elif mask == "ragged":
        kv = torch.rand((B, T), generator=g) > 0.3
        kv[1] = False
        kv = kv.cuda()
    return q, k, v, do, kv


def main(forms) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    for source in ("flash_attention.cu", "flash_attention_f32.cu"):
        _, log, _ = _build.build(source, verbose=True)
        print(f"build {source} {time.perf_counter() - t0:.1f} s")
        for ln in log.splitlines():
            if any(w in ln for w in ("registers", "Compiling entry", "spill")):
                print("ptxas:", ln.strip())
    ok = True
    for form in forms:
        dtype = FORMS[form]
        g = torch.Generator().manual_seed(0)
        for name, (B, H, Hkv, T, D, causal, window, mask) in CASES.items():
            q, k, v, do, kv = _inputs(g, B, H, Hkv, T, D, mask, dtype)
            kw = {"causal": causal, "window": window}
            o, lse = flash_attention_fwd_lse(q, k, v, kv, **kw)
            ro, rlse = flash_attention_fwd_lse_reference(q, k, v, kv, **kw)
            grads = flash_attention_bwd(q, k, v, ro, rlse, do, kv, **kw)
            rgrads = flash_attention_bwd_reference(q, k, v, ro, rlse, do, kv, **kw)
            delta = torch.randn((B, H, T), generator=g).cuda()
            dgrads = flash_attention_bwd(q, k, v, ro, rlse, do, kv, delta=delta, **kw)
            rdgrads = flash_attention_bwd_reference(q, k, v, ro, rlse, do, kv,
                                                    delta=delta, **kw)
            torch.cuda.synchronize()
            live = rlse < 1e29
            err = cs._rel if form == "bf16" else cs._rel_max
            o_tol, g_tol = cs.FLASH_TOLS[form]
            res = {"o": err(o, ro),
                   "lse": float((lse - rlse)[live].abs().max()) if bool(live.any()) else 0.0,
                   "masked_rows_equal": bool(((lse >= 1e29) == ~live).all()),
                   "dtypes_kept": all(x.dtype == dtype for x in (o, *grads, *dgrads)),
                   **{n: err(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, rgrads)},
                   **{f"delta_{n}": err(a, b)
                      for n, a, b in zip(("dq", "dk", "dv"), dgrads, rdgrads)}}
            good = (res["o"] <= o_tol and res["masked_rows_equal"] and res["dtypes_kept"]
                    and res["lse"] <= cs.FLASH_LSE_ATOL
                    and max(v for n, v in res.items()
                            if n.startswith(("dq", "dk", "dv", "delta_"))) <= g_tol)
            if form == "f16" and name in ("bert", "llama"):
                for sc in cs.F16_DO_SCALES:
                    dos = (do.float() * sc).to(dtype)
                    sg = flash_attention_bwd(q, k, v, ro, rlse, dos, kv, **kw)
                    rsg = flash_attention_bwd_reference(q, k, v, ro, rlse, dos, kv, **kw)
                    row = {n: cs._f16_grad_ok(a, b) for n, a, b in
                           zip(("dq", "dk", "dv"), sg, rsg)}
                    res[f"do_x{sc:g}"] = row
                    good &= all(r["ok"] for r in row.values())
            ok &= good
            bounds = cs._flash_bounds(form, B, H, Hkv, T, D, kv, causal, window)
            res["fwd_ms"] = _ms(lambda: flash_attention_fwd_lse(q, k, v, kv, **kw))
            res["fwd_bound_ms"] = bounds["fwd"]["bound_ms"]
            res["bwd_ms"] = _ms(lambda: flash_attention_bwd(q, k, v, ro, rlse, do, kv, **kw))
            res["bwd_bound_ms"] = bounds["bwd"]["bound_ms"]
            print(form, name, "OK" if good else "BAD", json.dumps(res), flush=True)
    print("launches by form", flash_attention_fwd_lse.launches_by_variant,
          flash_attention_bwd.launches_by_variant)
    print("ALL OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main([a for a in sys.argv[1:] if a in FORMS] or list(FORMS)))
