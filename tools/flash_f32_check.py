#!/usr/bin/env python3
"""Build B1/B2's f32 and f16 forms (``csrc/flash_attention_f32.cu``) and
hold them against their plain versions on one CUDA card.

    python3 tools/flash_f32_check.py [f32] [f16]

Prints ptxas's register and spill lines, then for each form (both when
none is named) and case (BERT-base's training shape with a padding
mask, Llama-3-8B's causal GQA shape, a causal window, a ragged length
with a fully masked row, a non-causal window at GQA 4) the worst error
of o, lse, dq, dk and dv (and of the gradients of the ``delta_in`` form)
relative to max |plain|, the plain version fed the same tensors, and the
mean ms of 10 back-to-back launches of each kernel (no L2 flush:
``chip_smoke.py``'s ``[flash f32]`` is the timed measurement) beside
its bounds, as ``chip_smoke.py``'s ``_flash_bounds`` reckons them:
``bound_ms`` (the function's operations at the 3xTF32 rate in f32, at the
16-bit tensor-core rate in f16), ``bound_ms_tf32`` (the TF32 products the
form runs: 3 a product in f32; in f16 1 for QK^T and dO V^T, 2 for the
others) and ``bound_ms_vector`` (at the f32 vector peak). Exits non-zero
unless every case is within FORMS' tolerances.
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
}
# form: (dtype, o tolerance, gradient tolerance): chip_smoke.py's
FORMS = {"f32": (torch.float32, cs.FLASH_F32_O_REL, cs.FLASH_F32_GRAD_REL),
         "f16": (torch.float16, cs.FLASH_F16_O_REL, cs.FLASH_F16_GRAD_REL)}


def _rel(a, b):
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


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


def main(forms) -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, log, _ = _build.build("flash_attention_f32.cu", verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s")
    for ln in log.splitlines():
        if any(w in ln for w in ("registers", "Compiling entry", "spill")):
            print("ptxas:", ln.strip())
    ok = True
    for form in forms:
        dtype, o_tol, g_tol = FORMS[form]
        g = torch.Generator().manual_seed(0)
        for name, (B, H, Hkv, T, D, causal, window, mask) in CASES.items():
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
            res = {"o": _rel(o, ro),
                   "lse": float((lse - rlse)[live].abs().max()),
                   "masked_rows_equal": bool(((lse >= 1e29) == ~live).all()),
                   "dtypes_kept": all(x.dtype == dtype for x in (o, *grads, *dgrads)),
                   **{n: _rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, rgrads)},
                   **{f"delta_{n}": _rel(a, b)
                      for n, a, b in zip(("dq", "dk", "dv"), dgrads, rdgrads)}}
            good = (res["o"] <= o_tol and res["masked_rows_equal"] and res["dtypes_kept"]
                    and res["lse"] <= 1e-3
                    and max(v for n, v in res.items()
                            if n.startswith(("dq", "dk", "dv", "delta_"))) <= g_tol)
            ok &= good
            bounds = cs._flash_bounds(form, B, H, Hkv, T, D, kv, causal, window)
            res["fwd_ms"] = _ms(lambda: flash_attention_fwd_lse(q, k, v, kv, **kw))
            res["fwd"] = bounds["fwd"]
            res["bwd_ms"] = _ms(lambda: flash_attention_bwd(q, k, v, ro, rlse, do, kv, **kw))
            res["bwd"] = bounds["bwd"]
            print(form, name, "OK" if good else "BAD", json.dumps(res), flush=True)
    print("launches by form", flash_attention_fwd_lse.launches_by_variant,
          flash_attention_bwd.launches_by_variant)
    print("ALL OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main([a for a in sys.argv[1:] if a in FORMS] or list(FORMS)))
