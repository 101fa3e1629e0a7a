#!/usr/bin/env python3
"""Build B1/B2's f32 forms (``csrc/flash_attention_f32.cu``) and hold them
against their plain f32 versions on one CUDA card.

    python3 tools/flash_f32_check.py

Prints ptxas's register and spill lines, then for each case (BERT-base's
training shape with a padding mask, Llama-3-8B's causal GQA shape, a
causal window, a ragged length with a fully masked row, a non-causal
window at GQA 4) the worst error of o, lse, dq, dk and dv (and of the
gradients of the ``delta_in`` form) relative to max |plain|, and the
mean ms of 10 back-to-back launches of each kernel (no L2 flush:
``chip_smoke.py``'s ``[flash f32]`` is the timed measurement). Exits
non-zero unless every case is within 1e-4 (o) and 1e-3 (gradients).
"""

import sys

sys.path.insert(0, ".")

import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

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
O_REL, GRAD_REL = 1e-4, 1e-3


def _rel(a, b):
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


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, log, _ = _build.build("flash_attention_f32.cu", verbose=True)
    print(f"build {time.perf_counter() - t0:.1f} s")
    for ln in log.splitlines():
        if any(w in ln for w in ("registers", "Compiling entry", "spill")):
            print("ptxas:", ln.strip())
    g = torch.Generator().manual_seed(0)
    ok = True
    for name, (B, H, Hkv, T, D, causal, window, mask) in CASES.items():
        q, k, v, do = (torch.randn((B, T, h, D), generator=g).cuda().transpose(1, 2)
                       for h in (H, Hkv, Hkv, H))
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
               **{n: _rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, rgrads)},
               **{f"delta_{n}": _rel(a, b)
                  for n, a, b in zip(("dq", "dk", "dv"), dgrads, rdgrads)}}
        good = (res["o"] <= O_REL and res["masked_rows_equal"]
                and max(v for n, v in res.items()
                        if n.startswith(("dq", "dk", "dv", "delta_"))) <= GRAD_REL)
        ok &= good
        res["fwd_ms"] = _ms(lambda: flash_attention_fwd_lse(q, k, v, kv, **kw))
        res["bwd_ms"] = _ms(lambda: flash_attention_bwd(q, k, v, ro, rlse, do, kv, **kw))
        print(name, "OK" if good else "BAD", json.dumps(res), flush=True)
    print("launches by form", flash_attention_fwd_lse.launches_by_variant,
          flash_attention_bwd.launches_by_variant)
    print("ALL OK" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
