"""Proof-of-learning by deterministic re-execution (port of
``tensorlink_tpu/roles/pol.py``).

A validator that holds a stage's spec (from the job record it approved)
fetches the worker's params, replays a seeded challenge input through its
own build of the same spec, and compares digests: forward output and the
input gradient of ``sum(out)``. Between two runs of the same program on
the same kind of device the digests are equal bit for bit; across devices
or packages every commitment also carries an f32 sketch and sum, and
``verify_commitment`` picks exact or tolerant comparison by the
``platform`` tag.

Differences from the reference, by design:

- The challenge input is a Box-Muller Gaussian over two words of the
  port's counter hash (``parallel.inference.counter_bits``), computed on
  the CPU and then moved: every port node derives the same tensor from
  (seed, shape, dtype), whatever its device. The reference draws
  threefry, which the port does not have, so a port digest is never
  compared with a reference digest.
- ``platform`` names the package and the device (``"torch-cuda"``,
  ``"torch-cpu"``): a port commitment and a reference one (``"cpu"``,
  ``"tpu"``) always take the tolerant branch.
- CUDA runs are made under ``torch.use_deterministic_algorithms(True)``,
  so cuBLAS picks reproducible kernels. That needs
  ``CUBLAS_WORKSPACE_CONFIG`` set before the process's first cuBLAS
  call (``python -m tensorlink_tpu_torch`` and ``chip_smoke.py`` set it
  at start); without it torch raises, and the error is not caught.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import math
import threading
from typing import Any

import numpy as np
import torch

SKETCH_LEN = 16

# the counter-hash salt of the challenge stream (no other stream uses it)
CHALLENGE_SALT = 0x504F4C


def challenge_input(seed: int, shape: tuple[int, ...],
                    dtype: str = "float32") -> torch.Tensor:
    """Deterministic challenge tensor (a CPU tensor): standard normals by
    Box-Muller over counter-hash words keyed by (seed, element index), in
    f32 on the CPU, then cast to ``dtype``."""
    from tensorlink_tpu_torch.parallel.inference import _uniform, counter_bits

    n = int(np.prod(shape)) if len(shape) else 1
    seed_t = torch.tensor([int(seed) & 0xFFFFFFFF], dtype=torch.int64)
    bits = counter_bits(seed_t, torch.zeros(1, dtype=torch.int64), 2 * n,
                        salt=CHALLENGE_SALT)[0]
    u1, u2 = _uniform(bits[:n]), _uniform(bits[n:])
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.reshape(tuple(shape)).to(getattr(torch, str(dtype)))


def platform_tag(device) -> str:
    """The package and device a commitment was computed on."""
    return f"torch-{torch.device(device).type}"


def _host(arr: Any) -> np.ndarray:
    """A tensor or array as a host numpy array; bf16 as its bits
    (an int16 view, so the digest covers the bytes that were computed)."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.ascontiguousarray(np.asarray(arr))


def _as_f32(arr: Any) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().cpu().numpy()
    return np.asarray(arr).astype(np.float32)


def commitment(arr: Any) -> dict:
    """Digest + tolerance sketch of a tensor or array."""
    a = _host(arr)
    f = _as_f32(arr).reshape(-1)
    platform = platform_tag(arr.device if isinstance(arr, torch.Tensor) else "cpu")
    dtype = (str(arr.dtype).removeprefix("torch.")
             if isinstance(arr, torch.Tensor) else a.dtype.name)
    return {
        "digest": hashlib.sha256(a.tobytes()).hexdigest(),
        "shape": list(a.shape),
        "dtype": dtype,
        "sum": float(f.sum()),
        "sketch": [float(v) for v in f[:SKETCH_LEN]],
        "platform": platform,
    }


def verify_commitment(expected: Any, proof: dict, rtol: float = 1e-4,
                      atol: float = 1e-5) -> bool:
    """Compare a locally computed tensor with a remote commitment: the
    same platform -> exact digest equality; otherwise sketch and sum
    within tolerance."""
    ours = commitment(expected)
    if proof.get("platform") == ours["platform"]:
        return proof["digest"] == ours["digest"]
    if list(proof.get("shape", [])) != ours["shape"]:
        return False
    a = np.asarray(proof["sketch"], np.float32)
    b = np.asarray(ours["sketch"], np.float32)
    if not np.allclose(a, b, rtol=rtol, atol=atol):
        return False
    scale = max(abs(ours["sum"]), 1.0)
    return abs(proof["sum"] - ours["sum"]) <= rtol * scale * 10


def params_digest(params: Any) -> str:
    """Order-stable digest of a param tree or a flat state dict, over the
    reference's flattened names (a nested tree and the state dict it
    stands for give the same digest)."""
    from tensorlink_tpu_torch.p2p.serialization import tree_flatten_arrays

    h = hashlib.sha256()
    flat = tree_flatten_arrays(params)
    for name in sorted(flat):
        h.update(name.encode())
        h.update(_host(flat[name]).tobytes())
    return h.hexdigest()


_DET_LOCK = threading.Lock()


@contextlib.contextmanager
def deterministic(device: torch.device):
    """Deterministic algorithms for one PoL run on CUDA (the flag is
    process-wide, so runs that need it take a lock)."""
    if torch.device(device).type != "cuda":
        yield
        return
    with _DET_LOCK:
        prev = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(prev)


def pol_run(module, params: dict, x: torch.Tensor):
    """Forward output and the input gradient of ``sum(out)`` of
    ``module`` under ``params`` (a flat state dict): the one program both
    the worker's proof and the validator's replay run."""
    from torch.func import functional_call

    with deterministic(x.device), torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        out = functional_call(module, {k: v.detach() for k, v in params.items()},
                              (xx,))
        (gx,) = torch.autograd.grad(out, xx, torch.ones_like(out))
    return out.detach(), gx


_REPLAY_CACHE: dict[str, Any] = {}
# one replay at a time: functional_call swaps the cached module's params
_REPLAY_LOCK = threading.Lock()


def replay_stage(module_config: dict, params: dict, x: torch.Tensor):
    """Validator-side re-execution: rebuild the module from its spec (the
    approved job record, never worker-supplied) once per spec, on the
    meta device as a worker builds a stage, and compute (forward output,
    input gradient of sum(out)) with the worker's params (a flat state
    dict on ``x``'s device)."""
    from tensorlink_tpu_torch.nn.module import module_from_config

    key = json.dumps(module_config, sort_keys=True, default=str)
    with _REPLAY_LOCK:
        mod = _REPLAY_CACHE.get(key)
        if mod is None:
            mod = module_from_config(module_config, device=torch.device("meta"))
            _REPLAY_CACHE[key] = mod
        return pol_run(mod, params, x)
