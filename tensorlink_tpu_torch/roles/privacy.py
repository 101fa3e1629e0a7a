"""Obfuscated offloading (port of ``tensorlink_tpu/roles/privacy.py``).

Per stage boundary the user draws a secret orthogonal matrix (QR of a
Gaussian; the key never leaves the user):

- the INPUT rotation R folds into the stage's first Dense weight
  (``W -> R^T W``) and the user sends ``x R`` instead of ``x``;
- the OUTPUT rotation S folds into the stage's last Dense
  (``W -> W S``, ``b -> b S``) and the user un-rotates ``y' S^T``.

The worker computes the same function on a rotated view of the
activations and of its boundary weights; gradients flow in the rotated
basis (``dL/dx' = dL/dx R``). Folding needs the stage's first (and, for
S, last) operation to be a Dense: a norm-fronted transformer stage is
refused, since normalization does not commute with rotation. Rotation
hides the basis; it is not cryptographic secrecy (norms and spectra are
preserved).

Param trees are the reference's nested layout (``{"0": {"w": ...}}``) of
torch tensors. The key is an integer seed or a ``torch.Generator``; the
rotations differ from the reference's threefry draws for the same key.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from tensorlink_tpu_torch.nn.layers import Dense
from tensorlink_tpu_torch.nn.module import Sequential


def _generator(key) -> torch.Generator:
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator().manual_seed(int(key))


def random_orthogonal(key, dim: int) -> np.ndarray:
    """Haar-ish random orthogonal matrix: QR of a Gaussian in float64 (a
    crisp inverse), signs fixed, stored float32."""
    g = torch.randn((dim, dim), generator=_generator(key),
                    dtype=torch.float32).numpy().astype(np.float64)
    q, r = np.linalg.qr(g)
    q = q * np.sign(np.diag(r))  # fix QR sign ambiguity
    return q.astype(np.float32)


def _dense_positions(seq: Sequential) -> tuple[int, int]:
    """Indices of the first and last Dense layers of a stage."""
    idx = [i for i, layer in enumerate(seq.layers) if isinstance(layer, Dense)]
    if not idx:
        raise ValueError("stage has no Dense layer to fold a rotation into")
    return idx[0], idx[-1]


def _matmul(a, m: np.ndarray, left: bool = False) -> torch.Tensor:
    """``a @ m`` (or ``m @ a``) in f32, back in ``a``'s dtype and type."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    mt = torch.from_numpy(m).to(t.device)
    out = (mt @ t.float()) if left else (t.float() @ mt)
    return out.to(t.dtype)


@dataclass
class StageObfuscation:
    r_in: np.ndarray | None  # [D_in, D_in] input rotation (None = identity)
    s_out: np.ndarray | None  # [D_out, D_out] output rotation


@dataclass
class ObfuscationPlan:
    """Master-side secret: per-stage boundary rotations. Never serialized
    onto the wire; recovery re-folds from the cached folded params."""

    stages: list[StageObfuscation] = field(default_factory=list)

    @classmethod
    def build(cls, key, stage_parts: list[tuple[Sequential, dict]], *,
              obfuscate_final_output: bool = False) -> "ObfuscationPlan":
        """One rotation per boundary: stage 0 gets an input rotation too
        (its worker is the one that would see raw user data); the final
        output rotation is off by default (the master consumes it)."""
        gen = _generator(key)
        plan = cls()
        n = len(stage_parts)
        for i, (seq, _params) in enumerate(stage_parts):
            fi, li = _dense_positions(seq)
            d_in = seq.layers[fi].in_dim
            d_out = seq.layers[li].out_dim
            r_in = random_orthogonal(gen, d_in)
            s_draw = random_orthogonal(gen, d_out)
            # an output rotation folds into the last layer only when it is
            # the stage's final op: a trailing nonlinearity does not
            # commute with rotation (the next stage's input rotation still
            # hides that boundary from the next worker)
            s_out = (s_draw if (i < n - 1 or obfuscate_final_output)
                     and li == len(seq.layers) - 1 else None)
            if fi != 0:
                raise ValueError(
                    f"stage {i}: first layer is not Dense (index {fi}); "
                    "cannot fold the input rotation soundly"
                )
            plan.stages.append(StageObfuscation(r_in=r_in, s_out=s_out))
        return plan

    # ------------------------------------------------------------ folding
    def _rotate(self, index: int, seq: Sequential, params: dict, inverse: bool) -> dict:
        ob = self.stages[index]
        fi, li = _dense_positions(seq)
        out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
        if ob.r_in is not None:
            r = ob.r_in if inverse else ob.r_in.T
            out[str(fi)]["w"] = _matmul(out[str(fi)]["w"], r, left=True)
        if ob.s_out is not None:
            s = ob.s_out.T if inverse else ob.s_out
            last = out[str(li)]
            last["w"] = _matmul(last["w"], s)
            if "b" in last:
                last["b"] = _matmul(last["b"], s)
        return out

    def fold_stage(self, index: int, seq: Sequential, params: dict) -> dict:
        """Params with the stage's boundary rotations folded in: what ships
        to the worker."""
        return self._rotate(index, seq, params, inverse=False)

    def unfold_stage(self, index: int, seq: Sequential, params: dict) -> dict:
        """Inverse of ``fold_stage``: true params from a worker's (trained)
        folded ones (exact up to rounding: the rotations are orthogonal)."""
        return self._rotate(index, seq, params, inverse=True)

    # --------------------------------------------------------- activations
    def forward_in(self, index: int, x):
        r = self.stages[index].r_in
        return x if r is None else _matmul(x, r)

    def forward_out(self, index: int, y):
        s = self.stages[index].s_out
        return y if s is None else _matmul(y, s.T)

    def backward_in(self, index: int, g):
        """Master -> worker: cotangent of the stage output into the rotated
        basis (dL/dy' = dL/dy S)."""
        s = self.stages[index].s_out
        return g if s is None else _matmul(g, s)

    def backward_out(self, index: int, g):
        """Worker -> master: the returned input cotangent back to the true
        basis (dL/dx = dL/dx' R^T)."""
        r = self.stages[index].r_in
        return g if r is None else _matmul(g, r.T)
