"""The 1F1B pipeline schedule over the mesh's ``pipe`` group (port of
``tensorlink_tpu/parallel/pp1f1b.py``).

After a warmup of S - s forwards, stage s alternates one backward with
one forward, so at most S - s micros are in flight at stage s. The
schedule is the reference's own table: ``simulate_1f1b`` (a copy, pure
numpy) gives each (slot, stage) its action and micro, and every rank
walks the slots of its column; each slot runs at most one forward or one
backward and then exchanges in ONE ``batch_isend_irecv``: the activation
it produced to s + 1, the input gradient it produced to s - 1, and the
receives its neighbours' actions in the same slot imply.

The last stage folds head and loss into its backward (the gradient of a
scalar loss seeds it), which is also where tied weights (GPT-2's LM head
= ``wte``) take their head-side gradient. Each micro's seed is 1 / M, so
every gradient that leaves ``train_grads`` is already the gradient of
the mean over micros.

Memory: the reference recomputes each stage forward inside its
per-micro backward (remat by construction). Here a forward keeps its
autograd graph until the micro's backward (at most ``max_inflight``
graphs a stage), and ``remat=True`` runs the forward without a graph and
recomputes it in the backward, the reference's cost model; the flash
kernel B1 then runs twice a micro.

Loss restriction (the reference's): the total is the unweighted mean of
the per-micro losses, which equals the full-batch loss only for a loss
that is a per-example mean over equal micros (``ShardedTrainer`` rejects
``loss_reduction="batch_normalized"`` under 1F1B).

``seq_axis`` (``pp.SeqShard``): xs and every micro-batch leaf of rank
>= 3 ([M, mb, T, ...]) are cut to this rank's token shard, and the head
and loss run on the shard, so ``head_loss`` must be a uniform per-token
mean (the reference's ``head_per_token`` contract). Each rank's seed is
1 / (M S): the gradients summed over the seq group (the caller's job) are
those of the mean over shards, and the loss is averaged over the group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from tensorlink_tpu_torch.parallel.pp import (
    PipeComm,
    fold_in,
    generator,
    seq_shard,
    stage_apply,
    stage_apply_aux,
)

IDLE, FWD, BWD = 0, 1, 2


def simulate_1f1b(num_stages: int, num_micro: int):
    """Greedy lockstep simulation of the 1F1B schedule.

    Returns (act [T, S] in {IDLE, FWD, BWD}, mic [T, S] micro index).
    One compute per stage per slot; transfers land at the end of the
    producing slot, so a consumer can run no earlier than the next slot.
    """
    S, M = num_stages, num_micro
    nf, nb = [0] * S, [0] * S
    fdone = [[None] * M for _ in range(S)]
    bdone = [[None] * M for _ in range(S)]
    act_rows, mic_rows = [], []
    t = 0
    while any(nb[s] < M for s in range(S)):
        acts, mics = [], []
        for s in range(S):
            a, m = IDLE, 0
            can_f = nf[s] < M and (
                s == 0 or (fdone[s - 1][nf[s]] is not None and fdone[s - 1][nf[s]] < t)
            )
            can_b = (
                nb[s] < M
                and nb[s] < nf[s]
                and (
                    s == S - 1
                    or (bdone[s + 1][nb[s]] is not None and bdone[s + 1][nb[s]] < t)
                )
            )
            inflight = nf[s] - nb[s]
            cap = S - s  # 1F1B in-flight bound for stage s
            if can_b and (inflight >= cap or nf[s] == M):
                a, m = BWD, nb[s]
            elif can_f and inflight < cap:
                a, m = FWD, nf[s]
            elif can_b:
                a, m = BWD, nb[s]
            # no forward-past-the-cap fallback: exceeding S - s in-flight
            # would break the 1F1B memory bound, and idling cannot
            # deadlock (backward availability depends only on activations
            # already sent downstream)
            acts.append(a)
            mics.append(m)
        for s in range(S):
            if acts[s] == FWD:
                fdone[s][mics[s]] = t
                nf[s] += 1
            elif acts[s] == BWD:
                bdone[s][mics[s]] = t
                nb[s] += 1
        act_rows.append(acts)
        mic_rows.append(mics)
        t += 1
        if t > 4 * (M + S) + 8:
            raise RuntimeError(f"1F1B schedule deadlock at S={S} M={M}")
    return np.asarray(act_rows, np.int32), np.asarray(mic_rows, np.int32)


def max_inflight(act: np.ndarray, mic: np.ndarray, stage: int = 0) -> int:
    """Peak number of stashed activations at ``stage`` (memory bound)."""
    infl = peak = 0
    for t in range(act.shape[0]):
        if act[t, stage] == FWD:
            infl += 1
            peak = max(peak, infl)
        elif act[t, stage] == BWD:
            infl -= 1
    return peak


def head_seed(rng: int | None, micro: int) -> int | None:
    """The last stage's head stream for ``micro``: a sentinel fold first,
    so it never equals a block's (micro, layer) stream."""
    return None if rng is None else fold_in(fold_in(rng, 0x1F1B), micro)


@dataclasses.dataclass(eq=False)
class Pipeline1F1B:
    """1F1B over the mesh's ``pipe`` axis, producing gradients directly.

    ``block_fn(layer_params, x)`` applies ONE layer, ``layers_per_stage``
    of them a stage. ``head_loss(aux_params, y, micro_batch, rng) ->
    scalar`` is one micro's head and loss on the last stage;
    ``aux_params`` (head and anything tied to it, e.g. the embeddings) is
    whole on every stage, and its gradients land only on the last one
    (the caller sums them over ``pipe``)."""

    mesh: Any
    block_fn: Callable
    num_stages: int
    layers_per_stage: int
    head_loss: Callable
    axis: str = "pipe"
    # MoE router aux loss: each stage's aux term is local to its
    # per-micro backward (cotangent aux_weight / M); at model > 1 the
    # block returns it averaged over the model group (nn/moe.py)
    block_fn_aux: Callable | None = None
    aux_weight: float = 0.0
    # the token-sharded seq axis (module docstring)
    seq_axis: str | None = None
    remat: bool = False

    def __post_init__(self):
        self.seq = seq_shard(self.mesh, self.seq_axis)
        self.comm = PipeComm(self.mesh, self.axis)
        if self.comm.size != self.num_stages:
            raise ValueError(f"pipe group of {self.comm.size} ranks for "
                             f"{self.num_stages} stages")

    @property
    def _use_aux(self) -> bool:
        return self.block_fn_aux is not None and bool(self.aux_weight)

    def _stage(self, stage_params, x, seed, extras):
        layer0 = self.comm.stage * self.layers_per_stage
        if self._use_aux:
            return stage_apply_aux(self.block_fn_aux, self.layers_per_stage,
                                   stage_params, x, seed, layer0, extras)
        return stage_apply(self.block_fn, self.layers_per_stage, stage_params,
                           x, seed, layer0, extras), None

    def train_grads(self, stage_params, aux_params, xs, micro_batches,
                    rng=None, extras=None, *, device=None):
        """One 1F1B pass of this stage. ``stage_params``: this stage's
        per-layer params (tensors that are, or derive from, leaves that
        require grad); ``aux_params``: what ``head_loss`` reads;
        ``xs`` [M, mb, ...]: the embedded micros on stage 0, any tensor of
        their shape and dtype elsewhere; ``micro_batches``: a dict of
        [M, ...] leaves; ``rng``: an integer seed (None: no dropout);
        ``extras``: a list of M per-micro inputs, or None.

        Parameter gradients of the mean loss over micros accumulate in
        the leaves' ``.grad``. Returns (mean loss, the same on every pipe
        rank; stage 0's input gradients [M, mb, ...], None elsewhere)."""
        S, s, comm, sq = self.num_stages, self.comm.stage, self.comm, self.seq
        M = xs.shape[0]
        dev = device if device is not None else xs.device
        act, mic = simulate_1f1b(S, M)
        inq, cotq, stash = {}, {}, {}
        dxs = [None] * M
        loss = torch.zeros((), dtype=torch.float32, device=dev)
        aw = float(self.aux_weight) if self._use_aux else 0.0
        shape = tuple(xs.shape[1:])
        inv = 1.0 / M
        if sq is not None:
            shape = sq.local_shape(shape)
            inv /= sq.size
            # token-dim leaves follow the activations; per-example ones
            # ([M, mb]) stay whole
            micro_batches = {k: sq.cut(v, 2) if v.dim() >= 3 else v
                             for k, v in micro_batches.items()}
            if rng is not None:
                rng = fold_in(rng, sq.rank)
        ctx = (lambda: sq.context()) if sq is not None else contextlib.nullcontext

        def seed(m):
            return None if rng is None else fold_in(rng, m)

        def ex(m):
            return None if extras is None else extras[m]

        for t in range(act.shape[0]):
            a, m = int(act[t, s]), int(mic[t, s])
            send_f = send_b = None
            if a == FWD:
                x = (xs[m] if sq is None else sq.cut(xs[m])).detach() \
                    if comm.first else inq.pop(m)
                x.requires_grad_()
                if self.remat:
                    with torch.no_grad(), ctx():
                        y, _ = self._stage(stage_params, x, seed(m), ex(m))
                    stash[m] = (x, None, None)
                else:
                    with ctx():
                        y, av = self._stage(stage_params, x, seed(m), ex(m))
                    stash[m] = (x, y, av)
                if not comm.last:
                    send_f = y.detach()
            elif a == BWD:
                x, y, av = stash.pop(m)
                if y is None:  # remat: recompute with a graph
                    with ctx():
                        y, av = self._stage(stage_params, x, seed(m), ex(m))
                outs, cots = [], []
                if comm.last:
                    mb = {k: v[m] for k, v in micro_batches.items()}
                    lm = self.head_loss(aux_params, y, mb,
                                        generator(head_seed(rng, m), dev)).float()
                    if aw:
                        lm = lm + aw * av.float()
                    outs, cots = [lm], [torch.full_like(lm, inv)]
                    loss = loss + lm.detach()
                else:
                    outs, cots = [y], [cotq.pop(m)]
                    if aw:
                        outs.append(av.float())
                        cots.append(torch.full_like(outs[-1], aw * inv))
                        loss = loss + aw * av.detach().float()
                with ctx():
                    torch.autograd.backward(outs, cots)
                if comm.first:
                    dxs[m] = x.grad
                else:
                    send_b = x.grad
            sends, recvs = [], []
            if send_f is not None:
                sends.append((send_f, comm.next))
            if send_b is not None:
                sends.append((send_b, comm.prev))
            if not comm.first and act[t, s - 1] == FWD:
                buf = torch.empty(shape, dtype=xs.dtype, device=dev)
                inq[int(mic[t, s - 1])] = buf
                recvs.append((buf, comm.prev))
            if not comm.last and act[t, s + 1] == BWD:
                buf = torch.empty(shape, dtype=xs.dtype, device=dev)
                cotq[int(mic[t, s + 1])] = buf
                recvs.append((buf, comm.next))
            comm.exchange(sends, recvs)
        loss = comm.sum(loss) / M
        if sq is not None:
            loss = sq.mean(loss)
        return loss, (torch.stack(dxs) if comm.first else None)

    @property
    def bubble_fraction(self) -> Callable[[int], float]:
        # slots = 2M + 2(S-1); useful = 2M — same fraction as GPipe
        S = self.num_stages
        return lambda m: (S - 1) / (m + S - 1)
