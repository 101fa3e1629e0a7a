"""PyTorch port, parallel/pp1f1b.py: the schedule table equal to the JAX
package's for S 1-4 x M 1-8 (pure numpy, exact), its validity on the
reference's own cases, and ``Pipeline1F1B.train_grads`` on spawned gloo
ranks against direct autograd of the same computation in one process
(loss rtol 1e-5, gradients atol 1e-5, f32), as the reference's test
holds its pipeline against direct autodiff.

Top level: torch and the port only (spawned ranks import this module).
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tensorlink_tpu_torch.config import MeshConfig
from tensorlink_tpu_torch.parallel.pp1f1b import (
    BWD,
    FWD,
    Pipeline1F1B,
    max_inflight,
    simulate_1f1b,
)
from torch_ranks import spawn_cpu_ranks


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("M", range(1, 9))
def test_schedule_table_equals_reference(S, M):
    from tensorlink_tpu.parallel.pp1f1b import max_inflight as j_inflight
    from tensorlink_tpu.parallel.pp1f1b import simulate_1f1b as j_sim

    act, mic = simulate_1f1b(S, M)
    j_act, j_mic = j_sim(S, M)
    np.testing.assert_array_equal(act, j_act)
    np.testing.assert_array_equal(mic, j_mic)
    for s in range(S):
        assert max_inflight(act, mic, s) == j_inflight(j_act, j_mic, s)


@pytest.mark.parametrize("S,M", [(2, 2), (4, 4), (4, 8), (8, 8), (3, 7), (4, 2)])
def test_schedule_valid(S, M):
    act, mic = simulate_1f1b(S, M)
    T = act.shape[0]
    for s in range(S):
        f = [mic[t, s] for t in range(T) if act[t, s] == FWD]
        b = [mic[t, s] for t in range(T) if act[t, s] == BWD]
        assert sorted(f) == list(range(M)) and sorted(b) == list(range(M))
    slot = {}
    for t in range(T):
        for s in range(S):
            if act[t, s] != 0:
                slot[(act[t, s], s, mic[t, s])] = t
    for s in range(S):
        for i in range(M):
            if s > 0:
                assert slot[(FWD, s, i)] > slot[(FWD, s - 1, i)]
            if s < S - 1:
                assert slot[(BWD, s, i)] > slot[(BWD, s + 1, i)]
            assert slot[(BWD, s, i)] > slot[(FWD, s, i)]
    for s in range(S):
        assert max_inflight(act, mic, s) <= S - s
    if M >= S:
        assert T == 2 * M + 2 * (S - 1)


# (name, mesh, stages, micros, layers a stage)
RUNS = (("S4_M4", dict(pipe=4), 4, 4, 1),
        ("S4_M8", dict(pipe=4), 4, 8, 1),
        ("S2_M6_data2", dict(data=2, pipe=2), 2, 6, 1),
        ("S2_M4_Lps3_data2", dict(data=2, pipe=2), 2, 4, 3))
DIM, MB = 8, 2


def _setup(S, M, Lps, seed=0):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((S, Lps, DIM, DIM), generator=g) * 0.3
    b = torch.randn((S, Lps, DIM), generator=g) * 0.1
    wo = torch.randn((DIM, 3), generator=g) * 0.3
    xs = torch.randn((M, MB, DIM), generator=g)
    labels = torch.randint(0, 3, (M, MB), generator=g)
    return w, b, wo, xs, labels


def _block(lp, x):
    return F.gelu(x @ lp["w"] + lp["b"], approximate="tanh")


def _head_loss(aux, y, mb, rng=None):
    logp = torch.log_softmax(y @ aux["wo"], dim=-1)
    return -logp.gather(-1, mb["labels"][..., None]).mean()


def _pp_rank(rank, world, out_dir):
    from tensorlink_tpu_torch.runtime.mesh import make_mesh

    for name, mesh_kw, S, M, Lps in RUNS:
        if int(np.prod(list(mesh_kw.values()))) != world:
            continue
        mesh = make_mesh(MeshConfig(**mesh_kw), device="cpu")
        w, b, wo, xs, labels = _setup(S, M, Lps)
        s = mesh.get_local_rank("pipe")
        sp = [{"w": w[s, l].clone().requires_grad_(), "b": b[s, l].clone().requires_grad_()}
              for l in range(Lps)]
        aux = {"wo": wo.clone().requires_grad_()}
        pipe = Pipeline1F1B(mesh, _block, S, Lps, _head_loss)
        loss, dxs = pipe.train_grads(sp, aux, xs, {"labels": labels})
        torch.save({"loss": float(loss), "stage": s, "dxs": dxs,
                    "gw": [p["w"].grad for p in sp], "gb": [p["b"].grad for p in sp],
                    "gwo": aux["wo"].grad},
                   os.path.join(out_dir, f"{name}_rank{rank}.pt"))


def _direct(S, M, Lps):
    w, b, wo, xs, labels = _setup(S, M, Lps)
    w.requires_grad_()
    b.requires_grad_()
    wo.requires_grad_()
    xs.requires_grad_()
    losses = []
    for i in range(M):
        x = xs[i]
        for s in range(S):
            for l in range(Lps):
                x = _block({"w": w[s, l], "b": b[s, l]}, x)
        losses.append(_head_loss({"wo": wo}, x, {"labels": labels[i]}))
    loss = torch.stack(losses).mean()
    loss.backward()
    return float(loss), w.grad, b.grad, wo.grad, xs.grad


@pytest.fixture(scope="module")
def pp_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("pp1f1b")
    spawn_cpu_ranks(_pp_rank, 4, str(d), store_dir=str(d))
    return d


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_1f1b_matches_direct(run, pp_results):
    name, mesh_kw, S, M, Lps = run
    loss, gw, gb, gwo, gxs = _direct(S, M, Lps)
    world = int(np.prod(list(mesh_kw.values())))
    for r in range(world):
        out = torch.load(pp_results / f"{name}_rank{r}.pt")
        s = out["stage"]
        np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
        for l in range(Lps):
            np.testing.assert_allclose(out["gw"][l], gw[s, l], atol=1e-5)
            np.testing.assert_allclose(out["gb"][l], gb[s, l], atol=1e-5)
        if s == S - 1:
            np.testing.assert_allclose(out["gwo"], gwo, atol=1e-5)
        else:
            assert out["gwo"] is None  # the head's gradient lands on the last stage
        if s == 0:
            np.testing.assert_allclose(out["dxs"], gxs, atol=1e-5)
        else:
            assert out["dxs"] is None


def test_bubble_fraction_is_gpipe_closed_form():
    from tensorlink_tpu_torch.runtime.metrics import pipeline_bubble_fraction

    for S in (1, 2, 4):
        for M in (1, 4, 8):
            frac = (S - 1) / (M + S - 1)
            assert pipeline_bubble_fraction(S, M) == pytest.approx(frac)
