"""PyTorch port, ``python -m tensorlink_tpu_torch``: ``info`` reports the
devices, ``demo --device cpu`` trains the two-stage MLP job over a
validator, two workers and a user in one process with a falling loss,
``keygen`` writes identities, and ``bench`` refuses (the port's bench
entry does not exist yet) with a non-zero exit and no JSON line."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=ROOT, TL_CAPABILITY_BENCH="0")
    return subprocess.run([sys.executable, "-m", "tensorlink_tpu_torch", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT, env=env)


def test_info_exits_zero():
    r = _run("info")
    assert r.returncode == 0, r.stderr
    info = json.loads(r.stdout)
    assert info["devices"] and "backend" in info


def test_demo_cpu_exits_zero():
    r = _run("demo", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-2000:]
    losses = [float(line.split()[-1]) for line in r.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 10 and losses[-1] < losses[0]
    assert r.stdout.strip().endswith("demo OK")


@pytest.mark.parametrize("cmd", ["bench", "keygen"])
def test_bench_refuses_and_keygen(cmd, tmp_path):
    if cmd == "bench":
        r = _run("bench")
        assert r.returncode != 0 and r.stdout == ""
        return
    r = _run("keygen", "--key-dir", str(tmp_path), "--roles", "worker,user")
    assert r.returncode == 0, r.stderr
    assert [line.split(":")[0] for line in r.stdout.splitlines()] == ["worker", "user"]
