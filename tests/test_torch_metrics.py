"""PyTorch port, runtime/metrics.py (a copy of the JAX package's module,
which uses no framework): the reference's own metric assertions
(``tests/test_runtime.py``, ``tests/test_observability.py``) pointed at
the copy, and its JSON snapshot and Prometheus text byte-equal to the JAX
package's for the same observations."""

import math

import pytest

from tensorlink_tpu.runtime import metrics as jmetrics
from tensorlink_tpu_torch.runtime.metrics import (
    DEFAULT_BUCKETS,
    DEVICE_BUCKETS,
    Histogram,
    Metrics,
    StepTimer,
    pipeline_bubble_fraction,
    throughput,
)


def test_bubble_fraction():
    assert pipeline_bubble_fraction(1, 8) == 0.0
    assert pipeline_bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert pipeline_bubble_fraction(4, 32) < 0.1


def test_metrics_snapshot_and_throughput():
    m = Metrics()
    for i in range(5):
        m.observe("loss", 1.0 / (i + 1))
    m.incr("steps", 5)
    snap = m.snapshot()
    assert snap["counters"]["steps"] == 5
    assert snap["loss"]["n"] == 5
    assert throughput(100, 2.0, 4) == 12.5
    assert math.isnan(throughput(1, 0.0))


def test_step_timer():
    t = StepTimer(warmup=1)
    for _ in range(3):
        with t:
            pass
    assert len(t.times) == 2 and t.mean_s >= 0 and t.p50_s >= 0
    assert math.isnan(StepTimer().mean_s) and math.isnan(StepTimer().p50_s)


def test_metrics_snapshot_min_max_additive():
    m = Metrics()
    for v in (3.0, 1.0, 2.0):
        m.observe("loss", v)
    snap = m.snapshot()
    assert snap["loss"]["last"] == 2.0 and snap["loss"]["n"] == 3
    assert snap["loss"]["min"] == 1.0 and snap["loss"]["max"] == 3.0
    assert "histograms" not in snap


def test_histogram_quantiles_and_degenerate_ends():
    h = Histogram(buckets=(0.1, 1.0, 10.0))
    assert math.isnan(h.quantile(0.5))
    for v in [0.05] * 50 + [0.5] * 40 + [5.0] * 9 + [100.0]:
        h.observe(v)
    snap = h.snapshot()
    assert snap["n"] == 100
    assert snap["p50"] <= 0.1
    assert 0.1 < snap["p90"] <= 1.0
    assert 1.0 < snap["p99"] <= 10.0
    assert h.quantile(1.0) == 10.0
    one = Histogram(buckets=(0.1, 1.0, 10.0))
    one.observe(0.5)
    assert one.quantile(0.0) == pytest.approx(0.1)
    assert one.quantile(1.0) == pytest.approx(1.0)
    below = Histogram(buckets=(0.1, 1.0))
    below.observe(0.05)
    assert below.quantile(0.0) == pytest.approx(0.0)
    above = Histogram(buckets=(0.1, 1.0))
    above.observe(50.0)
    assert above.quantile(0.0) == pytest.approx(1.0)
    with pytest.raises(ValueError):
        Histogram(buckets=())


def _observe(m):
    m.incr("msgs_in", 7)
    m.incr("msg:PING", 2)
    m.incr("9lives")  # a leading digit is prefixed
    m.incr("9-lives")  # sanitizes onto the same name: dropped, never two TYPEs
    m.observe("loss", 1.25)
    m.observe("loss", 0.75)
    m.observe("bad\nname\\x", 3.0)
    for v in (0.002, 0.03, 0.4, 20.0):
        m.observe_hist("rpc_seconds", v)
    for v in (2e-5, 3e-4, 0.07):
        m.observe_hist("busy_s", v, buckets=DEVICE_BUCKETS)


def test_prometheus_and_json_byte_equal_to_jax_package():
    ours, ref = Metrics(), jmetrics.Metrics()
    _observe(ours)
    _observe(ref)
    text = ours.to_prometheus()
    assert text == ref.to_prometheus()
    assert ours.to_prometheus(prefix="tl") == ref.to_prometheus(prefix="tl")
    assert ours.to_json() == ref.to_json()
    assert DEFAULT_BUCKETS == jmetrics.DEFAULT_BUCKETS
    assert DEVICE_BUCKETS == jmetrics.DEVICE_BUCKETS
    assert text.count("# TYPE tensorlink__9lives_total") == 1
    assert 'tensorlink_rpc_seconds_bucket{le="+Inf"} 4' in text
    assert "tensorlink_rpc_seconds_count 4" in text
    assert "# HELP tensorlink_bad_name_x tensorlink gauge bad\\nname\\\\x" in text
