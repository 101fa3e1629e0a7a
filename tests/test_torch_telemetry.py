"""PyTorch port, the telemetry copies: ``utils/logging.py``,
``runtime/tracing.py``, ``runtime/timeseries.py``, ``runtime/alerts.py``,
``runtime/flight.py``, ``runtime/http_status.py`` and the capture half of
``runtime/profiling.py`` (on ``torch.profiler``).

- The reference's module-level tests, copied and pointed at the copies
  (from ``tests/test_observability.py``: the roofline, tracer, Chrome
  trace, HEAD/405, straggler and JSON-formatter tests; from
  ``tests/test_flight.py``: the recorder, watchdog, health, watermark and
  post-mortem tests, whose bundle reports torch and CUDA in place of
  jax; from ``tests/test_timeseries.py``: every test that needs no node,
  engine or P2P). The ones that need ``p2p/node.py`` or the roles wait
  for the P2P slice.
- Parity on the same inputs under a fixed clock and fixed ids: the
  Chrome-trace export, the Prometheus text, a downsampled series, a
  fleet rollup and the alert evaluations equal the reference's.
- The capture half on the CPU: ``trace``/``step_trace`` write a trace,
  ``op_breakdown`` and ``timed_capture`` return the reference's bundle
  keys (an empty breakdown: a CPU capture holds no device events), a
  second concurrent capture raises ``ProfileBusyError`` and ``/profile``
  answers 409 then; ``parse_op_breakdown`` groups Kineto kernel events
  by family; the logger root and the trace-id lookup are the port's.
"""

import asyncio
import json
import threading
import time

import pytest

from tensorlink_tpu_torch.config import NodeConfig
from tensorlink_tpu_torch.runtime.alerts import (
    AlertEngine,
    AlertRule,
    default_rules,
    evaluate_rule,
    load_rules,
)
from tensorlink_tpu_torch.runtime.flight import (
    FlightRecorder,
    HealthState,
    Watchdog,
    sample_memory_watermarks,
    write_postmortem,
)
from tensorlink_tpu_torch.runtime.metrics import Metrics
from tensorlink_tpu_torch.runtime.timeseries import (
    FleetStore,
    TimeSeriesStore,
    sanitize_delta,
)


# ---- tests/test_observability.py


async def _http_raw(host: str, port: int, request: bytes) -> tuple[int, bytes, bytes]:
    """-> (status, header bytes, body bytes)"""
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(request)
    await writer.drain()
    raw = await reader.read(1 << 20)
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), head, body


def test_roofline_floors_and_bound():
    """Roofline math: floors, ridge, and the binding-wall verdict (the
    bench's 'is the residual MFU gap bandwidth?' evidence)."""
    from tensorlink_tpu_torch.runtime.profiling import roofline

    # compute-bound: high intensity vs ridge
    r = roofline(flops_per_step=1e12, hbm_bytes_per_step=1e9,
                 peak_tflops=200.0, hbm_gbps=800.0, measured_step_s=0.01)
    assert r["bound"] == "compute"
    assert r["t_compute_floor_s"] == pytest.approx(1e12 / 200e12)
    assert r["t_memory_floor_s"] == pytest.approx(1e9 / 800e9)
    assert r["arithmetic_intensity_flop_per_byte"] == pytest.approx(1000.0)
    assert r["ridge_flop_per_byte"] == pytest.approx(250.0)
    assert r["fraction_of_binding_floor"] == pytest.approx(
        (1e12 / 200e12) / 0.01
    )
    # memory-bound: intensity below the ridge
    r2 = roofline(flops_per_step=1e9, hbm_bytes_per_step=1e9,
                  peak_tflops=200.0, hbm_gbps=800.0)
    assert r2["bound"] == "memory"
    assert "measured_step_s" not in r2
    # attainable MFU at the binding floor < 1 when memory-bound
    r3 = roofline(flops_per_step=1e9, hbm_bytes_per_step=1e9,
                  peak_tflops=200.0, hbm_gbps=800.0, measured_step_s=1.0)
    assert r3["attainable_mfu_at_floor"] < 1.0


def test_tracer_nesting_decorator_and_bounds():
    from tensorlink_tpu_torch.runtime.tracing import Tracer, current_span

    t = Tracer("svc", max_spans=4)
    with t.span("outer", {"k": 1}) as outer:
        assert current_span() is outer
        with t.span("inner") as inner:
            assert inner.trace_id == outer.trace_id
            assert inner.parent_id == outer.span_id
    assert current_span() is None

    @t.trace("deco")
    def f(x):
        return x + 1

    assert f(1) == 2
    names = [s.name for s in t.spans()]
    assert names == ["inner", "outer", "deco"]  # recorded at exit

    # error status is stamped and the exception propagates
    with pytest.raises(ValueError):
        with t.span("boom"):
            raise ValueError("x")
    assert t.spans()[-1].status == "error"

    # bounded buffer: oldest evicted
    for i in range(10):
        with t.span(f"s{i}"):
            pass
    assert len(t) == 4


def test_tracer_async_decorator_and_remote_parent():
    from tensorlink_tpu_torch.runtime.tracing import Tracer

    t = Tracer("svc")

    @t.trace()
    async def work():
        return 7

    assert asyncio.run(work()) == 7
    assert t.spans()[-1].name.endswith("work")

    with t.span("child", remote={"trace_id": "abc", "span_id": "def"}) as s:
        assert s.trace_id == "abc" and s.parent_id == "def"


def test_chrome_trace_span_buffer_overflow_eviction_order():
    """max_spans overflow: the buffer keeps the NEWEST spans in record
    order, and to_chrome_trace exports exactly those — an overflowing
    tracer must never export evicted spans or scramble ordering."""
    from tensorlink_tpu_torch.runtime.tracing import Tracer

    t = Tracer("svc", max_spans=4)
    for i in range(10):
        with t.span(f"s{i}", {"i": i}):
            pass
    assert len(t) == 4
    assert [s.name for s in t.spans()] == ["s6", "s7", "s8", "s9"]
    xs = [e for e in t.to_chrome_trace()["traceEvents"] if e["ph"] == "X"]
    assert [e["name"] for e in xs] == ["s6", "s7", "s8", "s9"]
    assert [e["args"]["i"] for e in xs] == [6, 7, 8, 9]
    # timestamps of the kept window are monotone (record order == time)
    ts = [e["ts"] for e in xs]
    assert ts == sorted(ts)
    # a nested survivor whose PARENT was evicted still exports cleanly
    t2 = Tracer("svc", max_spans=1)
    with t2.span("outer"):
        with t2.span("inner"):
            pass
    # inner recorded first (exit order), then outer evicted it... no:
    # outer exits LAST, so it evicts inner — the newest span wins
    assert [s.name for s in t2.spans()] == ["outer"]
    assert len(t2.to_chrome_trace()["traceEvents"]) == 3  # 2 meta + 1 X


def test_chrome_trace_export_shape():
    from tensorlink_tpu_torch.runtime.tracing import Tracer

    t = Tracer("svc")
    with t.span("a", {"x": 1}):
        pass
    ct = t.to_chrome_trace()
    assert set(ct) == {"traceEvents"}
    xs = [e for e in ct["traceEvents"] if e.get("ph") == "X"]
    assert len(xs) == 1
    e = xs[0]
    assert {"name", "ph", "ts", "dur", "pid", "tid", "args"} <= set(e)
    assert e["args"]["x"] == 1 and e["args"]["trace_id"]
    # metadata rows name the process (service) and each trace
    metas = [ev for ev in ct["traceEvents"] if ev.get("ph") == "M"]
    assert any(ev["name"] == "process_name" for ev in metas)
    assert any(ev["name"] == "thread_name" for ev in metas)


@pytest.mark.asyncio
async def test_http_head_405_and_timeout():
    from tensorlink_tpu_torch.runtime.http_status import StatusServer

    class FakeNode:
        def status(self):
            return {"ok": 1}

    srv = StatusServer(FakeNode(), "127.0.0.1", 0, timeout_s=0.3)
    await srv.start()
    try:
        port = srv.bound_port
        # HEAD: headers only, correct Content-Length, no body
        st, head, body = await _http_raw(
            "127.0.0.1", port, b"HEAD /healthz HTTP/1.1\r\n\r\n"
        )
        assert st == 200 and body == b""
        assert b"Content-Length:" in head and b"Cache-Control: no-store" in head
        # non-GET/HEAD -> 405
        st, _, _ = await _http_raw(
            "127.0.0.1", port, b"POST /healthz HTTP/1.1\r\n\r\n"
        )
        assert st == 405
        # header-trickle client: the overall deadline closes the
        # connection with no response instead of pinning the task
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(b"GET /healthz HTTP/1.1\r\n")  # never finishes headers
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(1 << 16), timeout=5.0)
        assert raw == b""
        writer.close()
    finally:
        await srv.stop()


def test_straggler_report_skew_and_heartbeat():
    import time as _time

    from tensorlink_tpu_torch.runtime.metrics import Metrics
    from tensorlink_tpu_torch.runtime.tracing import straggler_report

    m = Metrics()
    for _ in range(4):
        m.observe("stage0_fwd_s", 0.10)
        m.observe("stage1_fwd_s", 0.30)  # straggler
        m.observe("stage0_bwd_s", 0.10)
        m.observe("stage1_bwd_s", 0.30)
    m.observe("loss", 1.0)  # non-stage series must be ignored

    class P:
        last_seen = _time.time() - 5.0

    rep = straggler_report(m, {"peer-a": P()})
    assert rep["slowest_stage"] == 1
    # totals 0.2 vs 0.6 -> median 0.4 -> skew 1.5
    assert rep["skew"] == pytest.approx(1.5, rel=0.01)
    assert rep["stages"]["1"]["fwd_mean_s"] == pytest.approx(0.30)
    assert rep["heartbeat_age_s"]["peer-a"] == pytest.approx(5.0, abs=0.5)
    # empty metrics -> structurally valid, no skew keys
    empty = straggler_report(Metrics())
    assert empty["stages"] == {} and "skew" not in empty


def test_json_formatter_extras_and_trace_ids():
    import logging

    from tensorlink_tpu_torch.runtime.tracing import Tracer
    from tensorlink_tpu_torch.utils.logging import JsonFormatter

    fmt = JsonFormatter()
    logger = logging.getLogger("tensorlink_tpu_torch.test_fmt")
    rec = logger.makeRecord(
        "tensorlink_tpu_torch.test_fmt", logging.INFO, __file__, 1,
        "hello %s", ("world",), None,
        extra={"job_id": "j1", "weird": object()},
    )
    out = json.loads(fmt.format(rec))
    assert out["msg"] == "hello world"
    assert out["job_id"] == "j1"  # extra fields survive
    assert isinstance(out["weird"], str)  # non-JSON extras stringified
    assert "trace_id" not in out  # no active span

    t = Tracer("svc")
    with t.span("logging") as s:
        out2 = json.loads(fmt.format(rec))
    assert out2["trace_id"] == s.trace_id and out2["span_id"] == s.span_id


# ---- tests/test_flight.py


def test_flight_recorder_ring_and_filters():
    r = FlightRecorder("svc", max_events=3)
    for i in range(5):
        r.record("tick", x=i)
    r.record("boom", "error", why="bad")
    # bounded: oldest evicted, order preserved; totals keep counting
    assert len(r) == 3
    assert [e["attrs"].get("x") for e in r.events()] == [3, 4, None]
    assert r.counts["tick"] == 5 and r.counts["boom"] == 1
    # filters: kind, min_severity, since (seq-exclusive), limit
    assert [e["kind"] for e in r.events(kind="boom")] == ["boom"]
    assert [e["kind"] for e in r.events(min_severity="error")] == ["boom"]
    last_seq = r.events()[-1]["seq"]
    assert r.events(since=last_seq) == []
    assert len(r.events(limit=2)) == 2
    # non-JSON attrs are stringified at record time, never at serve time
    r.record("obj", thing=object(), nested={"k": {1, 2}})
    ev = r.events(kind="obj")[0]
    json.dumps(ev)  # must not raise
    assert isinstance(ev["attrs"]["thing"], str)
    with pytest.raises(ValueError, match="severity"):
        r.record("x", "fatal")


def test_flight_recorder_thread_safety_smoke():
    import threading

    r = FlightRecorder("svc", max_events=64)

    def spam(i):
        for _ in range(200):
            r.record("t", i=i)

    ts = [threading.Thread(target=spam, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(r) == 64 and r.counts["t"] == 800


def test_watchdog_trip_edge_and_rearm():
    r = FlightRecorder("svc")
    dog = Watchdog("step", deadline_s=0.05, recorder=r)
    assert dog.check()
    time.sleep(0.08)
    assert not dog.check()
    assert not dog.check()  # still tripped, but only ONE trip event
    assert len(r.events(kind="watchdog_trip")) == 1
    dog.kick()  # recovery event + healthy again
    assert dog.check()
    assert len(r.events(kind="watchdog_recovered")) == 1
    # disarmed dogs never trip; arm() restarts the clock cleanly
    dog.disarm()
    time.sleep(0.08)
    assert dog.check()
    dog.arm()
    assert dog.check() and not dog.tripped


def test_health_state_report_and_conditions():
    r = FlightRecorder("svc")
    h = HealthState(r)
    assert h.report()["ok"]
    h.set_condition("job:x:stage1", "worker dead")
    rep = h.report()
    assert not rep["ok"] and not rep["ready"] and rep["live"]
    assert "condition:job:x:stage1" in rep["reasons"]
    assert r.events(kind="health_degraded")
    # duplicate set: reason updates, no second degraded event
    h.set_condition("job:x:stage1", "still dead")
    assert len(r.events(kind="health_degraded")) == 1
    h.clear_conditions("job:x")
    assert h.report()["ok"] and r.events(kind="health_restored")
    # watchdog integration + loop lag
    dog = h.watchdog("hb", 0.01)
    time.sleep(0.03)
    rep = h.report()
    assert "watchdog:hb" in rep["reasons"]
    dog.kick()
    h.note_loop_lag(5.0)
    rep = h.report()
    assert "event_loop_lag" in rep["reasons"]
    h.note_loop_lag(0.0)
    assert h.report()["ok"]
    # retired dogs vanish from the report entirely (no per-job buildup)
    h.remove_watchdog("hb")
    assert "hb" not in h.report()["watchdogs"]


def test_memory_watermarks_sampled_into_metrics():
    m = Metrics()
    out = sample_memory_watermarks(m)
    # host gauges exist on any Linux/psutil host; HBM gauges appear once
    # CUDA is initialized (never on the CPU)
    assert "host_mem_used_frac" in out
    snap = m.snapshot()
    assert 0.0 <= snap["host_mem_used_frac"]["last"] <= 1.0


def test_write_postmortem_bundle(tmp_path):
    from tensorlink_tpu_torch.runtime.tracing import Tracer

    r = FlightRecorder("svc")
    r.record("peer_dropped", "warn", peer="abcd")
    t = Tracer("svc")
    with t.span("work"):
        pass
    m = Metrics()
    m.observe("loss", 1.0)
    cfg = NodeConfig(role="worker")
    try:
        raise RuntimeError("boom")
    except RuntimeError as e:
        path = write_postmortem(
            str(tmp_path / "pm.json"), "unhandled RuntimeError",
            recorder=r, tracer=t, metrics=m, config=cfg, exc=e,
        )
    with open(path) as f:
        bundle = json.load(f)
    assert bundle["reason"] == "unhandled RuntimeError"
    assert bundle["versions"]["python"] and bundle["versions"]["torch"]
    assert "cuda" in bundle["versions"]
    assert bundle["events"][0]["kind"] == "peer_dropped"
    assert bundle["spans"][0]["name"] == "work"
    assert bundle["metrics"]["loss"]["last"] == 1.0
    assert bundle["config"]["role"] == "worker"
    assert "RuntimeError: boom" in bundle["exception"]


# ---- tests/test_timeseries.py


T0 = 1_700_000_000.0  # fixed synthetic epoch: these tests never sleep


def test_ring_wraparound_keeps_only_newest():
    ts = TimeSeriesStore(tiers=((1.0, 10),))
    for i in range(25):
        ts.record("g", float(i), "gauge", now=T0 + i)
    pts = ts.query("g", now=T0 + 24.5)["points"]
    # 10 slots: buckets 15..24 survive, 0..14 were overwritten in place
    assert len(pts) == 10
    assert pts[0][0] == pytest.approx(T0 + 15)
    assert pts[-1][0] == pytest.approx(T0 + 24)
    assert [v for _, v in pts] == [float(i) for i in range(15, 25)]


def test_counter_conserved_across_downsample_boundary():
    """Counters are stored CUMULATIVE, so a coarse bucket's value is
    the last fine sample inside it and any delta split across a
    downsample boundary is conserved exactly — no increments are lost
    or double-counted when a query falls back to the coarse tier."""
    ts = TimeSeriesStore(tiers=((1.0, 600), (15.0, 480)))
    total = 0.0
    for i in range(120):
        total += i % 7  # lumpy increments
        ts.record("c", total, "counter", now=T0 + i)
    now = T0 + 119.5
    fine = ts.query("c", step=1.0, now=now)["points"]
    coarse = ts.query("c", step=15.0, now=now)["points"]
    assert ts.query("c", step=15.0, now=now)["step"] == 15.0
    assert fine[-1][1] == coarse[-1][1] == total
    fine_by_t = dict((t, v) for t, v in fine)

    def fine_at_end(t):  # fine-tier value at the end of coarse bucket t
        return fine_by_t[max(ft for ft in fine_by_t if t <= ft < t + 15.0)]

    for t, v in coarse:
        assert v == fine_at_end(t)
    # consequence: per-coarse-bucket deltas sum to the full-span delta
    deltas = [b[1] - a[1] for a, b in zip(coarse, coarse[1:])]
    assert sum(deltas) == coarse[-1][1] - coarse[0][1]


def test_gauge_downsample_is_mean():
    ts = TimeSeriesStore(tiers=((1.0, 600), (15.0, 480)))
    for i in range(60):
        ts.record("g", float(i % 13), "gauge", now=T0 + i)
    now = T0 + 59.5
    fine = ts.query("g", step=1.0, now=now)["points"]
    coarse = ts.query("g", step=15.0, now=now)["points"]
    for t, v in coarse:
        vals = [fv for ft, fv in fine if t <= ft < t + 15.0]
        assert v == pytest.approx(sum(vals) / len(vals))


def test_since_pagination_stable_under_live_writer():
    """A dashboard cursors with since=: already-fetched pages must not
    change as the writer keeps appending, and consecutive pages must
    tile without overlap or holes."""
    ts = TimeSeriesStore(tiers=((1.0, 200),))
    for i in range(50):
        ts.record("g", float(i), "gauge", now=T0 + i)
    page1 = ts.query("g", now=T0 + 49.5)["points"]
    cursor = page1[-1][0]
    for i in range(50, 90):  # live writer keeps going
        ts.record("g", float(i), "gauge", now=T0 + i)
    again = ts.query("g", since=page1[0][0], now=T0 + 89.5)["points"]
    assert again[: len(page1)] == page1  # retained history is stable
    page2 = ts.query("g", since=cursor + 0.5, now=T0 + 89.5)["points"]
    assert page2[0][0] == pytest.approx(cursor + 1.0)  # no overlap
    assert [t for t, _ in page1 + page2] == [
        pytest.approx(T0 + i) for i in range(90)
    ]  # no holes


def test_kind_is_fixed_nan_dropped_cardinality_capped():
    ts = TimeSeriesStore(tiers=((1.0, 10),), max_series=3)
    ts.record("a", 1.0, "counter", now=T0)
    ts.record("a", 2.0, "gauge", now=T0 + 1)  # kind pinned at creation
    assert ts.kind("a") == "counter"
    ts.record("a", float("nan"), "counter", now=T0 + 2)
    assert len(ts.query("a", now=T0 + 3)["points"]) == 2
    ts.record("b", 1.0, "gauge", now=T0)
    ts.record("c", 1.0, "gauge", now=T0)
    ts.record("overflow", 1.0, "gauge", now=T0)
    assert ts.kind("overflow") is None
    assert ts.dropped_series >= 1


def test_sample_metrics_shapes():
    m = Metrics()
    m.incr("reqs_total", 3)
    m.observe("util", 0.5)
    for v in (0.1, 0.2, 0.9):
        m.observe_hist("lat_s", v)
    ts = TimeSeriesStore()
    ts.sample_metrics(m, now=T0)
    assert ts.kind("reqs_total") == "counter"
    assert ts.kind("util") == "gauge"
    assert ts.kind("lat_s.p99") == "gauge"
    assert ts.kind("lat_s.count") == "counter"
    assert ts.query("lat_s.count", now=T0 + 1)["points"][-1][1] == 3.0


def test_delta_roundtrip_and_missed_beat_gap():
    """The heartbeat protocol: cursor-based deltas into a FleetStore.
    A missed stretch of beats widens the next ask; the refill comes
    from the responder's rings, and the un-sampled stretch stays a
    VISIBLE hole in the fleet view — never interpolated."""
    worker = TimeSeriesStore()
    fleet = FleetStore()
    for i in range(10):
        worker.record("g", float(i), "gauge", now=T0 + i)
    d1 = worker.delta(fleet.cursor("w"), patterns=("g",), now=T0 + 9.5)
    assert fleet.ingest("w", d1, now=T0 + 9.5) == 10
    cur = fleet.cursor("w")
    assert cur > T0 + 9  # advanced past the newest shipped bucket

    # the worker goes dark for [10, 20), then resumes sampling
    for i in range(20, 30):
        worker.record("g", float(i), "gauge", now=T0 + i)
    # beats were MISSED — the next ask still starts at the old cursor,
    # so the whole resumed stretch backfills in one delta, with no
    # re-send of the bucket already shipped
    d2 = worker.delta(cur, patterns=("g",), now=T0 + 29.5)
    assert fleet.ingest("w", d2, now=T0 + 29.5) == 10
    pts = fleet.query("g", now=T0 + 29.5)["nodes"]["w"]["points"]
    assert len(pts) == 20
    times = [t for t, _ in pts]
    gaps = [b - a for a, b in zip(times, times[1:])]
    # the dark stretch is a visible hole, not an interpolated line
    assert max(gaps) == pytest.approx(11.0)
    assert all(g == pytest.approx(1.0) for g in gaps if g < 5)


def test_sanitize_delta_bounds_hostile_peer():
    long_name = "x" * 500
    hostile = {
        "t": "nope",
        "series": {
            long_name: {"kind": "gauge", "points": [[T0, 1.0]]},
            "inf": {"kind": "gauge", "points": [[T0, float("inf")]]},
            "bad_kind": {"kind": "exploit", "points": [[T0, 1.0]]},
            "flood": {
                "kind": "counter",
                "points": [[T0 + i, float(i)] for i in range(100000)],
            },
            "not_points": {"kind": "gauge", "points": "boom"},
            "ok": {"kind": "gauge", "points": [[T0, 2.0], ["x", 3.0]]},
        },
    }
    clean = sanitize_delta(hostile)
    names = set(clean["series"])
    assert long_name not in names  # name length clamp
    assert "inf" not in names  # non-finite values dropped
    assert "not_points" not in names  # malformed body dropped
    assert clean["series"]["bad_kind"]["kind"] == "gauge"  # coerced
    assert clean["series"]["ok"]["points"] == [[T0, 2.0]]
    assert len(clean["series"]["flood"]["points"]) <= 160
    assert "t" not in clean  # non-numeric timestamp dropped
    assert sanitize_delta("garbage") is None
    assert sanitize_delta({"series": "garbage"}) is None


def test_fleet_rollup_counters_sum_gauges_mean():
    fleet = FleetStore()
    for nid, base in (("a", 0.0), ("b", 100.0)):
        fleet.ingest(nid, {
            "t": T0,
            "series": {
                "reqs": {
                    "kind": "counter",
                    "points": [[T0 + i, base + i] for i in range(5)],
                },
                "util": {
                    "kind": "gauge",
                    "points": [[T0 + i, 0.2 if nid == "a" else 0.6]
                               for i in range(5)],
                },
            },
        }, now=T0 + 5)
    q = fleet.query("reqs", now=T0 + 5)
    assert q["kind"] == "counter"
    assert len(q["nodes"]) == 2
    assert q["fleet"][-1][1] == pytest.approx(4 + 104)  # summed
    q = fleet.query("util", now=T0 + 5)
    assert all(v == pytest.approx(0.4) for _, v in q["fleet"])  # mean
    summ = fleet.summary(now=T0 + 6)
    assert set(summ["nodes"]) == {"a", "b"}
    assert len(summ["tiers"]) >= 2
    assert summ["nodes"]["a"]["last_seen_age_s"] == pytest.approx(1.0)
    assert "reqs" in summ["series"] and "util" in summ["series"]


def test_fleet_ingest_sanitizes_kv_summary():
    fleet = FleetStore()
    fleet.ingest("w", {"t": T0, "series": {}}, now=T0, kv={
        "occupancy": 0.5, "chains": 3, "num_blocks": 64,
        "evil": "x" * 10000, "used": float("inf"), "cached": True,
    })
    kv = fleet.summary(now=T0)["nodes"]["w"]["kv"]
    assert kv == {"occupancy": 0.5, "chains": 3, "num_blocks": 64}


def _feed(store, name, value, t_from, t_to, kind="gauge"):
    t = t_from
    while t < t_to:
        store.record(name, value, kind, now=t)
        t += 1.0


def test_latency_burn_fires_and_clears_with_health_and_flight():
    from tensorlink_tpu_torch.runtime.flight import FlightRecorder, HealthState

    rule = AlertRule(
        name="ttft-burn", kind="latency", series="ttft.p99",
        target=0.1, windows_s=(5.0, 15.0), severity="error",
    )
    fr, hs, m = FlightRecorder("t"), HealthState(), Metrics()
    eng = AlertEngine([rule], recorder=fr, health=hs, metrics=m)
    ts = TimeSeriesStore()
    _feed(ts, "ttft.p99", 0.02, T0, T0 + 20)
    assert eng.evaluate(ts, now=T0 + 20) == []
    assert hs.report()["ok"]

    _feed(ts, "ttft.p99", 0.9, T0 + 20, T0 + 40)
    active = eng.evaluate(ts, now=T0 + 40)
    assert [a["name"] for a in active] == ["ttft-burn"]
    assert active[0]["severity"] == "error"
    assert active[0]["value"] == pytest.approx(0.9)
    rep = hs.report()
    # a burning SLO flips readiness: /healthz goes 503 for the LB
    assert not rep["ok"]
    assert "condition:alert:ttft-burn" in rep["reasons"]
    assert m.counters.get("alerts_fired_total") == 1
    fired = fr.events(kind="alert_fired")
    assert len(fired) == 1
    # satellite 5: alert transitions carry BOTH wall + monotonic stamps
    assert fired[0]["ts"] > 1e9 and 0 < fired[0]["mono"] < 1e9

    _feed(ts, "ttft.p99", 0.02, T0 + 40, T0 + 80)
    assert eng.evaluate(ts, now=T0 + 80) == []
    assert hs.report()["ok"]
    cleared = fr.events(kind="alert_cleared")
    assert len(cleared) == 1 and cleared[0]["mono"] > 0
    # edge-triggered: re-evaluating while clear emits nothing new
    eng.evaluate(ts, now=T0 + 81)
    assert len(fr.events(kind="alert_cleared")) == 1


def test_burn_requires_all_windows():
    """Multi-window burn semantics: a short spike exceeds the fast
    window but not the slow one -> no alert (flap suppression)."""
    rule = AlertRule(
        name="burn", kind="latency", series="s", target=0.1,
        windows_s=(3.0, 30.0),
    )
    ts = TimeSeriesStore()
    _feed(ts, "s", 0.01, T0, T0 + 28)
    _feed(ts, "s", 0.5, T0 + 28, T0 + 30)  # 2 s spike
    assert not evaluate_rule(rule, ts, now=T0 + 30).firing
    _feed(ts, "s", 0.5, T0 + 30, T0 + 58)  # sustained
    assert evaluate_rule(rule, ts, now=T0 + 58).firing


def test_no_data_abstains():
    rule = AlertRule(
        name="burn", kind="latency", series="absent", target=0.1,
        windows_s=(5.0,),
    )
    res = evaluate_rule(rule, TimeSeriesStore(), now=T0)
    assert not res.firing and "no data" in res.detail


def test_budget_burn_rate():
    rule = AlertRule(
        name="shed-burn", kind="budget_burn", numerator="shed",
        denominator="reqs", budget_frac=0.01, burn_factor=10.0,
        windows_s=(5.0, 10.0),
    )
    ts = TimeSeriesStore()
    reqs = shed = 0.0
    for i in range(20):  # 5% shed: under the 10x-burn limit of 10%
        reqs += 10.0
        shed += 0.5
        ts.record("reqs", reqs, "counter", now=T0 + i)
        ts.record("shed", shed, "counter", now=T0 + i)
    assert not evaluate_rule(rule, ts, now=T0 + 20).firing
    for i in range(20, 40):  # 50% shed: burning 5x faster than allowed
        reqs += 10.0
        shed += 5.0
        ts.record("reqs", reqs, "counter", now=T0 + i)
        ts.record("shed", shed, "counter", now=T0 + i)
    res = evaluate_rule(rule, ts, now=T0 + 40)
    assert res.firing and res.value == pytest.approx(0.5, abs=0.05)


def test_staleness_via_fleet_and_name_suffix():
    fleet = FleetStore()
    beat = {"t": T0, "series": {"g": {"kind": "gauge",
                                      "points": [[T0, 1.0]]}}}
    fleet.ingest("w1", beat, now=T0)
    eng = AlertEngine([AlertRule(
        name="heartbeat-stale", kind="staleness", stale_after_s=10.0,
        severity="error",
    )])
    assert eng.evaluate_fleet(fleet, now=T0 + 5) == []
    active = eng.evaluate_fleet(fleet, now=T0 + 30)
    assert [a["name"] for a in active] == ["heartbeat-stale@w1"]
    fleet.ingest("w1", dict(beat), now=T0 + 31)  # peer comes back
    assert eng.evaluate_fleet(fleet, now=T0 + 32) == []


def test_default_rules_and_slo_file_roundtrip(tmp_path):
    slo = {
        "ttft_p99_s": {"interactive": 0.5},
        "tpot_p99_s": 0.2,
        "shed_budget_frac": 0.01,
        "windows_s": [10, 60],
    }
    rules = default_rules(slo)
    names = {r.name for r in rules}
    assert {"ttft-burn:interactive", "tpot-burn", "shed-burn",
            "host-bound", "kv-pressure", "heartbeat-stale"} <= names
    ttft = next(r for r in rules if r.name == "ttft-burn:interactive")
    assert ttft.series == "serving_ttft_s:interactive.p99"
    assert ttft.windows_s == (10.0, 60.0)
    shed = next(r for r in rules if r.name == "shed-burn")
    assert shed.numerator == "serving_shed_total"
    assert shed.denominator == "serving_requests_total"

    p = tmp_path / "slo.json"
    p.write_text(json.dumps({
        **slo,
        "rules": [{"name": "custom", "kind": "threshold",
                   "series": "x", "target": 1.0}],
    }))
    loaded = load_rules(str(p))
    assert {r.name for r in loaded} == names | {"custom"}
    assert AlertRule.from_dict(ttft.to_dict()) == ttft


def test_event_monotonic_and_postmortem_timeseries(tmp_path):
    from tensorlink_tpu_torch.runtime.flight import (
        FlightRecorder,
        write_postmortem,
    )

    fr = FlightRecorder("t")
    fr.record("something", "info")
    ev = fr.events()[0]
    assert ev["ts"] > 1e9 and 0 < ev["mono"] < 1e9  # wall + monotonic

    ts = TimeSeriesStore()
    now = time.time()  # snapshot() reads the wall clock internally
    _feed(ts, "g", 1.0, now - 30, now)
    path = str(tmp_path / "pm.json")
    write_postmortem(path, "test", recorder=fr, timeseries=ts)
    bundle = json.loads(open(path).read())
    assert bundle["at"] > 1e9 and bundle["at_mono"] > 0
    g = bundle["timeseries"]["series"]["g"]
    assert g["tiers"][0]["points"]  # the rings rode into the crash dump


def _parse_prom(text: str) -> dict:
    """Strict exposition-format (0.0.4) parser: HELP then TYPE per
    family, every sample attributed to a declared family."""
    fams: dict = {}
    cur = None
    for line in text.rstrip("\n").split("\n"):
        if line.startswith("# HELP "):
            _, _, name, help_text = line.split(" ", 3)
            assert name not in fams, f"duplicate HELP {name}"
            fams[name] = {"help": help_text, "type": None, "samples": {}}
            cur = name
        elif line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            assert name == cur, "TYPE must follow its own HELP"
            assert fams[name]["type"] is None, f"duplicate TYPE {name}"
            fams[name]["type"] = kind
        else:
            assert not line.startswith("#"), f"unknown comment: {line}"
            key, val = line.rsplit(" ", 1)
            base = key.partition("{")[0]
            fam = base
            for suffix in ("_bucket", "_sum", "_count"):
                if base.endswith(suffix) and base[: -len(suffix)] in fams:
                    fam = base[: -len(suffix)]
            assert fam in fams, f"sample {key} has no family"
            fams[fam]["samples"][key] = float(val)
    return fams


def test_prometheus_exposition_roundtrip():
    m = Metrics()
    m.incr("reqs_total", 7)
    m.incr("msg:PING", 2)  # colons are legal in prom metric names
    m.observe("util", 0.25)
    for v in (0.05, 0.3, 0.3, 2.0):
        m.observe_hist("lat_s", v)
    fams = _parse_prom(m.to_prometheus())
    for fam in fams.values():  # every family: HELP + exactly one TYPE
        assert fam["help"]
        assert fam["type"] in ("counter", "gauge", "histogram")
    c = fams["tensorlink_reqs_total_total"]
    assert c["type"] == "counter"
    assert c["samples"]["tensorlink_reqs_total_total"] == 7.0
    assert fams["tensorlink_msg:PING_total"]["samples"][
        "tensorlink_msg:PING_total"] == 2.0
    assert fams["tensorlink_util"]["type"] == "gauge"
    h = fams["tensorlink_lat_s"]
    assert h["type"] == "histogram"
    buckets = [v for k, v in h["samples"].items() if "_bucket{" in k]
    assert buckets == sorted(buckets)  # cumulative, non-decreasing
    inf = next(v for k, v in h["samples"].items() if 'le="+Inf"' in k)
    assert inf == h["samples"]["tensorlink_lat_s_count"] == 4.0
    assert h["samples"]["tensorlink_lat_s_sum"] == pytest.approx(2.65)


# ------------------------------------------- parity with the reference


@pytest.fixture
def fixed_clock(monkeypatch):
    """time.time / time.time_ns on a fixed synthetic timeline and uuid4
    a counter, for both packages' modules (they read the stdlib's)."""
    import itertools
    import uuid

    ticks = itertools.count()
    ids = itertools.count(1)
    monkeypatch.setattr(time, "time_ns", lambda: int(T0 * 1e9) + next(ticks) * 1000)
    monkeypatch.setattr(time, "time", lambda: T0 + next(ticks) * 1e-3)
    monkeypatch.setattr(uuid, "uuid4", lambda: uuid.UUID(int=next(ids)))

    def reset():
        nonlocal ticks, ids
        ticks, ids = itertools.count(), itertools.count(1)

    return reset


def _both(name: str):
    import importlib

    return (importlib.import_module(f"tensorlink_tpu.runtime.{name}"),
            importlib.import_module(f"tensorlink_tpu_torch.runtime.{name}"))


def test_chrome_trace_equals_reference(fixed_clock):
    out = []
    for tracing in _both("tracing"):
        fixed_clock()
        t = tracing.Tracer("svc", max_spans=8)
        with t.span("outer", {"k": 1}):
            with t.span("inner"):
                pass
        with t.span("remote", remote={"trace_id": "abc", "span_id": "def"}):
            pass
        with pytest.raises(ValueError):
            with t.span("boom"):
                raise ValueError("x")
        out.append(json.dumps(t.to_chrome_trace(), sort_keys=True))
    assert out[0] == out[1]


def test_prometheus_text_equals_reference(fixed_clock):
    out = []
    for metrics in _both("metrics"):
        fixed_clock()
        m = metrics.Metrics()
        m.incr("reqs_total", 7)
        m.incr("msg:PING", 2)
        for v in (0.25, 0.5):
            m.observe("util", v)
        for v in (0.05, 0.3, 0.3, 2.0):
            m.observe_hist("lat_s", v)
        out.append(m.to_prometheus())
    assert out[0] == out[1]


def test_series_rollup_and_alerts_equal_reference(fixed_clock):
    out = []
    for (ts, alerts), flight in zip(zip(_both("timeseries"), _both("alerts")),
                                    _both("flight")):
        fixed_clock()
        store = ts.TimeSeriesStore()
        for i in range(600):  # ten minutes: every downsampling tier fills
            store.record("ttft.p99", 0.02 if i < 400 else 0.5, "gauge", now=T0 + i)
            store.record("reqs", float(i), "counter", now=T0 + i)
        fleet = ts.FleetStore()
        for node in ("a", "b"):
            fleet.ingest(node, store.delta(since=None, now=T0 + 600), now=T0 + 600)
        rule = alerts.AlertRule(name="ttft-burn", kind="latency", series="ttft.p99",
                                target=0.1, windows_s=(30.0, 120.0), severity="error")
        fr = flight.FlightRecorder("t")
        eng = alerts.AlertEngine([rule, *alerts.default_rules()], recorder=fr)
        evals = [eng.evaluate(store, now=T0 + t) for t in (300, 500, 600)]
        out.append(json.dumps({
            "query": store.query("reqs", since=T0, step=60.0, now=T0 + 600),
            "window": store.window("ttft.p99", 120.0, now=T0 + 600),
            "fleet": fleet.query("reqs", since=T0, step=60.0, now=T0 + 600),
            "summary": fleet.summary(now=T0 + 600),
            "evals": evals, "active": eng.active(),
            "events": [(e["kind"], e["attrs"]) for e in fr.events()],
        }, sort_keys=True, default=str))
    assert out[0] == out[1]


# ------------------------------------------------- the capture half


def test_profiling_helpers(tmp_path):
    import os

    import torch

    from tensorlink_tpu_torch.runtime.profiling import Stopwatch, step_trace, trace

    sw = Stopwatch().start()
    dt = sw.stop(sync_array={"x": torch.ones(8, 8) * 2})
    assert dt > 0
    with trace(str(tmp_path)):
        with step_trace("step0"):
            torch.ones(16, 16) @ torch.ones(16, 16)
    assert any(os.scandir(tmp_path)), "profiler trace wrote nothing"


def test_op_breakdown_keeps_caller_log_dir(tmp_path):
    """A CPU capture with an explicit log_dir: no device events, so the
    breakdown is empty, and the capture is kept and reported."""
    import os

    import torch

    from tensorlink_tpu_torch.runtime.profiling import op_breakdown

    out = op_breakdown(lambda a: (a @ a).sum(), torch.ones(32, 32),
                       log_dir=str(tmp_path))
    assert out["total_s"] == 0.0 and out["categories"] == {}
    assert out["trace_dir"] == str(tmp_path)
    assert any(os.scandir(tmp_path)), "capture not kept in caller's dir"


def test_parse_op_breakdown_groups_kineto_kernels():
    from tensorlink_tpu_torch.runtime.profiling import parse_op_breakdown

    ev = [{"ph": "X", "cat": "kernel", "name": n, "dur": d} for n, d in (
        ("void paged_mma_kernel<true>(PagedArgs)", 30.0),
        ("void fused_norm_kernel<bf16>(...)", 10.0),
        ("flash_fwd_kernel", 20.0), ("flash_bwd_dq_kernel", 15.0),
        ("nvjet_tst_128x64", 25.0), ("mystery", 5.0))]
    ev += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 5.0},
           {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "dur": 99.0},
           {"ph": "M", "name": "thread_name", "args": {"name": "x"}}]
    out = parse_op_breakdown(ev)
    assert out["total_s"] == pytest.approx(110e-6)
    cats = out["categories"]
    assert cats["paged_decode (B3)"]["ops"] == 1
    assert cats["fused_residual_norm (B4)"]["s"] == pytest.approx(10e-6)
    assert {"flash_fwd (B1)", "flash_bwd (B2)", "gemm (cuBLAS)", "other",
            "gpu_memcpy"} <= set(cats)
    assert sum(c["fraction"] for c in cats.values()) == pytest.approx(1.0)


@pytest.mark.asyncio
async def test_timed_capture_bundle_busy_and_profile_route():
    from tensorlink_tpu_torch.runtime import profiling
    from tensorlink_tpu_torch.runtime.http_status import StatusServer

    out = profiling.timed_capture(10)
    assert set(out) == {"duration_ms", "op_breakdown"}
    assert not profiling.CAPTURE_LIVE.is_set()
    # another thread sees the window open while the capture records
    worker = threading.Thread(target=profiling.timed_capture, args=(200,))
    worker.start()
    assert profiling.CAPTURE_LIVE.wait(30)
    worker.join()
    assert not profiling.CAPTURE_LIVE.is_set()
    assert out["duration_ms"] == profiling.MIN_PROFILE_MS
    assert profiling._clamp_ms(10**9) == profiling.MAX_PROFILE_MS
    assert set(out["op_breakdown"]) >= {"total_s", "categories"}

    class FakeNode:
        def status(self):
            return {"ok": 1}

    srv = StatusServer(FakeNode(), "127.0.0.1", 0)
    await srv.start()
    try:
        port = srv.bound_port
        st, _, body = await _http_raw("127.0.0.1", port,
                                      b"GET /profile?ms=10 HTTP/1.1\r\n\r\n")
        assert st == 200 and "op_breakdown" in json.loads(body)
        assert profiling._capture_lock.acquire(blocking=False)
        try:  # a capture is live: a second is refused, the route says 409
            with pytest.raises(profiling.ProfileBusyError):
                profiling.timed_capture(10)
            st, _, body = await _http_raw("127.0.0.1", port,
                                          b"GET /profile?ms=10 HTTP/1.1\r\n\r\n")
            assert st == 409 and "already running" in json.loads(body)["error"]
        finally:
            profiling._capture_lock.release()
    finally:
        await srv.stop()


def test_logger_root_and_trace_lookup_are_the_ports():
    import logging

    from tensorlink_tpu_torch.utils.logging import get_logger

    log = get_logger("unit")
    assert log.name == "tensorlink_tpu_torch.unit"
    assert logging.getLogger("tensorlink_tpu_torch").handlers
    # a span of the JAX package's tracer is not the port's: no stamp
    from tensorlink_tpu.runtime.tracing import Tracer as JTracer
    from tensorlink_tpu_torch.utils.logging import JsonFormatter

    rec = log.makeRecord(log.name, logging.INFO, __file__, 1, "m", (), None)
    with JTracer("svc").span("other"):
        assert "trace_id" not in json.loads(JsonFormatter().format(rec))


def test_shape_key_walks_the_batch_like_jax():
    import numpy as np
    import torch

    from tensorlink_tpu.runtime.tracing import StepTelemetry as JStep
    from tensorlink_tpu_torch.runtime.tracing import StepTelemetry

    batch = {"b": np.zeros((2, 3), np.int64), "a": [np.ones(4, np.float32), None]}
    assert StepTelemetry.shape_key(batch, None) == JStep.shape_key(batch, None)
    tb = {"b": torch.zeros(2, 3, dtype=torch.int64), "a": [torch.ones(4), None]}
    assert StepTelemetry.shape_key(tb, 1) == (False, (((4,), "torch.float32"),
                                                      ((2, 3), "torch.int64")))
