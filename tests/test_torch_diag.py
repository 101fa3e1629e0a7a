"""PyTorch port, diag.py (tldiag), against the JAX package's copy.

- Each renderer's text equals the reference's on the same bundle, diff
  or payload: the cluster table, bench, manifest and proto diffs, the
  profile (with device categories), watch, history (catalog and ring),
  ledger and check (text, github and json) renderers, and the CLI's
  ``table``, ``bench-diff``, ``manifest-diff`` and ``proto-diff`` output
  and exit codes on records written under ``tmp_path``.
- ``scrape_cluster`` runs against a port node and a reference node on
  loopback: both rows healthy, each with its ``/node`` identity, and the
  two packages render the bundle alike.
- ``check`` evaluates with the port's ``runtime/alerts`` and
  ``runtime/timeseries`` (the reference's are never imported by it) and
  gives the reference's verdict on the same node.
"""

import asyncio
import json
import sys

import pytest

import tensorlink_tpu_torch.diag as tdiag

NOW = 1_700_000_000.0


def _rdiag():
    import tensorlink_tpu.diag as rdiag

    return rdiag


def _scrape(target, *, healthy=True, node=None, metrics=None, dead=False):
    if dead:
        return {"target": target, "error": "ConnectionRefusedError: refused"}
    return {"target": target, "routes": {
        "/healthz": {"status": 200 if healthy else 503,
                     "body": {"healthy": healthy,
                              "reasons": {} if healthy else {"watchdog:job_step": "stalled"}}},
        "/node": {"status": 200, "body": node or {"node_id": target, "role": "worker"}},
        "/metrics": {"status": 200, "body": metrics or {}},
        "/events": {"status": 200, "body": {"events": []}},
    }}


def _bundle():
    return {"t": NOW, "targets": ["a:1", "b:2", "c:3"], "nodes": [
        _scrape("a:1", node={"node_id": "aaaa", "role": "worker",
                             "serving_leg": "decode"}),
        _scrape("b:2", healthy=False),
        _scrape("c:3", dead=True),
    ]}


def _manifest(programs):
    return {"programs": programs, "suppress": []}


def _proto(frames, versions=None):
    return {"schema": 1, "frames": frames, "versions": versions or {}}


def _cases():
    old_bench = {"value": 1000.0, "mfu": 0.50, "decode_tokens_per_sec": 10000.0,
                 "step_seconds": 0.10, "flops_per_step_xla": 1e12}
    new_bench = {"value": 900.0, "mfu": 0.51, "decode_tokens_per_sec": 12000.0,
                 "step_seconds": 0.13, "flops_per_step_xla": 2e12}
    old_m = _manifest({"p": {"alias": 12, "donated": 12, "temp_bytes": 300_000,
                             "collectives": {"all-gather": 4096}},
                       "gone": {"alias": 1}})
    new_m = _manifest({"p": {"alias": 10, "donated": 12, "temp_bytes": 400_000,
                             "collectives": {"all-gather": 2048}},
                       "new": {"alias": 2}})
    old_p = _proto({"PING": {"fields": {"t": {"kind": "float", "required": True}}},
                    "GONE": {"fields": {}}}, {"KV_WIRE_SCHEMA": 1})
    new_p = _proto({"PING": {"fields": {"t": {"kind": "str", "required": True},
                                        "o": {"kind": "int", "required": False}}}},
                   {"KV_WIRE_SCHEMA": 2})
    profile = {"target": "a:1", "status": 200, "body": {
        "duration_ms": 200, "trace_dir": "/tmp/x",
        "op_breakdown": {"total_s": 0.0123, "categories": {
            "gemm": {"s": 0.01, "fraction": 0.81, "ops": 40},
            "attention": {"s": 0.0023, "fraction": 0.19, "ops": 12}}}}}
    frame = {"target": "a:1", "t": NOW, "summary": {
        "nodes": {"node-a": {"last_seen_age_s": 1.5, "series": ["x", "y"],
                             "kv": {"occupancy": 0.5, "fragmentation": 0.1,
                                    "chains": 3}},
                  "node-b": {"series": []}},
        "alerts": {"own": [{"severity": "error", "name": "ttft", "detail": "0.9 > 0.1"}],
                   "fleet": []}},
        "queries": {"serving_ttft_s": {"fleet": [[NOW - 2, 0.1], [NOW - 1, 0.3]]},
                    "kv_pool_utilization": {"fleet": []}}}
    ledger = {"accepted_total": 3, "rejected_total": 1, "observed_tokens_total": 40,
              "anomalies": {"busy_overbill": 1},
              "tenants": {"t1": {"receipts": 2, "prompt_tokens": 10, "emitted_tokens": 30,
                                 "observed_tokens": 30, "busy_s": 0.5,
                                 "kv_block_s": 2.0, "wire_bytes": 4096, "anomalies": 0}},
              "workers": {"w1": {"receipts": 3, "emitted_tokens": 40, "busy_s": 0.7,
                                 "anomalies": 1, "last_anomaly": "busy_overbill"}}}
    alert = {"name": "ttft-burn:interactive", "severity": "error",
             "rule": "ttft-burn:interactive", "detail": "0.9 > 0.1"}
    check = {"targets": ["h:1"], "nodes": {"h:1": {"alerts": [alert]}},
             "firing": [{**alert, "target": "h:1"}], "ok": False}
    return {
        "table": lambda d: d.render_table(d.cluster_table(_bundle())),
        "bench_diff": lambda d: d.render_bench_diff(d.bench_diff(old_bench, new_bench, 0.05)),
        "manifest_diff": lambda d: d.render_manifest_diff(d.manifest_diff(old_m, new_m)),
        "proto_diff": lambda d: d.render_proto_diff(d.proto_manifest_diff(old_p, new_p)),
        "profile": lambda d: d.render_profile(profile),
        "profile_error": lambda d: d.render_profile(
            {"target": "a:1", "status": 503, "body": {"error": "busy"}}),
        "watch": lambda d: d.render_watch(frame),
        "history_catalog": lambda d: d.render_history(
            {"tiers": [[1.0, 600], [60.0, 1440]], "series": ["a", "b"]}),
        "history_ring": lambda d: d.render_history(
            {"series": "a", "kind": "gauge", "step": 1.0,
             "points": [[NOW, 1.0], [NOW + 1, 2.5]]}),
        "ledger": lambda d: d.render_ledger(ledger),
        "ledger_empty": lambda d: d.render_ledger({}),
        **{f"check_{fmt}": (lambda fmt: lambda d: d.render_check(check, fmt))(fmt)
           for fmt in ("text", "github", "json")},
        "sparkline": lambda d: d.sparkline([0.0, 3.0, 1.0, 7.0], width=8),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_renderer_text_equals_the_reference(case):
    fn = _cases()[case]
    assert fn(tdiag) == fn(_rdiag())


def test_parse_target_and_bench_record(tmp_path):
    assert tdiag.parse_target("h:81") == _rdiag().parse_target("h:81") == ("h", 81)
    (tmp_path / "BENCH_r01.json").write_text(json.dumps({"value": 1.0}))
    (tmp_path / "BENCH_r02.json").write_text("not json")
    assert tdiag.latest_bench_record(str(tmp_path)) == \
        _rdiag().latest_bench_record(str(tmp_path))


def _cli_files(tmp_path):
    files = {}
    for name, body in {
        "bundle.json": _bundle(),
        "old.json": {"value": 10.0, "step_seconds": 1.0},
        "new.json": {"value": 8.0, "step_seconds": 1.0},
        "m_old.json": _manifest({"p": {"alias": 2}}),
        "m_new.json": _manifest({"p": {"alias": 1}}),
        "p_old.json": _proto({"PING": {"fields": {"t": {"kind": "float", "required": True}}}}),
        "p_new.json": _proto({"PING": {"fields": {}}}),
    }.items():
        p = tmp_path / name
        p.write_text(json.dumps(body))
        files[name] = str(p)
    return files


def test_cli_output_and_exit_codes_equal_the_reference(tmp_path, capsys):
    f = _cli_files(tmp_path)
    for argv in (["table", f["bundle.json"]],
                 ["bench-diff", f["old.json"], f["new.json"]],
                 ["bench-diff", f["old.json"], f["new.json"], "--json"],
                 ["manifest-diff", f["m_old.json"], f["m_new.json"]],
                 ["proto-diff", f["p_old.json"], f["p_new.json"]],
                 ["proto-diff", f["p_old.json"], f["p_old.json"]]):
        rc_t = tdiag.main(argv)
        out_t = capsys.readouterr()
        rc_r = _rdiag().main(argv)
        out_r = capsys.readouterr()
        assert (rc_t, out_t.out) == (rc_r, out_r.out), argv


# ----------------------------------------------------------- live nodes


async def _nodes_scrape():
    from tensorlink_tpu.config import NodeConfig as JNodeConfig
    from tensorlink_tpu.roles.worker import WorkerNode as JWorkerNode
    from tensorlink_tpu_torch.config import NodeConfig
    from tensorlink_tpu_torch.roles.worker import WorkerNode

    port = WorkerNode(NodeConfig(role="worker", host="127.0.0.1", port=0,
                                 http_status_port=0), device="cpu")
    ref = JWorkerNode(JNodeConfig(role="worker", host="127.0.0.1", port=0,
                                  http_status_port=0))
    await port.start()
    await ref.start()
    try:
        for n in (port, ref):
            n.metrics.incr("steps")
        targets = [f"127.0.0.1:{n._http.bound_port}" for n in (port, ref)]
        bundle = await tdiag.scrape_cluster(targets, timeout=5.0)
        ids = (port.node_id, ref.node_id)
        port_check = await tdiag.check_nodes(targets[:1], timeout=5.0)
        ref_check = await _rdiag().check_nodes(targets[:1], timeout=5.0)
        return bundle, targets, ids, port_check, ref_check
    finally:
        await port.stop()
        await ref.stop()


def test_scrape_cluster_reads_port_and_reference_nodes(monkeypatch):
    bundle, targets, ids, port_check, ref_check = asyncio.run(_nodes_scrape())
    assert bundle["targets"] == targets
    rows = tdiag.cluster_table(bundle)
    for row, scrape, nid in zip(rows, bundle["nodes"], ids):
        assert row["healthy"] is True and "DEAD" not in row["flags"], row
        assert scrape["routes"]["/node"]["body"]["node_id"] == nid
        assert scrape["routes"]["/healthz"]["status"] == 200
    assert tdiag.render_table(rows) == _rdiag().render_table(_rdiag().cluster_table(bundle))
    # check: the port's alert engine and store, the reference's verdict
    assert set(port_check) == set(ref_check)
    assert port_check["ok"] == ref_check["ok"]
    assert tdiag.render_check(port_check) == _rdiag().render_check(ref_check)


def test_check_uses_the_ports_alerts_and_timeseries(monkeypatch):
    """``check_nodes`` imports the port's ``runtime/alerts`` and
    ``runtime/timeseries``: with the reference's modules made unimportable
    it still evaluates (an unreachable node fails the gate)."""
    for name in ("tensorlink_tpu.runtime.alerts", "tensorlink_tpu.runtime.timeseries"):
        monkeypatch.setitem(sys.modules, name, None)
    result = asyncio.run(tdiag.check_nodes(["127.0.0.1:1"], timeout=1.0))
    assert result["ok"] is False and result["targets"] == ["127.0.0.1:1"]
    assert "tensorlink_tpu_torch.runtime.alerts" in sys.modules
    assert "tensorlink_tpu_torch.runtime.timeseries" in sys.modules
