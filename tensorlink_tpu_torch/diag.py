"""tldiag — cluster-wide diagnostics over the node status endpoints
(port of ``tensorlink_tpu/diag.py``).

``python -m tensorlink_tpu_torch.diag`` scrapes
``/healthz``, ``/metrics`` (JSON + Prometheus), ``/spans``, ``/events``,
and ``/node`` from a list of node status ports into ONE diagnostic
bundle, prints a cluster health table (dead/unhealthy nodes, stale
heartbeats, stragglers, anomaly counts), and diffs ``BENCH_r*.json``
pairs for step-time/throughput regressions:

    tldiag scrape 127.0.0.1:8080 worker-1:8080 -o bundle.json
    tldiag table bundle.json
    tldiag bench-diff BENCH_r04.json BENCH_r05.json --threshold 0.05
    tldiag manifest-diff hlo.manifest.json /tmp/new-manifest.json

``manifest-diff`` reviews a tlhlo (analysis/hlo.py) manifest
regeneration: per-program direction verdicts — memory/collective bytes
lower-better at a threshold, alias/donated pairs exact (a shrunk alias
count is always a regression: a dropped donation).

The port's copy reads the same endpoints of port and reference nodes
alike, renders the same text, and evaluates ``check`` with the port's
``runtime/alerts`` and ``runtime/timeseries``; the ``tldiag`` console
script stays the reference's. Dependency-free in itself (stdlib +
asyncio sockets — the same
dependency posture as the StatusServer it scrapes) and never touches an
accelerator, so it runs on an operator laptop against a remote cluster.
The scraping API is async (``scrape_cluster``) so in-process tests can
drive it against live asyncio nodes without deadlocking the shared
event loop.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import re
import sys
import time
from typing import Any

# every node serves these (http_status.py); /jobs exists only on
# validators, /kv only on paged serving nodes, /history and /fleet only
# when the time-series sampler is on — all fetched opportunistically
ROUTES = ("/healthz", "/metrics", "/metrics?format=prom", "/spans",
          "/events", "/node", "/jobs", "/history", "/kv", "/fleet",
          "/ledger")


# ------------------------------------------------------------- scraping
async def http_get(
    host: str, port: int, path: str, timeout: float = 5.0
) -> tuple[int, bytes]:
    """Minimal HTTP/1.1 GET -> (status, body). Raises OSError/timeout
    for unreachable targets — callers turn that into a DEAD row."""
    reader, writer = await asyncio.wait_for(
        asyncio.open_connection(host, port), timeout
    )
    try:
        writer.write(
            f"GET {path} HTTP/1.1\r\nHost: {host}\r\n"
            "Connection: close\r\n\r\n".encode()
        )
        await writer.drain()
        raw = await asyncio.wait_for(reader.read(-1), timeout)
    finally:
        writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    parts = head.split()
    if len(parts) < 2 or not parts[1].isdigit():
        raise ConnectionError(f"malformed response from {host}:{port}")
    return int(parts[1]), body


def parse_target(target: str) -> tuple[str, int]:
    """'host:port' or bare 'port' (localhost)."""
    host, _, port = target.rpartition(":")
    return (host or "127.0.0.1"), int(port)


async def scrape_node(target: str, timeout: float = 5.0) -> dict[str, Any]:
    """All routes of one node -> {"target", "routes": {...}, "error"?}.
    A node that answers ANY route is alive; one that answers none is
    recorded with the connection error (the bundle must name dead nodes,
    not skip them)."""
    host, port = parse_target(target)
    out: dict[str, Any] = {"target": target, "routes": {}}
    for path in ROUTES:
        try:
            status, body = await http_get(host, port, path, timeout)
        except (OSError, asyncio.TimeoutError, ConnectionError) as e:
            out["routes"][path] = {"error": f"{type(e).__name__}: {e}"}
            if path == "/healthz":  # first route failing = probably dead
                out["error"] = f"{type(e).__name__}: {e}"
            continue
        rec: dict[str, Any] = {"status": status}
        if "format=prom" in path:
            rec["text"] = body.decode(errors="replace")
        else:
            try:
                rec["body"] = json.loads(body) if body else None
            except ValueError:
                rec["text"] = body.decode(errors="replace")[:2000]
        out["routes"][path] = rec
    if all("error" in r for r in out["routes"].values()):
        out["error"] = out.get("error") or "unreachable"
    return out


async def scrape_cluster(
    targets: list[str], timeout: float = 5.0
) -> dict[str, Any]:
    """One bundle over every target, scraped concurrently."""
    nodes = await asyncio.gather(
        *(scrape_node(t, timeout) for t in targets)
    )
    return {
        "collected_at": time.time(),
        "targets": list(targets),
        "nodes": list(nodes),
    }


# ------------------------------------------------------- health table
# anomaly counters surfaced per row (from each node's /metrics counters)
ANOMALY_COUNTERS = (
    "train_nonfinite_total",
    "peer_dropped_total",
    "dispatch_errors_total",
    "receipt_anomaly_total",
)


def _route_body(scrape: dict, path: str) -> Any:
    return (scrape.get("routes", {}).get(path) or {}).get("body")


def node_row(
    scrape: dict,
    stale_heartbeat_s: float = 30.0,
    skew_threshold: float = 1.5,
) -> dict[str, Any]:
    """One cluster-table row from one node's scrape."""
    row: dict[str, Any] = {
        "target": scrape.get("target"),
        "role": "?",
        "node_id": "?",
        "healthy": None,
        "reasons": "",
        "peers": None,
        "max_heartbeat_age_s": None,
        "skew": None,
        "anomalies": {},
        "error_events": 0,
        "kv_pool_pct": None,
        "spec_accept_pct": None,
        "mfu_pct": None,
        "bubble_pct": None,
        "flags": [],
    }
    if scrape.get("error"):
        row["flags"].append("DEAD")
        row["reasons"] = scrape["error"]
        return row
    hz = scrape.get("routes", {}).get("/healthz") or {}
    body = hz.get("body") or {}
    row["healthy"] = hz.get("status") == 200 and bool(body.get("ok", True))
    if not row["healthy"]:
        row["flags"].append("UNHEALTHY")
        row["reasons"] = "; ".join(
            f"{k}: {v}" for k, v in (body.get("reasons") or {}).items()
        )
    node = _route_body(scrape, "/node") or {}
    row["role"] = node.get("role", "?")
    # disaggregated serving: the ROLE column names the advertised leg
    # (worker/prefill, worker/decode, worker/colocated) straight from
    # the capability record, so the cluster table reads as a serving
    # topology, not just a process list
    serve_mode = (node.get("capability") or {}).get("serving_mode")
    if serve_mode:
        row["role"] = f"{row['role']}/{serve_mode}"
    # pipeline-sharded serving: a loaded stage names its slot in the
    # chain (worker/stage1/3) so the table reads as the pipeline's
    # actual topology — which stage lives where, at a glance
    pcap = node.get("capability") or {}
    if pcap.get("pipe_stage") is not None:
        row["role"] = (
            f"{node.get('role', '?')}/stage{pcap['pipe_stage']}"
            f"/{pcap.get('pipe_n_stages', '?')}"
        )
    row["node_id"] = str(node.get("node_id", "?"))[:16]
    peers = node.get("peers") or {}
    row["peers"] = len(peers)
    ages = [
        p.get("last_seen_age_s")
        for p in peers.values()
        if isinstance(p, dict) and p.get("last_seen_age_s") is not None
    ]
    if ages:
        row["max_heartbeat_age_s"] = round(max(ages), 1)
        if max(ages) > stale_heartbeat_s:
            row["flags"].append("STALE-HEARTBEAT")
    stragglers = node.get("stragglers") or {}
    skew = stragglers.get("skew")
    if skew is not None:
        row["skew"] = round(float(skew), 2)
        if float(skew) > skew_threshold:
            row["flags"].append(
                f"STRAGGLER(stage {stragglers.get('slowest_stage')})"
            )
    serving = node.get("serving") or {}
    pool = serving.get("pool") or {}
    util = pool.get("utilization")
    if util is not None:
        # paged-KV pool pressure (serving nodes): a pool near capacity
        # is the serving analogue of a stale heartbeat — admissions are
        # about to backpressure with PoolExhaustedError
        row["kv_pool_pct"] = round(float(util) * 100, 1)
        if float(util) >= 0.9:
            row["flags"].append(
                f"KV-PRESSURE({pool.get('blocks_in_use')}/"
                f"{pool.get('num_blocks')})"
            )
    spec = serving.get("spec") or {}
    healed = serving.get("spec_self_healed")
    if spec.get("proposed_total"):
        # speculative serving: pathological acceptance means the draft
        # (or n-gram lookup) is a bad match for this node's traffic —
        # every rejected token was a wasted draft step, and below ~0.3
        # the extra passes can cost more than the accepted tokens buy
        acc = float(spec.get("acceptance_rate") or 0.0)
        row["spec_accept_pct"] = round(acc * 100, 1)
        if acc < 0.3 and not healed:
            row["flags"].append(
                f"LOW-ACCEPT({spec.get('mode')},{acc:.2f})"
            )
    if healed:
        # the engine already acted on its own LOW-ACCEPT condition
        # (dropped draft -> n-gram -> non-spec, serving.py
        # _maybe_self_heal): the condition cleared without operator
        # action — advisory flag replaced by the record of the fix
        row["flags"].append(f"SELF-HEALED({healed.get('to')})")
    disagg = serving.get("disagg") or {}
    wire_s = disagg.get("wire_s_ewma")
    pre_s = disagg.get("prefill_s_ewma")
    if wire_s is not None and pre_s is not None and float(wire_s) > float(pre_s):
        # the DCN hop costs more than the prefill compute it ships:
        # this prefill worker is transfer-bound — bigger blocks, better
        # compression, or a closer decode peer would pay more than a
        # faster chip
        row["flags"].append(
            f"XFER-STALLED({float(wire_s):.3f}s>{float(pre_s):.3f}s)"
        )
    adm = serving.get("admission") or {}
    if adm.get("shed_total"):
        # SLO admission control is actively shedding (serving.py
        # OverloadedError): the total is CLIMBING when the last shed is
        # recent — a historical shed from yesterday's burst is history,
        # not a flag. Clients see typed 429s with the retry_after_s
        # this row's /node reports under serving.admission.
        age = adm.get("last_shed_age_s")
        if age is not None and float(age) < 60.0:
            row["flags"].append(f"SHEDDING({adm['shed_total']})")
    # device-time telemetry: the node's CapabilityRecord (/node
    # "capability") or its serving scheduler's device_time attribution.
    # MFU% = best per-program MFU; BUBBLE% = host-gap fraction of the
    # device timeline — above 30% the chip is waiting on the HOST
    # (dispatch, scheduling, input pipeline), not on compute/bandwidth,
    # and more chip will not make that node faster
    cap = node.get("capability") or {}
    dt = serving.get("device_time") or {}
    progs = {**(cap.get("programs") or {}), **(dt.get("programs") or {})}
    mfus = [
        p.get("mfu") for p in progs.values()
        if isinstance(p, dict) and p.get("mfu") is not None
    ]
    # pipeline stages advertise their decode MFU and bubble fraction
    # as capability scalars (pipe_mfu / pipe_bubble_frac) — a stage
    # with a fat bubble is waiting on its NEIGHBOURS' activations, and
    # rebalancing the layer split (not more chip) is the fix
    if cap.get("pipe_mfu") is not None:
        mfus.append(cap["pipe_mfu"])
    if mfus:
        row["mfu_pct"] = round(max(mfus) * 100, 1)
    gap = dt.get(
        "host_gap_frac",
        cap.get("host_gap_frac", cap.get("pipe_bubble_frac")),
    )
    if gap is not None:
        row["bubble_pct"] = round(float(gap) * 100, 1)
        if float(gap) > 0.3:
            row["flags"].append(f"HOST-BOUND({float(gap):.2f})")
    alerts = node.get("alerts") or {}
    firing = (alerts.get("own") or []) + (alerts.get("fleet") or [])
    if firing:
        # SLO burn-rate alerting (runtime/alerts.py): the node itself
        # says which budgets are burning — name the worst offender
        worst = max(
            firing,
            key=lambda a: (a.get("severity") == "error", a.get("name", "")),
        )
        row["flags"].append(f"ALERTS({len(firing)}:{worst.get('name')})")
    metrics = _route_body(scrape, "/metrics") or {}
    counters = metrics.get("counters") or {}
    row["anomalies"] = {
        k: counters[k] for k in ANOMALY_COUNTERS if counters.get(k)
    }
    if row["anomalies"]:
        row["flags"].append("ANOMALIES")
    # receipt auditing (validator rows): a worker billing busy seconds
    # its own published roofline / wall window cannot explain is a
    # metering integrity failure — name the count, `tldiag ledger`
    # names the worker
    ledger = _route_body(scrape, "/ledger") or {}
    oc = (ledger.get("anomalies") or {}).get("overclaim")
    if oc:
        row["flags"].append(f"OVERCLAIM({oc})")
    events = (_route_body(scrape, "/events") or {}).get("events") or []
    row["error_events"] = sum(1 for e in events if e.get("severity") == "error")
    return row


def cluster_table(
    bundle: dict,
    stale_heartbeat_s: float = 30.0,
    skew_threshold: float = 1.5,
) -> list[dict[str, Any]]:
    return [
        node_row(s, stale_heartbeat_s, skew_threshold)
        for s in bundle.get("nodes", [])
    ]


def render_table(rows: list[dict[str, Any]]) -> str:
    cols = ("target", "role", "node_id", "healthy", "peers",
            "max_heartbeat_age_s", "skew", "kv_pool_pct",
            "spec_accept_pct", "mfu_pct", "bubble_pct", "error_events",
            "flags")
    titles = ("TARGET", "ROLE", "NODE", "OK", "PEERS", "HB-AGE",
              "SKEW", "KV%", "SPEC%", "MFU%", "BUBBLE%", "ERR-EVTS",
              "FLAGS")

    def cell(row: dict, col: str) -> str:
        v = row.get(col)
        if col == "flags":
            extra = ",".join(
                f"{k}={n}" for k, n in (row.get("anomalies") or {}).items()
            )
            return ",".join(v or []) + (f" [{extra}]" if extra else "") or "-"
        if v is None:
            return "-"
        return str(v)

    table = [titles] + [[cell(r, c) for c in cols] for r in rows]
    widths = [max(len(line[i]) for line in table) for i in range(len(cols))]
    lines = [
        "  ".join(c.ljust(w) for c, w in zip(line, widths)).rstrip()
        for line in table
    ]
    unhealthy = [
        r for r in rows if r["flags"] or r["healthy"] is False
    ]
    for r in unhealthy:
        if r.get("reasons"):
            lines.append(f"  !! {r['target']}: {r['reasons']}")
    return "\n".join(lines)


# ------------------------------------------------------- bench diffing
# key fragments that say which way "good" points; everything else is
# reported as a delta without a regression verdict
_HIGHER_BETTER = (
    "samples_per_sec", "tokens_per_sec", "mfu", "speedup", "throughput",
    "fraction_attained", "vs_baseline", "tick_over_dispatch",
    # continuous-vs-static serving ratio: 1.0 = parity, higher = the
    # scheduler beats the static batch
    "vs_static",
    # paged KV cache: prefix sharing served MORE prompt tokens from
    # resident blocks
    "hit_rate",
    # speculative decoding: more accepted draft tokens per target
    # weight pass / higher acceptance = more tokens per weight read
    # (the decode-roofline lever); vs_nonspec is spec-over-baseline
    "tokens_per_weight_pass", "acceptance_rate", "vs_nonspec",
    # adaptive speculation: the controller's wall-clock win over the
    # best hand-tuned static K on the same mixed workload (> 1.0 =
    # the measure->adapt loop pays)
    "vs_best_static",
    # device-time telemetry: model-bandwidth utilization and the
    # measured chip HBM bandwidth (capability_hbm_gbps) — more of
    # either is strictly better ("mfu" already matches above)
    "mbu", "gbps",
    # disaggregated serving: tokens/s of the split prefill/decode path
    # over the colocated baseline (1.0 = parity; the wire-byte TOTAL
    # stays deliberately directionless — payload size is a property of
    # the workload — but per-token wire bytes and the KV footprint
    # ratios are regression axes now that int8 pools exist to shrink
    # them, see _LOWER_BETTER_RE)
    "vs_colocated",
    # pipeline-sharded serving: chain tokens/s over the single-node
    # paged baseline on the same traffic (1.0 = parity; > 1.0 = the
    # in-flight microbatching hides the hop latency)
    "vs_single_node",
)
_LOWER_BETTER_RE = re.compile(
    r"(_s$|_s_per_call$|seconds|latency|bubble_frac|drop_fraction"
    # serving latency percentiles (TTFT/TPOT histograms) and the int8
    # quality KL: smaller is better even where the unit suffix differs
    r"|ttft|tpot|(^|_)kl(_|$)"
    # paged KV cache at fixed bench traffic: fewer blocks / lower pool
    # pressure / fewer re-prefilled tokens = the sharing is working
    r"|kv_blocks|kv_pool_utilization|prefilled_tokens|cow_copies"
    # int8 KV blocks: at fixed traffic, a smaller paged-
    # over-contiguous footprint ratio and fewer wire bytes per token
    # are the quantization win (the _total wire key stays undirected —
    # it scales with workload). decode_mbu_* and the kernel-vs-xla
    # tokens/sec ratio ride the existing higher-better fragments.
    r"|kv_footprint|kv_wire_bytes_per_token"
    # speculation at fixed traffic: fewer n-gram misses = the lookup
    # is finding real recurrences
    r"|preempt|spec_fallback"
    # overload robustness (serving_under_load round): shed load and
    # missed deadlines at fixed offered traffic are pure degradation,
    # as is INTERACTIVE p99 growing over its uncontended baseline
    r"|shed_rate|shed_total|deadline_miss|p99_degradation"
    # device-time telemetry: host-gap (pipeline bubble) fraction and
    # the measured always-on timing overhead — both pure waste
    r"|host_gap|overhead_frac"
    # work-receipt auditing (runtime/ledger.py): flagged/rejected
    # receipts at fixed traffic are integrity failures, not volume
    r"|anomal)"
)


def _direction(key: str) -> str | None:
    k = key.lower()
    leaf = k.rsplit(".", 1)[-1]
    if leaf == "value" or any(t in k for t in _HIGHER_BETTER):
        return "higher"
    if _LOWER_BETTER_RE.search(leaf):
        return "lower"
    return None


def _flatten_numeric(d: Any, prefix: str = "") -> dict[str, float]:
    out: dict[str, float] = {}
    if isinstance(d, dict):
        for k, v in d.items():
            out.update(_flatten_numeric(v, f"{prefix}.{k}" if prefix else str(k)))
    elif isinstance(d, bool):
        pass  # bools are not measurements
    elif isinstance(d, (int, float)) and prefix:
        out[prefix] = float(d)
    return out


def _bench_payload(rec: dict) -> dict:
    """Committed BENCH_r*.json wraps the bench's JSON line under
    ``parsed`` (run metadata around it); accept the wrapper, the raw
    bench output, and — when ``parsed`` is null — the bench line
    embedded in the captured ``tail`` text."""
    inner = rec.get("parsed")
    if isinstance(inner, dict):
        return inner
    tail = rec.get("tail")
    if isinstance(tail, str):
        for line in reversed(tail.strip().splitlines()):
            i = line.find('{"metric"')
            if i >= 0:
                try:
                    return json.loads(line[i:])
                except ValueError:
                    break  # front-truncated tail: unrecoverable
    return rec


def bench_diff(
    old: dict, new: dict, threshold: float = 0.05
) -> dict[str, Any]:
    """Per-key relative deltas between two bench records (BENCH_r*.json
    shape). A key regresses when it moved AGAINST its direction by more
    than ``threshold`` (5% default); direction-less keys only report.
    This is a report, never a failure — CI policy belongs to the
    caller."""
    a = _flatten_numeric(_bench_payload(old))
    b = _flatten_numeric(_bench_payload(new))
    keys: dict[str, Any] = {}
    regressions: list[str] = []
    improvements: list[str] = []
    for k in sorted(set(a) & set(b)):
        if a[k] == 0:
            continue  # no meaningful relative delta
        delta = (b[k] - a[k]) / abs(a[k])
        direction = _direction(k)
        rec = {
            "old": a[k],
            "new": b[k],
            "delta_frac": round(delta, 4),
            "direction": direction,
        }
        if direction is not None and abs(delta) > threshold:
            worse = delta < 0 if direction == "higher" else delta > 0
            rec["regression"] = worse
            (regressions if worse else improvements).append(k)
        keys[k] = rec
    return {
        "threshold": threshold,
        "keys": keys,
        "regressions": regressions,
        "improvements": improvements,
        "only_old": sorted(set(a) - set(b)),
        "only_new": sorted(set(b) - set(a)),
    }


def render_bench_diff(diff: dict) -> str:
    lines = [
        f"bench diff (threshold {diff['threshold']:.0%}): "
        f"{len(diff['regressions'])} regression(s), "
        f"{len(diff['improvements'])} improvement(s)"
    ]
    for k in diff["regressions"]:
        r = diff["keys"][k]
        lines.append(
            f"  REGRESSION {k}: {r['old']:g} -> {r['new']:g} "
            f"({r['delta_frac']:+.1%})"
        )
    for k in diff["improvements"]:
        r = diff["keys"][k]
        lines.append(
            f"  improved   {k}: {r['old']:g} -> {r['new']:g} "
            f"({r['delta_frac']:+.1%})"
        )
    return "\n".join(lines)


# ---------------------------------------------------- manifest diffing
# tlhlo's hlo.manifest.json (analysis/hlo.py) pins per-program compiled
# facts; this diff says which way each one MOVED between two manifests —
# the review tool for a --write-manifest regeneration ("what did my
# change do to the compiled programs?"). Memory and collective bytes
# are measurements (lower is better, judged at a threshold); alias /
# donated / program-set facts are EXACT — any change is a verdict, and
# a SHRUNK alias count is always a regression (a dropped donation).
_MANIFEST_LOWER_BETTER = (
    "temp_bytes", "argument_bytes", "output_bytes",
    "f32_dot", "f32_convert", "host_calls",
)


def _manifest_key_direction(key: str) -> str | None:
    leaf = key.rsplit(".", 1)[-1]
    if leaf in _MANIFEST_LOWER_BETTER or key.startswith("collectives."):
        return "lower"
    if leaf in ("alias", "donated"):
        return "exact"
    return None


def manifest_diff(
    old: dict, new: dict, threshold: float = 0.05
) -> dict[str, Any]:
    """Per-program, per-key direction verdicts between two tlhlo
    manifests. Byte measurements regress when they GROW by more than
    ``threshold``; exact keys regress on any unfavorable change
    (alias/donated shrinking); added/removed programs and collective
    kinds are always reported."""
    a = old.get("programs", {})
    b = new.get("programs", {})
    programs: dict[str, Any] = {}
    regressions: list[str] = []
    improvements: list[str] = []
    for name in sorted(set(a) & set(b)):
        fa = _flatten_numeric(a[name])
        fb = _flatten_numeric(b[name])
        keys: dict[str, Any] = {}
        # identity facts are STRINGS (invisible to the numeric flatten):
        # a dtype flip bfloat16->float32 silently switches TLH103 off
        # for that program, so any change here is always a verdict
        for sk in ("dtype", "group"):
            sa, sb = a[name].get(sk), b[name].get(sk)
            if isinstance(sa, str) and isinstance(sb, str) and sa != sb:
                keys[sk] = {
                    "old": sa, "new": sb, "direction": "exact",
                    "regression": True,
                }
                regressions.append(f"{name}.{sk}")
        for k in sorted(set(fa) | set(fb)):
            va, vb = fa.get(k), fb.get(k)
            direction = _manifest_key_direction(k)
            full = f"{name}.{k}"

            def _i(v):  # manifest values are counts/bytes: keep ints
                return int(v) if v is not None and v == int(v) else v

            rec: dict[str, Any] = {
                "old": _i(va), "new": _i(vb), "direction": direction,
            }
            if va is None or vb is None:
                # a collective kind appearing/disappearing IS the event
                rec["regression"] = worse = va is None
                (regressions if worse else improvements).append(full)
            elif direction == "exact":
                if va != vb:
                    rec["regression"] = worse = vb < va
                    (regressions if worse else improvements).append(full)
            elif direction == "lower":
                if va:
                    delta = (vb - va) / abs(va)
                    rec["delta_frac"] = round(delta, 4)
                    if abs(delta) > threshold:
                        rec["regression"] = worse = delta > 0
                        (regressions if worse else improvements).append(full)
                elif vb:
                    # growth from a ZERO pin (first f32 dot, first host
                    # call, first temp byte) is the highest-signal move
                    # these keys make — a relative threshold cannot see
                    # it, so it is always a verdict
                    rec["regression"] = True
                    regressions.append(full)
            keys[k] = rec
        programs[name] = keys
    return {
        "threshold": threshold,
        "programs": programs,
        "regressions": regressions,
        "improvements": improvements,
        "added": sorted(set(b) - set(a)),
        "removed": sorted(set(a) - set(b)),
    }


def render_manifest_diff(diff: dict) -> str:
    lines = [
        f"manifest diff (threshold {diff['threshold']:.0%}): "
        f"{len(diff['regressions'])} regression(s), "
        f"{len(diff['improvements'])} improvement(s), "
        f"{len(diff['added'])} added, {len(diff['removed'])} removed "
        f"program(s)"
    ]

    def _fmt(full: str, tag: str) -> str:
        name, _, key = full.partition(".")
        # program names and collectives.* keys both contain dots —
        # resplit against the program table, LONGEST prefix first
        for prog in sorted(diff["programs"], key=len, reverse=True):
            if full.startswith(prog + "."):
                name, key = prog, full[len(prog) + 1:]
                break
        r = diff["programs"][name][key]
        delta = (
            f" ({r['delta_frac']:+.1%})" if "delta_frac" in r else ""
        )
        return (
            f"  {tag} {name} {key}: {r['old']} -> {r['new']}{delta}"
        )

    for full in diff["regressions"]:
        lines.append(_fmt(full, "REGRESSION"))
    for full in diff["improvements"]:
        lines.append(_fmt(full, "improved  "))
    for name in diff["added"]:
        lines.append(f"  added      {name}")
    for name in diff["removed"]:
        lines.append(f"  removed    {name}")
    return "\n".join(lines)


def proto_manifest_diff(old: dict, new: dict) -> dict[str, Any]:
    """Rolling-upgrade verdicts between two tlproto proto.manifest.json
    files. The compatibility contract (analysis/proto.py TLP4xx): a
    frame or field removal, a value-kind change, an optional field
    turning required, a new required field, or a wire-version bump all
    BREAK mixed-version fleets — an old peer still sends (or bare-reads)
    the old shape. A new frame only needs its pin recorded; a new
    optional field is the one silent evolution the contract allows."""
    a = old.get("frames", {})
    b = new.get("frames", {})
    breaks: list[str] = []
    pins: list[str] = []
    ok: list[str] = []
    frames: dict[str, Any] = {}
    for name in sorted(set(a) - set(b)):
        breaks.append(f"{name}: frame removed")
    for name in sorted(set(b) - set(a)):
        pins.append(f"{name}: frame added")
    for name in sorted(set(a) & set(b)):
        fa = a[name].get("fields", {})
        fb = b[name].get("fields", {})
        verdicts: dict[str, str] = {}
        for f in sorted(set(fa) - set(fb)):
            verdicts[f] = "removed"
            breaks.append(f"{name}.{f}: field removed")
        for f in sorted(set(fb) - set(fa)):
            if fb[f].get("required"):
                verdicts[f] = "added-required"
                breaks.append(
                    f"{name}.{f}: new required field (old senders omit it)"
                )
            else:
                verdicts[f] = "added-optional"
                ok.append(f"{name}.{f}: optional field added")
        for f in sorted(set(fa) & set(fb)):
            ka, kb = fa[f].get("kind"), fb[f].get("kind")
            if ka != kb and "any" not in (ka, kb):
                verdicts[f] = f"kind {ka}->{kb}"
                breaks.append(f"{name}.{f}: kind changed {ka} -> {kb}")
            elif not fa[f].get("required") and fb[f].get("required"):
                verdicts[f] = "now-required"
                breaks.append(
                    f"{name}.{f}: optional field turned required"
                )
        if verdicts:
            frames[name] = verdicts
    va = old.get("versions", {})
    vb = new.get("versions", {})
    for k in sorted(set(va) | set(vb)):
        if va.get(k) == vb.get(k):
            continue
        if k not in va:
            # a version constant born WITH its frame family: no old
            # peer ever sent those frames, so there is nothing to
            # skew against — record the pin like a frame addition
            pins.append(f"version {k}: pinned at {vb.get(k)}")
        else:
            breaks.append(
                f"version {k}: {va.get(k)} -> {vb.get(k)}"
            )
    return {
        "breaks": breaks, "pins": pins, "ok": ok, "frames": frames,
        "compatible": not breaks,
    }


def render_proto_diff(diff: dict) -> str:
    lines = [
        f"proto diff: {len(diff['breaks'])} break(s), "
        f"{len(diff['pins'])} pin update(s), "
        f"{len(diff['ok'])} compatible change(s)"
    ]
    for item in diff["breaks"]:
        lines.append(f"  BREAK {item}")
    for item in diff["pins"]:
        lines.append(f"  pin   {item}")
    for item in diff["ok"]:
        lines.append(f"  ok    {item}")
    if diff["compatible"]:
        lines.append("  rolling upgrade: safe (additive-optional only)")
    else:
        lines.append(
            "  rolling upgrade: UNSAFE — drain the fleet or version-gate"
        )
    return "\n".join(lines)


def latest_bench_record(root: str) -> tuple[str, dict] | None:
    """Newest USABLE committed BENCH_r*.json under ``root`` (descending
    round order; a round whose payload has no headline value or recorded
    an error — failed run, truncated capture — is skipped so bench.py
    never diffs a real run against noise). Returns (filename, record)
    or None."""
    import os

    try:
        names = os.listdir(root)
    except OSError:
        return None
    rounds = sorted(
        (
            (int(m.group(1)), name)
            for name in names
            if (m := re.fullmatch(r"BENCH_r(\d+)\.json", name))
        ),
        reverse=True,
    )
    for _, name in rounds:
        try:
            with open(os.path.join(root, name)) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        payload = _bench_payload(rec)
        if payload.get("value") and "error" not in payload:
            return name, rec
    return None


# ------------------------------------------------------- /profile pull
async def fetch_profile(
    target: str, ms: int = 200, timeout: float | None = None
) -> dict[str, Any]:
    """Trigger a bounded ``GET /profile?ms=N`` capture on one node and
    return its parsed payload (op_breakdown bundle). The HTTP timeout
    covers the capture duration plus slack; a 409 means another capture
    is already running there."""
    host, port = parse_target(target)
    status, body = await http_get(
        host, port, f"/profile?ms={int(ms)}",
        timeout or (ms / 1000.0 + 15.0),
    )
    try:
        payload = json.loads(body) if body else None
    except ValueError:
        payload = {"text": body.decode(errors="replace")[:2000]}
    return {"target": target, "status": status, "body": payload}


def merge_profile_into_bundle(path: str, rec: dict[str, Any]) -> None:
    """Attach a fetched /profile capture to a saved scrape bundle (the
    node entry matching the target gains a ``/profile`` route; a fresh
    bundle is created when the file does not exist)."""
    import os

    if os.path.exists(path):
        with open(path) as f:
            bundle = json.load(f)
    else:
        bundle = {"collected_at": time.time(),
                  "targets": [rec["target"]], "nodes": []}
    node = next(
        (n for n in bundle.get("nodes", [])
         if n.get("target") == rec["target"]),
        None,
    )
    if node is None:
        node = {"target": rec["target"], "routes": {}}
        bundle.setdefault("nodes", []).append(node)
    node.setdefault("routes", {})["/profile"] = {
        "status": rec["status"], "body": rec["body"],
    }
    with open(path, "w") as f:
        json.dump(bundle, f)


def render_profile(rec: dict[str, Any]) -> str:
    body = rec.get("body") or {}
    if rec.get("status") != 200:
        return (
            f"{rec['target']}: /profile -> HTTP {rec.get('status')} "
            f"({(body or {}).get('error', '?')})"
        )
    ob = body.get("op_breakdown") or {}
    lines = [
        f"{rec['target']}: {body.get('duration_ms')} ms capture, "
        f"{ob.get('total_s', 0.0):.4f}s device time"
    ]
    for cat, d in list((ob.get("categories") or {}).items())[:8]:
        lines.append(
            f"  {cat}: {d['s']:.4f}s ({d['fraction']:.1%}, {d['ops']} ops)"
        )
    if not ob.get("categories"):
        lines.append(
            "  (no device events — CPU captures carry none; "
            "this is a GPU instrument)"
        )
    if body.get("trace_dir"):
        lines.append(f"  raw capture retained at {body['trace_dir']}")
    return "\n".join(lines)


# ----------------------------------------------- fleet watch / history
_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float], width: int = 32) -> str:
    """Unicode sparkline over the LAST ``width`` points, scaled to the
    visible min/max (a flat series renders as a flat low bar)."""
    vs = [float(v) for v in values][-width:]
    if not vs:
        return ""
    lo, hi = min(vs), max(vs)
    span = hi - lo
    if span <= 0:
        return _SPARK[0] * len(vs)
    return "".join(
        _SPARK[min(len(_SPARK) - 1, int((v - lo) / span * len(_SPARK)))]
        for v in vs
    )


# the dashboard's default panel: one sparkline per series per frame
WATCH_SERIES = (
    "serving_ttft_s.p99", "serving_tpot_s.p99",
    "kv_pool_utilization", "serving_requests_total",
)


async def fetch_fleet_frame(
    target: str,
    series: tuple[str, ...] = WATCH_SERIES,
    window_s: float = 120.0,
    timeout: float = 5.0,
) -> dict[str, Any]:
    """One dashboard frame: the /fleet summary plus a rolled query per
    watched series (only those the fleet has actually seen)."""
    host, port = parse_target(target)
    frame: dict[str, Any] = {"target": target, "t": time.time()}
    status, body = await http_get(host, port, "/fleet", timeout)
    if status != 200:
        raise ConnectionError(f"/fleet -> HTTP {status}")
    summary = json.loads(body)
    frame["summary"] = summary
    known = set(summary.get("series") or [])
    since = time.time() - window_s
    frame["queries"] = {}
    for name in series:
        if name not in known:
            continue
        _, qbody = await http_get(
            host, port, f"/fleet?series={name}&since={since}", timeout
        )
        try:
            frame["queries"][name] = json.loads(qbody)
        except ValueError:
            continue
    return frame


def render_watch(frame: dict[str, Any]) -> str:
    """One ANSI-free dashboard frame (the caller adds clear-screen):
    fleet sparklines, per-node last values + KV residency, active
    alerts."""
    summary = frame.get("summary") or {}
    nodes = summary.get("nodes") or {}
    when = time.strftime("%H:%M:%S", time.localtime(frame.get("t")))
    lines = [
        f"tldiag watch {frame.get('target')}  {when}  "
        f"{len(nodes)} node(s) reporting"
    ]
    queries = frame.get("queries") or {}
    if queries:
        lines.append("")
        namew = max(len(n) for n in queries)
        for name, q in queries.items():
            pts = q.get("fleet") or []
            vals = [p[1] for p in pts]
            last = f"{vals[-1]:g}" if vals else "-"
            lines.append(
                f"  {name.ljust(namew)}  {sparkline(vals):32s}  {last}"
            )
    if nodes:
        lines.append("")
        lines.append(
            "  NODE              AGE-S   KV-OCC  FRAG    CHAINS  SERIES"
        )
        for nid, rec in sorted(nodes.items()):
            kv = rec.get("kv") or {}
            age = rec.get("last_seen_age_s")
            lines.append(
                "  {:<16s}  {:<6s}  {:<6s}  {:<6s}  {:<6s}  {}".format(
                    nid[:16],
                    "-" if age is None else f"{age:.1f}",
                    "-" if "occupancy" not in kv
                    else f"{kv['occupancy']:.2f}",
                    "-" if "fragmentation" not in kv
                    else f"{kv['fragmentation']:.2f}",
                    "-" if "chains" not in kv else str(kv["chains"]),
                    len(rec.get("series") or []),
                )
            )
    alerts = summary.get("alerts") or {}
    firing = (alerts.get("own") or []) + (alerts.get("fleet") or [])
    lines.append("")
    if firing:
        lines.append(f"  ACTIVE ALERTS ({len(firing)}):")
        for a in firing:
            lines.append(
                f"    [{a.get('severity', '?'):5s}] {a.get('name')}: "
                f"{a.get('detail', '')}"
            )
    else:
        lines.append("  no active alerts")
    return "\n".join(lines)


async def watch_loop(
    target: str,
    interval: float = 2.0,
    iterations: int | None = None,
    series: tuple[str, ...] = WATCH_SERIES,
    out=None,
) -> int:
    """Poll /fleet and redraw. A TTY gets an ANSI clear per frame; a
    pipe (or --once) gets plain frames, newline-separated — the same
    renderer, so tests and terminals see identical content."""
    out = out or sys.stdout
    live = iterations is None and out.isatty()
    n = 0
    while True:
        try:
            frame = await fetch_fleet_frame(target, series)
            text = render_watch(frame)
        except (OSError, ConnectionError, asyncio.TimeoutError, ValueError) as e:
            text = f"tldiag watch {target}: {type(e).__name__}: {e}"
        if live:
            out.write("\x1b[2J\x1b[H" + text + "\n")
        else:
            out.write(text + "\n")
        out.flush()
        n += 1
        if iterations is not None and n >= iterations:
            return 0
        await asyncio.sleep(interval)


async def fetch_history(
    target: str,
    series: str | None = None,
    since: float | None = None,
    step: float | None = None,
    timeout: float = 5.0,
) -> dict[str, Any]:
    """GET /history from one node: the series catalog when ``series``
    is None, else that series' ring contents."""
    host, port = parse_target(target)
    path = "/history"
    if series:
        path += f"?series={series}"
        if since is not None:
            path += f"&since={since}"
        if step is not None:
            path += f"&step={step}"
    status, body = await http_get(host, port, path, timeout)
    payload = json.loads(body) if body else {}
    if status != 200:
        raise ConnectionError(
            f"/history -> HTTP {status}: {payload.get('error', '?')}"
        )
    return payload


def render_history(payload: dict[str, Any]) -> str:
    if "points" not in payload:  # catalog form
        tiers = ", ".join(
            f"{s:g}s x {n}" for s, n in payload.get("tiers") or []
        )
        lines = [f"retention tiers: {tiers}"]
        lines += [f"  {name}" for name in payload.get("series") or []]
        return "\n".join(lines)
    pts = payload.get("points") or []
    lines = [
        f"{payload.get('series')} ({payload.get('kind')}, "
        f"step {payload.get('step'):g}s, {len(pts)} point(s))"
    ]
    vals = [p[1] for p in pts]
    if vals:
        lines.append(f"  {sparkline(vals, width=64)}")
    for t, v in pts:
        when = time.strftime("%H:%M:%S", time.localtime(t))
        lines.append(f"  {when}  {v:g}")
    return "\n".join(lines)


# ------------------------------------------------- work-receipt ledger
async def fetch_ledger(target: str, timeout: float = 5.0) -> dict[str, Any]:
    """GET /ledger from a validator: the receipt auditor's per-tenant /
    per-worker rollups and anomaly tallies (runtime/ledger.py)."""
    host, port = parse_target(target)
    status, body = await http_get(host, port, "/ledger", timeout)
    payload = json.loads(body) if body else {}
    if status != 200:
        raise ConnectionError(
            f"/ledger -> HTTP {status}: {payload.get('error', '?')} "
            "(only nodes carrying a ReceiptAuditor — validators — "
            "serve this route)"
        )
    return payload


def _ledger_table(rows: dict[str, dict], label: str) -> list[str]:
    head = (f"{label:<20} {'receipts':>8} {'prompt':>8} {'emitted':>8} "
            f"{'observed':>8} {'busy_s':>9} {'kv_blk_s':>9} "
            f"{'wire_kb':>8} {'anom':>5}")
    out = [head, "-" * len(head)]
    for key, r in sorted(
        rows.items(), key=lambda kv: -kv[1].get("emitted_tokens", 0)
    ):
        obs = r.get("observed_tokens")
        out.append(
            f"{key[:20]:<20} {r.get('receipts', 0):>8} "
            f"{r.get('prompt_tokens', 0):>8} "
            f"{r.get('emitted_tokens', 0):>8} "
            f"{obs if obs is not None else '-':>8} "
            f"{r.get('busy_s', 0.0):>9.3f} "
            f"{r.get('kv_block_s', 0.0):>9.1f} "
            f"{r.get('wire_bytes', 0) / 1024:>8.1f} "
            f"{r.get('anomalies', 0):>5}"
        )
    return out


def render_ledger(payload: dict[str, Any]) -> str:
    lines = [
        f"receipts: {payload.get('accepted_total', 0)} accepted, "
        f"{payload.get('rejected_total', 0)} rejected; "
        f"{payload.get('observed_tokens_total', 0)} user-observed "
        "token(s)"
    ]
    anomalies = payload.get("anomalies") or {}
    if anomalies:
        lines.append("anomalies: " + ", ".join(
            f"{k}={v}" for k, v in sorted(anomalies.items())
        ))
    tenants = payload.get("tenants") or {}
    if tenants:
        lines.append("")
        lines += _ledger_table(tenants, "tenant")
    workers = payload.get("workers") or {}
    if workers:
        lines.append("")
        lines += _ledger_table(workers, "worker")
        flagged = [
            (k, r["last_anomaly"]) for k, r in workers.items()
            if r.get("last_anomaly")
        ]
        for wid, why in flagged:
            lines.append(f"  !! {wid[:20]}: last anomaly {why}")
    if not tenants and not workers:
        lines.append("(no receipts ingested yet)")
    return "\n".join(lines)


# ------------------------------------------------------- SLO gate (CI)
async def check_nodes(
    targets: list[str],
    slo: dict | str | None = None,
    timeout: float = 5.0,
) -> dict[str, Any]:
    """Evaluate the SLO rule set against each node's served /history
    rings — the CI gate behind ``tldiag check``. A node is judged on
    ITS OWN recorded telemetry (scraped, rebuilt into a local store,
    evaluated at the node's newest sample time so operator/node clock
    skew cannot fake or mask a burn). Unreachable nodes and nodes
    without /history FAIL — a gate that cannot see is not passing."""
    from tensorlink_tpu_torch.runtime.alerts import (
        AlertEngine, default_rules, load_rules,
    )
    from tensorlink_tpu_torch.runtime.timeseries import TimeSeriesStore

    rules = load_rules(slo) if slo else default_rules()
    needed = set()
    for r in rules:
        for name in (r.series, r.numerator, r.denominator):
            if name:
                needed.add(name)
    out: dict[str, Any] = {"targets": list(targets), "nodes": {}, "firing": []}
    for target in targets:
        rec: dict[str, Any] = {"alerts": [], "error": None}
        out["nodes"][target] = rec
        try:
            catalog = await fetch_history(target, timeout=timeout)
            store = TimeSeriesStore()
            newest = None
            for name in sorted(needed & set(catalog.get("series") or [])):
                q = await fetch_history(target, series=name, timeout=timeout)
                kind = q.get("kind") or "gauge"
                for t, v in q.get("points") or []:
                    store.record(name, float(v), kind, now=float(t))
                    if newest is None or t > newest:
                        newest = t
            engine = AlertEngine(rules)
            alerts = engine.evaluate(store, now=newest)
            rec["alerts"] = alerts
            for a in alerts:
                out["firing"].append({**a, "target": target})
        except (OSError, ConnectionError, asyncio.TimeoutError, ValueError) as e:
            rec["error"] = f"{type(e).__name__}: {e}"
            out["firing"].append({
                "name": f"unreachable@{target}", "target": target,
                "severity": "error", "detail": rec["error"],
            })
    out["ok"] = not out["firing"]
    return out


def render_check(result: dict[str, Any], fmt: str = "text") -> str:
    """``--format github`` emits workflow-command annotations — one
    ``::error``/``::warning`` line per firing alert, which the Actions
    runner turns into PR annotations; plain text otherwise."""
    lines = []
    if fmt == "github":
        for a in result["firing"]:
            level = "error" if a.get("severity") == "error" else "warning"
            detail = str(a.get("detail", "")).replace("\n", " ")
            lines.append(
                f"::{level} title=SLO {a.get('name')} "
                f"({a.get('target')})::{detail}"
            )
        if result["ok"]:
            lines.append("::notice title=SLO check::all targets within SLO")
        return "\n".join(lines)
    for target, rec in result["nodes"].items():
        if rec.get("error"):
            lines.append(f"{target}: UNREACHABLE ({rec['error']})")
        elif rec["alerts"]:
            lines.append(f"{target}: {len(rec['alerts'])} alert(s) firing")
            for a in rec["alerts"]:
                lines.append(
                    f"  [{a.get('severity', '?'):5s}] {a.get('name')}: "
                    f"{a.get('detail', '')}"
                )
        else:
            lines.append(f"{target}: ok")
    lines.append("SLO check: " + ("PASS" if result["ok"] else "FAIL"))
    return "\n".join(lines)


# ------------------------------------------------------------------ CLI
def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tldiag",
        description="cluster diagnostics over node status endpoints",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    sc = sub.add_parser("scrape", help="collect a diagnostic bundle")
    sc.add_argument("targets", nargs="+", metavar="HOST:PORT")
    sc.add_argument("-o", "--out", default=None,
                    help="write the full bundle JSON here")
    sc.add_argument("--timeout", type=float, default=5.0)
    sc.add_argument("--stale-heartbeat-s", type=float, default=30.0)
    sc.add_argument("--skew-threshold", type=float, default=1.5)
    tb = sub.add_parser("table", help="health table from a saved bundle")
    tb.add_argument("bundle", help="bundle JSON from `tldiag scrape -o`")
    tb.add_argument("--stale-heartbeat-s", type=float, default=30.0)
    tb.add_argument("--skew-threshold", type=float, default=1.5)
    bd = sub.add_parser(
        "bench-diff", help="flag regressions between two BENCH_r*.json"
    )
    bd.add_argument("old")
    bd.add_argument("new")
    bd.add_argument("--threshold", type=float, default=0.05,
                    help="relative delta beyond which a directional key "
                         "counts as moved (default 5%%)")
    bd.add_argument("--json", action="store_true", dest="as_json",
                    help="print the full diff as JSON")
    pf = sub.add_parser(
        "profile",
        help="trigger a bounded profiler capture on one node "
             "(GET /profile?ms=N) and print the op breakdown",
    )
    pf.add_argument("target", metavar="HOST:PORT")
    pf.add_argument("--ms", type=int, default=200,
                    help="capture duration in milliseconds (server "
                         "clamps to its bound)")
    pf.add_argument("-o", "--out", default=None,
                    help="attach the capture to this bundle JSON "
                         "(created if missing)")
    pf.add_argument("--timeout", type=float, default=None)
    md = sub.add_parser(
        "manifest-diff",
        help="direction verdicts between two tlhlo hlo.manifest.json "
             "(memory/collective bytes lower-better, alias pairs exact)",
    )
    md.add_argument("old")
    md.add_argument("new")
    md.add_argument("--threshold", type=float, default=0.05,
                    help="relative growth beyond which a byte "
                         "measurement regresses (default 5%%)")
    md.add_argument("--json", action="store_true", dest="as_json",
                    help="print the full diff as JSON")
    pd = sub.add_parser(
        "proto-diff",
        help="rolling-upgrade verdicts between two tlproto "
             "proto.manifest.json (removals/kind changes break, "
             "additive-optional is safe); exit 1 on breaks",
    )
    pd.add_argument("old")
    pd.add_argument("new")
    pd.add_argument("--json", action="store_true", dest="as_json",
                    help="print the full diff as JSON")
    wa = sub.add_parser(
        "watch",
        help="live fleet dashboard: poll a validator's /fleet and "
             "redraw sparklines, KV residency, and active alerts",
    )
    wa.add_argument("target", metavar="HOST:PORT",
                    help="a node running the fleet rollup (validator)")
    wa.add_argument("--interval", type=float, default=2.0)
    wa.add_argument("--once", action="store_true",
                    help="print one frame and exit (CI / pipes)")
    wa.add_argument("--series", action="append", default=None,
                    metavar="NAME",
                    help="series to sparkline (repeatable; default: "
                         "TTFT/TPOT p99, KV utilization, request rate)")
    hi = sub.add_parser(
        "history",
        help="one node's on-board ring buffers (GET /history): the "
             "series catalog, or one series' retained points",
    )
    hi.add_argument("target", metavar="HOST:PORT")
    hi.add_argument("--series", default=None, metavar="NAME")
    hi.add_argument("--since", type=float, default=None,
                    help="unix time lower bound (default: whole ring)")
    hi.add_argument("--step", type=float, default=None,
                    help="preferred bucket seconds (picks the tier)")
    hi.add_argument("--json", action="store_true", dest="as_json")
    lg = sub.add_parser(
        "ledger",
        help="per-tenant / per-worker metering rollups from a "
             "validator's receipt auditor (GET /ledger)",
    )
    lg.add_argument("target", metavar="HOST:PORT",
                    help="a node carrying a ReceiptAuditor (validator)")
    lg.add_argument("--json", action="store_true", dest="as_json")
    lg.add_argument("--timeout", type=float, default=5.0)
    ck = sub.add_parser(
        "check",
        help="SLO gate: evaluate alert rules against each node's "
             "/history rings; exit 1 if any alert fires",
    )
    ck.add_argument("targets", nargs="+", metavar="HOST:PORT")
    ck.add_argument("--slo", default=None,
                    help="SLO rule file (runtime/alerts.py compact or "
                         "explicit form); default rule set if omitted")
    ck.add_argument("--format", choices=("text", "github"),
                    default="text",
                    help="github: ::error/::warning workflow-command "
                         "annotations for Actions")
    ck.add_argument("--timeout", type=float, default=5.0)
    args = ap.parse_args(argv)

    if args.cmd == "scrape":
        bundle = asyncio.run(scrape_cluster(args.targets, args.timeout))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(bundle, f)
            print(f"bundle written: {args.out}", file=sys.stderr)
        rows = cluster_table(
            bundle, args.stale_heartbeat_s, args.skew_threshold
        )
        print(render_table(rows))
        return 0
    if args.cmd == "table":
        with open(args.bundle) as f:
            bundle = json.load(f)
        print(render_table(cluster_table(
            bundle, args.stale_heartbeat_s, args.skew_threshold
        )))
        return 0
    if args.cmd == "bench-diff":
        with open(args.old) as f:
            old = json.load(f)
        with open(args.new) as f:
            new = json.load(f)
        diff = bench_diff(old, new, args.threshold)
        print(json.dumps(diff) if args.as_json else render_bench_diff(diff))
        return 0
    if args.cmd == "profile":
        rec = asyncio.run(fetch_profile(args.target, args.ms, args.timeout))
        if args.out:
            merge_profile_into_bundle(args.out, rec)
            print(f"capture attached to: {args.out}", file=sys.stderr)
        print(render_profile(rec))
        return 0 if rec.get("status") == 200 else 1
    if args.cmd == "manifest-diff":
        with open(args.old) as f:
            old = json.load(f)
        with open(args.new) as f:
            new = json.load(f)
        diff = manifest_diff(old, new, args.threshold)
        print(
            json.dumps(diff) if args.as_json
            else render_manifest_diff(diff)
        )
        return 0
    if args.cmd == "proto-diff":
        with open(args.old) as f:
            old = json.load(f)
        with open(args.new) as f:
            new = json.load(f)
        diff = proto_manifest_diff(old, new)
        print(
            json.dumps(diff) if args.as_json else render_proto_diff(diff)
        )
        return 0 if diff["compatible"] else 1
    if args.cmd == "watch":
        series = tuple(args.series) if args.series else WATCH_SERIES
        try:
            return asyncio.run(watch_loop(
                args.target, args.interval,
                iterations=1 if args.once else None, series=series,
            ))
        except KeyboardInterrupt:
            return 0
    if args.cmd == "history":
        try:
            payload = asyncio.run(fetch_history(
                args.target, args.series, args.since, args.step,
            ))
        except (OSError, ConnectionError, asyncio.TimeoutError) as e:
            print(f"{args.target}: {e}", file=sys.stderr)
            return 1
        print(json.dumps(payload) if args.as_json
              else render_history(payload))
        return 0
    if args.cmd == "ledger":
        try:
            payload = asyncio.run(fetch_ledger(args.target, args.timeout))
        except (OSError, ConnectionError, asyncio.TimeoutError) as e:
            print(f"{args.target}: {e}", file=sys.stderr)
            return 1
        print(json.dumps(payload) if args.as_json
              else render_ledger(payload))
        return 0
    if args.cmd == "check":
        result = asyncio.run(check_nodes(
            args.targets, args.slo, timeout=args.timeout,
        ))
        print(render_check(result, args.format))
        return 0 if result["ok"] else 1
    return 2  # pragma: no cover — argparse enforces the subcommands


if __name__ == "__main__":
    sys.exit(main())
