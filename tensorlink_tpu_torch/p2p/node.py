"""Base overlay node: listener, mutual-auth handshake, typed dispatch, DHT RPC.

The asyncio re-design of the reference's SmartNode thread
(src/p2p/smart_node.py:103-967): same protocol concepts — handshake,
tag-dispatched messages, recursive DHT lookup with timeout + exclusion,
ping latency, per-peer stats/reputation, ghost accounting — but structured
concurrency instead of thread-per-peer, typed msgpack instead of byte-tag
prefixes, and request/response correlation by message id instead of
busy-wait polling shared dicts.

The port's copy of ``tensorlink_tpu/p2p/node.py``: the same wire (HELLO /
HELLO_ACK / HELLO_FIN, typed msgpack frames through the port's own codec,
whose bytes equal msgpack's), handlers, clamps and telemetry, so a port
node and a reference node talk to each other. ``_build_serving`` builds
the port's serving engines; ``handle_kv_blocks`` and ``handle_act_fwd``
stay role hooks.
"""

from __future__ import annotations

import asyncio
import functools
import random
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Sequence

from tensorlink_tpu_torch.config import NodeConfig
from tensorlink_tpu_torch.p2p.connection import FramedStream
from tensorlink_tpu_torch.p2p.crypto import Identity, new_nonce
from tensorlink_tpu_torch.p2p.dht import DHT, PeerInfo
from tensorlink_tpu_torch.p2p.serialization import decode_message, encode_message
from tensorlink_tpu_torch.utils.logging import get_logger

Handler = Callable[["Node", "Peer", dict], Awaitable[Any]]


def wire_guard(fn):
    """Malformed-frame backstop for wire handlers: a peer-controlled
    field that is missing or mistyped must produce a typed ERROR reply,
    not a handler crash. Handlers still validate the fields that matter
    (better error messages, targeted counters); this wrapper is the
    last line, so no hostile frame shape can take the handler task down
    or leave a requester waiting on a reply that never comes.

    tlproto treats reads inside a ``@wire_guard`` def as guarded."""

    @functools.wraps(fn)
    async def wrapped(self, node, peer, msg):
        try:
            return await fn(self, node, peer, msg)
        except (KeyError, TypeError, ValueError, IndexError,
                AttributeError) as e:
            return self._reject_malformed(peer, msg, e)

    wrapped.__wire_guarded__ = True
    return wrapped


@dataclass
class Peer:
    info: PeerInfo
    stream: FramedStream
    reputation: float = 1.0
    ping_ms: float | None = None
    ghosts: int = 0  # unsolicited/malformed messages (reference ghost stat)
    msgs_in: int = 0
    msgs_out: int = 0
    connected_at: float = field(default_factory=time.time)
    # wall time of the last frame received from this peer: the straggler
    # report's heartbeat age (a slow stage whose heartbeat is also stale
    # is dead, not slow)
    last_seen: float = field(default_factory=time.time)

    @property
    def node_id(self) -> str:
        return self.info.node_id

    @property
    def role(self) -> str:
        return self.info.role


class Node:
    """Run with `await node.start()`; subclass roles register handlers in
    `register_handlers` via `self.on("TYPE", coro)`."""

    def __init__(self, cfg: NodeConfig, identity: Identity | None = None):
        self.cfg = cfg
        self.identity = identity or (
            Identity.load_or_generate(cfg.key_dir, cfg.role)
            if cfg.key_dir
            else Identity.generate()
        )
        self.node_id = self.identity.node_id
        self.role = cfg.role
        self.dht = DHT(self.node_id, replication=cfg.dht_replication)
        self.peers: dict[str, Peer] = {}
        self.log = get_logger(f"{cfg.role}.{self.node_id[:8]}")
        self._handlers: dict[str, Handler] = {}
        self._stream_kinds: dict[str, Any] = {}  # kind -> factory
        self._streams: dict[str, dict] = {}  # sid -> assembly state
        self._pending: dict[str, asyncio.Future] = {}
        self._pending_peer: dict[str, str] = {}  # msg id -> peer node_id
        # dials in flight by the node id they expect (connect_candidates):
        # a second caller joins the first dial instead of opening another
        self._dials: dict[str, asyncio.Task] = {}
        self._server: asyncio.AbstractServer | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._tasks: set[asyncio.Task] = set()
        self.port: int | None = None
        self.external_ip: str | None = None  # set by UPnP mapping
        self._lan_ip: str | None = None  # routable local addr (UPnP/detected)
        self._upnp_gateway = None
        self.started = asyncio.Event()
        self._stopping = False
        self._http = None
        from tensorlink_tpu_torch.runtime.metrics import Metrics

        self.metrics = Metrics()  # published via GET /metrics
        # runtime.* imports stay out of module scope on purpose (same as
        # Metrics above), as in the reference: tooling that only speaks
        # the wire need not load the runtime
        from tensorlink_tpu_torch.runtime.tracing import (
            Tracer,
            current_trace_context,
        )

        # span buffer published via GET /spans (runtime/tracing.py);
        # spans propagate to peers through the _trace envelope field
        self.tracer = Tracer(service=f"{cfg.role}:{self.node_id[:8]}")
        self._trace_ctx = current_trace_context  # hot-path binding (send)
        from tensorlink_tpu_torch.runtime import chaos
        from tensorlink_tpu_torch.runtime.flight import FlightRecorder, HealthState

        # fault-injection hook handle (runtime/chaos.py): the hot-path
        # guard is one attribute read + identity test on
        # ``_chaos.ACTIVE`` — a disarmed harness costs nothing
        self._chaos = chaos
        # jittered-exponential-backoff RNG for request_idempotent;
        # tests seed it for deterministic retry schedules
        self._retry_rng = random.Random()
        # black box (runtime/flight.py): ring of lifecycle/failure events
        # published via GET /events; health computed from watchdogs +
        # readiness conditions, served as a truthful GET /healthz
        self.flight = FlightRecorder(service=f"{cfg.role}:{self.node_id[:8]}")
        self.health = HealthState(self.flight)
        self._traffic_dog = None  # armed by start_heartbeat
        # device-capability publishing (runtime/profiling.py): this
        # node's own measured record (set by WorkerNode's microbench or
        # by an operator) rides every PONG, and records harvested from
        # peers' PONGs form the live fleet table a validator's /node
        # serves — the placement input ROADMAP item 1 consumes
        self.capability: dict | None = None
        self.peer_capabilities: dict[str, dict] = {}
        from tensorlink_tpu_torch.runtime.alerts import (
            AlertEngine,
            default_rules,
            load_rules,
        )
        from tensorlink_tpu_torch.runtime.timeseries import (
            FleetStore,
            TimeSeriesStore,
        )

        # bounded ring-buffer history of every metric (GET /history,
        # postmortem rings, the heartbeat-delta source); None = off
        # (the observability-overhead bench flips this)
        self.timeseries = (
            TimeSeriesStore() if cfg.timeseries_enabled else None
        )
        # per-peer rings rolled up from heartbeat-PONG metric deltas —
        # populated on whichever node runs start_heartbeat (the
        # validator in practice) and served at GET /fleet
        self.fleet_series = FleetStore()
        _rules = (
            load_rules(cfg.slo_path) if cfg.slo_path else default_rules()
        )
        # own-SLO engine: firing alerts become health conditions (503);
        # the fleet engine watches PEERS — their burn must not mark
        # this node unready, so no health hookup there
        self.alerts = AlertEngine(
            _rules, recorder=self.flight, health=self.health,
            metrics=self.metrics,
        )
        self.fleet_alerts = AlertEngine(
            _rules, recorder=self.flight, metrics=self.metrics
        )
        self.register_handlers()

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> None:
        self._loop = asyncio.get_running_loop()
        port = self.cfg.port
        if port < 0:
            # upward scan from base_port (reference smart_node.py:949-967);
            # port=0 stays OS-assigned, the cleaner default
            from tensorlink_tpu_torch.p2p.nat import scan_bind_port

            port = await asyncio.to_thread(
                scan_bind_port, self.cfg.host, self.cfg.base_port
            )
        self._server = await asyncio.start_server(
            self._accept, self.cfg.host, port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        if self.cfg.host == "0.0.0.0" and self._lan_ip is None:
            # wildcard bind: discover the routable source address so info
            # never advertises 0.0.0.0 (reference's UDP trick,
            # smart_node.py:120-123); no packet is actually sent
            try:
                from tensorlink_tpu_torch.p2p.nat import _local_ip_toward

                # start() runs once per node, before any handler can
                # touch _lan_ip — the check-then-act straddle is safe here
                self._lan_ip = await asyncio.to_thread(  # tlint: disable=TL102
                    _local_ip_toward, "8.8.8.8"
                )
            except OSError:
                pass
            if self._lan_ip is None:
                self.log.warning(
                    "bound 0.0.0.0 but could not detect a routable local "
                    "address — this node will advertise 0.0.0.0, which "
                    "remote peers cannot dial; set --host to the LAN address"
                )
        if self.cfg.upnp:
            await self._init_upnp()
        if self.cfg.http_status_port is not None:
            from tensorlink_tpu_torch.runtime.http_status import StatusServer

            self._http = StatusServer(
                self, self.cfg.host, self.cfg.http_status_port
            )
            await self._http.start()
            self.log.info("status endpoint on :%s", self._http.bound_port)
        if self.cfg.dht_snapshot_path:
            self._restore_dht_snapshot()
            self._spawn(self._dht_snapshot_loop())
        self._spawn(self._health_loop())
        if self.timeseries is not None:
            self._spawn(self._timeseries_loop())
        self.started.set()
        self.flight.record(
            "node_started", host=self.cfg.host, port=self.port,
            role=self.role,
        )
        self.log.info("listening on %s:%s", self.cfg.host, self.port)

    async def _health_loop(self) -> None:
        """Sentinel tick: event-loop lag probe (the overshoot of a timed
        sleep IS the lag every other coroutine experienced), watchdog
        trip-edge checks (events fire between scrapes, not only when
        /healthz is polled), and memory watermark gauges."""
        from tensorlink_tpu_torch.runtime.flight import sample_memory_watermarks

        interval = self.cfg.health_interval_s
        loop = asyncio.get_running_loop()
        while not self._stopping:
            t0 = loop.time()
            await asyncio.sleep(interval)
            self.health.note_loop_lag(max(0.0, loop.time() - t0 - interval))
            self.metrics.observe("event_loop_lag_s", self.health.loop_lag_s)
            self.health.check_watchdogs()
            sample_memory_watermarks(self.metrics)

    async def _timeseries_loop(self) -> None:
        """Ring sampler tick: fold every metric into the retention
        tiers, refresh the KV residency gauges (a quiescent engine's
        occupancy must not flatline at its last step's value), and
        evaluate the SLO rules — own metrics into health conditions,
        harvested peer rings into the fleet alert table."""
        interval = self.cfg.timeseries_interval_s
        while not self._stopping:
            await asyncio.sleep(interval)
            try:
                self.timeseries.sample_metrics(self.metrics)
                serving = getattr(self, "serving", None)
                if serving is not None and hasattr(
                    serving, "kv_stats_summary"
                ):
                    # off the loop: the summary takes the engine's lock,
                    # which a step holds for its whole run (seconds at a
                    # graph capture), and the loop must keep serving
                    kv = await asyncio.to_thread(serving.kv_stats_summary)
                    for k in ("occupancy", "fragmentation", "chains"):
                        if k in kv:
                            self.timeseries.record(
                                f"kv_{k}", kv[k], "gauge"
                            )
                self.alerts.evaluate(self.timeseries)
                if self.fleet_series.nodes():
                    self.fleet_alerts.evaluate_fleet(self.fleet_series)
            except Exception as e:  # noqa: BLE001 — telemetry must
                # never kill the node; one bad tick is one lost sample
                self.log.warning("timeseries tick failed: %s", e)

    # ------------------------------------------------------ NAT traversal
    # (reference: miniupnpc IGD mapping at node start, smart_node.py:787-816)
    async def _init_upnp(self) -> None:
        from tensorlink_tpu_torch.p2p.nat import UpnpGateway

        try:
            gw = await asyncio.to_thread(
                UpnpGateway.discover, self.cfg.upnp_timeout_s,
                self.cfg.upnp_ssdp_addr,
            )
            await asyncio.to_thread(
                gw.add_port_mapping, self.port, self.port,
                "TCP", f"tensorlink-tpu {self.role} {self.node_id[:8]}",
                self.cfg.upnp_lease_s,
            )
            # the mapping exists NOW: remember the gateway immediately so a
            # failure below still unmaps on stop (indefinite leases would
            # otherwise outlive the node on the router)
            self._upnp_gateway = gw
            # the address the router forwards to — set BEFORE the
            # external-IP query so a partial failure (mapping active,
            # external IP unknown) still advertises a dialable LAN address
            self._lan_ip = gw.local_ip
            # warn about a loopback bind BEFORE the external-IP query: the
            # mapping is live either way, and this is the diagnostic that
            # matters when forwarded traffic gets refused
            if self.cfg.host.startswith("127.") or self.cfg.host == "localhost":
                self.log.warning(
                    "UPnP mapping forwards to %s but this node binds only "
                    "%s — forwarded traffic will be refused; bind 0.0.0.0 "
                    "or the LAN address", gw.local_ip, self.cfg.host,
                )
            self.external_ip = await asyncio.to_thread(gw.external_ip)
            self.log.info(
                "UPnP mapped %s:%s -> %s:%s",
                self.external_ip, self.port, gw.local_ip, self.port,
            )
        except Exception as e:  # noqa: BLE001 — best-effort by contract:
            # a node on a cluster or public IP needs no mapping, and a
            # malformed/hostile LAN responder must not kill node start
            if getattr(self, "_upnp_gateway", None) is not None:
                # AddPortMapping succeeded, only the external-IP query
                # failed: the router mapping IS active (and will be torn
                # down on stop) — saying "unmapped" would mislead an
                # operator debugging reachability (advisor r3)
                self.log.warning(
                    "UPnP mapping active but external-IP query failed "
                    "(%s); external address unknown", e,
                )
            else:
                self.log.warning(
                    "UPnP unavailable (%s); continuing unmapped", e
                )

    async def _teardown_upnp(self) -> None:
        gw = getattr(self, "_upnp_gateway", None)
        if gw is None:
            return
        self._upnp_gateway = None
        try:
            await asyncio.to_thread(gw.delete_port_mapping, self.port, "TCP")
        except Exception as e:  # noqa: BLE001
            self.log.warning("UPnP unmap failed: %s", e)

    # --------------------------------------------------- DHT persistence
    # (reference: save_dht_state every 600 s, smart_node.py:701-728 — the
    # round-2 DHT had snapshot()/restore() that nothing called)
    def _restore_dht_snapshot(self) -> None:
        import json
        import os

        path = self.cfg.dht_snapshot_path
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                self.dht.restore(json.load(f))
            self.log.info("restored DHT snapshot from %s", path)
        except Exception as e:  # noqa: BLE001
            self.log.warning("DHT snapshot restore failed: %s", e)

    def save_dht_snapshot(self) -> None:
        import json
        import os

        path = self.cfg.dht_snapshot_path
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.dht.snapshot(), f)
        os.replace(tmp, path)

    async def _dht_snapshot_loop(self) -> None:
        while not self._stopping:
            await asyncio.sleep(self.cfg.dht_snapshot_interval_s)
            try:
                await asyncio.to_thread(self.save_dht_snapshot)
            except Exception as e:  # noqa: BLE001
                self.log.warning("DHT snapshot save failed: %s", e)

    async def stop(self) -> None:
        self._stopping = True
        await self._teardown_upnp()
        if self.cfg.dht_snapshot_path:
            try:
                self.save_dht_snapshot()  # final flush on clean shutdown
            except Exception as e:  # noqa: BLE001
                self.log.warning("final DHT snapshot failed: %s", e)
        if getattr(self, "_http", None) is not None:
            await self._http.stop()
            self._http = None
        for t in list(self._tasks):
            t.cancel()
        # Close peer transports BEFORE wait_closed: on 3.12+ wait_closed
        # blocks until every accepted connection's handler is done.
        for p in list(self.peers.values()):
            p.stream.close()
        self.peers.clear()
        if self._server:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=2.0)
            except asyncio.TimeoutError:
                pass
        await asyncio.sleep(0)  # let cancelled tasks unwind

    def _spawn(self, coro):
        """Track a background task. Safe from worker threads too (stage
        install runs under asyncio.to_thread and spawns pre-connects):
        off-loop it schedules onto the node's loop thread-safely."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            if self._loop is None:
                raise
            # hop onto the node's loop and spawn THERE, so the task gets
            # the same tracking/cancellation as any other (a raw
            # run_coroutine_threadsafe future would escape stop() and
            # swallow exceptions)
            self._loop.call_soon_threadsafe(self._spawn, coro)
            return None
        t = loop.create_task(coro)
        self._tasks.add(t)
        t.add_done_callback(self._tasks.discard)
        return t

    @property
    def info(self) -> PeerInfo:
        # a NAT'd node advertises its UPnP-mapped external address — the
        # private bind address is unroutable for remote peers — but keeps
        # its routable LAN address (the one the router forwards to) as a
        # fallback candidate: hairpin NAT routinely fails for peers inside
        # the same LAN. The wildcard bind 0.0.0.0 is never advertised — a
        # peer dialing it would reach its own loopback.
        routable = [
            h for h in (self._lan_ip, self.cfg.host)
            if h and h != "0.0.0.0"
        ]
        if self.external_ip:
            # loopback is meaningless beyond this machine — gossiping it
            # network-wide makes remote peers dial THEMSELVES; same-host
            # peers still reach us via the validator's observed-address
            # candidate
            host = self.external_ip
            alts = [h for h in routable
                    if not (h.startswith("127.") or h == "localhost")]
        else:
            host = routable[0] if routable else self.cfg.host
            alts = routable[1:]
        seen = {host}
        return PeerInfo(
            node_id=self.node_id,
            role=self.role,
            host=host,
            port=self.port or 0,
            alt_hosts=[h for h in alts if not (h in seen or seen.add(h))],
        )

    async def connect_candidates(
        self,
        host: str,
        port: int,
        alt_hosts: Sequence[str] = (),
        expect_id: str | None = None,
    ) -> Peer:
        """Dial candidate addresses in order until a handshake succeeds.
        The dial (not the handshake) is bounded by connect_timeout_s inside
        connect(). With expect_id, a candidate that handshakes as a
        DIFFERENT node is treated as a failed candidate — behind shared
        NATs the same (ip, port) can route to an unrelated peer, and the
        mutual-auth handshake only proves the peer owns *some* key, not
        the one the placement names. Raises the LAST error when every
        candidate fails.

        Dials with the same expect_id are single-flight: a caller that
        arrives while one is in flight awaits its result. Two dials to one
        node (say, two relay hops that found no peer at once) would
        register twice, and the second registration closes the first
        stream: a request in flight on it would lose its reply and ride
        out its whole timeout. The shared dial runs as a task of its own,
        so a caller that is cancelled leaves the others' dial running."""
        if expect_id is None:
            return await self._dial_candidates(host, port, alt_hosts, None)
        dial = self._dials.get(expect_id)
        if dial is None:
            dial = self._spawn(
                self._dial_candidates(host, port, alt_hosts, expect_id))
            self._dials[expect_id] = dial
            dial.add_done_callback(
                lambda t, k=expect_id: self._dial_done(k, t))
        return await asyncio.shield(dial)

    def _dial_done(self, expect_id: str, dial: asyncio.Task) -> None:
        if self._dials.get(expect_id) is dial:
            del self._dials[expect_id]
        if not dial.cancelled():
            dial.exception()  # retrieved: a dial whose callers all left is no leak

    async def _dial_candidates(
        self, host: str, port: int, alt_hosts: Sequence[str],
        expect_id: str | None,
    ) -> Peer:
        last: Exception | None = None
        for h in [host, *alt_hosts]:
            try:
                peer = await self.connect(h, port, expect_id=expect_id)
            except (OSError, ConnectionError, asyncio.TimeoutError,
                    asyncio.IncompleteReadError) as e:
                self.log.debug("candidate %s:%s failed: %s", h, port, e)
                last = e
                continue
            return peer
        raise ConnectionError(
            f"all candidates failed for :{port} ({[host, *alt_hosts]})"
        ) from last

    async def bootstrap_from_registry(self, registry, k: int = 6):
        """Auto-join the overlay from a validator registry (typically the
        chain contract): sample up to ``k`` validators and dial each —
        candidate addresses in order, identity pinned to the registered
        node_id — until one handshakes. The reference joins exactly this
        way, sampling the contract and dialing (smart_node.py:539-585);
        with this, ``--chain-url`` alone suffices and ``--bootstrap`` is
        an override, not a requirement.

        Returns the connected validator Peer, or None when the registry
        is empty or every candidate fails (callers may retry later —
        an empty contract is a young network, not an error).
        """
        try:
            entries = await asyncio.to_thread(registry.sample_validators, k)
        except Exception as e:  # noqa: BLE001 — chain RPC may be down
            self.log.warning("registry bootstrap: sampling failed: %s", e)
            return None
        for e in entries:
            info = e.info
            if info.node_id == self.node_id:
                continue
            try:
                peer = await self.connect_candidates(
                    info.host, info.port,
                    tuple(getattr(info, "alt_hosts", ()) or ()),
                    expect_id=info.node_id,
                )
            except (ConnectionError, OSError, asyncio.TimeoutError) as err:
                self.log.info(
                    "registry bootstrap: validator %s at %s:%s unreachable: %s",
                    info.node_id[:8], info.host, info.port, err,
                )
                continue
            self.log.info(
                "registry bootstrap: joined via validator %s",
                peer.node_id[:8],
            )
            return peer
        self.log.warning(
            "registry bootstrap: no reachable validator among %d sampled",
            len(entries),
        )
        return None

    # ------------------------------------------------------------ handshake
    async def connect(
        self, host: str, port: int, expect_id: str | None = None
    ) -> Peer:
        """Dial + mutual signature handshake (initiator). The TCP dial is
        bounded by connect_timeout_s; the handshake keeps its own (longer)
        handshake_timeout_s — a slow peer is not a failed dial. With
        expect_id, an identity mismatch aborts BEFORE peer registration —
        checking afterwards would let a mis-routed dial displace a healthy
        existing connection to the mis-identified node (_register_peer
        closes the old stream), failing its in-flight requests."""
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, port), self.cfg.connect_timeout_s
        )
        stream = FramedStream(
            reader, writer, self.cfg.compression, self.cfg.compression_min_bytes
        )
        try:
            return await self._connect_handshake(stream, host, port, expect_id)
        except BaseException:
            # cancellation (connect_candidates timeout) or any recv error
            # must not leak the transport — retry loops would accumulate fds
            stream.close()
            raise

    async def _connect_handshake(
        self, stream: FramedStream, host: str, port: int,
        expect_id: str | None = None,
    ) -> Peer:
        nonce_a = new_nonce()
        await stream.send(
            encode_message(
                {
                    "type": "HELLO",
                    "role": self.role,
                    "pubkey": self.identity.public_der,
                    "nonce": nonce_a,
                    "listen_port": self.port or 0,
                    "caps": ["crc"],
                }
            )
        )
        ack = decode_message(
            await asyncio.wait_for(stream.recv(), self.cfg.handshake_timeout_s)
        )
        if ack.get("type") != "HELLO_ACK":
            stream.close()
            raise ConnectionError(f"handshake rejected: {ack.get('type')}")
        their_pub = ack["pubkey"]
        if not Identity.verify(their_pub, ack["sig"], nonce_a + ack["nonce"]):
            stream.close()
            raise ConnectionError("peer failed signature challenge")
        their_id = Identity.node_id_for(their_pub)
        if expect_id is not None and their_id != expect_id:
            raise ConnectionError(
                f"{host}:{port} handshook as {their_id[:8]}, "
                f"expected {expect_id[:8]}"
            )
        await stream.send(
            encode_message(
                {"type": "HELLO_FIN", "sig": self.identity.sign(ack["nonce"] + nonce_a)}
            )
        )
        stream.integrity = "crc" in ack.get("caps", [])
        info = PeerInfo(
            node_id=their_id,
            role=str(ack["role"]),
            host=host,
            port=int(ack["listen_port"]) or port,
        )
        return self._register_peer(info, stream)

    async def _accept(self, reader, writer) -> None:
        stream = FramedStream(
            reader, writer, self.cfg.compression, self.cfg.compression_min_bytes
        )
        if self._stopping:
            # A connection can race out of the accept backlog while (or
            # just after) stop() runs: its callback task is not in
            # self._tasks, so nothing cancels it, and a half-dead node
            # would handshake and serve RPCs from a cleared peer table —
            # e.g. compute a relay hop and then drop the result on the
            # floor, leaving the origin to ride out its full timeout.
            # Close immediately: the dialer fails fast instead.
            stream.close()
            return
        try:
            hello = decode_message(
                await asyncio.wait_for(stream.recv(), self.cfg.handshake_timeout_s)
            )
            if hello.get("type") != "HELLO":
                raise ConnectionError("expected HELLO")
            their_pub = hello["pubkey"]
            their_id = Identity.node_id_for(their_pub)
            if not self.authorize_peer(their_id, str(hello["role"])):
                await stream.send(encode_message({"type": "REJECT", "reason": "unauthorized"}))
                stream.close()
                return
            if len(self.peers) >= self.cfg.max_connections:
                await stream.send(encode_message({"type": "REJECT", "reason": "full"}))
                stream.close()
                return
            nonce_b = new_nonce()
            await stream.send(
                encode_message(
                    {
                        "type": "HELLO_ACK",
                        "role": self.role,
                        "pubkey": self.identity.public_der,
                        "nonce": nonce_b,
                        "sig": self.identity.sign(hello["nonce"] + nonce_b),
                        "listen_port": self.port or 0,
                        "caps": ["crc"],
                    }
                )
            )
            fin = decode_message(
                await asyncio.wait_for(stream.recv(), self.cfg.handshake_timeout_s)
            )
            if fin.get("type") != "HELLO_FIN" or not Identity.verify(
                their_pub, fin["sig"], nonce_b + hello["nonce"]
            ):
                raise ConnectionError("initiator failed signature challenge")
            stream.integrity = "crc" in hello.get("caps", [])
            host = stream.peername[0] if stream.peername else "?"
            info = PeerInfo(
                node_id=their_id,
                role=str(hello["role"]),
                host=host,
                port=int(hello["listen_port"]),
            )
            self._register_peer(info, stream)  # refuses if stopping
        except Exception as e:  # noqa: BLE001
            self.log.debug("inbound handshake failed: %s", e)
            stream.close()

    def authorize_peer(self, node_id: str, role: str) -> bool:
        """Hook: reputation gate (reference refuses rep==0 peers,
        smart_node.py:329-337). Roles override."""
        return True

    def _register_peer(self, info: PeerInfo, stream: FramedStream) -> Peer:
        if self._stopping:
            # An in-flight dial (e.g. a stage-install pre-connect spawned
            # from a worker thread) can complete after stop() cleared the
            # peer table. Registering it would resurrect this node as a
            # reachable peer — the remote side replaces its just-EOF'd
            # connection and then fires relay hops into a socket nobody
            # reads, losing them silently. Refuse instead.
            stream.close()
            raise ConnectionError("node is stopping")
        old = self.peers.get(info.node_id)
        if old is not None:
            old.stream.close()
        peer = Peer(info=info, stream=stream)
        self.peers[info.node_id] = peer
        self.dht.table.add(info)
        self._spawn(self._recv_loop(peer))
        self.flight.record(
            "peer_joined", peer=info.node_id[:16], role=info.role,
            replaced=old is not None,
        )
        self.log.info("peer %s (%s) connected", info.node_id[:8], info.role)
        return peer

    # ------------------------------------------------------------ dispatch
    def on(self, msg_type: str, handler: Handler) -> None:
        self._handlers[msg_type] = handler

    def register_handlers(self) -> None:
        self.on("PING", self._h_ping)
        self.on("DHT_STORE", self._h_dht_store)
        self.on("DHT_QUERY", self._h_dht_query)
        self.on("PEERS", self._h_peers)
        self.on("STREAM_BEGIN", self._h_stream_begin)
        self.on("STREAM_CHUNK", self._h_stream_chunk)
        self.on("STREAM_END", self._h_stream_end)
        self.on("KV_BLOCKS", self._h_kv_blocks)
        self.on("ACT_FWD", self._h_act_fwd)

    # ------------------------------------------------------ KV-block wire
    # Disaggregated serving's data plane (ROADMAP item 1): a prefill
    # worker ships a request's filled KV blocks — one CRC-framed blob
    # from parallel/kvwire.py — to the decode worker that will continue
    # the stream. The frame layer counts bytes on BOTH legs
    # (kv_wire_bytes_total / kv_wire_transfers_total in /metrics); what
    # to do with a received payload is the role's business
    # (WorkerNode.handle_kv_blocks imports it into its serving engine).

    KV_TRANSFER_TIMEOUT_S = 120.0

    async def send_kv_blocks(
        self, peer: Peer, blob: bytes, meta: dict | None = None,
        timeout: float | None = None,
    ) -> dict:
        """Ship one packed KV-block payload (``kvwire.pack_kv_payload``)
        and await the receiver's import verdict (``KV_IMPORTED`` with
        the decode-side rid, or a typed ``SERVE_FAILED``)."""
        resp = await self.request(
            peer,
            {"type": "KV_BLOCKS", "meta": dict(meta or {}), "blob": blob},
            timeout=timeout or self.KV_TRANSFER_TIMEOUT_S,
        )
        # counted only once the receiver's reply proves the payload
        # crossed — a send that dies on a dead decode peer must not
        # inflate the sender-leg wire counters the acceptance criterion
        # and tldiag's transfer narrative read
        self.metrics.incr("kv_wire_bytes_total", len(blob))
        self.metrics.incr("kv_wire_transfers_total")
        return resp

    @wire_guard
    async def _h_kv_blocks(self, node, peer, msg) -> dict:
        blob = msg.get("blob")
        if not isinstance(blob, (bytes, bytearray)):
            peer.ghosts += 1
            self._penalize(peer)
            return {"type": "ERROR", "error": "KV_BLOCKS carries no blob"}
        self.metrics.incr("kv_wire_bytes_total", len(blob))
        self.metrics.incr("kv_wire_transfers_total")
        return await self.handle_kv_blocks(peer, msg)

    async def handle_kv_blocks(self, peer: Peer, msg: dict) -> dict:
        """Role hook: consume a received KV-block payload. The base
        node has no pool to graft into."""
        from tensorlink_tpu_torch.parallel.serving import (
            ServingError,
            serve_error_to_wire,
        )

        return serve_error_to_wire(
            ServingError(f"{self.role} node has no KV sink")
        )

    # ---------------------------------------------------- activation wire
    # Pipeline-sharded serving's data plane (ROADMAP item 2): per-chunk
    # activations hop stage-to-stage as one CRC-framed blob
    # (parallel/pipeserve.py codec). ACT_FWD is the request frame on
    # every hop; the LAST stage's ACT_RESULT (sampled tokens / first
    # token) relays back up the chain as each hop's reply, so typed
    # errors and deadline decrements cross every leg exactly like the
    # KV wire. Byte counters mirror the KV wire's discipline: the
    # sender leg counts only after the receiver's reply proves the
    # payload crossed.

    ACT_TRANSFER_TIMEOUT_S = 60.0

    async def send_activations(
        self, peer: Peer, blob: bytes, meta: dict | None = None,
        timeout: float | None = None,
    ) -> dict:
        """Ship one packed activation payload
        (``pipeserve.pack_act_payload``) and await the end-of-chain
        verdict (``ACT_RESULT``, or a typed ``SERVE_FAILED`` from
        whichever stage rejected it)."""
        resp = await self.request(
            peer,
            {"type": "ACT_FWD", "meta": dict(meta or {}), "blob": blob},
            timeout=timeout or self.ACT_TRANSFER_TIMEOUT_S,
        )
        self.metrics.incr("act_wire_bytes_total", len(blob))
        self.metrics.incr("act_wire_transfers_total")
        return resp

    @wire_guard
    async def _h_act_fwd(self, node, peer, msg) -> dict:
        blob = msg.get("blob")
        if not isinstance(blob, (bytes, bytearray)):
            peer.ghosts += 1
            self._penalize(peer)
            return {"type": "ERROR", "error": "ACT_FWD carries no blob"}
        self.metrics.incr("act_wire_bytes_total", len(blob))
        self.metrics.incr("act_wire_transfers_total")
        return await self.handle_act_fwd(peer, msg)

    async def handle_act_fwd(self, peer: Peer, msg: dict) -> dict:
        """Role hook: run a pipeline stage over a received activation
        chunk (and relay downstream). The base node holds no stage."""
        from tensorlink_tpu_torch.parallel.serving import (
            ServingError,
            serve_error_to_wire,
        )

        return serve_error_to_wire(
            ServingError(f"{self.role} node has no pipeline stage")
        )

    # ------------------------------------------------------------ streaming
    # Chunked array transfer (serialization.py streaming section): large
    # MODULE_SPEC / PARAMETERS payloads ride many small frames instead of
    # one message-sized one, so per-hop memory is bounded by the chunk
    # size + the largest single tensor — not the whole stage (VERDICT
    # missing #3). Roles register a kind with
    # ``register_stream_kind(kind, factory)``; factory(peer, meta,
    # manifest) returns either an error dict or (sink, finish) where
    # sink(name, array) consumes each completed tensor and
    # ``await finish()`` produces the STREAM_END response.

    STREAM_TIMEOUT_S = 300.0
    # hostile-ingest clamps (tlproto TLP201/TLP202): a peer drives
    # stream creation and chunk naming, so both are bounded — rejects
    # count into stream_rejected_total and the flight recorder
    MAX_ACTIVE_STREAMS = 64
    MAX_STREAM_SID_LEN = 64
    MAX_STREAM_NAME_LEN = 512

    def register_stream_kind(self, kind: str, factory) -> None:
        self._stream_kinds[kind] = factory

    async def send_stream(
        self,
        peer: Peer,
        kind: str,
        meta: dict,
        arrays,
        chunk_bytes: int | None = None,
        timeout: float | None = None,
    ) -> dict:
        """Stream {name: np.ndarray} to a peer. Returns the receiver's
        STREAM_END response (e.g. LOADED), or the BEGIN rejection."""
        from tensorlink_tpu_torch.p2p.serialization import (
            STREAM_CHUNK_BYTES,
            iter_array_chunks,
            stream_manifest,
        )

        sid = uuid.uuid4().hex
        manifest = stream_manifest(arrays)
        begin = await self.request(
            peer,
            {
                "type": "STREAM_BEGIN",
                "sid": sid,
                "kind": kind,
                "meta": meta,
                "manifest": manifest,
            },
            timeout=timeout,
        )
        if begin.get("type") != "STREAM_ACCEPT":
            return begin
        for name, off, data in iter_array_chunks(
            arrays, chunk_bytes or STREAM_CHUNK_BYTES
        ):
            await self.send(
                peer,
                {"type": "STREAM_CHUNK", "sid": sid, "name": name,
                 "off": off, "data": data},
            )
        return await self.request(
            peer,
            {"type": "STREAM_END", "sid": sid},
            timeout=timeout or self.STREAM_TIMEOUT_S,
        )

    def _reject_stream(self, peer: Peer, why: str) -> dict:
        self.metrics.incr("stream_rejected_total")
        self.flight.record(
            "stream_rejected", "warn", peer=peer.node_id[:16], why=why,
        )
        return {"type": "ERROR", "error": why}

    @wire_guard
    async def _h_stream_begin(self, node, peer, msg) -> dict:
        self._purge_expired_streams()  # reclaim abandoned BEGINs too
        sid = msg.get("sid")
        manifest = msg.get("manifest")
        if not isinstance(sid, str) or not sid or \
                len(sid) > self.MAX_STREAM_SID_LEN:
            return self._reject_stream(peer, "bad stream sid")
        if not isinstance(manifest, dict) or not manifest:
            return self._reject_stream(peer, "bad stream manifest")
        if len(self._streams) >= self.MAX_ACTIVE_STREAMS:
            # the peer controls BEGIN volume: without a cap, looping
            # BEGIN frames grows _streams (and its assemblers) until OOM
            return self._reject_stream(peer, "too many active streams")
        factory = self._stream_kinds.get(str(msg.get("kind")))
        if factory is None:
            peer.ghosts += 1
            self._penalize(peer)
            return {"type": "ERROR", "error": "unknown stream kind"}
        made = await factory(peer, msg.get("meta") or {}, manifest)
        if isinstance(made, dict):  # rejection (capacity/authorization)
            return self._typed_reply(made)
        sink, finish = made
        from tensorlink_tpu_torch.p2p.serialization import StreamAssembler

        self._streams[sid] = {
            "peer": peer.node_id,
            "asm": StreamAssembler(manifest, sink),
            "finish": finish,
            "event": asyncio.Event(),
            "deadline": time.time() + self.STREAM_TIMEOUT_S,
        }
        return {"type": "STREAM_ACCEPT", "sid": sid}

    def _purge_expired_streams(self) -> None:
        now = time.time()
        for sid, st in list(self._streams.items()):
            if st["deadline"] < now:
                self.log.warning("stream %s expired, reclaiming", sid[:8])
                del self._streams[sid]

    @wire_guard
    async def _h_stream_chunk(self, node, peer, msg) -> None:
        self._purge_expired_streams()
        st = self._streams.get(msg.get("sid"))
        if st is None or st["peer"] != peer.node_id:
            # NOT a ghost: chunks of a just-expired/aborted stream are a
            # normal race, and penalizing them 0.1 apiece would sever the
            # connection after ten stragglers
            return None
        # validate the peer-controlled fields BEFORE they reach the
        # assembler (tlproto TLP201): name bounds the staging-buffer
        # key space, off indexes raw memory, data is memcpy'd
        name = msg.get("name")
        off = msg.get("off")
        data = msg.get("data")
        if not isinstance(name, str) or not name or \
                len(name) > self.MAX_STREAM_NAME_LEN:
            self._reject_stream(peer, "bad chunk name")
            return None
        if not isinstance(off, int) or isinstance(off, bool) or off < 0:
            self._reject_stream(peer, "bad chunk offset")
            return None
        if not isinstance(data, (bytes, bytearray)):
            self._reject_stream(peer, "bad chunk data")
            return None
        # the transfer is alive: push the idle deadline out (a fixed
        # BEGIN-anchored deadline capped stream size at rate x timeout)
        st["deadline"] = time.time() + self.STREAM_TIMEOUT_S
        # memcpy-sized work off the event loop so heartbeats keep flowing
        await asyncio.to_thread(st["asm"].feed, name, off, data)
        if st["asm"].done:
            st["event"].set()
        return None

    @wire_guard
    async def _h_stream_end(self, node, peer, msg) -> dict:
        sid = msg.get("sid")
        st = self._streams.get(sid)
        if st is None or st["peer"] != peer.node_id:
            peer.ghosts += 1
            self._penalize(peer)
            return {"type": "ERROR", "error": "unknown stream"}
        # dispatch is concurrent per message: chunks may still be in
        # flight when END arrives — wait for assembly to complete
        try:
            await asyncio.wait_for(
                st["event"].wait(), max(st["deadline"] - time.time(), 1.0)
            )
        except asyncio.TimeoutError:
            del self._streams[sid]
            return {"type": "ERROR", "error": "stream incomplete at END"}
        del self._streams[sid]
        # finishers are role-registered closures — coerce whatever they
        # produce onto the typed-reply invariant (tlproto TLP301)
        return self._typed_reply(await st["finish"]())

    async def _recv_loop(self, peer: Peer) -> None:
        try:
            while True:
                try:
                    raw = await peer.stream.recv()
                except (
                    asyncio.IncompleteReadError,
                    ConnectionError,
                    asyncio.CancelledError,
                ):
                    break
                except Exception as e:  # corrupt frame: bad flag byte,
                    # zstd/zlib decompress failure — framing is lost, the
                    # stream cannot resync; penalize and drop.
                    peer.ghosts += 1
                    self._penalize(peer)
                    self.log.warning(
                        "corrupt frame from %s: %s", peer.node_id[:8], e
                    )
                    break
                try:
                    msg = decode_message(raw)
                except ValueError:
                    peer.ghosts += 1
                    self._penalize(peer)
                    continue
                if self._stopping:
                    # close so the sender sees EOF (not a silent sink)
                    peer.stream.close()
                    break
                peer.msgs_in += 1
                peer.last_seen = time.time()
                if self._traffic_dog is not None:
                    self._traffic_dog.kick()  # any inbound frame = traffic
                self.metrics.incr("msgs_in")
                # only known types get their own counter: a peer spraying
                # random type strings must not grow the registry (and the
                # /metrics payload) without bound
                mtype = msg.get("type")
                self.metrics.incr(
                    f"msg:{mtype}" if mtype in self._handlers else "msg:unknown"
                )
                self._spawn(self._dispatch(peer, msg))
        finally:
            self._drop_peer(peer)

    async def _dispatch(self, peer: Peer, msg: dict) -> None:
        # response correlation
        re_id = msg.get("re")
        if re_id is not None:
            fut = self._pending.pop(re_id, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            else:
                peer.ghosts += 1  # unsolicited response
                self._penalize(peer)
            return
        # a frame with a missing/non-str "type" must not KeyError the
        # dispatch task — it is peer-controlled input like everything
        # else in the envelope
        mtype = msg.get("type")
        if not isinstance(mtype, str):
            self.metrics.incr("malformed_frames_total")
            peer.ghosts += 1
            self._penalize(peer)
            return
        handler = self._handlers.get(mtype)
        if handler is None:
            peer.ghosts += 1
            self._penalize(peer)
            return
        try:
            ctx = msg.get("_trace")
            if isinstance(ctx, dict):  # hostile peers may send junk here
                # the sender had a span open: continue ITS trace — this
                # server-side span's parent_id is the requester's span id
                # on the other node, which is what stitches one job's
                # RPC chain into a single cross-node trace
                with self.tracer.span(
                    f"rpc.{mtype}",
                    {"peer": peer.node_id[:8], "peer_role": peer.role},
                    remote=ctx,
                ):
                    reply = await handler(self, peer, msg)
            else:
                reply = await handler(self, peer, msg)
        except Exception as e:  # noqa: BLE001
            self.log.warning("handler %s failed: %s", mtype, e)
            self.metrics.incr("dispatch_errors_total")
            self.flight.record(
                "dispatch_error", "error", type=str(msg.get("type")),
                peer=peer.node_id[:16], error=str(e)[:200],
            )
            reply = {"type": "ERROR", "error": str(e)}
        if reply is not None and "id" in msg:
            reply.setdefault("type", "RESPONSE")
            reply["re"] = msg["id"]
            try:
                await self.send(peer, reply)
            except (ConnectionError, OSError):
                # peer dropped while the handler ran (send now fails
                # fast on a closed transport); the requester's side is
                # already resolving this via its own peer-lost path
                self.log.debug(
                    "reply to %s undeliverable (peer gone)",
                    peer.node_id[:8],
                )

    def _penalize(self, peer: Peer) -> None:
        peer.reputation = max(0.0, peer.reputation - 0.1)
        if peer.reputation == 0.0:
            self.log.warning("peer %s reputation zero, dropping", peer.node_id[:8])
            peer.stream.close()

    def _reject_malformed(self, peer: Peer, msg: dict, exc: Exception) -> dict:
        """Typed reject for a frame whose fields failed validation
        (wire_guard's landing pad). Counts + flight-records, marks the
        ghost, but does NOT touch reputation: _penalize docks 0.1 per
        call, so a reputation hit here would let ten malformed frames
        (or one fuzzing test run) sever an otherwise healthy link —
        reputation is for protocol violations, not field typos."""
        mtype = str(msg.get("type", "?"))[:32]
        self.metrics.incr("malformed_frames_total")
        self.flight.record(
            "malformed_frame", "warn", type=mtype,
            peer=peer.node_id[:16],
            error=f"{type(exc).__name__}: {exc}"[:200],
        )
        peer.ghosts += 1
        return {
            "type": "ERROR",
            "error": f"malformed {mtype} frame: {type(exc).__name__}",
        }

    @staticmethod
    def _typed_reply(reply: Any, fallback: str = "ERROR") -> dict | None:
        """Coerce a dynamically-produced reply (stream finisher, union
        helper) onto the wire invariant: every reply is None or a
        ``{"type": ...}`` dict. tlproto (TLP301) accepts returns routed
        through this shim."""
        if reply is None or (isinstance(reply, dict) and "type" in reply):
            return reply
        if isinstance(reply, dict):
            return {"type": fallback, **reply}
        return {
            "type": fallback,
            "error": f"untyped reply ({type(reply).__name__})",
        }

    def _drop_peer(self, peer: Peer) -> None:
        # reclaim half-shipped streams from this peer: their assemblers
        # pin staging buffers (and sinks may pin device arrays) for as
        # long as the state dict holds them
        for sid, st in list(self._streams.items()):
            if st["peer"] == peer.node_id:
                del self._streams[sid]
        # close our transport too (recv saw EOF = remote is gone): later
        # sends on a stale Peer reference fail fast instead of writing
        # into a half-closed socket and riding out the request timeout
        peer.stream.close()
        if self.peers.get(peer.node_id) is peer:
            del self.peers[peer.node_id]
            # the fleet capability table is a LIVE view: a dead peer's
            # record must not keep advertising capacity to placement
            self.peer_capabilities.pop(peer.node_id, None)
            self.flight.record(
                "peer_lost", "warn", peer=peer.node_id[:16], role=peer.role,
                last_seen_age_s=round(time.time() - peer.last_seen, 3),
            )
            # fail in-flight requests to the dead peer immediately instead
            # of letting them ride out the full request timeout
            for mid, target in list(self._pending_peer.items()):
                if target == peer.node_id:
                    fut = self._pending.get(mid)
                    if fut is not None and not fut.done():
                        fut.set_exception(
                            ConnectionError(f"peer {peer.node_id[:8]} lost")
                        )
                    self._pending_peer.pop(mid, None)
            self.on_peer_lost(peer)

    def on_peer_lost(self, peer: Peer) -> None:
        """Hook for roles (fault detection)."""

    # ------------------------------------------------------------ messaging
    async def send(self, peer: Peer, msg: dict) -> None:
        h = self._chaos.ACTIVE
        if h is not None:
            # scripted churn (runtime/chaos.py): delay or drop outbound
            # frames at the send boundary — a dropped frame looks to
            # the caller exactly like the network losing it (a request
            # rides out its timeout; retry paths must recover)
            drop = False
            for act in h.actions(
                "p2p.send", type=msg.get("type"), role=self.role
            ):
                if act["action"] == "delay" and act["delay_s"] > 0:
                    await asyncio.sleep(act["delay_s"])
                drop = drop or act["action"] == "drop"
            if drop:
                self.metrics.incr("chaos_frames_dropped_total")
                return
        peer.msgs_out += 1
        self.metrics.incr("msgs_out")
        if "_trace" not in msg:
            # trace-context propagation: only while a span is active —
            # an untraced node's messages carry no envelope overhead
            # (one ContextVar read decides). Copy before injecting: the
            # caller's dict may be reused (retries re-send it).
            ctx = self._trace_ctx()
            if ctx is not None:
                msg = dict(msg, _trace=ctx)
        await peer.stream.send(encode_message(msg))

    async def request(
        self, peer: Peer, msg: dict, timeout: float | None = None
    ) -> dict:
        """Send and await the correlated response."""
        msg = dict(msg)
        msg["id"] = uuid.uuid4().hex
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[msg["id"]] = fut
        self._pending_peer[msg["id"]] = peer.node_id
        t0 = time.perf_counter()
        try:
            await self.send(peer, msg)
            resp = await asyncio.wait_for(
                fut, timeout or self.cfg.request_timeout_s
            )
            # request/response round-trip latency histogram — the p50/
            # p90/p99 behind /metrics?format=prom (only successful
            # round-trips: a timeout is a liveness event, not a latency)
            self.metrics.observe_hist(
                "rpc_seconds", time.perf_counter() - t0
            )
            return resp
        finally:
            self._pending.pop(msg["id"], None)
            self._pending_peer.pop(msg["id"], None)

    async def request_idempotent(
        self,
        peer: Peer,
        msg: dict,
        timeout: float | None = None,
        retries: int = 2,
        backoff_s: float = 0.05,
        max_backoff_s: float = 2.0,
    ) -> dict:
        """``request`` with jittered-exponential-backoff retries, for
        RPCs that are SAFE to deliver twice (reads like DHT_QUERY /
        PEERS / STATS_REQUEST, and writes the receiver dedupes by key,
        like DHT_STORE or a replica's per-sender GRAD_SHARE slot). A
        transient peer blip — one lost frame, a heartbeat-window stall,
        a connection the remote is re-establishing — then costs one
        backoff instead of a failed request. Between attempts the peer
        is re-resolved from the live table and, if it dropped, re-dialed
        with its identity pinned; full jitter (0.5-1.5x) on the delay
        keeps a churn event from re-synchronizing every retrier into
        the next thundering herd. NEVER route non-idempotent RPCs here:
        a retry after a timeout can double-apply them."""
        last: Exception | None = None
        for attempt in range(retries + 1):
            target = self.peers.get(peer.node_id) or peer
            try:
                return await self.request(target, msg, timeout=timeout)
            except (asyncio.TimeoutError, ConnectionError, OSError) as e:
                last = e
                if attempt >= retries:
                    break
                delay = min(max_backoff_s, backoff_s * (2 ** attempt))
                delay *= 0.5 + self._retry_rng.random()
                self.metrics.incr("rpc_retries_total")
                self.flight.record(
                    "rpc_retry", "info", type=str(msg.get("type")),
                    peer=peer.node_id[:16], attempt=attempt + 1,
                    delay_s=round(delay, 4), error=str(e)[:120],
                )
                await asyncio.sleep(delay)
                if peer.node_id not in self.peers and not self._stopping:
                    try:
                        await self.connect_candidates(
                            peer.info.host, peer.info.port,
                            tuple(getattr(peer.info, "alt_hosts", ()) or ()),
                            expect_id=peer.node_id,
                        )
                    except (ConnectionError, OSError,
                            asyncio.TimeoutError):
                        continue  # still down; next attempt may rejoin
        raise last

    # capability-record sanitation bounds: a PONG arrives from the
    # WIRE, so a hostile peer must not pin megabytes in the fleet table
    _CAP_SCALARS = (
        "schema", "chip", "peak_tflops", "hbm_gbps", "host_gap_frac",
        "measured_at", "measure_s", "cached",
        # disaggregated serving: the advertised leg (prefill/decode/
        # colocated) and the live KV-pool headroom the validator's
        # two-leg placement gates on
        "serving_mode", "kv_blocks_free", "kv_blocks_total",
        "kv_block_size",
        # pipeline-sharded serving: HBM capacity claim (the quantity
        # stage partitioning is proportional to) and the loaded stage's
        # identity/health — the replacement planner recruits spares and
        # tldiag renders ROLE/MFU%/BUBBLE% from these
        "hbm_bytes", "pipe_sid", "pipe_stage", "pipe_n_stages",
        "pipe_lo", "pipe_hi", "pipe_bubble_frac", "pipe_mfu",
    )
    _CAP_MAX_PROGRAMS = 16

    @staticmethod
    def _cap_value(v: Any) -> Any | None:
        """Bound one wire value: numbers/bools pass, strings truncate,
        anything structured is dropped — a PONG field must never pin
        more than a few bytes."""
        if isinstance(v, bool) or isinstance(v, (int, float)):
            return v
        if isinstance(v, str):
            return v[:64]
        return None

    def _note_peer_capability(self, peer: Peer, cap: Any) -> None:
        if not isinstance(cap, dict):
            return
        rec: dict[str, Any] = {}
        for k in self._CAP_SCALARS:
            v = self._cap_value(cap.get(k))
            if v is not None:
                rec[k] = v
        progs = cap.get("programs")
        if isinstance(progs, dict):
            rec["programs"] = {
                str(name)[:64]: {
                    str(pk)[:64]: cv
                    for pk, pv in list(p.items())[:16]
                    if (cv := self._cap_value(pv)) is not None
                }
                for name, p in list(progs.items())[: self._CAP_MAX_PROGRAMS]
                if isinstance(p, dict)
            }
        rec["role"] = peer.role
        rec["received_at"] = time.time()
        self.peer_capabilities[peer.node_id] = rec

    async def ping(self, peer: Peer) -> float:
        t0 = time.perf_counter()
        # ts_since opts into the metric-delta piggyback: the responder
        # stays stateless (cursor lives HERE, per-peer, in FleetStore),
        # so a missed beat just widens the next ask and the gap
        # backfills from the responder's own rings — never interpolated
        ping = {"type": "PING", "ts_since": self.fleet_series.cursor(peer.node_id)}
        resp = await self.request(peer, ping)
        peer.ping_ms = (time.perf_counter() - t0) * 1e3
        # heartbeat piggyback: every PONG from a capability-publishing
        # peer refreshes this node's fleet table — a validator running
        # start_heartbeat holds a LIVE capability view with no extra RPC
        self._note_peer_capability(peer, resp.get("capability"))
        delta = resp.get("timeseries_delta")
        if isinstance(delta, dict):
            from tensorlink_tpu_torch.runtime.timeseries import TS_DELTA_SCHEMA

            # explicit wire-version gate (pinned in proto.manifest.json):
            # an unknown version is a typed reject + flight event, never
            # a parse attempt. Absent "v" = pre-versioning peer, accepted
            # — the additive-optional grace the rollout itself needs.
            v = delta.get("v", TS_DELTA_SCHEMA)
            if isinstance(v, bool) or not isinstance(v, int) or \
                    v != TS_DELTA_SCHEMA:
                self.metrics.incr("ts_delta_rejected_total")
                self.flight.record(
                    "ts_delta_rejected", "warn",
                    peer=peer.node_id[:16], version=str(v)[:32],
                )
            else:
                self.fleet_series.ingest(
                    peer.node_id, delta, kv=resp.get("kv")
                )
        # receipt harvest: only a node carrying a ReceiptAuditor (the
        # validator role) consumes these; the same explicit version
        # gate as timeseries_delta — unknown schema is a typed reject
        # plus flight event, never a parse attempt
        auditor = getattr(self, "receipt_auditor", None)
        if auditor is not None and (
            "receipts" in resp or "receipt_obs" in resp
        ):
            from tensorlink_tpu_torch.runtime.ledger import RECEIPT_SCHEMA

            v = resp.get("receipt_schema")
            if isinstance(v, bool) or not isinstance(v, int) or \
                    v != RECEIPT_SCHEMA:
                self.metrics.incr("receipt_rejected_total")
                self.flight.record(
                    "receipt_rejected", "warn",
                    peer=peer.node_id[:16], version=str(v)[:32],
                )
            else:
                rs = resp.get("receipts")
                if isinstance(rs, list):
                    for r in rs[:64]:
                        auditor.ingest(r)
                obs = resp.get("receipt_obs")
                if isinstance(obs, list):
                    for o in obs[:256]:
                        auditor.observe(o)
        return peer.ping_ms

    # ------------------------------------------------------- failure detection
    def start_heartbeat(
        self, interval_s: float = 10.0, timeout_s: float = 5.0, max_misses: int = 3
    ) -> None:
        """Lease-style liveness: periodic PING to every peer; a peer that
        misses `max_misses` consecutive beats is dropped via on_peer_lost.
        The reference's only liveness signal was a manual ping and socket
        errors (survey §5.3); this catches silent hangs too."""
        # peer-traffic watchdog: trips when NO peer produced a frame for
        # a whole eviction window — the node is isolated (or its network
        # is), which a per-peer drop alone cannot say. Kicked by every
        # inbound frame and by beat rounds with nothing to monitor.
        self._traffic_dog = self.health.watchdog(
            "peer_traffic", interval_s * (max_misses + 1)
        )
        self._traffic_dog.arm()
        self._spawn(self._heartbeat_loop(interval_s, timeout_s, max_misses))

    async def _heartbeat_loop(
        self, interval_s: float, timeout_s: float, max_misses: int
    ) -> None:
        misses: dict[str, int] = {}

        async def beat(peer: Peer) -> None:
            try:
                await asyncio.wait_for(self.ping(peer), timeout=timeout_s)
                misses.pop(peer.node_id, None)
            except (asyncio.TimeoutError, ConnectionError, OSError):
                n = misses.get(peer.node_id, 0) + 1
                misses[peer.node_id] = n
                if n >= max_misses:
                    self.log.warning(
                        "peer %s missed %d heartbeats, dropping",
                        peer.node_id[:8], n,
                    )
                    # the eviction used to be silent (log line only):
                    # count it and record the black-box event BEFORE the
                    # drop, so the peer_dropped -> peer_lost order in
                    # /events reads as cause -> effect
                    self.metrics.incr("peer_dropped_total")
                    self.flight.record(
                        "peer_dropped", "warn", peer=peer.node_id[:16],
                        role=peer.role, missed_beats=n,
                    )
                    peer.stream.close()
                    self._drop_peer(peer)
                    misses.pop(peer.node_id, None)

        while not self._stopping:
            await asyncio.sleep(interval_s)
            if not self.peers and self._traffic_dog is not None:
                # nothing to monitor: an idle node is not unhealthy
                self._traffic_dog.kick()
            # concurrent: one hung peer must not delay liveness checks for
            # the rest (a round is bounded by one timeout, not k of them)
            await asyncio.gather(*(beat(p) for p in list(self.peers.values())))

    # ------------------------------------------------------------ DHT RPC
    async def dht_store(self, key: str, value: Any) -> int:
        """Store locally + replicate to the closest peers. Returns number
        of replicas written."""
        self.dht.put_local(key, value)
        n = 1
        for info in self.dht.table.closest(key, self.dht.replication):
            peer = self.peers.get(info.node_id)
            if peer is None:
                continue
            try:
                # idempotent by construction (a second store of the
                # same key/value is a no-op): retry through blips
                await self.request_idempotent(
                    peer, {"type": "DHT_STORE", "key": key, "value": value}
                )
                n += 1
            except (asyncio.TimeoutError, ConnectionError, OSError):
                continue
        return n

    async def dht_query(
        self, key: str, max_hops: int = 8, _exclude: set[str] | None = None
    ) -> Any | None:
        """Local hit, else recursive query of XOR-closest peers with
        timeout + exclusion (reference: query_dht, smart_node.py:587-680)."""
        local = self.dht.get_local(key)
        if local is not None:
            return local
        exclude = _exclude or {self.node_id}
        for info in self.dht.table.closest(key, k=8, exclude=exclude):
            if max_hops <= 0:
                break
            peer = self.peers.get(info.node_id)
            if peer is None:
                continue
            exclude.add(info.node_id)
            max_hops -= 1
            try:
                resp = await self.request_idempotent(
                    peer,
                    {"type": "DHT_QUERY", "key": key, "exclude": sorted(exclude)},
                )
                if resp.get("value") is not None:
                    return resp["value"]
            except (asyncio.TimeoutError, ConnectionError, OSError):
                continue
        return None

    # a PEER_LIST is peer-controlled: entry count and every field in
    # each record are clamped before the routing table sees them
    MAX_PEER_LIST = 256

    async def discover_peers(self, peer: Peer) -> list[PeerInfo]:
        """Ask a peer for its peer list; merge into routing table.
        Malformed entries are dropped (counted), not raised — one bad
        record must not discard the rest of the list."""
        resp = await self.request_idempotent(peer, {"type": "PEERS"})
        raw = resp.get("peers", [])
        raw = raw if isinstance(raw, (list, tuple)) else []
        if len(raw) > self.MAX_PEER_LIST:
            self.metrics.incr(
                "peer_list_rejected_total",
                len(raw) - self.MAX_PEER_LIST,
            )
            self.flight.record(
                "peer_list_clamped", "warn", peer=peer.node_id[:16],
                got=len(raw), kept=self.MAX_PEER_LIST,
            )
            raw = raw[: self.MAX_PEER_LIST]
        infos = []
        for d in raw:
            try:
                infos.append(PeerInfo.from_wire(d))
            except (KeyError, TypeError, ValueError):
                self.metrics.incr("peer_list_rejected_total")
        for i in infos:
            self.dht.table.add(i)
        return infos

    # ------------------------------------------------------------ handlers
    @wire_guard
    async def _h_ping(self, node, peer, msg) -> dict:
        out = {"type": "PONG", "t": time.time()}
        cap = self.capability_record()
        if cap is not None:
            out["capability"] = cap
        # metric-delta piggyback is requester opt-in (old nodes send a
        # bare PING and get a bare PONG); sizes are bounded on BOTH
        # sides — delta() clamps here, sanitize_delta clamps on ingest
        if "ts_since" in msg and self.timeseries is not None:
            since = msg.get("ts_since")
            if since is not None and not isinstance(since, (int, float)):
                since = None
            out["timeseries_delta"] = self.timeseries.delta(since)
            serving = getattr(self, "serving", None)
            if serving is not None and hasattr(serving, "kv_stats_summary"):
                try:  # off the loop: it takes the engine's lock
                    out["kv"] = await asyncio.to_thread(
                        serving.kv_stats_summary
                    )
                except Exception:  # noqa: BLE001
                    pass
        # work-receipt piggyback (runtime/ledger.py): signed finished-
        # request receipts (workers) and client-side token observations
        # (users) ride the PONG back to the auditing validator — no new
        # RPC round-trips. Drain-once semantics, so only a validator's
        # ping collects them; version-gated like timeseries_delta.
        if peer.role == "validator":
            stamped = False
            for attr, key in (
                ("pending_receipts", "receipts"),
                ("pending_receipt_obs", "receipt_obs"),
            ):
                fn = getattr(self, attr, None)
                if fn is None:
                    continue
                try:
                    items = fn()
                except Exception:  # noqa: BLE001 — telemetry only
                    continue
                if items:
                    out[key] = items
                    if not stamped:
                        from tensorlink_tpu_torch.runtime.ledger import (
                            RECEIPT_SCHEMA,
                        )

                        out["receipt_schema"] = RECEIPT_SCHEMA
                        stamped = True
        return out

    def _build_serving(self, engine, *, paged: bool = False, **kw):
        """Shared scheduler construction for the serving roles: wire
        this node's observability surfaces — metrics, flight recorder,
        tracer, compile/autotune caches, measured chip capability (so
        the engine's device_time reports MFU/MBU and per-request spans
        land in this node's /spans) — into the engine unless the caller
        overrides them, and attach it as ``self.serving``
        (:meth:`capability_record` and /node read it there)."""
        from tensorlink_tpu_torch.parallel.serving import (
            ContinuousBatchingEngine,
            PagedContinuousBatchingEngine,
        )

        kw.setdefault("metrics", self.metrics)
        kw.setdefault("recorder", self.flight)
        kw.setdefault("compile_cache_dir", self.cfg.compile_cache_dir)
        kw.setdefault("autotune_dir", self.cfg.autotune_dir)
        kw.setdefault("tracer", self.tracer)
        kw.setdefault("capability", self.capability)
        cls = (
            PagedContinuousBatchingEngine if paged
            else ContinuousBatchingEngine
        )
        self.serving = cls(engine, **kw)
        return self.serving

    def capability_record(self) -> dict | None:
        """This node's CapabilityRecord: the measured chip roofline
        (peak TFLOPs, HBM GB/s) plus — when a serving scheduler is
        attached — its live per-program device-time/MFU/MBU attribution,
        host-gap fraction, and (disaggregated serving) the advertised
        serving mode with live KV-pool headroom. None when there is
        neither a measurement nor an advertised serving role. Rides
        every PONG and is served at /node; WorkerNode extends it with
        per-stage program MFU."""
        mode = getattr(self, "serving_mode", None)
        if self.capability is None and mode is None:
            return None
        rec = dict(self.capability or {})
        serving = getattr(self, "serving", None)
        if serving is not None and hasattr(serving, "device_time"):
            try:
                dt = serving.device_time()
            except Exception:  # noqa: BLE001 — telemetry must not PONG 500s
                dt = None
            if dt:
                rec["programs"] = dt["programs"]
                rec["host_gap_frac"] = dt["host_gap_frac"]
        if mode is not None:
            rec["serving_mode"] = mode
            pool = getattr(serving, "pool", None)
            if pool is not None:
                # live headroom for the validator's placement gate: a
                # PONG's worth of staleness is the accepted tradeoff
                # (typed import backpressure covers the race)
                rec["kv_blocks_free"] = pool.available
                rec["kv_blocks_total"] = pool.num_blocks
                rec["kv_block_size"] = pool.block_size
        return rec

    def dht_store_allowed(self, peer: Peer, key: str) -> bool:
        """Remote-write policy. 'rep:' (reputation) keys are local-only —
        an unauthenticated peer must never set another node's reputation;
        roles may restrict further (validators: job records only from
        validators)."""
        return not key.startswith("rep:")

    # hostile-ingest clamps for remote DHT writes (tlproto TLP201):
    # key length, serialized value size, and total remote-fed keys are
    # bounded — rejects count into dht_rejected_total
    MAX_DHT_KEY_LEN = 256
    MAX_DHT_VALUE_BYTES = 64 << 10
    MAX_DHT_KEYS = 4096
    MAX_DHT_EXCLUDE = 64

    def _reject_dht(self, peer: Peer, key: str, why: str) -> dict:
        self.metrics.incr("dht_rejected_total")
        self.flight.record(
            "dht_rejected", "warn", peer=peer.node_id[:16],
            key=key[:64], why=why,
        )
        return {"type": "DHT_DENIED", "key": key, "why": why}

    def _clamp_dht_value(self, value):
        """Registered tlproto sanitizer for remote DHT writes: the
        value must be msgpack-encodable and fit the remote-write size
        budget. Returns the value unchanged, or None on reject (None is
        never worth storing — get_local reads it as a miss)."""
        try:
            # encode_message requires a "type" key; wrap the value in a
            # minimal envelope purely to measure its encoded size (the
            # lowercase type never leaves this function — not a frame)
            size = len(encode_message({"type": "dht-size-probe", "v": value}))
        except (TypeError, ValueError, OverflowError):
            return None
        if size > self.MAX_DHT_VALUE_BYTES:
            return None
        return value

    @wire_guard
    async def _h_dht_store(self, node, peer, msg) -> dict:
        key = str(msg.get("key", ""))[: self.MAX_DHT_KEY_LEN + 1]
        if not key or len(key) > self.MAX_DHT_KEY_LEN:
            return self._reject_dht(peer, key, "bad key")
        if not self.dht_store_allowed(peer, key):
            peer.ghosts += 1
            self._penalize(peer)
            return {"type": "DHT_DENIED", "key": key}
        value = self._clamp_dht_value(msg.get("value"))
        if value is None:
            return self._reject_dht(
                peer, key, "unencodable or oversized value",
            )
        if key not in self.dht.store and \
                len(self.dht.store) >= self.MAX_DHT_KEYS:
            return self._reject_dht(peer, key, "store full")
        self.dht.put_local(key, value)
        return {"type": "DHT_STORED"}

    @wire_guard
    async def _h_dht_query(self, node, peer, msg) -> dict:
        key = str(msg.get("key", ""))[: self.MAX_DHT_KEY_LEN]
        val = self.dht.get_local(key)
        if val is None:
            raw = msg.get("exclude")
            raw = raw if isinstance(raw, (list, tuple)) else []
            # bound the peer-fed exclusion set: it rides every recursive
            # hop of the lookup
            exclude = {
                str(x)[:128] for x in raw[: self.MAX_DHT_EXCLUDE]
            } | {self.node_id}
            val = await self.dht_query(key, max_hops=2, _exclude=exclude)
        return {"type": "DHT_VALUE", "key": key, "value": val}

    @wire_guard
    async def _h_peers(self, node, peer, msg) -> dict:
        return {
            "type": "PEER_LIST",
            "peers": [p.info.to_wire() for p in self.peers.values()],
        }

    # ------------------------------------------------------------ status
    def status(self) -> dict:
        """Self-report (reference: get_self_info + node_stats,
        smart_node.py:855-947)."""
        out = {
            "node_id": self.node_id,
            "role": self.role,
            "port": self.port,
            "peers": {
                p.node_id[:16]: {
                    "role": p.role,
                    "reputation": p.reputation,
                    "ping_ms": p.ping_ms,
                    "msgs_in": p.msgs_in,
                    "msgs_out": p.msgs_out,
                    "ghosts": p.ghosts,
                    "last_seen_age_s": round(time.time() - p.last_seen, 3),
                }
                for p in self.peers.values()
            },
            "dht_keys": len(self.dht.store),
            "routing_peers": len(self.dht.table),
            # per-stage step-time skew + heartbeat age (runtime/tracing):
            # populated from the stage{i}_fwd_s/_bwd_s series the master
            # and workers record per micro-batch
            "stragglers": self._straggler_report(),
        }
        serving = getattr(self, "serving", None)
        if serving is not None:
            # scheduler snapshot (queue depth, slot occupancy; paged
            # engines add KV-pool pressure + prefix hit rate) — tldiag
            # health tables read this to flag KV-PRESSURE
            try:
                out["serving"] = serving.stats()
            except Exception:  # noqa: BLE001 — status must not 500
                pass
        cap = self.capability_record()
        if cap is not None:
            out["capability"] = cap
        if self.peer_capabilities:
            # the live fleet table harvested from heartbeat PONGs —
            # on a validator this is the per-worker roofline view the
            # disaggregated-placement work (ROADMAP item 1) consumes
            out["fleet"] = {
                nid[:16]: rec
                for nid, rec in self.peer_capabilities.items()
            }
        auditor = getattr(self, "receipt_auditor", None)
        if auditor is not None:
            # headline numbers only — the full per-tenant/per-worker
            # rollup lives at GET /ledger (auditor.snapshot())
            out["ledger"] = {
                "accepted": auditor.accepted_total,
                "rejected": auditor.rejected_total,
                "anomalies": dict(auditor.anomaly_counts),
                "tenants": len(auditor.tenants),
                "workers": len(auditor.workers),
            }
        own = self.alerts.active()
        fleet = self.fleet_alerts.active()
        if own or fleet:
            out["alerts"] = {"own": own, "fleet": fleet}
        return out

    def _straggler_report(self) -> dict:
        from tensorlink_tpu_torch.runtime.tracing import straggler_report

        return straggler_report(self.metrics, self.peers)

    def postmortem(self, path: str, reason: str = "manual") -> str:
        """Dump this node's black box (events + spans + metrics +
        config + versions) to ``path`` — the same bundle the crash
        handler writes, callable on a live node."""
        from tensorlink_tpu_torch.runtime.flight import write_postmortem

        return write_postmortem(
            path, reason, recorder=self.flight, tracer=self.tracer,
            metrics=self.metrics, config=self.cfg,
            timeseries=self.timeseries,
        )
