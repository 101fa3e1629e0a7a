"""PyTorch port, the P2P control plane: p2p/crypto.py (``new_nonce``),
p2p/serialization.py (the message codec and the chunked streams),
p2p/connection.py, p2p/dht.py, p2p/nat.py, p2p/node.py and
``config.config_from_env``.

- The message codec is the port's own msgpack subset: a hypothesis
  property over generated message trees (nested maps and lists, int map
  keys, negative and 64-bit ints, float64, bool, nil, str, bin) holds
  its bytes equal to ``msgpack.packb(m, use_bin_type=True)``, and each
  side decodes the other's. Streams, frames, routing-table order and
  UPnP discovery and SOAP calls against one fake gateway are held to the
  reference's modules on the same inputs.
- The reference's own node and NAT cases (tests/test_p2p.py,
  tests/test_nat.py) run on port nodes over 127.0.0.1.
- A port ``Node`` and a reference ``Node`` in one event loop: handshake
  both ways, PING/PONG with ``ts_since``, a DHT store on one and a lookup
  from the other, and one stream of arrays each way.
- ``Node._build_serving`` builds the port's paged engine with the node's
  metrics, flight recorder and tracer: a reference node's PING gets the
  engine's ``kv_stats_summary`` and its device-time programs, and the
  status server answers ``GET /kv`` and ``GET /metrics``.
"""

import asyncio
import json
import math
import socket
import threading
import urllib.request

import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tensorlink_tpu.config import NodeConfig as JNodeConfig
from tensorlink_tpu.p2p import connection as jconnection
from tensorlink_tpu.p2p import dht as jdht
from tensorlink_tpu.p2p import nat as jnat
from tensorlink_tpu.p2p import serialization as jser
from tensorlink_tpu.p2p.node import Node as JNode
from tensorlink_tpu_torch import config as tconfig
from tensorlink_tpu_torch.config import NodeConfig
from tensorlink_tpu_torch.p2p import connection, nat
from tensorlink_tpu_torch.p2p import serialization as ser
from tensorlink_tpu_torch.p2p.crypto import Identity, new_nonce
from tensorlink_tpu_torch.p2p.dht import DHT, PeerInfo, RoutingTable
from tensorlink_tpu_torch.p2p.nat import UpnpError, UpnpGateway, scan_bind_port
from tensorlink_tpu_torch.p2p.node import Node
from test_nat import FakeIGD


# ------------------------------------------------------------ the codec

_leaves = (st.none() | st.booleans()
           | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
           | st.floats(allow_nan=False) | st.text(max_size=40)
           | st.binary(max_size=40))
_trees = st.recursive(
    _leaves,
    lambda kids: (st.lists(kids, max_size=6)
                  | st.dictionaries(st.text(max_size=8) | st.integers(-300, 300),
                                    kids, max_size=6)),
    max_leaves=24,
)
_messages = st.builds(lambda t, body: {"type": t, **body}, st.text(max_size=12),
                      st.dictionaries(st.text(max_size=8).filter(lambda k: k != "type"),
                                      _trees, max_size=5))


@settings(max_examples=200, deadline=None)
@given(_messages)
def test_codec_bytes_equal_msgpack(msg):
    ours = ser.encode_message(msg)
    theirs = msgpack.packb(msg, use_bin_type=True)
    assert ours == theirs
    assert ser.decode_message(theirs) == msg
    assert msgpack.unpackb(ours, raw=False, strict_map_key=False) == msg


@pytest.mark.parametrize("n", [31, 32, 255, 256, 65535, 65536])
def test_codec_length_forms_equal_msgpack(n):
    """Each str, bin, array and map length form, at its boundaries."""
    msg = {"type": "X", "s": "a" * n, "b": b"\x01" * n,
           "l": list(range(min(n, 70000))),
           "m": {i: i for i in range(min(n, 70000))},
           "f": [0.0, -0.0, math.inf, -math.inf, 1e308, 5e-324]}
    ours = ser.encode_message(msg)
    assert ours == msgpack.packb(msg, use_bin_type=True)
    assert ser.decode_message(ours) == msg


def test_codec_refusals():
    """The reference's contract: a message needs a string type, nothing
    executable serializes, malformed and truncated input raise
    ``ValueError``, and only messages accept non-string map keys."""
    class Evil:
        pass

    with pytest.raises(ValueError):
        ser.encode_message({"payload": 1})
    with pytest.raises(TypeError):
        ser.encode_message({"type": "X", "obj": Evil()})
    with pytest.raises(OverflowError):
        ser.encode_message({"type": "X", "n": 1 << 64})
    good = ser.encode_message({"type": "X", "n": [1, 2, 3]})
    bad_utf8 = ser.encode_message({"type": "X"})[:-1] + b"\xff"
    for bad in (good[:-1], bad_utf8, good + b"\x00", b"\xc1"):
        with pytest.raises(ValueError):
            ser.decode_message(bad)
        with pytest.raises(ValueError):
            jser.decode_message(bad)
    with pytest.raises(ValueError):
        ser.decode_message(msgpack.packb([1, 2]))
    with pytest.raises(ValueError):
        ser.unpackb(msgpack.packb({1: 2}))
    deep = b"\x91" * 1000 + b"\xc0"
    with pytest.raises(ValueError):
        ser.unpackb(deep)
    assert ser.decode_message(msgpack.packb({"type": "T", 7: {-1: None}})) == \
        {"type": "T", 7: {-1: None}}


def test_message_roundtrip():
    msg = {"type": "JOB_REQ", "n": 3, "blob": b"\x00\x01", "nested": {"a": [1, 2]}}
    assert ser.decode_message(ser.encode_message(msg)) == msg


def test_config_from_env_matches_reference():
    from tensorlink_tpu.config import config_from_env as jconfig_from_env

    env = {"TLTPU_MESH_DATA": "2", "TLTPU_MESH_MODEL": "4"}
    assert tconfig.config_from_env(env).to_dict() == jconfig_from_env(env).to_dict()
    assert tconfig.config_from_env({}).mesh == tconfig.MeshConfig()


# ------------------------------------------------------------ streams


def _arrays():
    r = np.random.default_rng(0)
    return {"w": r.normal(size=(16, 9)).astype(np.float32),
            "i": np.arange(7, dtype=np.int64), "e": np.zeros((0,), np.int32),
            "h": np.ones((3, 5), np.float16)}


def test_stream_helpers_match_reference():
    arrays = _arrays()
    assert ser.stream_manifest(arrays) == jser.stream_manifest(arrays)
    assert list(ser.iter_array_chunks(arrays, 100)) == list(jser.iter_array_chunks(arrays, 100))
    assert ser.STREAM_CHUNK_BYTES == jser.STREAM_CHUNK_BYTES
    # the reference's chunks, fed out of order, assemble on the port
    got = {}
    asm = ser.StreamAssembler(ser.stream_manifest(arrays),
                              lambda n, t: got.__setitem__(n, t))
    for name, off, data in reversed(list(jser.iter_array_chunks(arrays, 64))):
        assert not asm.done
        asm.feed(name, off, data)
    assert asm.done and set(got) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k].numpy(), v)
    with pytest.raises(ValueError):
        asm.feed("w", 0, b"\x00" * 4)  # after completion
    with pytest.raises(ValueError):
        asm.feed("nope", 0, b"")


def test_bf16_stream_reaches_the_reference_as_its_bits():
    t = torch.linspace(-3, 3, 40, dtype=torch.bfloat16).reshape(5, 8)
    man = ser.stream_manifest({"t": t})
    assert man["tensors"]["t"] == {"dtype": "bfloat16", "shape": [5, 8], "nbytes": 80}
    got = {}
    asm = jser.StreamAssembler(man, lambda n, a: got.__setitem__(n, a))
    for name, off, data in ser.iter_array_chunks({"t": t}, 32):
        asm.feed(name, off, data)
    assert got["t"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(got["t"].view(np.uint16), t.view(torch.int16).numpy().view(np.uint16))


# ------------------------------------------------------------ crypto


def test_identity_and_nonce():
    a, b = Identity.generate(), Identity.generate()
    sig = a.sign(b"challenge")
    assert Identity.verify(a.public_der, sig, b"challenge")
    assert not Identity.verify(b.public_der, sig, b"challenge")
    assert a.node_id != b.node_id and len(a.node_id) == 64
    n1, n2 = new_nonce(), new_nonce()
    assert len(n1) == 32 and n1 != n2


def test_identity_persistence(tmp_path):
    a = Identity.load_or_generate(tmp_path, "worker")
    assert Identity.load_or_generate(tmp_path, "worker").node_id == a.node_id
    assert Identity.load_or_generate(tmp_path, "validator").node_id != a.node_id


# ------------------------------------------------------------ connection


async def _stream_pair(send_mod, recv_mod, **kw):
    got = asyncio.get_running_loop().create_future()

    async def accept(reader, writer):
        got.set_result(recv_mod.FramedStream(reader, writer))

    server = await asyncio.start_server(accept, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    tx = send_mod.FramedStream(reader, writer, **kw)
    rx = await got
    return server, tx, rx


@pytest.mark.asyncio
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
async def test_frames_cross_between_packages(direction):
    mods = (connection, jconnection) if direction == "port_to_ref" else (jconnection, connection)
    server, tx, rx = await _stream_pair(*mods, compression="zstd",
                                        compression_min_bytes=64, integrity=True)
    try:
        payloads = [b"x", bytes(range(256)) * 40, ser.encode_message({"type": "A"})]
        for p in payloads:
            await tx.send(p)
        assert [await rx.recv() for _ in payloads] == payloads
    finally:
        tx.close()
        rx.close()
        server.close()


@pytest.mark.asyncio
async def test_frames_fall_back_to_zlib_without_zstandard(monkeypatch):
    """A host without ``zstandard`` (the card's) sends zlib frames that
    say so, which the reference reads; it refuses a zstd frame."""
    server, tx, rx = await _stream_pair(connection, jconnection, compression="zstd",
                                        compression_min_bytes=16, integrity=True)
    try:
        monkeypatch.setattr(ser, "_zstd", None)
        big = bytes(range(256)) * 8
        await tx.send(big)
        assert await rx.recv() == big
        with pytest.raises(ValueError, match="zstandard"):
            ser._decompress(b"\x28\xb5\x2f\xfd", "zstd")
    finally:
        tx.close()
        rx.close()
        server.close()


# ------------------------------------------------------------ DHT


def test_routing_table_closest_matches_reference():
    ids = [f"{int(x):064x}" for x in np.random.default_rng(5).integers(1, 1 << 62, 60)]
    port, ref = RoutingTable("a" * 64), jdht.RoutingTable("a" * 64)
    for i in ids:
        port.add(PeerInfo(node_id=i, role="worker", host="h", port=1))
        ref.add(jdht.PeerInfo(node_id=i, role="worker", host="h", port=1))
    for key in ids[:5] + ["job:1", "rep:x"]:
        for k, ex in ((3, ()), (8, set(ids[:10]))):
            assert [p.node_id for p in port.closest(key, k=k, exclude=ex)] == \
                [p.node_id for p in ref.closest(key, k=k, exclude=ex)]
    close = port.closest(ids[5], k=3)
    assert close[0].node_id == ids[5] and len(close) == 3


def test_dht_store_separate_from_peers():
    dht = DHT("a" * 64)
    dht.table.add(PeerInfo(node_id="b" * 64, role="validator", host="h", port=1))
    dht.put_local("job1", {"x": 1})
    assert dht.delete_local("job1")
    assert len(dht.table) == 1
    dht2 = jdht.DHT("c" * 64)
    dht2.restore(dht.snapshot())  # the snapshot is the reference's form
    assert len(dht2.table) == 1


# ------------------------------------------------------------ NAT


def test_scan_bind_port_skips_taken_ports():
    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    base = blocker.getsockname()[1]
    try:
        assert scan_bind_port("127.0.0.1", base, max_tries=10) > base
    finally:
        blocker.close()


def test_upnp_discovery_and_soap_match_reference():
    """SSDP discovery, the description XML and the SOAP calls of both
    packages against one fake gateway: the same gateway record, external
    address and mappings, and the same refusal of an unknown mapping."""
    with FakeIGD() as igd:
        gws = [mod.UpnpGateway.discover(timeout=2.0, ssdp_addr=igd.ssdp_addr)
               for mod in (nat, jnat)]
        assert [vars(g) for g in gws] == [vars(gws[1])] * 2
        assert gws[0].service_type.endswith("WANIPConnection:1")
        for gw, port in zip(gws, (38751, 38752)):
            assert gw.external_ip() == "203.0.113.7"
            gw.add_port_mapping(port, port, description="node", lease_s=3600)
        a, b = igd.mappings[(38751, "TCP")], igd.mappings[(38752, "TCP")]
        assert a["desc"] == b["desc"] == "node" and a["lease"] == b["lease"] == 3600
        assert a["internal"][0] == b["internal"][0]
        gws[0].delete_port_mapping(38751)
        assert (38751, "TCP") not in igd.mappings
        with pytest.raises(UpnpError):
            gws[0].delete_port_mapping(40000)
        with pytest.raises(jnat.UpnpError):
            gws[1].delete_port_mapping(40000)


def test_discover_timeout_no_gateway():
    silent = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    silent.bind(("127.0.0.1", 0))
    try:
        with pytest.raises(UpnpError):
            UpnpGateway.discover(timeout=0.5, ssdp_addr=silent.getsockname())
    finally:
        silent.close()


@pytest.mark.asyncio
async def test_node_maps_and_unmaps_on_lifecycle():
    with FakeIGD() as igd:
        node = Node(NodeConfig(role="worker", port=0, upnp=True,
                               upnp_ssdp_addr=igd.ssdp_addr, upnp_lease_s=7200))
        await node.start()
        try:
            key = (node.port, "TCP")
            assert key in igd.mappings and igd.mappings[key]["internal"][1] == node.port
            assert node.external_ip == "203.0.113.7"
        finally:
            await node.stop()
        assert (node.port, "TCP") not in igd.mappings


@pytest.mark.asyncio
async def test_node_survives_missing_gateway_and_scans_ports():
    silent = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    silent.bind(("127.0.0.1", 0))
    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    base = blocker.getsockname()[1]
    try:
        node = Node(NodeConfig(role="worker", port=-1, base_port=base, upnp=True,
                               upnp_timeout_s=0.3,
                               upnp_ssdp_addr=silent.getsockname()))
        await node.start()
        assert node.port > base  # listening above the taken base, unmapped
        await node.stop()
    finally:
        silent.close()
        blocker.close()


# ------------------------------------------------------------ port nodes


def _cfg(role="worker", **kw):
    return NodeConfig(role=role, host="127.0.0.1", port=0, **kw)


async def _start(*nodes):
    for n in nodes:
        await n.start()
    return nodes


@pytest.mark.asyncio
async def test_handshake_ping_ghosts_and_discovery():
    a, b, c = await _start(Node(_cfg("user")), Node(_cfg("validator")), Node(_cfg()))
    try:
        peer_b = await a.connect("127.0.0.1", b.port)
        assert peer_b.role == "validator"
        assert await a.ping(peer_b) >= 0
        await asyncio.sleep(0.05)
        assert a.node_id in b.peers
        await a.send(peer_b, {"type": "NO_SUCH_TYPE"})
        await asyncio.sleep(0.1)
        bp = b.peers[a.node_id]
        assert bp.ghosts == 1 and bp.reputation < 1.0
        pc_b = await c.connect("127.0.0.1", b.port)
        await asyncio.sleep(0.05)
        assert a.node_id in {i.node_id for i in await c.discover_peers(pc_b)}
        # a dial that handshakes as the wrong node fails without dropping
        # the healthy connection
        with pytest.raises(ConnectionError):
            await a.connect_candidates("127.0.0.1", b.port, expect_id="f" * 64)
        assert a.peers.get(b.node_id) is peer_b
        assert (await a.request(peer_b, {"type": "PING"}))["type"] == "PONG"
    finally:
        for n in (a, b, c):
            await n.stop()


@pytest.mark.asyncio
async def test_concurrent_dials_to_one_node_share_one_connection():
    """Two dials to one node at once (two relay hops that both found no
    peer, as a pipeline stage relaying two prompts' prefill chunks does)
    share one connection: a second registration would close the first
    stream under the request in flight on it, whose reply is then lost
    and which rides out its whole timeout."""
    a, b = await _start(Node(_cfg()), Node(_cfg()))
    try:
        p1, p2 = await asyncio.gather(*(
            a.connect_candidates("127.0.0.1", b.port, expect_id=b.node_id)
            for _ in range(2)))
        assert p1 is p2 and a.peers[b.node_id] is p1 and not a._dials
        r1, r2 = await asyncio.gather(
            a.request(p1, {"type": "PING"}, timeout=10.0),
            a.request(p2, {"type": "PING"}, timeout=10.0))
        assert r1["type"] == r2["type"] == "PONG"
        joined = [e for e in b.flight.events() if e.get("kind") == "peer_joined"]
        assert len(joined) == 1
        # a dial that fails is shared too, and leaves nothing behind
        results = await asyncio.gather(*(
            a.connect_candidates("127.0.0.1", b.port, expect_id="f" * 64)
            for _ in range(2)), return_exceptions=True)
        assert all(isinstance(r, ConnectionError) for r in results)
        assert not a._dials and a.peers.get(b.node_id) is p1
    finally:
        for n in (a, b):
            await n.stop()


@pytest.mark.asyncio
async def test_cancelled_dial_caller_leaves_joined_dial_running():
    """A caller cancelled while another has joined its dial (a node's
    stop, or an outer deadline, reaching one relay hop) does not cancel
    the dial under the other: the joined caller still gets the peer."""
    a, b = await _start(Node(_cfg()), Node(_cfg()))
    gate, connect = asyncio.Event(), a.connect

    async def held_connect(*args, **kw):
        await gate.wait()
        return await connect(*args, **kw)

    a.connect = held_connect
    try:
        dial = lambda: asyncio.ensure_future(a.connect_candidates(  # noqa: E731
            "127.0.0.1", b.port, expect_id=b.node_id))
        first = dial()
        await asyncio.sleep(0)
        assert b.node_id in a._dials
        second = dial()
        await asyncio.sleep(0)
        first.cancel()
        with pytest.raises(asyncio.CancelledError):
            await first
        gate.set()
        peer = await asyncio.wait_for(second, 10.0)
        assert a.peers[b.node_id] is peer and not a._dials
        assert (await a.request(peer, {"type": "PING"}, timeout=10.0))["type"] == "PONG"
    finally:
        gate.set()
        for n in (a, b):
            await n.stop()


@pytest.mark.asyncio
async def test_dht_across_nodes_and_request_timeout():
    a, b, c = await _start(Node(_cfg("validator")), Node(_cfg("validator")), Node(_cfg("user")))
    try:
        await a.connect("127.0.0.1", b.port)
        await a.dht_store("job:42", {"author": "me", "size": 3})
        pa = await c.connect("127.0.0.1", a.port)
        assert await c.dht_query("job:42") == {"author": "me", "size": 3}
        assert await c.dht_query("job:nope") is None

        async def slow(node, p, msg):
            await asyncio.sleep(1.0)
            return {"type": "LATE"}

        a.on("SLOW", slow)
        with pytest.raises(asyncio.TimeoutError):
            await c.request(pa, {"type": "SLOW"}, timeout=0.1)
    finally:
        for n in (a, b, c):
            await n.stop()


def test_status_snapshot():
    s = Node(_cfg("validator")).status()
    assert s["role"] == "validator" and s["dht_keys"] == 0


# ------------------------------------------------ port node <-> reference node


def _ref_cfg(role):
    return JNodeConfig(role=role, host="127.0.0.1", port=0)


@pytest.mark.asyncio
@pytest.mark.parametrize("dialer", ["port", "reference"])
async def test_port_and_reference_nodes_talk(dialer):
    """One port node and one reference node on loopback, either side
    dialing: the handshake, PING/PONG with ``ts_since`` both ways, a DHT
    store on each side found from the other, and a stream each way."""
    p, r = Node(_cfg("validator")), JNode(_ref_cfg("validator"))
    await p.start()
    await r.start()
    try:
        if dialer == "port":
            to_r = await p.connect("127.0.0.1", r.port)
            await asyncio.sleep(0.05)
            to_p = r.peers[p.node_id]
        else:
            to_p = await r.connect("127.0.0.1", p.port)
            await asyncio.sleep(0.05)
            to_r = p.peers[r.node_id]
        assert to_r.node_id == r.node_id and to_p.node_id == p.node_id
        assert to_r.stream.integrity and to_p.stream.integrity  # "crc" negotiated

        for node, peer in ((p, to_r), (r, to_p)):
            node.metrics.incr("probe_total")
            pong = await node.request(peer, {"type": "PING", "ts_since": 0})
            assert pong["type"] == "PONG" and "timeseries_delta" in pong
            assert await node.ping(peer) >= 0

        assert await p.dht_store("job:port", {"from": "port", "n": [1, 2]}) == 2
        assert await r.dht_store("job:ref", {"from": "ref", 3: -4}) == 2
        assert r.dht.get_local("job:port") == {"from": "port", "n": [1, 2]}
        assert await p.dht_query("job:ref") == {"from": "ref", 3: -4}
        p.dht.store.pop("job:ref")  # the lookup now crosses the wire
        assert await p.dht_query("job:ref") == {"from": "ref", 3: -4}

        arrays = _arrays()
        got = {"port": {}, "ref": {}}

        def kind(side):
            async def factory(peer, meta, manifest):
                async def finish():
                    return {"type": "LOADED", "n": len(got[side]), "meta": meta}

                return (lambda name, arr: got[side].__setitem__(name, arr)), finish
            return factory

        p.register_stream_kind("T", kind("port"))
        r.register_stream_kind("T", kind("ref"))
        t = torch.arange(12, dtype=torch.bfloat16).reshape(3, 4)
        resp = await p.send_stream(to_r, "T", {"k": 1}, {**arrays, "bf": t}, chunk_bytes=64)
        assert resp == {"type": "LOADED", "n": 5, "meta": {"k": 1}, "re": resp["re"]}
        resp = await r.send_stream(to_p, "T", {"k": 2}, arrays, chunk_bytes=64)
        assert resp["type"] == "LOADED" and resp["n"] == 4
        for k, v in arrays.items():
            np.testing.assert_array_equal(got["ref"][k], v)
            np.testing.assert_array_equal(got["port"][k].numpy(), v)
        assert got["ref"]["bf"].dtype.name == "bfloat16"
        np.testing.assert_array_equal(got["ref"]["bf"].astype(np.float32),
                                      t.float().numpy())
    finally:
        await p.stop()
        await r.stop()


def _http_get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return json.loads(resp.read())


@pytest.mark.asyncio
async def test_node_builds_serving_with_its_telemetry():
    """``_build_serving`` hands the node's metrics, flight recorder,
    tracer and capability to the port's paged engine; a reference node's
    PING then carries the engine's KV summary and device-time programs,
    and the status server serves ``/kv`` and ``/metrics``."""
    from tensorlink_tpu_torch.models.llama import Llama, LlamaConfig
    from tensorlink_tpu_torch.parallel.inference import GenerationConfig, InferenceEngine

    node = Node(_cfg("worker", http_status_port=0))
    node.capability = {"schema": 1, "chip": "cpu", "peak_tflops": 1.0, "hbm_gbps": 1.0}
    ref = JNode(_ref_cfg("validator"))
    await node.start()
    await ref.start()
    try:
        eng = InferenceEngine(Llama(LlamaConfig.tiny(), device="cpu", seed=3), max_len=32,
                              device="cpu", cache_dtype=torch.float32,
                              param_dtype=torch.float32)
        sch = node._build_serving(eng, paged=True, slots=2, block_size=4,
                                  gen=GenerationConfig(max_new_tokens=4))
        assert node.serving is sch and sch.metrics is node.metrics
        assert sch.recorder is node.flight and sch.tracer is node.tracer
        r = np.random.default_rng(1)
        rids = [sch.submit(r.integers(0, 128, (n,))) for n in (5, 9)]
        await asyncio.to_thread(lambda: [sch.result(i) for i in rids])
        assert node.metrics.counters["serving_requests_total"] == 2
        assert node.flight.counts["serving.admit"] == 2
        assert sum(s.name == "serving.request" for s in node.tracer.spans()) == 2

        peer = await ref.connect("127.0.0.1", node.port)
        pong = await ref.request(peer, {"type": "PING", "ts_since": 0})
        assert pong["kv"] == sch.kv_stats_summary()
        dt = sch.device_time()
        assert pong["capability"]["programs"] == json.loads(json.dumps(dt["programs"]))
        assert pong["capability"]["host_gap_frac"] == dt["host_gap_frac"]
        await ref.ping(peer)  # the reference's ingest of the port's PONG
        assert ref.peer_capabilities[node.node_id]["peak_tflops"] == 1.0

        port = node._http.bound_port
        kv = await asyncio.to_thread(_http_get, port, "/kv?limit=8")
        assert kv["pool"] == sch.kv_stats(limit=8)["pool"]
        met = await asyncio.to_thread(_http_get, port, "/metrics")
        assert met["counters"]["serving_tokens_total"] == 8
    finally:
        await ref.stop()
        await node.stop()


# a loop that waits on the serving lock is freed only by this backstop
LOCK_BACKSTOP_S = 10.0


class _LockedServing:
    """A serving engine's KV surface behind its step lock."""

    def __init__(self):
        self._lock = threading.Lock()

    def kv_stats_summary(self):
        with self._lock:
            return {"occupancy": 0.25, "fragmentation": 0.0, "chains": 1}

    def kv_stats(self, limit=64):
        with self._lock:
            return {"pool": {"blocks_in_use": 1}, "chains": []}


@pytest.mark.asyncio
async def test_node_loop_does_not_wait_on_the_serving_lock():
    """The engine's lock is held for a whole step (seconds at a graph
    capture on the card): the node's timeseries tick, a PING with
    ``ts_since`` and ``GET /kv`` wait for it off the event loop, which
    keeps running (a loop that waited showed as event-loop lag > 1 s and
    an unhealthy node), and they answer once the step lets go.

    The test holds the lock itself while the loop beats 30 times and
    lets go only after it has seen both requests still pending. A loop
    that waited on the lock could never beat again: only a backstop
    thread, which lets go after LOCK_BACKSTOP_S, would free it, and the
    test fails if the backstop had to. So the result hangs on no timer
    racing the loop and on no bound of the loop's lag."""
    node = Node(_cfg("worker", http_status_port=0, timeseries_interval_s=0.05))
    other = Node(_cfg("validator"))
    await _start(node, other)
    serving = node.serving = _LockedServing()
    guard, rescued, done = threading.Lock(), threading.Event(), []

    def backstop():
        with guard:
            if not done:
                rescued.set()
                serving._lock.release()

    def let_go():
        with guard:
            done.append(True)
            if not rescued.is_set():
                serving._lock.release()

    timer = threading.Timer(LOCK_BACKSTOP_S, backstop)
    try:
        peer = await other.connect("127.0.0.1", node.port)
        serving._lock.acquire()  # a step in flight, until the test lets go
        timer.start()
        port = node._http.bound_port
        kv = asyncio.ensure_future(asyncio.to_thread(_http_get, port, "/kv"))
        pong = asyncio.ensure_future(other.request(peer, {"type": "PING", "ts_since": 0}))
        beats = 0
        for _ in range(30):  # the loop's beats while the step runs
            await asyncio.sleep(0.02)
            beats += 1
        assert beats == 30 and not rescued.is_set(), "the loop waited on the lock"
        assert not pong.done() and not kv.done()  # both wait on the step
        let_go()
        assert (await pong)["kv"] == serving.kv_stats_summary()
        assert (await kv)["pool"] == {"blocks_in_use": 1}
        assert node.timeseries.kind("kv_occupancy") == "gauge"
    finally:
        timer.cancel()
        if not done and serving._lock.locked():
            let_go()
        await other.stop()
        await node.stop()


@pytest.mark.asyncio
async def test_natted_worker_reachable_via_alt_host():
    """A NAT'd port worker advertises its external IP, which same-host
    peers cannot dial; the port validator's recruitment carries the
    observed address as a fallback candidate, so the port user reaches
    the worker and trains a step."""
    from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig
    from tensorlink_tpu_torch.roles.registry import InMemoryRegistry
    from tensorlink_tpu_torch.roles.user import UserNode
    from tensorlink_tpu_torch.roles.validator import ValidatorNode
    from tensorlink_tpu_torch.roles.worker import WorkerNode

    with FakeIGD() as igd:
        validator = ValidatorNode(NodeConfig(role="validator", port=0),
                                  registry=InMemoryRegistry(), device="cpu")
        await validator.start()
        worker = WorkerNode(NodeConfig(role="worker", port=0, upnp=True,
                                       upnp_ssdp_addr=igd.ssdp_addr), device="cpu")
        await worker.start()
        assert worker.info.host == "203.0.113.7"
        assert worker.info.alt_hosts == []
        await worker.connect("127.0.0.1", validator.port)
        user = UserNode(NodeConfig(role="user", port=0, connect_timeout_s=1.0))
        await user.start()
        v_peer = await user.connect("127.0.0.1", validator.port)
        try:
            m = MLP(MLPConfig(in_dim=8, hidden_dim=8, out_dim=4, num_layers=1),
                    device="cpu")
            job = await user.request_job(
                m.seq, dict(m.seq.named_parameters()), v_peer,
                max_stage_bytes=1 << 30, micro_batches=1,
                train={"optimizer": "sgd", "learning_rate": 0.1})
            assert [st.peer.node_id for st in job.stages] == [worker.node_id]

            def loss_grad(logits, micro):
                g = logits.float()
                return float((g ** 2).mean()), 2 * g / g.numel()

            loss = await job.train_step(torch.ones((4, 8)), loss_grad)
            assert math.isfinite(loss)
        finally:
            for n in (user, worker, validator):
                await n.stop()
