"""Kademlia-style DHT data structures.

Same keyspace design as the reference (SHA-256 keys, XOR metric, 256
buckets — src/p2p/smart_node.py:44-95) with the two structural bugs fixed:
buckets actually participate in lookup, and the value store is separate
from the peer routing table (the reference mixed both in one dict,
smart_node.py:145, which is why delete() could evict validators,
§2.9.8). Network recursion lives in Node.dht_query/dht_store.

The port's copy of ``tensorlink_tpu/p2p/dht.py``, which uses no
framework: the port keeps its own so that it never imports the JAX
package. Keep the two in step.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Any, Iterable


def key_hash(key: str) -> int:
    return int.from_bytes(hashlib.sha256(key.encode()).digest(), "big")


def xor_distance(a: str, b: str) -> int:
    return key_hash(a) ^ key_hash(b)


@dataclass
class PeerInfo:
    node_id: str
    role: str
    host: str
    port: int
    last_seen: float = field(default_factory=time.time)
    # fallback candidate addresses (poor-man's ICE): a NAT'd node advertises
    # its UPnP external IP as `host` but hairpin NAT often fails for peers on
    # the same LAN — alt_hosts carries the bind/observed addresses so a
    # connector can try each in order
    alt_hosts: list = field(default_factory=list)

    def to_wire(self) -> dict:
        d = {
            "node_id": self.node_id,
            "role": self.role,
            "host": self.host,
            "port": self.port,
        }
        if self.alt_hosts:
            d["alt_hosts"] = list(self.alt_hosts)
        return d

    # wire-record clamps: peer lists and DHT values carry these records
    # from untrusted peers, and every parsed one is held in the routing
    # table — bound each field so a hostile record cannot smuggle
    # megabyte strings into memory (tlproto registered sanitizer)
    MAX_ID_LEN = 128
    MAX_ROLE_LEN = 32
    MAX_HOST_LEN = 256
    MAX_ALT_HOSTS = 8

    @classmethod
    def from_wire(cls, d: dict) -> "PeerInfo":
        """Parse an untrusted wire record. Raises KeyError/TypeError/
        ValueError on a malformed one — callers drop-and-count."""
        port = int(d["port"])
        if isinstance(d["port"], bool) or not (0 < port < 65536):
            raise ValueError(f"peer record port out of range: {port}")
        node_id = str(d["node_id"])[: cls.MAX_ID_LEN]
        if not node_id:
            raise ValueError("peer record has an empty node_id")
        return cls(
            node_id=node_id,
            role=str(d["role"])[: cls.MAX_ROLE_LEN],
            host=str(d["host"])[: cls.MAX_HOST_LEN],
            port=port,
            alt_hosts=[
                str(h)[: cls.MAX_HOST_LEN]
                for h in list(d.get("alt_hosts", []))[: cls.MAX_ALT_HOSTS]
            ],
        )


class RoutingTable:
    """256 XOR-prefix buckets of PeerInfo, bounded size each."""

    def __init__(self, self_id: str, bucket_size: int = 16):
        self.self_id = self_id
        self.bucket_size = bucket_size
        self.buckets: list[dict[str, PeerInfo]] = [{} for _ in range(256)]

    def _bucket_index(self, node_id: str) -> int:
        d = xor_distance(self.self_id, node_id)
        return max(d.bit_length() - 1, 0) if d else 0

    def add(self, info: PeerInfo) -> None:
        if info.node_id == self.self_id:
            return
        b = self.buckets[self._bucket_index(info.node_id)]
        if info.node_id in b or len(b) < self.bucket_size:
            b[info.node_id] = info

    def remove(self, node_id: str) -> None:
        self.buckets[self._bucket_index(node_id)].pop(node_id, None)

    def get(self, node_id: str) -> PeerInfo | None:
        return self.buckets[self._bucket_index(node_id)].get(node_id)

    def all_peers(self) -> list[PeerInfo]:
        return [p for b in self.buckets for p in b.values()]

    def closest(self, key: str, k: int = 3, exclude: Iterable[str] = ()) -> list[PeerInfo]:
        ex = set(exclude)
        peers = [p for p in self.all_peers() if p.node_id not in ex]
        target = key_hash(key)
        peers.sort(key=lambda p: key_hash(p.node_id) ^ target)
        return peers[:k]

    def __len__(self) -> int:
        return sum(len(b) for b in self.buckets)


class DHT:
    """Local value store + routing table. Values are plain msgpack-able
    data (job records, worker adverts) — never code."""

    def __init__(self, self_id: str, replication: int = 3, bucket_size: int = 16):
        self.table = RoutingTable(self_id, bucket_size)
        self.store: dict[str, Any] = {}
        self.replication = replication

    def put_local(self, key: str, value: Any) -> None:
        self.store[key] = value

    def get_local(self, key: str) -> Any | None:
        return self.store.get(key)

    def delete_local(self, key: str) -> bool:
        return self.store.pop(key, None) is not None

    def snapshot(self) -> dict:
        """Persistable state (reference: save_dht_state,
        smart_node.py:701-728)."""
        return {
            "store": self.store,
            "peers": [p.to_wire() for p in self.table.all_peers()],
        }

    def restore(self, snap: dict) -> None:
        self.store.update(snap.get("store", {}))
        for d in snap.get("peers", []):
            self.table.add(PeerInfo.from_wire(d))
