"""Stdlib JSON-RPC client for EVM endpoints.

Covers exactly what the registry needs — `eth_call` reads and
`eth_sendTransaction` writes against a node-managed account — the same
read-mostly surface the reference exercises through web3.py
(src/p2p/smart_node.py:522-537; its transaction paths are commented out,
src/roles/user.py:171-199). No signing machinery: deployments that need
local signing can front this with any standard signer; the control-plane
protocol never depends on it.

The port's copy of ``tensorlink_tpu/chain/rpc.py``, which uses no
framework: the port keeps its own so that it never imports the JAX
package. Keep the two in step.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request


class ChainError(RuntimeError):
    """JSON-RPC transport or EVM-level error."""


class ChainRpc:
    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout
        self._id = 0

    def request(self, method: str, params: list):
        self._id += 1
        body = json.dumps(
            {"jsonrpc": "2.0", "id": self._id, "method": method, "params": params}
        ).encode()
        req = urllib.request.Request(
            self.url, data=body, headers={"Content-Type": "application/json"}
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                payload = json.loads(resp.read())
        except (urllib.error.URLError, OSError, json.JSONDecodeError) as e:
            raise ChainError(f"rpc {method} failed: {e}") from e
        if payload.get("error"):
            raise ChainError(f"rpc {method}: {payload['error']}")
        return payload.get("result")

    # ------------------------------------------------------------- eth helpers
    def eth_call(self, to: str, data: bytes) -> bytes:
        result = self.request(
            "eth_call", [{"to": to, "data": "0x" + data.hex()}, "latest"]
        )
        return bytes.fromhex(result[2:]) if result and result != "0x" else b""

    def send_transaction(self, to: str, data: bytes, sender: str | None = None) -> str:
        tx = {"to": to, "data": "0x" + data.hex()}
        if sender:
            tx["from"] = sender
        return self.request("eth_sendTransaction", [tx])

    def get_transaction_receipt(self, tx_hash: str) -> dict | None:
        """Receipt (status + event logs) for a mined transaction; None
        while pending/unknown. The logs are how a transaction's "return
        value" actually reaches a JSON-RPC client (chain/registry.py
        request_job_onchain parses JobRequested from here)."""
        out = self.request("eth_getTransactionReceipt", [tx_hash])
        return out if isinstance(out, dict) else None

    def chain_id(self) -> int:
        return int(self.request("eth_chainId", []), 16)
