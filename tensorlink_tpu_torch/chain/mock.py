"""In-process mock EVM provider for hermetic chain tests.

The reference's only escape from its contract dependency is skipping it
(`off_chain_test=True`, src/p2p/smart_node.py:110,165). This mock instead
keeps the full RPC → calldata → ABI round-trip live: a threaded HTTP server
speaks JSON-RPC, and a Python object executes the registry contract's
semantics against the same selectors and codec `Web3Registry` emits. Tests
exercise the identical byte path a real node would, minus the EVM itself.

The port's copy of ``tensorlink_tpu/chain/mock.py``, which uses no
framework: the port keeps its own so that it never imports the JAX
package. Keep the two in step.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from tensorlink_tpu_torch.chain import abi
from tensorlink_tpu_torch.chain.keccak import keccak256, selector

CONTRACT_ADDRESS = "0x" + "42" * 20


class MockRegistryContract:
    """Python-executed equivalent of the registry contract (see
    chain/registry.py module docstring for the Solidity interface)."""

    def __init__(self):
        self._validators: dict[str, dict] = {}  # nodeId -> record, insertion-ordered
        self._jobs: list[dict] = []  # on-chain job records (1-based ids)
        self._clock = 1_700_000_000  # deterministic "block time"
        # EVM-style event log emitted by the CURRENT execute() call; the
        # server moves these into the transaction's receipt (requestJob
        # emits JobRequested so submitters read their job id from the
        # receipt instead of racing a jobCount() re-read)
        self.pending_logs: list[dict] = []

    def execute(self, calldata: bytes) -> bytes:
        sel, args = calldata[:4], calldata[4:]
        if sel == selector("validatorCount()"):
            return abi.encode(["uint256"], [len(self._validators)])
        if sel == selector("validatorAt(uint256)"):
            [i] = abi.decode(["uint256"], args)
            rec = list(self._validators.values())[i]
            return abi.encode(
                ["string", "string", "uint256", "uint256", "uint256"],
                [rec["node_id"], rec["host"], rec["port"],
                 rec["reputation_milli"], rec["registered_at"]],
            )
        if sel == selector("isValidator(string)"):
            [node_id] = abi.decode(["string"], args)
            return abi.encode(["bool"], [node_id in self._validators])
        if sel == selector("registerValidator(string,string,uint256)"):
            node_id, host, port = abi.decode(["string", "string", "uint256"], args)
            self._clock += 1
            self._validators[node_id] = {
                "node_id": node_id, "host": host, "port": port,
                "reputation_milli": 1000, "registered_at": self._clock,
            }
            return b""
        if sel == selector("deregisterValidator(string)"):
            [node_id] = abi.decode(["string"], args)
            self._validators.pop(node_id, None)
            return b""
        if sel == selector("setReputation(string,uint256)"):
            node_id, rep = abi.decode(["string", "uint256"], args)
            if node_id in self._validators:
                self._validators[node_id]["reputation_milli"] = rep
            return b""
        # --- job/payment records (reference carried requestJob only as
        # commented-out intent, src/roles/user.py:50-64,171-199; here the
        # write path is live end to end against this contract)
        if sel == selector("jobCount()"):
            return abi.encode(["uint256"], [len(self._jobs)])
        if sel == selector("requestJob(string,uint256,uint256)"):
            user_id, capacity, payment = abi.decode(
                ["string", "uint256", "uint256"], args
            )
            self._clock += 1
            self._jobs.append({
                "user_id": user_id, "capacity": capacity,
                "payment_milli": payment, "completed": False,
                "requested_at": self._clock,
            })
            job_id = len(self._jobs)
            # event JobRequested(uint256 indexed jobId, string userId) —
            # the authoritative job-id channel for submitters (a tx return
            # value is unreadable over JSON-RPC; chain/registry.py)
            self.pending_logs.append({
                "address": CONTRACT_ADDRESS,
                "topics": [
                    "0x" + keccak256(b"JobRequested(uint256,string)").hex(),
                    "0x" + job_id.to_bytes(32, "big").hex(),
                ],
                "data": "0x" + abi.encode(["string"], [user_id]).hex(),
            })
            return abi.encode(["uint256"], [job_id])
        if sel == selector("completeJob(uint256)"):
            [job_id] = abi.decode(["uint256"], args)
            if not 1 <= job_id <= len(self._jobs):
                raise ValueError(f"unknown job {job_id}")
            self._jobs[job_id - 1]["completed"] = True
            return b""
        if sel == selector("jobAt(uint256)"):
            [job_id] = abi.decode(["uint256"], args)
            if not 1 <= job_id <= len(self._jobs):
                raise ValueError(f"unknown job {job_id}")
            rec = self._jobs[job_id - 1]
            return abi.encode(
                ["string", "uint256", "uint256", "bool"],
                [rec["user_id"], rec["capacity"], rec["payment_milli"],
                 rec["completed"]],
            )
        raise ValueError(f"unknown selector {sel.hex()}")


class MockChainServer:
    """Threaded JSON-RPC endpoint serving one MockRegistryContract."""

    def __init__(self, contract: MockRegistryContract | None = None):
        self.contract = contract or MockRegistryContract()
        self.calls: list[str] = []  # method log, for assertions
        self._receipts: dict[str, dict] = {}  # txHash -> receipt w/ logs
        self._tx_nonce = 0
        self._tx_lock = threading.Lock()  # handlers run on server threads
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                result, error = None, None
                try:
                    result = outer._dispatch(body["method"], body.get("params", []))
                except Exception as e:  # surfaces as a JSON-RPC error
                    error = {"code": -32000, "message": str(e)}
                reply = {"jsonrpc": "2.0", "id": body.get("id")}
                reply["error" if error else "result"] = error if error else result
                data = json.dumps(reply).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)

    def _dispatch(self, method: str, params: list):
        self.calls.append(method)
        if method == "eth_chainId":
            return hex(31337)
        if method == "eth_call":
            calldata = bytes.fromhex(params[0]["data"][2:])
            if params[0]["to"].lower() != CONTRACT_ADDRESS:
                raise ValueError("unknown contract")
            with self._tx_lock:
                return "0x" + self.contract.execute(calldata).hex()
        if method == "eth_sendTransaction":
            tx = params[0]
            # same unknown-contract check as eth_call: a misconfigured
            # --chain-contract must fail on the write path too (advisor r3)
            if tx["to"].lower() != CONTRACT_ADDRESS:
                raise ValueError("unknown contract")
            calldata = bytes.fromhex(tx["data"][2:])
            # ThreadingHTTPServer handles each request on its own thread:
            # the reset -> execute -> receipt-snapshot sequence (and the
            # nonce bump) must be atomic, or a concurrent submitter's
            # reset clears this tx's logs and its receipt comes up empty —
            # the exact job-id race the JobRequested event exists to kill
            with self._tx_lock:
                self.contract.pending_logs = []
                self.contract.execute(calldata)
                # salt with a per-server nonce: identical calldata
                # submitted twice must not collide on tx hash (real
                # chains mix in the sender nonce), or the second receipt
                # would shadow the first
                self._tx_nonce += 1
                tx_hash = "0x" + keccak256(
                    calldata + self._tx_nonce.to_bytes(8, "big")
                ).hex()
                # receipt carries the events this execution emitted,
                # exactly like a real node — Web3Registry reads
                # JobRequested from here
                self._receipts[tx_hash] = {
                    "status": "0x1",
                    "transactionHash": tx_hash,
                    "logs": list(self.contract.pending_logs),
                }
            return tx_hash
        if method == "eth_getTransactionReceipt":
            with self._tx_lock:
                return self._receipts.get(
                    params[0], {"status": "0x1", "transactionHash": params[0]}
                )
        raise ValueError(f"unsupported method {method}")

    # ----------------------------------------------------------- lifecycle
    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._server.server_address[1]}"

    def start(self) -> "MockChainServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
