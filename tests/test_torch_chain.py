"""PyTorch port, chain/* (keccak, ABI codec, JSON-RPC client, mock EVM,
Web3Registry), roles/registry.py and roles/jobs.py: the reference's own
cases (tests/test_chain.py) run on the port's copies over a live
loopback JSON-RPC server, and the port held to the reference on the same
inputs: keccak digests and selectors, ABI encodings byte for byte,
registry sampling under one seeded RNG, and job-record digests and wire
forms (the port hashes through its own msgpack codec).
"""

import random
import threading

import numpy as np
import pytest

from tensorlink_tpu.chain import abi as jabi
from tensorlink_tpu.chain.keccak import keccak256 as jkeccak256
from tensorlink_tpu.chain.keccak import selector as jselector
from tensorlink_tpu.p2p.dht import PeerInfo as JPeerInfo
from tensorlink_tpu.roles import jobs as jjobs
from tensorlink_tpu.roles.registry import InMemoryRegistry as JInMemoryRegistry
from tensorlink_tpu_torch.chain import ChainError, ChainRpc, Web3Registry, abi
from tensorlink_tpu_torch.chain.keccak import keccak256, selector
from tensorlink_tpu_torch.chain.mock import CONTRACT_ADDRESS, MockChainServer
from tensorlink_tpu_torch.config import NodeConfig
from tensorlink_tpu_torch.p2p.dht import PeerInfo
from tensorlink_tpu_torch.roles import jobs
from tensorlink_tpu_torch.roles.registry import InMemoryRegistry


# --------------------------------------------------------------------- keccak
def test_keccak256_known_vectors():
    assert keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    assert keccak256(b"x" * 1000) == keccak256(bytes(b"x" * 1000))
    assert selector("transfer(address,uint256)").hex() == "a9059cbb"


@pytest.mark.parametrize("n", [0, 1, 135, 136, 137, 272, 1000])
def test_keccak_matches_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert keccak256(data) == jkeccak256(data)
    sig = f"f{n}(uint256,string,address[])"
    assert selector(sig) == jselector(sig)


# ------------------------------------------------------------------ ABI codec
ABI_CASES = [
    (["uint256", "bool", "address", "bytes32"],
     [2**200 + 7, True, "0x" + "ab" * 20, b"\x01" * 32]),
    (["string", "uint256", "bytes", "string"],
     ["hello nodes", 42, b"\x00\xff" * 50, ""]),
    (["uint256[]", "string"], [[1, 2, 3, 10**30], "tail-after-array"]),
    (["int256", "string", "uint256[]"], [-5, "é" * 40, []]),
]


@pytest.mark.parametrize("case", range(len(ABI_CASES)))
def test_abi_matches_reference(case):
    types, vals = ABI_CASES[case]
    enc = abi.encode(types, vals)
    assert enc == jabi.encode(types, vals)
    assert abi.decode(types, enc) == jabi.decode(types, enc) == vals


def test_abi_dynamic_head_tail_layout():
    types, vals = ABI_CASES[1]
    enc = abi.encode(types, vals)
    assert int.from_bytes(enc[0:32], "big") == 4 * 32
    assert abi.decode(types, enc) == vals


def test_abi_address_validation():
    with pytest.raises(ValueError):
        abi.encode(["address"], ["0x1234"])


def test_abi_decode_truncated_raises():
    types = ["uint256", "string"]
    enc = abi.encode(types, [7, "hello nodes"])
    with pytest.raises(ValueError):
        abi.decode(types, enc[:40])
    with pytest.raises(ValueError):
        abi.decode(types, enc[:100])
    with pytest.raises(ValueError):
        abi.decode(["string"], (2**20).to_bytes(32, "big"))
    bad = abi.encode(["uint256[]"], [[1, 2]])
    bad = bad[:32] + (2**200).to_bytes(32, "big") + bad[64:]
    with pytest.raises(ValueError):
        abi.decode(["uint256[]"], bad)


# ------------------------------------------------------------- mock JSON-RPC
@pytest.fixture()
def chain():
    with MockChainServer() as server:
        yield server


def test_rpc_error_surface(chain):
    rpc = ChainRpc(chain.url)
    assert rpc.chain_id() == 31337
    with pytest.raises(ChainError):
        rpc.request("eth_unknownMethod", [])
    with pytest.raises(ChainError):
        rpc.eth_call(CONTRACT_ADDRESS, b"\xde\xad\xbe\xef")


def test_rpc_unreachable_endpoint():
    rpc = ChainRpc("http://127.0.0.1:1", timeout=0.5)
    with pytest.raises(ChainError):
        rpc.chain_id()


def _info(i: int) -> PeerInfo:
    return PeerInfo(node_id=f"validator-{i:02d}" + "0" * 48, role="validator",
                    host="10.0.0.%d" % i, port=38751 + i)


def test_web3_registry_register_and_enumerate(chain):
    reg = Web3Registry(chain.url, CONTRACT_ADDRESS, cache_ttl=0.0)
    assert reg.validator_count() == 0
    for i in range(3):
        reg.register_validator(_info(i))
    assert reg.validator_count() == 3
    entries = reg.list_validators()
    assert [e.info.port for e in entries] == [38751, 38752, 38753]
    assert all(e.info.role == "validator" for e in entries)
    assert all(e.reputation == 1.0 for e in entries)
    assert entries[0].registered_at < entries[2].registered_at


def test_web3_registry_role_verification_and_reputation(chain):
    reg = Web3Registry(chain.url, CONTRACT_ADDRESS, cache_ttl=0.0)
    reg.register_validator(_info(0))
    reg.register_validator(_info(1))
    assert reg.is_validator(_info(0).node_id)
    assert not reg.is_validator("impostor" + "0" * 56)
    reg.deregister_validator(_info(0).node_id)
    assert not reg.is_validator(_info(0).node_id)
    reg.set_reputation(_info(1).node_id, 0.25)
    [entry] = reg.list_validators()
    assert entry.reputation == pytest.approx(0.25)
    reg.set_reputation(_info(1).node_id, 0.0)
    [entry] = reg.list_validators()
    assert entry.reputation == 0.0


def test_web3_registry_cache_bounds_rpc_traffic(chain):
    reg = Web3Registry(chain.url, CONTRACT_ADDRESS, cache_ttl=60.0)
    reg.register_validator(_info(0))
    reg.list_validators()
    before = len(chain.calls)
    for _ in range(5):
        reg.list_validators()
        assert reg.is_validator(_info(0).node_id)
    assert len(chain.calls) == before
    reg.set_reputation(_info(0).node_id, 0.5)
    assert reg.list_validators()[0].reputation == pytest.approx(0.5)


def test_web3_registry_wrong_contract_is_error(chain):
    reg = Web3Registry(chain.url, "0x" + "00" * 20, cache_ttl=0.0)
    with pytest.raises(ChainError):
        reg.validator_count()
    with pytest.raises(ChainError):
        reg.register_validator(_info(0))


def test_web3_registry_local_check_is_cache_only(chain):
    reg = Web3Registry(chain.url, CONTRACT_ADDRESS, cache_ttl=1e9)
    reg.register_validator(_info(0))
    before = len(chain.calls)
    assert not reg.is_validator_local(_info(0).node_id)
    assert len(chain.calls) == before
    reg.refresh()
    before = len(chain.calls)
    assert reg.is_validator_local(_info(0).node_id)
    assert len(chain.calls) == before


def test_registry_sampling_matches_reference(chain):
    """Bootstrap sampling (<= 6 validators) under one seeded RNG picks the
    same validators in both packages, from memory and from the chain."""
    port_mem, ref_mem = InMemoryRegistry(), JInMemoryRegistry()
    web3 = Web3Registry(chain.url, CONTRACT_ADDRESS)
    for i in range(8):
        info = _info(i)
        port_mem.register_validator(info)
        ref_mem.register_validator(JPeerInfo(**info.to_wire()))
        web3.register_validator(info)
    for seed in (0, 1, 7):
        picks = []
        for reg in (port_mem, ref_mem, web3):
            random.seed(seed)
            picks.append([e.info.node_id for e in reg.sample_validators(k=6)])
        assert picks[0] == picks[1] == picks[2]
        assert len(set(picks[0])) == 6


def test_onchain_job_lifecycle_and_ledger_parity(chain):
    reg = Web3Registry(chain.url, CONTRACT_ADDRESS, cache_ttl=0.0)
    jid = reg.request_job_onchain("user-abc", 1_000_000, 2_500)
    assert jid == 1
    assert reg.job_onchain(jid) == {
        "user_id": "user-abc", "capacity_bytes": 1_000_000,
        "payment_milli": 2_500, "completed": False,
    }
    assert reg.request_job_onchain("user-xyz", 5, 0) == 2
    reg.complete_job_onchain(jid)
    assert reg.job_onchain(jid)["completed"] is True
    with pytest.raises(ChainError):
        reg.complete_job_onchain(99)
    mem = InMemoryRegistry()
    with pytest.raises(ValueError, match="unknown job"):
        mem.complete_job_onchain(1)
    assert mem.request_job_onchain("parity-user", 4096, 9) == 1
    mem.complete_job_onchain(1)
    assert mem.job_onchain(1)["completed"] is True
    assert mem.job_onchain(99) is None


def test_job_id_from_receipt_event(chain):
    """The job id comes from the JobRequested event of the receipt, not
    from a re-read of the count."""
    reg = Web3Registry(chain.url, CONTRACT_ADDRESS, cache_ttl=0.0)
    assert (reg.request_job_onchain("user-a", 1000, 5),
            reg.request_job_onchain("user-b", 2000, 7)) == (1, 2)
    assert reg.job_onchain(2)["user_id"] == "user-b"
    tx = reg._transact("requestJob", ["string", "uint256", "uint256"], ["user-c", 1, 1])
    [log] = ChainRpc(chain.url).get_transaction_receipt(tx)["logs"]
    assert log["topics"][0] == Web3Registry.JOB_REQUESTED_TOPIC
    assert int(log["topics"][1], 16) == 3


def test_job_ids_race_free_under_concurrent_submitters(chain):
    ids, errs = [], []

    def submit(i):
        try:
            reg = Web3Registry(chain.url, CONTRACT_ADDRESS, cache_ttl=0.0)
            jid = reg.request_job_onchain(f"user-{i}", 100 + i, 1)
            assert reg.job_onchain(jid)["user_id"] == f"user-{i}"
            ids.append(jid)
        except Exception as e:  # surfaces in the main thread's assert
            errs.append(e)

    threads = [threading.Thread(target=submit, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs
    assert sorted(ids) == list(range(1, 9))


@pytest.mark.asyncio
async def test_registry_bootstrap_auto_join(chain):
    """A port node joins from the contract alone: it samples validators
    and dials with the identity pinned; a dead entry is skipped and an
    empty contract yields None."""
    from tensorlink_tpu_torch.p2p.node import Node

    worker = Node(NodeConfig(role="worker", port=0))
    validator = Node(NodeConfig(role="validator", port=0))
    await worker.start()
    await validator.start()
    try:
        reg = Web3Registry(chain.url, CONTRACT_ADDRESS, cache_ttl=0.0)
        assert await worker.bootstrap_from_registry(reg) is None
        reg.register_validator(PeerInfo(node_id="d" * 64, role="validator",
                                        host="127.0.0.1", port=9))
        reg.register_validator(validator.info)
        random.seed(3)
        peer = await worker.bootstrap_from_registry(reg)
        assert peer is not None and peer.node_id == validator.node_id
        assert peer.node_id in worker.peers
    finally:
        await worker.stop()
        await validator.stop()


# ------------------------------------------------------------ job records
def _stages(mod):
    return [mod.StageSpec(index=i, module_config={"kind": "Dense", "in": 8 * (i + 1),
                                                   "out": 4, "act": None, "f": 0.5},
                          param_bytes=1000 + i)
            for i in range(3)]


def test_job_records_match_reference():
    author = "ab" * 32
    kw = dict(dp_factor=2, micro_batches=4,
              train={"optimizer": "adamw", "learning_rate": 1e-3, "steps": 10},
              created_at=1700000000.25)
    port = jobs.JobRecord(author=author, stages=_stages(jobs), **kw)
    ref = jjobs.JobRecord(author=author, stages=_stages(jjobs), **kw)
    assert [s.digest for s in port.stages] == [s.digest for s in ref.stages]
    assert port.job_id == ref.job_id
    assert port.to_wire() == ref.to_wire()
    # either side validates the other's wire form; a tampered id fails
    assert jobs.validate_job_request(ref.to_wire()).job_id == ref.job_id
    assert jjobs.validate_job_request(port.to_wire()).job_id == port.job_id
    bad = {**port.to_wire(), "job_id": "0" * 64}
    for mod in (jobs, jjobs):
        with pytest.raises(ValueError, match="job id mismatch"):
            mod.validate_job_request(bad)
    with pytest.raises(ValueError, match="no stages"):
        jobs.validate_job_request({**port.to_wire(), "stages": []})
    with pytest.raises(ValueError, match="malformed"):
        jobs.validate_job_request({"author": author})



# ------------------------------------------------------------ role nodes


@pytest.mark.asyncio
async def test_validator_node_chain_config(chain):
    """A port ValidatorNode builds its Web3Registry from NodeConfig alone
    and registers itself at start."""
    from tensorlink_tpu_torch.roles.validator import ValidatorNode

    node = ValidatorNode(NodeConfig(role="validator", port=0, off_chain=False,
                                    chain_url=chain.url,
                                    chain_contract=CONTRACT_ADDRESS),
                         device="cpu")
    assert isinstance(node.registry, Web3Registry)
    await node.start()
    try:
        assert node.registry.is_validator(node.node_id)
        assert node.registry.is_validator_local(node.node_id)
    finally:
        await node.stop()
    with pytest.raises(ValueError):
        ValidatorNode(NodeConfig(role="validator", off_chain=False), device="cpu")


@pytest.mark.asyncio
async def test_validator_node_with_web3_registry(chain):
    from tensorlink_tpu_torch.roles.validator import ValidatorNode

    reg = Web3Registry(chain.url, CONTRACT_ADDRESS, cache_ttl=0.0)
    node = ValidatorNode(NodeConfig(role="validator", port=0), registry=reg,
                         device="cpu")
    await node.start()
    try:
        assert reg.is_validator(node.node_id)
        assert any(e.info.node_id == node.node_id for e in reg.list_validators())
    finally:
        await node.stop()


@pytest.mark.asyncio
async def test_request_job_records_onchain(chain):
    """request_job(chain_registry=...) records the job before placement;
    complete_onchain closes it after an inference pass."""
    import torch

    from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig
    from tensorlink_tpu_torch.roles.user import UserNode
    from tensorlink_tpu_torch.roles.validator import ValidatorNode
    from tensorlink_tpu_torch.roles.worker import WorkerNode

    creg = Web3Registry(chain.url, CONTRACT_ADDRESS, cache_ttl=0.0)
    m = MLP(MLPConfig(in_dim=8, hidden_dim=16, out_dim=4, num_layers=2), device="cpu")

    def cfg(role):
        return NodeConfig(role=role, host="127.0.0.1", port=0)

    validator = ValidatorNode(cfg("validator"), registry=InMemoryRegistry(), device="cpu")
    await validator.start()
    worker = WorkerNode(cfg("worker"), device="cpu")
    await worker.start()
    await worker.connect("127.0.0.1", validator.port)
    user = UserNode(cfg("user"))
    await user.start()
    v_peer = await user.connect("127.0.0.1", validator.port)
    try:
        job = await user.request_job(m.seq, dict(m.seq.named_parameters()), v_peer,
                                     max_stage_bytes=1e9, chain_registry=creg,
                                     chain_payment_milli=1_500)
        assert job.chain_job_id == 1
        rec = creg.job_onchain(1)
        assert rec["user_id"] == user.node_id and rec["payment_milli"] == 1_500
        assert rec["completed"] is False
        out = await job.forward(torch.zeros((2, 8)))
        assert tuple(out.shape) == (2, 4)
        await job.complete_onchain()
        assert creg.job_onchain(1)["completed"] is True
    finally:
        for n in (user, validator, worker):
            await n.stop()
