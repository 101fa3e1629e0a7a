"""CLI: ``python -m tensorlink_tpu_torch <command>`` (port of
``tensorlink_tpu/__main__.py``). One typed entry point launches any role,
shows device info, or runs the demo:

    python -m tensorlink_tpu_torch worker --port 38751 --http-port 8080
    python -m tensorlink_tpu_torch validator --port 38752
    python -m tensorlink_tpu_torch demo --device cpu   # in-process e2e job
    python -m tensorlink_tpu_torch info                # devices + capacity

Roles run on CUDA unless ``--device cpu`` is given. ``bench`` exits
non-zero: the port's benchmark entry does not exist yet. The process
sets ``CUBLAS_WORKSPACE_CONFIG`` before any CUDA work, so the
proof-of-learning runs can ask cuBLAS for deterministic kernels.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys


def _node_cfg(args, role: str):
    from tensorlink_tpu_torch.config import NodeConfig

    return NodeConfig(
        role=role,
        host=args.host,
        port=args.port,
        key_dir=args.key_dir,
        http_status_port=args.http_port,
        stage_tp_devices=getattr(args, "stage_tp_devices", 1),
        dht_snapshot_path=args.dht_snapshot,
        upnp=args.upnp,
        off_chain=not getattr(args, "chain_url", None),
        chain_url=getattr(args, "chain_url", None),
        chain_contract=getattr(args, "chain_contract", None),
        chain_sender=getattr(args, "chain_sender", None),
    )


def _add_node_args(p: argparse.ArgumentParser) -> None:
    # loopback by default: the status endpoint is unauthenticated, so
    # exposing it network-wide must be an explicit operator choice
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address (0.0.0.0 to serve the network)")
    p.add_argument("--port", type=int, default=0,
                   help="0 = OS-assigned; -1 = scan upward from base port")
    p.add_argument("--upnp", action="store_true",
                   help="map the listen port through the home router (UPnP "
                        "IGD) for NAT'd peers")
    p.add_argument("--http-port", type=int, default=None,
                   help="HTTP status endpoint port (off when omitted)")
    p.add_argument("--key-dir", default=None,
                   help="persistent identity dir (ephemeral when omitted)")
    p.add_argument("--bootstrap", default=None, metavar="HOST:PORT",
                   help="validator to join via (overrides the registry "
                        "auto-join when --chain-url is also given)")
    p.add_argument("--chain-url", default=None,
                   help="EVM JSON-RPC endpoint: validators register on "
                        "the contract; workers/users auto-join by "
                        "sampling it (no --bootstrap needed)")
    p.add_argument("--chain-contract", default=None,
                   help="registry contract address (0x...)")
    p.add_argument("--chain-sender", default=None,
                   help="from-address for node-managed transactions")
    p.add_argument("--dht-snapshot", default=None, metavar="PATH",
                   help="persist DHT state to PATH periodically (and "
                        "restore from it on start)")
    p.add_argument("--postmortem-dir", default=None, metavar="DIR",
                   help="write a post-mortem JSON bundle (flight events, "
                        "spans, metrics, config) into DIR on unhandled "
                        "crash or SIGTERM")
    # multi-process group formation: every process of one job joins one
    # torch.distributed group at the coordinator's address
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="process-group rendezvous (process 0's "
                        "address); omit for a single process")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total processes in the group")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's index in the group")
    p.add_argument("--device", default=None,
                   help="device the role computes on (default cuda; "
                        "'cpu' runs the plain PyTorch versions)")


def _maybe_init_distributed(args) -> None:
    if not getattr(args, "coordinator", None):
        return
    from tensorlink_tpu_torch.config import DistributedConfig
    from tensorlink_tpu_torch.runtime.mesh import initialize_distributed

    info = initialize_distributed(DistributedConfig(
        coordinator=args.coordinator,
        num_processes=args.num_processes,
        process_id=args.process_id,
    ), device=args.device)
    print(f"joined process group: rank {info.get('process_id')}/"
          f"{info.get('num_processes')}")


async def _run_role(role: str, args) -> None:
    from tensorlink_tpu_torch.roles.registry import InMemoryRegistry
    from tensorlink_tpu_torch.roles.user import UserNode
    from tensorlink_tpu_torch.roles.validator import ValidatorNode
    from tensorlink_tpu_torch.roles.worker import WorkerNode

    _maybe_init_distributed(args)
    cls = {"worker": WorkerNode, "validator": ValidatorNode, "user": UserNode}[role]
    kw = {}
    if role == "validator" and not getattr(args, "chain_url", None):
        kw["registry"] = InMemoryRegistry()
    # chain-backed registry is built by ValidatorNode from cfg.chain_* when
    # off_chain=False (set in _node_cfg from --chain-url/--chain-contract)
    if role in ("worker", "validator"):
        kw["device"] = args.device
    node = cls(_node_cfg(args, role), **kw)
    await node.start()
    if args.postmortem_dir:
        # black box: unhandled crash / SIGTERM dumps events + spans +
        # metrics + config + versions as one JSON bundle
        from tensorlink_tpu_torch.runtime.flight import install_crash_handler

        install_crash_handler(
            args.postmortem_dir, recorder=node.flight, tracer=node.tracer,
            metrics=node.metrics, config=node.cfg,
        )
    validator_peer = None
    if args.bootstrap:
        host, port = args.bootstrap.rsplit(":", 1)
        validator_peer = await node.connect(host, int(port))
    elif role != "validator" and args.chain_url:
        # registry auto-join: sample validators from the contract and
        # dial (reference smart_node.py:539-585) — --chain-url suffices
        from tensorlink_tpu_torch.chain import Web3Registry

        validator_peer = await node.bootstrap_from_registry(
            Web3Registry(args.chain_url, args.chain_contract)
        )
        if validator_peer is None:
            print("registry bootstrap found no reachable validator; "
                  "running unconnected (will accept inbound peers)")
    node.start_heartbeat()
    if role == "user" and getattr(args, "resume_dir", None):
        if validator_peer is None:
            raise SystemExit("--resume-dir requires --bootstrap validator")
        job = await node.resume_job_from_checkpoint(
            args.resume_dir, validator_peer
        )
        print(f"resumed job {job.job.job_id[:16]} at step {job.step}")
    print(f"{role} {node.node_id[:16]} listening on {args.host}:{node.port}"
          + (f", status :{node._http.bound_port}" if node._http else ""))
    try:
        await asyncio.Event().wait()  # run until interrupted
    finally:
        await node.stop()


def _cmd_info() -> int:
    import torch

    from tensorlink_tpu_torch.runtime.mesh import local_device_info

    print(json.dumps(
        {
            "backend": "cuda" if torch.cuda.is_available() else "cpu",
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "device_count": torch.cuda.device_count(),
            "devices": local_device_info(),
        },
        indent=2, default=str,
    ))
    return 0


async def _cmd_demo(device=None) -> int:
    """The minimum end-to-end slice in one process: a validator, two
    workers and a user train an MLP split into two stages."""
    import numpy as np
    import torch

    from tensorlink_tpu_torch import resolve_device

    from tensorlink_tpu_torch.config import NodeConfig
    from tensorlink_tpu_torch.models.mlp import MLP, MLPConfig
    from tensorlink_tpu_torch.roles.registry import InMemoryRegistry
    from tensorlink_tpu_torch.roles.user import UserNode
    from tensorlink_tpu_torch.roles.validator import ValidatorNode
    from tensorlink_tpu_torch.roles.worker import WorkerNode

    dev = resolve_device(device)

    def cfg(role):
        return NodeConfig(role=role, host="127.0.0.1", port=0,
                          capability_bench=False)

    m = MLP(MLPConfig(in_dim=16, hidden_dim=32, out_dim=4, num_layers=2),
            device="cpu")

    reg = InMemoryRegistry()
    validator = ValidatorNode(cfg("validator"), registry=reg, device=dev)
    await validator.start()
    workers = []
    for _ in range(2):
        w = WorkerNode(cfg("worker"), device=dev)
        await w.start()
        await w.connect("127.0.0.1", validator.port)
        workers.append(w)
    user = UserNode(cfg("user"))
    await user.start()
    v_peer = await user.connect("127.0.0.1", validator.port)

    job = await user.request_job(
        m.seq, dict(m.seq.named_parameters()), v_peer, max_stage_bytes=16 * 32 * 4 + 200,
        micro_batches=2, train={"optimizer": "sgd", "learning_rate": 0.05},
    )
    print(f"job {job.job.job_id[:16]} placed on "
          f"{[st.peer.node_id[:8] for st in job.stages]}")

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    w_true = rng.normal(size=(16, 4))
    y = torch.from_numpy(np.argmax(x.numpy() @ w_true, -1))

    def loss_grad(logits, micro):
        lt = logits.float().requires_grad_(True)
        yt = torch.tensor_split(y, 2)[micro]
        loss = torch.nn.functional.cross_entropy(lt, yt)
        (g,) = torch.autograd.grad(loss, lt)
        return float(loss.detach()), g

    for i in range(10):
        loss = await job.train_step(x, loss_grad)
        print(f"step {i}: loss {loss:.4f}")
    for n in (user, validator, *workers):
        await n.stop()
    print("demo OK")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="tensorlink_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for role in ("worker", "validator", "user"):
        sp = sub.add_parser(role, help=f"run a {role} node")
        _add_node_args(sp)  # includes --chain-* (validator: registry
        # membership; worker/user: contract auto-join)
        if role == "worker":
            sp.add_argument(
                "--stage-tp-devices", type=int, default=1,
                dest="stage_tp_devices",
                help="TP width for loaded stages (-1 = all local devices)",
            )
        if role == "user":
            sp.add_argument(
                "--resume-dir", default=None,
                help="resume a job from a durable checkpoint directory "
                     "(requires --bootstrap validator)",
            )
    sub.add_parser("info", help="local devices and capacity")
    dp = sub.add_parser("demo", help="in-process end-to-end training demo")
    dp.add_argument("--device", default=None,
                    help="device the workers compute on (default cuda)")
    sub.add_parser("bench", help="the port's benchmark entry (not yet "
                                 "written: exits non-zero)")
    kp = sub.add_parser(
        "keygen",
        help="pre-generate per-role RSA identities (the reference does this "
             "in a pip-install hook, config/custom_install.py:6-14; here it "
             "is an explicit command since PEP 517 builds can't run code)",
    )
    kp.add_argument("--key-dir", required=True, help="directory for the keys")
    kp.add_argument("--roles", default="worker,validator,user",
                    help="comma-separated roles to generate keys for")
    args = ap.parse_args(argv)
    # before any cuBLAS call: deterministic cuBLAS kernels for the
    # proof-of-learning runs need a fixed workspace configuration
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    if args.cmd == "keygen":
        from tensorlink_tpu_torch.p2p.crypto import Identity

        for role in args.roles.split(","):
            ident = Identity.load_or_generate(args.key_dir, role.strip())
            print(f"{role.strip()}: {ident.node_id}")
        return 0
    if args.cmd == "info":
        return _cmd_info()
    if args.cmd == "demo":
        return asyncio.run(_cmd_demo(args.device))
    if args.cmd == "bench":
        print("the port's benchmark entry waits for its own benchmark "
              "change; nothing was run", file=sys.stderr)
        return 2
    try:
        asyncio.run(_run_role(args.cmd, args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
