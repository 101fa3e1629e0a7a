"""EVM chain integration, dependency-free.

The reference binds an EVM smart contract through web3.py for validator
enumeration, handshake role verification, and (planned) reputation and
payments (reference src/p2p/smart_node.py:165-179,522-537, config/
SmartNodes.json ABI). This package provides the same capability with zero
third-party dependencies: a pure-Python keccak-256, a minimal Solidity ABI
codec, a stdlib JSON-RPC client, and `Web3Registry` — a chain-backed
implementation of the `roles.registry.Registry` seam. `mock.MockChainServer`
is the hermetic stand-in for tests and off-chain development (the analogue of
the reference's `off_chain_test=True` bypass).

The port's copy of ``tensorlink_tpu/chain/__init__.py``, which uses no
framework: the port keeps its own so that it never imports the JAX
package. Keep the two in step.
"""

from tensorlink_tpu_torch.chain.registry import Web3Registry  # noqa: F401
from tensorlink_tpu_torch.chain.rpc import ChainError, ChainRpc  # noqa: F401
