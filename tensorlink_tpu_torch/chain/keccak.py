"""Pure-Python Keccak-256 (the pre-FIPS Ethereum variant, 0x01 padding).

Ethereum function selectors and event topics use original Keccak-256, not
NIST SHA3-256 (different domain-separation byte: 0x01 vs 0x06), so
`hashlib.sha3_256` cannot be used. The reference gets this via web3.py's
bundled eth-hash; this environment has no keccak provider, so the
permutation is implemented directly from the public Keccak specification.
Throughput is irrelevant here: the only inputs are 4-byte selectors'
signatures and small registration payloads on the control plane.

The port's copy of ``tensorlink_tpu/chain/keccak.py``, which uses no
framework: the port keeps its own so that it never imports the JAX
package. Keep the two in step.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

_ROUND_CONSTANTS = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rho rotation offsets, indexed [x][y]
_ROTATIONS = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]

_RATE_BYTES = 136  # 1600 - 2*256 bits


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK


def _keccak_f(state: list[list[int]]) -> list[list[int]]:
    a = state
    for rc in _ROUND_CONSTANTS:
        # theta
        c = [a[x][0] ^ a[x][1] ^ a[x][2] ^ a[x][3] ^ a[x][4] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        a = [[a[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        # rho + pi
        b = [[0] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rotl(a[x][y], _ROTATIONS[x][y])
        # chi
        a = [
            [b[x][y] ^ ((~b[(x + 1) % 5][y]) & _MASK & b[(x + 2) % 5][y])
             for y in range(5)]
            for x in range(5)
        ]
        # iota
        a[0][0] ^= rc
    return a


def keccak256(data: bytes) -> bytes:
    # multi-rate padding with the Keccak (not SHA3) domain byte
    pad_len = _RATE_BYTES - (len(data) % _RATE_BYTES)
    padded = bytearray(data)
    padded += b"\x00" * pad_len
    padded[len(data)] ^= 0x01
    padded[-1] ^= 0x80

    state = [[0] * 5 for _ in range(5)]
    for off in range(0, len(padded), _RATE_BYTES):
        block = padded[off:off + _RATE_BYTES]
        for i in range(_RATE_BYTES // 8):
            lane = int.from_bytes(block[8 * i:8 * i + 8], "little")
            state[i % 5][i // 5] ^= lane
        state = _keccak_f(state)

    out = bytearray()
    for i in range(4):  # 32 bytes = 4 lanes, all within the first plane
        out += state[i % 5][i // 5].to_bytes(8, "little")
    return bytes(out)


def selector(signature: str) -> bytes:
    """4-byte Solidity function selector, e.g. selector('transfer(address,uint256)')."""
    return keccak256(signature.encode("ascii"))[:4]
