// Native wire codec for the control/data-plane transport.
//
// The reference's transport is pure Python (chunked sendall + zlib +
// base64 + a disk round-trip per message, src/p2p/connection.py:39-151)
// with no integrity checking at all. Here the DCN hop gets a native
// codec:
//   - tl_crc32c: CRC-32C (Castagnoli), slicing-by-8 — end-to-end frame
//     integrity for tensor payloads crossing hosts.
//   - tl_gather: single-pass scatter/gather of N tensor buffers into one
//     contiguous wire blob with the checksum computed during the copy
//     (one memory pass instead of Python's copy-then-checksum two).
//
// A copy of the JAX package's codec (tensorlink_tpu/native/wirecodec.cpp),
// built on demand with g++ -O3 -shared -fPIC by
// tensorlink_tpu_torch/native/__init__.py; bound via ctypes. No Python.h
// dependency so the build needs nothing but a C++ toolchain.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

uint32_t table[8][256];
bool init_done = false;

void init_tables() {
    const uint32_t poly = 0x82F63B78u;  // reflected CRC-32C polynomial
    for (int i = 0; i < 256; i++) {
        uint32_t c = static_cast<uint32_t>(i);
        for (int k = 0; k < 8; k++) c = (c & 1) ? (poly ^ (c >> 1)) : (c >> 1);
        table[0][i] = c;
    }
    for (int i = 0; i < 256; i++) {
        uint32_t c = table[0][i];
        for (int j = 1; j < 8; j++) {
            c = table[0][c & 0xff] ^ (c >> 8);
            table[j][i] = c;
        }
    }
    init_done = true;
}

uint32_t crc32c_update(uint32_t crc, const uint8_t* buf, size_t len) {
#ifdef __SSE4_2__
    // hardware CRC32C (one 8-byte fold per cycle-ish); the build tries
    // -msse4.2 first and falls back to the table build elsewhere
    while (len >= 8) {
        uint64_t v;
        std::memcpy(&v, buf, 8);
        crc = static_cast<uint32_t>(
            __builtin_ia32_crc32di(static_cast<uint64_t>(crc), v));
        buf += 8;
        len -= 8;
    }
    while (len--) crc = __builtin_ia32_crc32qi(crc, *buf++);
    return crc;
#else
    while (len >= 8) {
        uint64_t v;
        std::memcpy(&v, buf, 8);
        crc ^= static_cast<uint32_t>(v);
        uint32_t hi = static_cast<uint32_t>(v >> 32);
        crc = table[7][crc & 0xff] ^ table[6][(crc >> 8) & 0xff] ^
              table[5][(crc >> 16) & 0xff] ^ table[4][crc >> 24] ^
              table[3][hi & 0xff] ^ table[2][(hi >> 8) & 0xff] ^
              table[1][(hi >> 16) & 0xff] ^ table[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
    while (len--) crc = table[0][(crc ^ *buf++) & 0xff] ^ (crc >> 8);
    return crc;
#endif
}

}  // namespace

extern "C" {

// CRC-32C of buf[0:len], chainable: pass the previous return value as
// `crc0` (0 for the first chunk).
uint32_t tl_crc32c(const uint8_t* buf, size_t len, uint32_t crc0) {
    if (!init_done) init_tables();
    return ~crc32c_update(~crc0, buf, len);
}

// Copy n buffers (srcs[i], lens[i]) back-to-back into dst, computing the
// CRC-32C of the concatenation during the same pass. Returns the crc
// (or 0 if with_crc == 0). dst must hold sum(lens).
uint32_t tl_gather(uint8_t* dst, const uint8_t** srcs, const size_t* lens,
                   size_t n, int with_crc) {
    if (!init_done) init_tables();
    uint32_t crc = ~0u;
    size_t off = 0;
    for (size_t i = 0; i < n; i++) {
        std::memcpy(dst + off, srcs[i], lens[i]);
        if (with_crc) crc = crc32c_update(crc, dst + off, lens[i]);
        off += lens[i];
    }
    return with_crc ? ~crc : 0;
}

int tl_abi_version() { return 1; }

}  // extern "C"
