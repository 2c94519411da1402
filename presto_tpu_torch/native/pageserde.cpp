// Native page codec for the DCN data plane (reference:
// execution/buffer/PagesSerdeFactory.java:31 — LZ4 block compression +
// xxhash checksums around every shuffled page; airlift-compress is the
// reference's pure-Java port, this is our C++ equivalent).
//
// Block format (LZ4-scheme, clean-room from the public block spec):
//   token byte: high nibble = literal length, low nibble = match
//   length - 4; nibble 15 extends with 255-continuation bytes; then
//   literals, then 2-byte little-endian match offset (>= 1, <= 65535).
//   The final sequence is literals-only (no offset).
//
// Exposed C ABI (ctypes):
//   pt_compress(src, n, dst, cap)   -> compressed size or -1
//   pt_decompress(src, n, dst, cap) -> decompressed size or -1 (bounds
//                                      checked: malformed input never
//                                      reads/writes out of range)
//   pt_checksum(src, n)             -> 64-bit content hash
//   pt_compress_bound(n)            -> worst-case compressed size

#include <cstdint>
#include <cstring>

extern "C" {

int64_t pt_compress_bound(int64_t n) {
    return n + (n / 255) + 64;
}

// 64-bit avalanche mix (splitmix64 finalizer) over 8-byte lanes.
uint64_t pt_checksum(const uint8_t* src, int64_t n) {
    uint64_t h = 0x9e3779b97f4a7c15ull ^ (uint64_t)n;
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t k;
        std::memcpy(&k, src + i, 8);
        h ^= k;
        h ^= h >> 30; h *= 0xbf58476d1ce4e5b9ull;
        h ^= h >> 27; h *= 0x94d049bb133111ebull;
        h ^= h >> 31;
    }
    uint64_t tail = 0;
    for (int s = 0; i < n; ++i, s += 8) tail |= (uint64_t)src[i] << s;
    h ^= tail;
    h ^= h >> 30; h *= 0xbf58476d1ce4e5b9ull;
    h ^= h >> 27; h *= 0x94d049bb133111ebull;
    h ^= h >> 31;
    return h;
}

namespace {

const int MIN_MATCH = 4;
const int HASH_BITS = 16;

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash4(uint32_t v) {
    return (v * 2654435761u) >> (32 - HASH_BITS);
}

// write a length with 15-nibble + 255-continuation extension
inline bool put_len(uint8_t*& op, const uint8_t* oend, int64_t len) {
    while (len >= 255) {
        if (op >= oend) return false;
        *op++ = 255;
        len -= 255;
    }
    if (op >= oend) return false;
    *op++ = (uint8_t)len;
    return true;
}

}  // namespace

int64_t pt_compress(const uint8_t* src, int64_t n,
                    uint8_t* dst, int64_t cap) {
    if (n < 0) return -1;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    const uint8_t* anchor = src;
    // last 12 bytes are always emitted as literals (spec end condition,
    // and it lets the decoder copy matches 8 bytes at a time)
    const uint8_t* mlimit = (n >= 12) ? iend - 12 : src;

    int32_t table[1 << HASH_BITS];
    for (int i = 0; i < (1 << HASH_BITS); ++i) table[i] = -1;

    if (n >= MIN_MATCH + 12) {
        while (ip < mlimit) {
            uint32_t h = hash4(read32(ip));
            int32_t cand = table[h];
            table[h] = (int32_t)(ip - src);
            if (cand >= 0 && (ip - src) - cand <= 65535 &&
                read32(src + cand) == read32(ip)) {
                // extend the match forward
                const uint8_t* match = src + cand;
                const uint8_t* p = ip + MIN_MATCH;
                const uint8_t* m = match + MIN_MATCH;
                while (p < iend - 8 && *p == *m) { ++p; ++m; }
                int64_t mlen = p - ip;
                int64_t litlen = ip - anchor;
                // token + worst-case lengths + literals + offset
                if (op + 1 + litlen + 16 >= oend) return -1;
                uint8_t* token = op++;
                if (litlen >= 15) {
                    *token = (uint8_t)(15 << 4);
                    if (!put_len(op, oend, litlen - 15)) return -1;
                } else {
                    *token = (uint8_t)(litlen << 4);
                }
                std::memcpy(op, anchor, litlen);
                op += litlen;
                uint16_t off = (uint16_t)(ip - match);
                std::memcpy(op, &off, 2);
                op += 2;
                if (mlen - MIN_MATCH >= 15) {
                    *token |= 15;
                    if (!put_len(op, oend, mlen - MIN_MATCH - 15))
                        return -1;
                } else {
                    *token |= (uint8_t)(mlen - MIN_MATCH);
                }
                ip += mlen;
                anchor = ip;
            } else {
                ++ip;
            }
        }
    }
    // trailing literals
    int64_t litlen = iend - anchor;
    if (op + 1 + litlen + 8 >= oend) return -1;
    uint8_t* token = op++;
    if (litlen >= 15) {
        *token = (uint8_t)(15 << 4);
        if (!put_len(op, oend, litlen - 15)) return -1;
    } else {
        *token = (uint8_t)(litlen << 4);
    }
    std::memcpy(op, anchor, litlen);
    op += litlen;
    return op - dst;
}

int64_t pt_decompress(const uint8_t* src, int64_t n,
                      uint8_t* dst, int64_t cap) {
    const uint8_t* ip = src;
    const uint8_t* iend = src + n;
    uint8_t* op = dst;
    uint8_t* oend = dst + cap;
    while (ip < iend) {
        uint8_t token = *ip++;
        int64_t litlen = token >> 4;
        if (litlen == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                litlen += b;
            } while (b == 255);
        }
        if (ip + litlen > iend || op + litlen > oend) return -1;
        std::memcpy(op, ip, litlen);
        ip += litlen;
        op += litlen;
        if (ip >= iend) break;  // final literals-only sequence
        if (ip + 2 > iend) return -1;
        uint16_t off;
        std::memcpy(&off, ip, 2);
        ip += 2;
        if (off == 0 || op - dst < off) return -1;
        int64_t mlen = (token & 15) + MIN_MATCH;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= iend) return -1;
                b = *ip++;
                mlen += b;
            } while (b == 255);
        }
        if (op + mlen > oend) return -1;
        const uint8_t* match = op - off;
        // byte-wise copy: overlapping matches (off < mlen) replicate
        for (int64_t i = 0; i < mlen; ++i) op[i] = match[i];
        op += mlen;
    }
    return op - dst;
}

}  // extern "C"
