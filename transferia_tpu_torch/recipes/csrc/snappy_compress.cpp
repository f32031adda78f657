// Snappy raw-format compressor for the recipe Parquet writer
// (recipes/parquet_writer.py), built by the port's host build.
//
// A greedy hash matcher, as snappy's own compressor works: the input is
// cut into 64 KiB blocks; within a block every position's 4-byte prefix
// is hashed into a table of earlier positions, a hit whose 4 bytes match
// is extended as far as the bytes agree and emitted as a copy element
// (1-byte offset form for short near copies, 2-byte form otherwise), and
// the bytes between copies go out as literal elements.  No skipping
// heuristic: every position is tried, so the output is never larger than
// what snappy's format bound allows and repetitive data really compresses
// (a literal-only stream would decode as a memcpy).

#include <cstdint>
#include <cstring>

namespace {

const int64_t kBlock = 1 << 16;  // copy offsets stay below 65536
const int kHashBits = 14;

inline uint32_t load32(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

inline uint32_t hash32(uint32_t v) {
    return (v * 0x1e35a7bdu) >> (32 - kHashBits);
}

uint8_t* emit_literal(uint8_t* op, const uint8_t* lit, int64_t len) {
    int64_t n = len - 1;
    if (n < 60) {
        *op++ = (uint8_t)(n << 2);
    } else {
        uint8_t* tag = op++;
        int count = 0;
        for (int64_t t = n; t > 0; t >>= 8) {
            *op++ = (uint8_t)(t & 0xff);
            count++;
        }
        *tag = (uint8_t)((59 + count) << 2);
    }
    memcpy(op, lit, (size_t)len);
    return op + len;
}

// 4 <= len <= 64, 0 < offset < 65536
uint8_t* emit_copy_upto64(uint8_t* op, int64_t offset, int64_t len) {
    if (len < 12 && offset < 2048) {
        *op++ = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
        *op++ = (uint8_t)(offset & 0xff);
    } else {
        *op++ = (uint8_t)(2 | ((len - 1) << 2));
        *op++ = (uint8_t)(offset & 0xff);
        *op++ = (uint8_t)(offset >> 8);
    }
    return op;
}

uint8_t* emit_copy(uint8_t* op, int64_t offset, int64_t len) {
    while (len >= 68) {
        op = emit_copy_upto64(op, offset, 64);
        len -= 64;
    }
    if (len > 64) {  // 65..67: leave at least 4 for the last element
        op = emit_copy_upto64(op, offset, 60);
        len -= 60;
    }
    return emit_copy_upto64(op, offset, len);
}

uint8_t* compress_block(const uint8_t* base, int64_t n, uint8_t* op,
                        uint16_t* table) {
    memset(table, 0, sizeof(uint16_t) << kHashBits);
    const uint8_t* end = base + n;
    const uint8_t* lit = base;
    if (n >= 8) {
        const uint8_t* limit = end - 4;  // last start of a 4-byte load
        const uint8_t* ip = base + 1;
        while (ip <= limit) {
            uint32_t cur = load32(ip);
            uint32_t h = hash32(cur);
            const uint8_t* cand = base + table[h];
            table[h] = (uint16_t)(ip - base);
            if (load32(cand) != cur) {
                ip++;
                continue;
            }
            if (lit < ip) op = emit_literal(op, lit, ip - lit);
            const uint8_t* s = ip + 4;
            const uint8_t* c = cand + 4;
            while (s < end && *s == *c) {
                s++;
                c++;
            }
            op = emit_copy(op, ip - cand, s - ip);
            ip = s;
            lit = s;
        }
    }
    if (lit < end) op = emit_literal(op, lit, end - lit);
    return op;
}

}  // namespace

extern "C" {

// The largest output snappy_compress can write for n input bytes.
int64_t snappy_max_compressed_length(int64_t n) {
    return 32 + n + n / 6;
}

// src[n] -> dst (at least snappy_max_compressed_length(n) bytes);
// returns the compressed length.
int64_t snappy_compress(const uint8_t* src, int64_t n, uint8_t* dst) {
    uint8_t* op = dst;
    uint64_t v = (uint64_t)n;
    while (v >= 0x80) {
        *op++ = (uint8_t)(v | 0x80);
        v >>= 7;
    }
    *op++ = (uint8_t)v;
    uint16_t table[1 << kHashBits];
    for (int64_t pos = 0; pos < n; pos += kBlock) {
        int64_t len = n - pos < kBlock ? n - pos : kBlock;
        op = compress_block(src + pos, len, op, table);
    }
    return op - dst;
}

}  // extern "C"
