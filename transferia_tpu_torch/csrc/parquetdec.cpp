// Native parquet column-chunk decoder (C++, ctypes-bound).
//
// The reference's ingest hot loop is hand-optimized Go per provider; here
// the analogous hot loop is parquet decode on the snapshot north-star path
// (providers/file.py -> ColumnBatch).  Arrow's general-purpose reader
// spends most of its single-core time in dictionary unification and
// dict-index materialization; this decoder goes straight from the column
// chunk bytes to the engine's columnar layout (flat values, or int32 codes
// + value pool adopted as DictEnc) with no intermediate representation.
//
// Scope (everything else returns an error and the caller falls back to
// arrow for that column):
//   - page header: thrift compact protocol, DataPage v1 + v2 + DictionaryPage
//   - codecs: UNCOMPRESSED, SNAPPY (system libsnappy or the decoder
//     below), GZIP (system zlib), ZSTD (system libzstd) — the system
//     libraries are dlopen'd at first use so the build has no link-time
//     dependencies; missing libraries degrade to arrow fallback per column
//   - encodings: PLAIN, RLE_DICTIONARY/PLAIN_DICTIONARY, RLE def-levels,
//     DELTA_BINARY_PACKED, DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY
//   - physical types: BOOLEAN, INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY
//   - max_definition_level <= 1 (flat schemas), no repetition levels
//
// Error contract: negative return = unsupported/corrupt (caller falls
// back); PQ_E_GROW with *needed set = output buffer too small, retry.
//
// The batched entry point pq_decode_rowgroup decodes every column of a
// row group in ONE ctypes call (the per-column Python+metadata overhead
// was ~40% of decode wall on the wide ClickBench-shaped bench).  Perf
// notes baked into the layout:
//   - bit-unpack runs 8 values per iteration off unaligned 64-bit loads
//   - validity fills lazily: all-defined chunks never touch the array
//   - dictionary pages decompress straight into their final home (the
//     caller's data buffer for the all-dict byte-array fast path; zero
//     copy for uncompressed chunks)
//   - narrow logical ints (int8/16) are truncated during decode, so the
//     Python side never runs an astype pass

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <dlfcn.h>

namespace {

// ---------------------------------------------------------------------------
// byte reader with bounds checking

struct Reader {
    const uint8_t* p;
    const uint8_t* end;
    bool fail = false;

    int64_t left() const { return end - p; }
    bool need(int64_t n) {
        if (left() < n) { fail = true; return false; }
        return true;
    }
    uint8_t u8() {
        if (!need(1)) return 0;
        return *p++;
    }
    uint64_t uvarint() {
        uint64_t v = 0;
        int shift = 0;
        while (shift < 64) {
            if (!need(1)) return 0;
            uint8_t b = *p++;
            v |= (uint64_t)(b & 0x7F) << shift;
            if (!(b & 0x80)) return v;
            shift += 7;
        }
        fail = true;
        return 0;
    }
    int64_t zigzag() {
        uint64_t v = uvarint();
        return (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
    }
    bool skip(int64_t n) {
        if (!need(n)) return false;
        p += n;
        return true;
    }
};

// ---------------------------------------------------------------------------
// thrift compact protocol: parse PageHeader, generically skipping unknown
// fields (statistics etc.)

enum TType {
    T_STOP = 0, T_TRUE = 1, T_FALSE = 2, T_BYTE = 3, T_I16 = 4,
    T_I32 = 5, T_I64 = 6, T_DOUBLE = 7, T_BINARY = 8, T_LIST = 9,
    T_SET = 10, T_MAP = 11, T_STRUCT = 12,
};

void thrift_skip(Reader& r, int ttype);

void thrift_skip_struct(Reader& r) {
    for (;;) {
        if (r.fail) return;
        uint8_t b = r.u8();
        if (b == 0) return;  // STOP
        int ttype = b & 0x0F;
        if ((b >> 4) == 0) r.zigzag();  // long-form field id
        thrift_skip(r, ttype);
    }
}

void thrift_skip(Reader& r, int ttype) {
    switch (ttype) {
    case T_TRUE: case T_FALSE: return;
    case T_BYTE: r.u8(); return;
    case T_I16: case T_I32: case T_I64: r.zigzag(); return;
    case T_DOUBLE: r.skip(8); return;
    case T_BINARY: { uint64_t n = r.uvarint(); r.skip((int64_t)n); return; }
    case T_LIST: case T_SET: {
        uint8_t sh = r.u8();
        int64_t n = sh >> 4;
        int et = sh & 0x0F;
        if (n == 15) n = (int64_t)r.uvarint();
        for (int64_t i = 0; i < n && !r.fail; i++) thrift_skip(r, et);
        return;
    }
    case T_MAP: {
        uint64_t n = r.uvarint();
        if (n == 0) return;
        uint8_t kv = r.u8();
        for (uint64_t i = 0; i < n && !r.fail; i++) {
            thrift_skip(r, kv >> 4);
            thrift_skip(r, kv & 0x0F);
        }
        return;
    }
    case T_STRUCT: thrift_skip_struct(r); return;
    default: r.fail = true; return;
    }
}

struct PageHeader {
    int32_t type = -1;              // 0 data, 2 dict, 3 data v2
    int32_t uncompressed_size = -1;
    int32_t compressed_size = -1;
    // data page v1
    int32_t num_values = -1;
    int32_t encoding = -1;
    int32_t def_level_encoding = 3;  // RLE unless the header says otherwise
    // data page v2
    int32_t v2_num_nulls = -1;
    int32_t v2_num_rows = -1;
    int32_t v2_def_len = 0;
    int32_t v2_rep_len = 0;
    bool v2_is_compressed = true;
    // dictionary page
    int32_t dict_num_values = -1;
    int32_t dict_encoding = -1;
};

bool parse_page_header(Reader& r, PageHeader& h) {
    int16_t fid = 0;
    for (;;) {
        if (r.fail) return false;
        uint8_t b = r.u8();
        if (b == 0) break;
        int ttype = b & 0x0F;
        int delta = b >> 4;
        if (delta == 0) fid = (int16_t)r.zigzag();
        else fid = (int16_t)(fid + delta);
        if (ttype == T_TRUE || ttype == T_FALSE) continue;
        switch (fid) {
        case 1: h.type = (int32_t)r.zigzag(); break;
        case 2: h.uncompressed_size = (int32_t)r.zigzag(); break;
        case 3: h.compressed_size = (int32_t)r.zigzag(); break;
        case 5: {  // DataPageHeader struct
            if (ttype != T_STRUCT) { thrift_skip(r, ttype); break; }
            int16_t f2 = 0;
            for (;;) {
                uint8_t b2 = r.u8();
                if (b2 == 0 || r.fail) break;
                int tt2 = b2 & 0x0F;
                int d2 = b2 >> 4;
                if (d2 == 0) f2 = (int16_t)r.zigzag();
                else f2 = (int16_t)(f2 + d2);
                if (tt2 == T_TRUE || tt2 == T_FALSE) continue;
                if (f2 == 1) h.num_values = (int32_t)r.zigzag();
                else if (f2 == 2) h.encoding = (int32_t)r.zigzag();
                else if (f2 == 3)
                    h.def_level_encoding = (int32_t)r.zigzag();
                else thrift_skip(r, tt2);
            }
            break;
        }
        case 7: {  // DictionaryPageHeader struct
            if (ttype != T_STRUCT) { thrift_skip(r, ttype); break; }
            int16_t f2 = 0;
            for (;;) {
                uint8_t b2 = r.u8();
                if (b2 == 0 || r.fail) break;
                int tt2 = b2 & 0x0F;
                int d2 = b2 >> 4;
                if (d2 == 0) f2 = (int16_t)r.zigzag();
                else f2 = (int16_t)(f2 + d2);
                if (tt2 == T_TRUE || tt2 == T_FALSE) continue;
                if (f2 == 1) h.dict_num_values = (int32_t)r.zigzag();
                else if (f2 == 2) h.dict_encoding = (int32_t)r.zigzag();
                else thrift_skip(r, tt2);
            }
            break;
        }
        case 8: {  // DataPageHeaderV2 struct
            if (ttype != T_STRUCT) { thrift_skip(r, ttype); break; }
            int16_t f2 = 0;
            for (;;) {
                uint8_t b2 = r.u8();
                if (b2 == 0 || r.fail) break;
                int tt2 = b2 & 0x0F;
                int d2 = b2 >> 4;
                if (d2 == 0) f2 = (int16_t)r.zigzag();
                else f2 = (int16_t)(f2 + d2);
                if (tt2 == T_TRUE || tt2 == T_FALSE) {
                    if (f2 == 7) h.v2_is_compressed = (tt2 == T_TRUE);
                    continue;
                }
                if (f2 == 1) h.num_values = (int32_t)r.zigzag();
                else if (f2 == 2) h.v2_num_nulls = (int32_t)r.zigzag();
                else if (f2 == 3) h.v2_num_rows = (int32_t)r.zigzag();
                else if (f2 == 4) h.encoding = (int32_t)r.zigzag();
                else if (f2 == 5) h.v2_def_len = (int32_t)r.zigzag();
                else if (f2 == 6) h.v2_rep_len = (int32_t)r.zigzag();
                else thrift_skip(r, tt2);
            }
            break;
        }
        default:
            thrift_skip(r, ttype);
        }
    }
    return !r.fail && h.type >= 0 && h.compressed_size >= 0;
}

// ---------------------------------------------------------------------------
// snappy raw-format decompressor (fallback when libsnappy is absent)

int64_t snappy_decompress_builtin(const uint8_t* src, int64_t src_len,
                                  uint8_t* dst, int64_t dst_cap) {
    Reader r{src, src + src_len};
    uint64_t out_len = r.uvarint();
    if (r.fail || (int64_t)out_len > dst_cap) return -1;
    uint8_t* op = dst;
    uint8_t* op_end = dst + out_len;
    while (r.p < r.end) {
        uint8_t tag = *r.p++;
        if ((tag & 3) == 0) {  // literal
            int64_t lenm1 = tag >> 2;
            if (lenm1 >= 60) {
                int nb = (int)lenm1 - 59;  // 1..4 extra length bytes
                if (!r.need(nb)) return -1;
                uint64_t l = 0;
                for (int i = 0; i < nb; i++) l |= (uint64_t)r.p[i] << (8 * i);
                r.p += nb;
                lenm1 = (int64_t)l;
            }
            int64_t len = lenm1 + 1;
            if (!r.need(len) || op + len > op_end) return -1;
            memcpy(op, r.p, (size_t)len);
            r.p += len;
            op += len;
        } else {
            int64_t len, offset;
            if ((tag & 3) == 1) {
                len = ((tag >> 2) & 7) + 4;
                if (!r.need(1)) return -1;
                offset = ((int64_t)(tag >> 5) << 8) | *r.p++;
            } else if ((tag & 3) == 2) {
                len = (tag >> 2) + 1;
                if (!r.need(2)) return -1;
                offset = (int64_t)r.p[0] | ((int64_t)r.p[1] << 8);
                r.p += 2;
            } else {
                len = (tag >> 2) + 1;
                if (!r.need(4)) return -1;
                offset = (int64_t)r.p[0] | ((int64_t)r.p[1] << 8)
                       | ((int64_t)r.p[2] << 16) | ((int64_t)r.p[3] << 24);
                r.p += 4;
            }
            if (offset <= 0 || op - dst < offset || op + len > op_end)
                return -1;
            const uint8_t* cp = op - offset;
            if (offset >= len) {
                memcpy(op, cp, (size_t)len);
                op += len;
            } else {
                for (int64_t i = 0; i < len; i++) *op++ = *cp++;
            }
        }
    }
    return (op == op_end) ? (int64_t)out_len : -1;
}

// ---------------------------------------------------------------------------
// system codec libraries, dlopen'd once (no link-time deps: a missing
// library only narrows the native envelope, never breaks the build)

// zlib ABI (stable since forever; defined here so no dev headers needed)
struct ZStream {
    const uint8_t* next_in;
    unsigned avail_in;
    unsigned long total_in;
    uint8_t* next_out;
    unsigned avail_out;
    unsigned long total_out;
    const char* msg;
    void* state;
    void* (*zalloc)(void*, unsigned, unsigned);
    void (*zfree)(void*, void*);
    void* opaque;
    int data_type;
    unsigned long adler;
    unsigned long reserved;
};

struct SysCodecs {
    // libsnappy
    int (*snappy_uncompress)(const char*, size_t, char*, size_t*) = nullptr;
    // libzstd
    size_t (*zstd_decompress)(void*, size_t, const void*, size_t) = nullptr;
    unsigned (*zstd_is_error)(size_t) = nullptr;
    // libz
    int (*inflate_init2)(ZStream*, int, const char*, int) = nullptr;
    int (*inflate)(ZStream*, int) = nullptr;
    int (*inflate_end)(ZStream*) = nullptr;
};

const SysCodecs& sys_codecs() {
    static SysCodecs c = [] {
        SysCodecs s;
        if (void* h = dlopen("libsnappy.so.1", RTLD_NOW | RTLD_LOCAL)) {
            s.snappy_uncompress =
                (int (*)(const char*, size_t, char*, size_t*))
                    dlsym(h, "snappy_uncompress");
        }
        if (void* h = dlopen("libzstd.so.1", RTLD_NOW | RTLD_LOCAL)) {
            s.zstd_decompress =
                (size_t (*)(void*, size_t, const void*, size_t))
                    dlsym(h, "ZSTD_decompress");
            s.zstd_is_error =
                (unsigned (*)(size_t))dlsym(h, "ZSTD_isError");
            if (!s.zstd_is_error) s.zstd_decompress = nullptr;
        }
        if (void* h = dlopen("libz.so.1", RTLD_NOW | RTLD_LOCAL)) {
            s.inflate_init2 = (int (*)(ZStream*, int, const char*, int))
                dlsym(h, "inflateInit2_");
            s.inflate = (int (*)(ZStream*, int))dlsym(h, "inflate");
            s.inflate_end = (int (*)(ZStream*))dlsym(h, "inflateEnd");
            if (!s.inflate || !s.inflate_end) s.inflate_init2 = nullptr;
        }
        return s;
    }();
    return c;
}

// parquet CompressionCodec enum values
enum {
    CODEC_RAW = 0, CODEC_SNAPPY = 1, CODEC_GZIP = 2, CODEC_ZSTD = 6,
};

bool codec_supported(int codec) {
    switch (codec) {
    case CODEC_RAW: case CODEC_SNAPPY: return true;
    case CODEC_GZIP: return sys_codecs().inflate_init2 != nullptr;
    case CODEC_ZSTD: return sys_codecs().zstd_decompress != nullptr;
    default: return false;
    }
}

// decompress src into dst; exact output size must match dst_len
bool decompress(int codec, const uint8_t* src, int64_t src_len,
                uint8_t* dst, int64_t dst_len) {
    const SysCodecs& c = sys_codecs();
    switch (codec) {
    case CODEC_SNAPPY: {
        if (c.snappy_uncompress) {
            size_t out = (size_t)dst_len;
            if (c.snappy_uncompress((const char*)src, (size_t)src_len,
                                    (char*)dst, &out) == 0
                && (int64_t)out == dst_len)
                return true;
            return false;
        }
        return snappy_decompress_builtin(src, src_len, dst, dst_len)
               == dst_len;
    }
    case CODEC_ZSTD: {
        if (!c.zstd_decompress) return false;
        size_t rc = c.zstd_decompress(dst, (size_t)dst_len, src,
                                      (size_t)src_len);
        return !c.zstd_is_error(rc) && (int64_t)rc == dst_len;
    }
    case CODEC_GZIP: {
        if (!c.inflate_init2) return false;
        ZStream zs;
        memset(&zs, 0, sizeof(zs));
        // windowBits 15+32: auto-detect gzip or zlib framing (parquet
        // writers emit gzip; be liberal).  Version string only pins the
        // major version in zlib's compatibility check.
        if (c.inflate_init2(&zs, 15 + 32, "1", (int)sizeof(zs)) != 0)
            return false;
        zs.next_in = src;
        zs.avail_in = (unsigned)src_len;
        zs.next_out = dst;
        zs.avail_out = (unsigned)dst_len;
        int rc = c.inflate(&zs, 4 /* Z_FINISH */);
        bool ok = (rc == 1 /* Z_STREAM_END */)
                  && (int64_t)zs.total_out == dst_len;
        c.inflate_end(&zs);
        return ok;
    }
    default:
        return false;
    }
}

// ---------------------------------------------------------------------------
// RLE/bit-packed hybrid decoder (def levels + dict indices)

struct RleDecoder {
    Reader r;
    int bit_width;
    // current run
    int64_t rle_count = 0;
    uint32_t rle_value = 0;
    int64_t bp_count = 0;       // remaining values in bit-packed run
    int64_t bp_bytes = 0;       // remaining stream bytes of that run
    uint64_t bit_buf = 0;
    int bit_cnt = 0;

    bool next_run() {
        if (r.p >= r.end) return false;
        uint64_t header = r.uvarint();
        if (r.fail) return false;
        if (header & 1) {
            bp_count = (int64_t)(header >> 1) * 8;
            // a bit-packed run occupies exactly groups*bit_width bytes;
            // refills must never read past it into the next run header
            bp_bytes = (int64_t)(header >> 1) * bit_width;
            bit_buf = 0;
            bit_cnt = 0;
        } else {
            rle_count = (int64_t)(header >> 1);
            int nb = (bit_width + 7) / 8;
            if (!r.need(nb)) return false;
            rle_value = 0;
            for (int i = 0; i < nb; i++)
                rle_value |= (uint32_t)r.p[i] << (8 * i);
            r.p += nb;
        }
        return true;
    }

    // decode n values into out (int32); returns false on error
    bool get(int32_t* out, int64_t n) {
        const uint32_t mask = (uint32_t)((1ull << bit_width) - 1);
        const int bw = bit_width;
        while (n > 0) {
            if (rle_count > 0) {
                int64_t take = n < rle_count ? n : rle_count;
                int32_t v = (int32_t)rle_value;
                for (int64_t i = 0; i < take; i++) out[i] = v;
                out += take; n -= take; rle_count -= take;
            } else if (bp_count > 0) {
                int64_t take = n < bp_count ? n : bp_count;
                int64_t i = 0;
                // unrolled fast path: 8 values per iteration, unaligned
                // 64-bit loads (8 values consume exactly bw bytes, and
                // runs always start byte-aligned)
                if (bw > 0) {
                    while (bit_cnt == 0 && take - i >= 8 && bp_bytes >= bw
                           && r.end - r.p >= bw + 8) {
                        const uint8_t* in = r.p;
                        for (int j = 0; j < 8; j++) {
                            uint64_t w;
                            memcpy(&w, in + ((j * bw) >> 3), 8);
                            out[i + j] =
                                (int32_t)((w >> ((j * bw) & 7)) & mask);
                        }
                        r.p += bw;
                        bp_bytes -= bw;
                        i += 8;
                    }
                }
                while (i < take) {
                    if (bit_cnt < bw) {
                        // refill: one unaligned load, bounded both by the
                        // buffer space and by the run's remaining bytes
                        int nb = (64 - bit_cnt) >> 3;
                        if ((int64_t)nb > bp_bytes) nb = (int)bp_bytes;
                        if (nb > 0 && r.end - r.p >= nb) {
                            uint64_t w = 0;
                            if (r.end - r.p >= 8) {
                                memcpy(&w, r.p, 8);
                                if (nb < 8)
                                    w &= ((1ull << (nb * 8)) - 1);
                            } else {
                                memcpy(&w, r.p, (size_t)nb);
                            }
                            bit_buf |= w << bit_cnt;
                            r.p += nb;
                            bp_bytes -= nb;
                            bit_cnt += nb * 8;
                        } else {
                            // starved tail (truncated input): consume what
                            // exists, zero-pad the overhang
                            while (bit_cnt < bw) {
                                uint64_t byte = 0;
                                if (bp_bytes > 0 && r.p < r.end) {
                                    byte = *r.p++;
                                    bp_bytes--;
                                }
                                bit_buf |= byte << bit_cnt;
                                bit_cnt += 8;
                            }
                        }
                    }
                    while (bit_cnt >= bw && i < take) {
                        out[i++] = (int32_t)(bit_buf & mask);
                        bit_buf >>= bw;
                        bit_cnt -= bw;
                    }
                    if (bw == 0) {
                        memset(out + i, 0, (size_t)(take - i) * 4);
                        i = take;
                    }
                }
                out += take; n -= take; bp_count -= take;
            } else if (!next_run()) {
                return false;
            }
        }
        return true;
    }
};

// ---------------------------------------------------------------------------
// bit reader for DELTA_BINARY_PACKED miniblocks (widths up to 64)

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    int bit = 0;
    bool fail = false;

    uint64_t get(int bw) {
        if (bw == 0) return 0;
        // fast path: an unaligned 8-byte load covers bit..bit+bw when the
        // value fits in what remains of the load after the shift
        if (end - p >= 9 && bit + bw <= 64) {
            uint64_t w;
            memcpy(&w, p, 8);
            uint64_t v = (w >> bit);
            if (bw < 64) v &= ((1ull << bw) - 1);
            int nbits = bit + bw;
            p += nbits >> 3;
            bit = nbits & 7;
            return v;
        }
        uint64_t v = 0;
        int got = 0;
        int need = bw;
        while (need > 0) {
            if (p >= end) { fail = true; return 0; }
            int avail = 8 - bit;
            int take = avail < need ? avail : need;
            v |= (uint64_t)((*p >> bit) & ((1u << take) - 1)) << got;
            bit += take;
            got += take;
            need -= take;
            if (bit == 8) { bit = 0; p++; }
        }
        return v;
    }
    void align_to_byte() {
        if (bit) { bit = 0; p++; }
    }
};

// DELTA_BINARY_PACKED: decode exactly `count` values (the page header's
// num-defined) into out as uint64 (caller truncates to the physical
// width).  Advances r past the encoded block.  Returns false on error.
bool delta_bp_decode(Reader& r, uint64_t* out, int64_t count) {
    uint64_t block_size = r.uvarint();
    uint64_t minis = r.uvarint();
    uint64_t total = r.uvarint();
    int64_t first = r.zigzag();
    if (r.fail || minis == 0 || minis > 4096) return false;
    if (block_size == 0 || block_size % 128 != 0) return false;
    uint64_t per_mini = block_size / minis;
    if (per_mini == 0 || per_mini % 32 != 0) return false;
    if ((int64_t)total < count) return false;
    if (count == 0) return true;
    out[0] = (uint64_t)first;
    uint64_t acc = (uint64_t)first;
    int64_t produced = 1;
    uint8_t widths[4096];
    BitReader br{r.p, r.end};
    while (produced < count) {
        // block header: min_delta + per-miniblock bit widths
        Reader hr{br.p, r.end};
        int64_t min_delta = hr.zigzag();
        if (hr.fail || !hr.need((int64_t)minis)) return false;
        memcpy(widths, hr.p, minis);
        hr.p += minis;
        br.p = hr.p;
        br.bit = 0;
        for (uint64_t m = 0; m < minis && produced < count; m++) {
            int bw = widths[m];
            if (bw > 64) return false;
            // a miniblock is padded to per_mini values even when only
            // partially needed
            for (uint64_t j = 0; j < per_mini; j++) {
                uint64_t d = br.get(bw);
                if (br.fail) return false;
                if (produced < count) {
                    acc += (uint64_t)min_delta + d;
                    out[produced++] = acc;
                }
            }
            br.align_to_byte();
        }
    }
    r.p = br.p + (br.bit ? 1 : 0);
    if (r.p > r.end) { r.fail = true; return false; }
    return true;
}

// ---------------------------------------------------------------------------
// shared chunk-walk state

enum {
    PQ_OK = 0,
    PQ_E_UNSUPPORTED = -1,
    PQ_E_CORRUPT = -3,
    PQ_E_GROW = -2,
};

enum {
    ENC_PLAIN = 0, ENC_PLAIN_DICT = 2, ENC_RLE = 3, ENC_RLE_DICT = 8,
    ENC_DELTA_BP = 5, ENC_DELTA_LEN_BA = 6, ENC_DELTA_BA = 7,
};

struct Scratch {
    uint8_t* buf = nullptr;
    int64_t cap = 0;
    ~Scratch() { free(buf); }
    uint8_t* ensure(int64_t n) {
        if (n > cap) {
            free(buf);
            buf = (uint8_t*)malloc((size_t)n);
            cap = buf ? n : 0;
        }
        return buf;
    }
};

// One data page, ready to decode: `data` points at the (decompressed)
// values section; def levels already applied to validity.
struct PageView {
    const uint8_t* data;
    const uint8_t* end;
    int64_t n;          // values in page (incl. nulls)
    int64_t defined;    // non-null values
    int32_t encoding;
};

// def-levels from an RLE block (max_def==1): fills validity[0..n),
// returns defined count or -1.
int64_t decode_def_rle(const uint8_t* p, int64_t len, int64_t n,
                       uint8_t* validity) {
    // fast path: one run covering the page (the overwhelmingly common
    // all-defined / all-null shapes)
    {
        Reader peek{p, p + len};
        uint64_t header = peek.uvarint();
        if (!peek.fail && !(header & 1) && (int64_t)(header >> 1) >= n
            && peek.need(1)) {
            uint8_t v = *peek.p;
            if (v <= 1) {
                memset(validity, v, (size_t)n);
                return v ? n : 0;
            }
        }
    }
    RleDecoder rd;
    rd.r = Reader{p, p + len};
    rd.bit_width = 1;
    int64_t defined = 0;
    int32_t tmp[1024];
    int64_t done = 0;
    while (done < n) {
        int64_t take = n - done < 1024 ? n - done : 1024;
        if (!rd.get(tmp, take)) return -1;
        for (int64_t i = 0; i < take; i++) {
            uint8_t v = (uint8_t)(tmp[i] != 0);
            validity[done + i] = v;
            defined += v;
        }
        done += take;
    }
    return defined;
}

// Walks the pages of one column chunk, handling v1/v2 framing, dictionary
// pages, codecs, and def levels; the value decode stays with the caller.
//
// Validity fills LAZILY: pages where every value is defined skip the
// memset until some page carries nulls — an all-defined chunk (the common
// case by far) never touches the validity array at all, and the caller
// learns that from the nulls count.
struct ChunkWalker {
    Reader r;
    int codec;
    int32_t max_def;
    uint8_t* validity;       // per-row validity out (or nullptr)
    bool validity_live = false;
    Scratch page_scratch;
    // dictionary page, recorded raw; decompressed on demand by load_dict
    const uint8_t* dict_comp_ptr = nullptr;
    int64_t dict_comp_len = 0;
    int64_t dict_uncomp = 0;
    int64_t dict_num = -1;
    Scratch dict_raw;

    void fill_defined(int64_t row, int64_t n) {
        if (validity && validity_live)
            memset(validity + row, 1, (size_t)n);
    }
    // a page with nulls appeared: backfill the all-defined prefix
    void go_live(int64_t row) {
        if (validity && !validity_live) {
            memset(validity, 1, (size_t)row);
            validity_live = true;
        }
    }

    // Decompress (or alias) the dictionary page.  dst: the final home
    // sized >= dict_uncomp, or nullptr to use internal scratch.  For
    // uncompressed chunks the returned pointer aliases the chunk itself
    // (zero copy) and dst is ignored — callers that do TYPED loads on
    // the dictionary must use load_dict_aligned instead (the chunk alias
    // sits at an arbitrary byte offset after the thrift header).
    const uint8_t* load_dict(uint8_t* dst) {
        if (!dict_comp_ptr) return nullptr;
        if (codec == CODEC_RAW) {
            if (dict_uncomp != dict_comp_len) return nullptr;
            return dict_comp_ptr;
        }
        if (!dst) {
            dst = dict_raw.ensure(dict_uncomp);
            if (!dst) return nullptr;
        }
        if (!decompress(codec, dict_comp_ptr, dict_comp_len, dst,
                        dict_uncomp))
            return nullptr;
        return dst;
    }

    // load_dict into malloc-aligned memory always (fixed-width gathers
    // index the dictionary as uint32_t*/uint64_t* arrays)
    const uint8_t* load_dict_aligned() {
        const uint8_t* p = load_dict(nullptr);
        if (!p || p != dict_comp_ptr) return p;
        uint8_t* dst = dict_raw.ensure(dict_uncomp);
        if (!dst) return nullptr;
        memcpy(dst, p, (size_t)dict_uncomp);
        return dst;
    }

    // returns: 1 = data page in *pv, 0 = end of chunk, <0 = error
    int next_page(PageView& pv, int64_t row, int64_t rows_left) {
        for (;;) {
            if (r.p >= r.end) return 0;
            PageHeader h;
            if (!parse_page_header(r, h)) return PQ_E_CORRUPT;
            if (h.compressed_size < 0 || h.uncompressed_size < 0)
                return PQ_E_CORRUPT;
            if (!r.need(h.compressed_size)) return PQ_E_CORRUPT;
            const uint8_t* raw = r.p;
            r.p += h.compressed_size;

            if (h.type == 2) {  // dictionary page: record, load lazily
                if (h.dict_encoding != ENC_PLAIN
                    && h.dict_encoding != ENC_PLAIN_DICT)
                    return PQ_E_UNSUPPORTED;
                dict_comp_ptr = raw;
                dict_comp_len = h.compressed_size;
                dict_uncomp = h.uncompressed_size;
                dict_num = h.dict_num_values;
                continue;
            }

            if (h.type != 0 && h.type != 3) return PQ_E_UNSUPPORTED;
            int64_t n = h.num_values;
            if (n < 0 || n > rows_left) return PQ_E_CORRUPT;
            pv.n = n;
            pv.encoding = h.encoding;

            if (h.type == 0) {  // DataPage v1: levels live inside the
                                // (possibly compressed) page body
                if (max_def > 0 && h.def_level_encoding != ENC_RLE)
                    return PQ_E_UNSUPPORTED;
                const uint8_t* pb;
                if (codec == CODEC_RAW) {
                    if (h.uncompressed_size != h.compressed_size)
                        return PQ_E_CORRUPT;
                    pb = raw;
                } else {
                    uint8_t* dst = page_scratch.ensure(h.uncompressed_size);
                    if (!dst) return PQ_E_CORRUPT;
                    if (!decompress(codec, raw, h.compressed_size, dst,
                                    h.uncompressed_size))
                        return PQ_E_CORRUPT;
                    pb = dst;
                }
                const uint8_t* pend = pb + h.uncompressed_size;
                if (max_def == 0) {
                    pv.defined = n;
                    fill_defined(row, n);
                } else {
                    if (pend - pb < 4) return PQ_E_CORRUPT;
                    uint32_t len = (uint32_t)pb[0] | ((uint32_t)pb[1] << 8)
                                 | ((uint32_t)pb[2] << 16)
                                 | ((uint32_t)pb[3] << 24);
                    pb += 4;
                    if (pend - pb < (int64_t)len) return PQ_E_CORRUPT;
                    // peek: all-defined pages skip the validity write
                    pv.defined = -1;
                    {
                        Reader peek{pb, pb + len};
                        uint64_t hd = peek.uvarint();
                        if (!peek.fail && !(hd & 1)
                            && (int64_t)(hd >> 1) >= n && peek.need(1)
                            && *peek.p == 1) {
                            pv.defined = n;
                            fill_defined(row, n);
                        }
                    }
                    if (pv.defined < 0) {
                        if (!validity) return PQ_E_CORRUPT;
                        go_live(row);
                        pv.defined = decode_def_rle(pb, len, n,
                                                    validity + row);
                        if (pv.defined < 0) return PQ_E_CORRUPT;
                    }
                    pb += len;
                }
                pv.data = pb;
                pv.end = pend;
                return 1;
            }

            // DataPage v2: rep/def levels sit uncompressed ahead of the
            // (possibly compressed) values
            if (h.v2_rep_len != 0) return PQ_E_UNSUPPORTED;
            if (h.v2_def_len < 0
                || h.v2_def_len > h.compressed_size) return PQ_E_CORRUPT;
            const uint8_t* lv = raw;
            const uint8_t* data_raw = raw + h.v2_def_len;
            int64_t data_comp = h.compressed_size - h.v2_def_len;
            int64_t data_uncomp = h.uncompressed_size - h.v2_def_len;
            if (data_uncomp < 0) return PQ_E_CORRUPT;
            if (max_def == 0 || h.v2_num_nulls == 0) {
                pv.defined = n;
                fill_defined(row, n);
            } else {
                if (!validity) return PQ_E_CORRUPT;
                go_live(row);
                pv.defined = decode_def_rle(lv, h.v2_def_len, n,
                                            validity + row);
                if (pv.defined < 0) return PQ_E_CORRUPT;
                if (h.v2_num_nulls >= 0
                    && pv.defined != n - h.v2_num_nulls)
                    return PQ_E_CORRUPT;
            }
            const uint8_t* pb;
            if (!h.v2_is_compressed || codec == CODEC_RAW) {
                if (data_comp != data_uncomp) return PQ_E_CORRUPT;
                pb = data_raw;
            } else {
                uint8_t* dst = page_scratch.ensure(data_uncomp);
                if (!dst && data_uncomp > 0) return PQ_E_CORRUPT;
                if (!decompress(codec, data_raw, data_comp, dst,
                                data_uncomp))
                    return PQ_E_CORRUPT;
                pb = dst;
            }
            pv.data = pb;
            pv.end = pb + data_uncomp;
            return 1;
        }
    }
};

// scratch for per-page delta buffers, reused across pages
struct DeltaScratch {
    Scratch s;
    uint64_t* ensure_u64(int64_t n) {
        return (uint64_t*)s.ensure(n * 8);
    }
};

// narrow-store helper: write value as ow little-endian bytes
inline void store_narrow(uint8_t* dst, uint64_t v, int ow) {
    switch (ow) {
    case 1: *dst = (uint8_t)v; break;
    case 2: { uint16_t x = (uint16_t)v; memcpy(dst, &x, 2); break; }
    case 4: { uint32_t x = (uint32_t)v; memcpy(dst, &x, 4); break; }
    default: memcpy(dst, &v, 8); break;
    }
}

// ---------------------------------------------------------------------------
// fixed-width decode core (physical width 4/8, output width ow <= width;
// ow < width truncates little-endian — the logical-type narrowing for
// int8/int16 columns that pyarrow stores as INT32)

int64_t decode_fixed_chunk(const uint8_t* chunk, int64_t chunk_len,
                           int32_t codec, int32_t width, int32_t ow,
                           int64_t num_values, int32_t max_def,
                           int32_t is_bool, uint8_t* out_values,
                           uint8_t* out_validity, int64_t* out_nulls) {
    if (codec != CODEC_RAW && !codec_supported(codec))
        return PQ_E_UNSUPPORTED;
    if (is_bool) {
        if (width != 1 || ow != 1) return PQ_E_UNSUPPORTED;
    } else {
        if (width != 4 && width != 8) return PQ_E_UNSUPPORTED;
        if (ow != 1 && ow != 2 && ow != 4 && ow != 8) return PQ_E_UNSUPPORTED;
        if (ow > width) return PQ_E_UNSUPPORTED;
    }
    if (max_def > 1) return PQ_E_UNSUPPORTED;
    ChunkWalker w;
    w.r = Reader{chunk, chunk + chunk_len};
    w.codec = codec;
    w.max_def = max_def;
    w.validity = out_validity;
    DeltaScratch delta;
    const uint8_t* dictb = nullptr;   // loaded on first dict-coded page
    int64_t dict_n = 0;
    int64_t row = 0;
    int64_t nulls = 0;
    int32_t idx_buf[4096];
    PageView pv;
    for (;;) {
        int rc = w.next_page(pv, row, num_values - row);
        if (rc < 0) return rc;
        if (rc == 0) break;
        int64_t n = pv.n;
        int64_t defined = pv.defined;
        nulls += n - defined;
        const uint8_t* pb = pv.data;
        const uint8_t* pend = pv.end;
        uint8_t* dst = out_values + row * ow;

        if (is_bool) {
            // BOOLEAN: PLAIN = LSB bit-packed; v2 pages may use RLE
            if (defined < n) memset(dst, 0, (size_t)n);
            if (pv.encoding == ENC_PLAIN) {
                BitReader br{pb, pend};
                for (int64_t i = 0; i < n; i++) {
                    if (defined != n && !out_validity[row + i]) continue;
                    dst[i] = (uint8_t)br.get(1);
                    if (br.fail) return PQ_E_CORRUPT;
                }
            } else if (pv.encoding == ENC_RLE) {
                // RLE-framed bools: u32 length prefix + RLE(bit_width 1)
                if (pend - pb < 4) return PQ_E_CORRUPT;
                uint32_t len = (uint32_t)pb[0] | ((uint32_t)pb[1] << 8)
                             | ((uint32_t)pb[2] << 16)
                             | ((uint32_t)pb[3] << 24);
                pb += 4;
                if (pend - pb < (int64_t)len) return PQ_E_CORRUPT;
                RleDecoder rd;
                rd.r = Reader{pb, pb + len};
                rd.bit_width = 1;
                int64_t i = 0;
                while (i < n) {
                    int64_t block = n - i < 4096 ? n - i : 4096;
                    int64_t nd = 0;
                    if (defined == n) nd = block;
                    else for (int64_t k = 0; k < block; k++)
                        nd += out_validity[row + i + k];
                    if (!rd.get(idx_buf, nd)) return PQ_E_CORRUPT;
                    int64_t ci = 0;
                    for (int64_t k = 0; k < block; k++) {
                        if (defined != n && !out_validity[row + i + k])
                            continue;
                        dst[i + k] = (uint8_t)(idx_buf[ci++] != 0);
                    }
                    i += block;
                }
            } else {
                return PQ_E_UNSUPPORTED;
            }
            row += n;
            continue;
        }

        if (pv.encoding == ENC_PLAIN) {
            if (pend - pb < defined * width) return PQ_E_CORRUPT;
            if (defined == n && ow == width) {
                memcpy(dst, pb, (size_t)(n * width));
            } else if (defined == n) {
                const uint8_t* src = pb;
                for (int64_t i = 0; i < n; i++) {
                    memcpy(dst + i * ow, src, (size_t)ow);
                    src += width;
                }
            } else {
                memset(dst, 0, (size_t)(n * ow));
                const uint8_t* src = pb;
                for (int64_t i = 0; i < n; i++) {
                    if (out_validity[row + i]) {
                        memcpy(dst + i * ow, src, (size_t)ow);
                        src += width;
                    }
                }
            }
        } else if (pv.encoding == ENC_DELTA_BP) {
            uint64_t* tmp = delta.ensure_u64(defined);
            if (!tmp && defined > 0) return PQ_E_CORRUPT;
            Reader dr{pb, pend};
            if (!delta_bp_decode(dr, tmp, defined)) return PQ_E_CORRUPT;
            if (defined < n) memset(dst, 0, (size_t)(n * ow));
            if (defined == n) {
                for (int64_t i = 0; i < n; i++)
                    store_narrow(dst + i * ow, tmp[i], ow);
            } else {
                int64_t ci = 0;
                for (int64_t i = 0; i < n; i++)
                    if (out_validity[row + i])
                        store_narrow(dst + i * ow, tmp[ci++], ow);
            }
        } else if (pv.encoding == ENC_RLE_DICT
                   || pv.encoding == ENC_PLAIN_DICT) {
            if (!dictb) {
                dictb = w.load_dict_aligned();
                if (!dictb) return PQ_E_CORRUPT;
                dict_n = w.dict_uncomp / width;
            }
            if (pend - pb < 1) return PQ_E_CORRUPT;
            RleDecoder rd;
            rd.bit_width = *pb++;
            if (rd.bit_width > 32) return PQ_E_CORRUPT;
            rd.r = Reader{pb, pend};
            if (defined < n) memset(dst, 0, (size_t)(n * ow));
            int64_t i = 0;
            while (i < n) {
                int64_t block = n - i < 4096 ? n - i : 4096;
                int64_t nd = 0;
                if (defined == n) {
                    nd = block;
                } else {
                    for (int64_t k = 0; k < block; k++)
                        nd += out_validity[row + i + k];
                }
                if (!rd.get(idx_buf, nd)) return PQ_E_CORRUPT;
                uint8_t* db = dst + i * ow;
                if (defined == n) {
                    // gather, specialized per (width, ow)
                    if (width == 4 && ow == 4) {
                        const uint32_t* dv = (const uint32_t*)dictb;
                        uint32_t* o32 = (uint32_t*)db;
                        for (int64_t k = 0; k < block; k++) {
                            uint32_t code = (uint32_t)idx_buf[k];
                            if ((int64_t)code >= dict_n)
                                return PQ_E_CORRUPT;
                            o32[k] = dv[code];
                        }
                    } else if (width == 8 && ow == 8) {
                        const uint64_t* dv = (const uint64_t*)dictb;
                        uint64_t* o64 = (uint64_t*)db;
                        for (int64_t k = 0; k < block; k++) {
                            uint32_t code = (uint32_t)idx_buf[k];
                            if ((int64_t)code >= dict_n)
                                return PQ_E_CORRUPT;
                            o64[k] = dv[code];
                        }
                    } else if (width == 4 && ow == 1) {
                        const uint32_t* dv = (const uint32_t*)dictb;
                        for (int64_t k = 0; k < block; k++) {
                            uint32_t code = (uint32_t)idx_buf[k];
                            if ((int64_t)code >= dict_n)
                                return PQ_E_CORRUPT;
                            db[k] = (uint8_t)dv[code];
                        }
                    } else if (width == 4 && ow == 2) {
                        const uint32_t* dv = (const uint32_t*)dictb;
                        uint16_t* o16 = (uint16_t*)db;
                        for (int64_t k = 0; k < block; k++) {
                            uint32_t code = (uint32_t)idx_buf[k];
                            if ((int64_t)code >= dict_n)
                                return PQ_E_CORRUPT;
                            o16[k] = (uint16_t)dv[code];
                        }
                    } else {  // width 8, ow < 8
                        const uint64_t* dv = (const uint64_t*)dictb;
                        for (int64_t k = 0; k < block; k++) {
                            uint32_t code = (uint32_t)idx_buf[k];
                            if ((int64_t)code >= dict_n)
                                return PQ_E_CORRUPT;
                            store_narrow(db + k * ow, dv[code], ow);
                        }
                    }
                } else {
                    int64_t ci = 0;
                    for (int64_t k = 0; k < block; k++) {
                        if (!out_validity[row + i + k]) continue;
                        uint32_t code = (uint32_t)idx_buf[ci++];
                        if ((int64_t)code >= dict_n) return PQ_E_CORRUPT;
                        uint64_t v = (width == 4)
                            ? ((const uint32_t*)dictb)[code]
                            : ((const uint64_t*)dictb)[code];
                        store_narrow(db + k * ow, v, ow);
                    }
                }
                i += block;
            }
        } else {
            return PQ_E_UNSUPPORTED;
        }
        row += n;
    }
    if (out_nulls) *out_nulls = nulls;
    return row;
}

}  // namespace

// (BYTE_ARRAY core and the exported ABI follow in part 2 of this file)
#include "parquetdec_ba.inc"
