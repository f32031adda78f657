// K10: the table fingerprint's per-row lanes, with the dict columns'
// per-pool-entry accumulator gather (K11's gather) fused in.
//
// Replaces the JAX device program transferia_tpu/ops/rowhash.py
// `_device_row_lanes` (line 520) as jitted for row keys (line 510) and for
// the fingerprint reduction (lines 669-683), with
// transferia_tpu/ops/decode.py `gather_pool_accumulators` (line 52) inside
// it.  `trt_var_accumulators` computes the per-pool-entry accumulators that
// transferia_tpu/ops/rowhash.py `pool_accumulators` (line 202) memoizes
// (host C++ in the reference, this kernel on the card).
//
// Every row hashes to two 32-bit lanes.  Each column has a descriptor
// (ColDesc, 48 bytes; ops/rowhash.py `ColDesc` is its ctypes twin):
//   a, b, c, valid pointers, size, seed1, seed2
// and a launch lists its fixed columns first, then its dict columns, then
// its var columns (the lanes add over columns, so the order is free):
// fixed: a = (n,) uint64 canonical bits
//        h = mix(lo ^ seed); h = mix(h + mix(hi ^ ~seed))
// var:   a = bytes (size of them, at most 2^31 - 1 counted: the offsets
//        are int32), b = (n+1,) int32 offsets
//        h = mix(poly(row) ^ seed), poly = sum of block[j] * P^j mod 2^32
//        over the row's canonical SHA-style block layout: its bytes, 0x80
//        at position len, zeros, and the 8 big-endian bytes of len*8 at
//        the end of its own last 64-byte block.  The layout is read
//        straight from (bytes, offsets): zero padding adds nothing, so no
//        padded matrix is built and the batch's padded width never
//        matters.
//        The host checked the offsets; each row is clamped to the buffer
//        all the same, so no offsets make the kernel read outside it.
// dict:  a = (n,) int32 codes, b/c = (size,) uint32 per-entry
//        accumulators
//        h = mix(acc[clamp(code, 0, size - 1)] ^ seed); the host checked
//        the codes' range before the launch.
// A null row (valid[row] == 0) takes null ^ seed instead of h.  Then
// r += mix(h) per lane, and finally r = mix(r).
//
// Modes: keys (reduce = 0) writes r1 and r2 per row (batch_row_keys);
// reduce (reduce = 1) sums and XORs r1 and r2 over the block with warp
// shuffles and adds them into acc[0..3] (sum1, sum2, xor1, xor2) with one
// atomicAdd / atomicXor per block.  Both are associative and commutative
// mod 2^32, so the result is exact in any order and accumulates across
// launches (one accumulator serves a whole table scan).
//
// Bound on an H100: operations (the mix chains, ~87 instructions per
// 8-byte fixed value for both lanes), counted from the SASS by
// chip_smoke.py; at the fingerprint's shapes a thread's chain of
// dependent loads matters as much.  What held the first design back: a
// descriptor array copied host to device before every launch and re-read
// from device memory per row and column, each load waited for before the
// next column's, and each var byte costing two multiplies for the next
// powers of P beside its two multiply-adds, then square-and-multiply for
// P^(end-8) a row.  This design:
//   - Descriptors by value: up to kByValueCols columns ride in the
//     __grid_constant__ LaneArgs, so a launch copies nothing, and a block
//     stages them in shared memory once.  Wider tables point at a ColDesc
//     array in device memory, read per row as before.
//   - A thread takes a row at a time, the grid striding.  Fixed and dict
//     columns go kBatch at a time: their loads are issued together before
//     any is used, and a null row's constant is a bit select, not a
//     branch.
//   - A var row takes its own thread, which runs Horner's rule over its
//     bytes from the last, the terminator first: two multiply-adds a byte
//     and no power of P but the length term's.  A row of at most
//     kShortRow bytes (ClickBench's every string) has constant powers
//     there (its q is at most 1); a longer one raises P^64 to q by
//     square-and-multiply once.  A warp's rows are consecutive, so their
//     byte loads share cache lines.  The next column's offsets load while
//     this one's bytes do.  (Measured slower on the H100 at the
//     ClickBench batch: a group of 8 or 16 lanes a row reading 16-byte
//     chunks, ~4x and ~8x, and a warp copying its rows' span into shared
//     memory first.)

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP1 = 0x01000193u;
constexpr uint32_t kP2 = 0x8DA6B343u;
constexpr uint32_t kNull1 = 0xA5A5A5A5u;
constexpr uint32_t kNull2 = 0x5A5A5A5Au;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 8;
constexpr int kByValueCols = 128;
constexpr int kBatch = 4;       // fixed or dict columns loaded at once
constexpr int kShortRow = 64;   // rows with constant length-term powers

struct ColDesc {
  const void* a;
  const void* b;
  const void* c;
  const uint8_t* valid;
  int64_t size;
  uint32_t seed1;
  uint32_t seed2;
};

// cols (or dev_cols): n_fixed fixed, then n_dict dict, then n_var var
// columns
struct LaneArgs {
  ColDesc cols[kByValueCols];  // by value when there are <= kByValueCols
  const ColDesc* dev_cols;     // in device memory when more
  uint32_t* r1;
  uint32_t* r2;
  uint32_t* acc;
  int64_t n;
  int32_t n_fixed;
  int32_t n_dict;
  int32_t n_var;
  int32_t reduce;
};

static_assert(sizeof(ColDesc) == 48, "ops/rowhash.py ColDesc");
static_assert(sizeof(LaneArgs) == 6200, "ops/rowhash.py LaneArgs");
static_assert(offsetof(LaneArgs, dev_cols) == 6144, "LaneArgs layout");
static_assert(offsetof(LaneArgs, n) == 6176, "LaneArgs layout");
static_assert(offsetof(LaneArgs, n_var) == 6192, "LaneArgs layout");

__host__ __device__ constexpr uint32_t cpow(uint32_t b, int e) {
  uint32_t r = 1u;
  for (int i = 0; i < e; ++i) r *= b;
  return r;
}


__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// a var row's bytes [start, start + len): offsets lo, hi clamped to the
// buffer's nb bytes (the host passes at most 2^31 - 1: the offsets are
// int32, so no row reaches past that)
__device__ __forceinline__ void row_span(int lo, int hi, int nb, int* start,
                                         int* len) {
  const int a = min(max(lo, 0), nb);
  *start = a;
  *len = min(max(hi, a), nb) - a;
}

// A row's Horner sums plus its length bytes: len*8 big-endian at the
// positions 64 q + 56 .. 64 q + 63, q = (len + 8) >> 6.  A row of at most
// kShortRow bytes has len*8 < 2^16 (the last two positions) and q <= 1,
// so every power is a constant; a longer one raises P^64 to q by
// square-and-multiply.
__device__ __forceinline__ void finish_row(uint32_t acc1, uint32_t acc2,
                                           int len, uint32_t* out1,
                                           uint32_t* out2) {
  constexpr uint32_t a56 = cpow(kP1, 56), a62 = cpow(kP1, 62),
                     a63 = cpow(kP1, 63), a64 = cpow(kP1, 64);
  constexpr uint32_t b56 = cpow(kP2, 56), b62 = cpow(kP2, 62),
                     b63 = cpow(kP2, 63), b64 = cpow(kP2, 64);
  if (len <= kShortRow) {
    const uint32_t bits = static_cast<uint32_t>(len) * 8u;
    const bool q = len + 8 >= 64;
    const uint32_t hi = bits >> 8, lo = bits & 0xffu;
    *out1 = acc1 + (q ? a64 : 1u) * (hi * a62 + lo * a63);
    *out2 = acc2 + (q ? b64 : 1u) * (hi * b62 + lo * b63);
    return;
  }
  const uint64_t bits = static_cast<uint64_t>(len) * 8u;
  uint32_t l1 = 0u, l2 = 0u, f1 = a56, f2 = b56;
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // position 56 + k: byte 7 - k of bits
    const uint32_t b = static_cast<uint32_t>((bits >> (8 * (7 - k))) & 0xffu);
    l1 += b * f1;
    l2 += b * f2;
    f1 *= kP1;
    f2 *= kP2;
  }
  uint32_t p1 = 1u, p2 = 1u, s1 = a64, s2 = b64;
#pragma unroll 1
  for (uint32_t q = (static_cast<uint32_t>(len) + 8u) >> 6; q != 0;
       q >>= 1) {
    if (q & 1u) {
      p1 *= s1;
      p2 *= s2;
    }
    s1 *= s1;
    s2 *= s2;
  }
  *out1 = acc1 + p1 * l1;
  *out2 = acc2 + p2 * l2;
}

// Both lanes' accumulators of the row data[start, start + len), read byte
// by byte by one thread: Horner's rule from the last byte, the terminator
// first (no power of P needed but the length term's)
__device__ __forceinline__ void var_bytes(const uint8_t* row, int len,
                                          uint32_t* out1, uint32_t* out2) {
  uint32_t acc1 = 0x80u, acc2 = 0x80u;  // the terminator, at position len
#pragma unroll 4
  for (int j = len - 1; j >= 0; --j) {
    const uint32_t b = row[j];
    acc1 = acc1 * kP1 + b;
    acc2 = acc2 * kP2 + b;
  }
  finish_row(acc1, acc2, len, out1, out2);
}

__device__ __forceinline__ bool is_null(const ColDesc& d, int64_t row) {
  return d.valid != nullptr && __ldg(d.valid + row) == 0;
}

// a if `take`, else b, without a branch
__device__ __forceinline__ uint32_t pick(bool take, uint32_t a, uint32_t b) {
  return b ^ ((a ^ b) & (0u - static_cast<uint32_t>(take)));
}

// K10's lanes; kByValue: the descriptors ride in the arguments (staged in
// shared memory), else in device memory.
template <bool kByValue>
__global__ void __launch_bounds__(kThreads)
    rowhash_lanes_kernel(const __grid_constant__ LaneArgs a) {
  __shared__ ColDesc s_cols[kByValue ? kByValueCols : 1];
  __shared__ uint32_t partial[4][kWarps];
  const int tid = threadIdx.x;
  const int nf = a.n_fixed, nd = a.n_dict, nv = a.n_var;
  const int n_cols = nf + nd + nv;
  if (kByValue) {
    // 6 eight-byte words a descriptor
    const auto* src = reinterpret_cast<const uint64_t*>(a.cols);
    auto* dst = reinterpret_cast<uint64_t*>(s_cols);
    for (int i = tid; i < n_cols * 6; i += kThreads) dst[i] = src[i];
  }
  const ColDesc* cols = kByValue ? s_cols : a.dev_cols;
  __syncthreads();
  uint32_t sum1 = 0u, sum2 = 0u, xor1 = 0u, xor2 = 0u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
       row < a.n; row += stride) {
    uint32_t r1 = 0u, r2 = 0u;
    // fixed columns, kBatch at a time: the loads first
#pragma unroll 1
    for (int c0 = 0; c0 < nf; c0 += kBatch) {
      uint64_t v[kBatch];
      bool null[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        v[u] = 0u;
        null[u] = false;
        if (c0 + u < nf) {
          const ColDesc& d = cols[c0 + u];
          null[u] = is_null(d, row);
          v[u] = __ldg(static_cast<const unsigned long long*>(d.a) + row);
        }
      }
      // a null slot is selected, not branched around; an absent one
      // (the same in every thread) is skipped
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (c0 + u >= nf) break;
        const ColDesc& d = cols[c0 + u];
        const uint32_t lo = static_cast<uint32_t>(v[u]);
        const uint32_t hi = static_cast<uint32_t>(v[u] >> 32);
        const uint32_t h1 = pick(null[u], kNull1 ^ d.seed1,
                                 mix(mix(lo ^ d.seed1) +
                                     mix(hi ^ ~d.seed1)));
        const uint32_t h2 = pick(null[u], kNull2 ^ d.seed2,
                                 mix(mix(lo ^ d.seed2) +
                                     mix(hi ^ ~d.seed2)));
        r1 += mix(h1);
        r2 += mix(h2);
      }
    }
    // dict columns, kBatch at a time: codes, then the gathers
#pragma unroll 1
    for (int c0 = nf; c0 < nf + nd; c0 += kBatch) {
      int32_t code[kBatch];
      bool null[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        code[u] = 0;
        null[u] = false;
        if (c0 + u < nf + nd) {
          const ColDesc& d = cols[c0 + u];
          null[u] = is_null(d, row);
          code[u] = __ldg(static_cast<const int32_t*>(d.a) + row);
        }
      }
      uint32_t acc1[kBatch], acc2[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {  // the gathers, all issued
        acc1[u] = acc2[u] = 0u;
        if (c0 + u < nf + nd) {
          const ColDesc& d = cols[c0 + u];
          const int32_t k = static_cast<int32_t>(d.size);  // pool size
          const int32_t c =
              code[u] < 0 ? 0 : (code[u] >= k ? k - 1 : code[u]);
          acc1[u] = __ldg(static_cast<const uint32_t*>(d.b) + c);
          acc2[u] = __ldg(static_cast<const uint32_t*>(d.c) + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (c0 + u >= nf + nd) break;
        const ColDesc& d = cols[c0 + u];
        const uint32_t h1 =
            pick(null[u], kNull1 ^ d.seed1, mix(acc1[u] ^ d.seed1));
        const uint32_t h2 =
            pick(null[u], kNull2 ^ d.seed2, mix(acc2[u] ^ d.seed2));
        r1 += mix(h1);
        r2 += mix(h2);
      }
    }
    // var columns: the row by its own thread (var_bytes), the next
    // column's offsets loaded while this one's bytes are
    if (nv != 0) {
      int lo, hi;
      bool null;
      const auto offsets_of = [&](int c) {
        const ColDesc& e = cols[c];
        null = is_null(e, row);
        lo = __ldg(static_cast<const int32_t*>(e.b) + row);
        hi = __ldg(static_cast<const int32_t*>(e.b) + row + 1);
      };
      offsets_of(nf + nd);
#pragma unroll 1
      for (int c = nf + nd; c < n_cols; ++c) {
        const ColDesc& d = cols[c];
        const int size = static_cast<int>(d.size);
        int start, len;
        row_span(lo, hi, size, &start, &len);
        const bool null0 = null;
        if (c + 1 < n_cols) offsets_of(c + 1);
        uint32_t h1 = kNull1 ^ d.seed1, h2 = kNull2 ^ d.seed2;
        if (!null0) {
          uint32_t p1, p2;
          var_bytes(static_cast<const uint8_t*>(d.a) + start, len, &p1, &p2);
          h1 = mix(p1 ^ d.seed1);
          h2 = mix(p2 ^ d.seed2);
        }
        r1 += mix(h1);
        r2 += mix(h2);
      }
    }
    r1 = mix(r1);
    r2 = mix(r2);
    if (a.reduce) {
      sum1 += r1;
      sum2 += r2;
      xor1 ^= r1;
      xor2 ^= r2;
    } else {
      a.r1[row] = r1;
      a.r2[row] = r2;
    }
  }
  if (!a.reduce) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum1 += __shfl_xor_sync(kFullMask, sum1, o);
    sum2 += __shfl_xor_sync(kFullMask, sum2, o);
    xor1 ^= __shfl_xor_sync(kFullMask, xor1, o);
    xor2 ^= __shfl_xor_sync(kFullMask, xor2, o);
  }
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) {
    partial[0][warp] = sum1;
    partial[1][warp] = sum2;
    partial[2][warp] = xor1;
    partial[3][warp] = xor2;
  }
  __syncthreads();
  if (warp != 0) return;
  const bool in = lane < kWarps;
  sum1 = in ? partial[0][lane] : 0u;
  sum2 = in ? partial[1][lane] : 0u;
  xor1 = in ? partial[2][lane] : 0u;
  xor2 = in ? partial[3][lane] : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum1 += __shfl_xor_sync(kFullMask, sum1, o);
    sum2 += __shfl_xor_sync(kFullMask, sum2, o);
    xor1 ^= __shfl_xor_sync(kFullMask, xor1, o);
    xor2 ^= __shfl_xor_sync(kFullMask, xor2, o);
  }
  if (lane == 0) {
    atomicAdd(&a.acc[0], sum1);
    atomicAdd(&a.acc[1], sum2);
    atomicXor(&a.acc[2], xor1);
    atomicXor(&a.acc[3], xor2);
  }
}

// the per-entry accumulators of a var column or pool, an entry a thread
__global__ void __launch_bounds__(kThreads)
    var_accumulators_kernel(const uint8_t* __restrict__ data, int nb,
                            const int32_t* __restrict__ offsets, int64_t n,
                            uint32_t* __restrict__ acc1,
                            uint32_t* __restrict__ acc2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    int start, len;
    row_span(__ldg(offsets + i), __ldg(offsets + i + 1), nb, &start, &len);
    var_bytes(data + start, len, acc1 + i, acc2 + i);
  }
}

int grid_for(long long units) {
  int device = 0, sms = 132;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  const long long blocks = (units + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < cap ? blocks : cap);
}

}  // namespace

// args: a host LaneArgs (ops/rowhash.py builds it with ctypes), passed to
// the kernel by value.
extern "C" int trt_rowhash_lanes(const void* args, void* stream) {
  const auto& a = *static_cast<const LaneArgs*>(args);
  const int n_cols = a.n_fixed + a.n_dict + a.n_var;
  if (a.n <= 0 || a.n_fixed < 0 || a.n_dict < 0 || a.n_var < 0 ||
      (n_cols > kByValueCols && a.dev_cols == nullptr) ||
      (a.reduce && a.acc == nullptr) ||
      (!a.reduce && (a.r1 == nullptr || a.r2 == nullptr))) {
    return cudaErrorInvalidValue;
  }
  const int grid = grid_for(a.n);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_cols <= kByValueCols)
    rowhash_lanes_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    rowhash_lanes_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trt_var_accumulators(const void* data, long long n_bytes,
                                    const void* offsets, long long n,
                                    void* acc1, void* acc2, void* stream) {
  if (n <= 0 || n_bytes < 0) return cudaErrorInvalidValue;
  // the offsets are int32: no row reaches past 2^31 - 1 bytes
  const int nb = n_bytes > 0x7fffffffLL ? 0x7fffffff
                                        : static_cast<int>(n_bytes);
  var_accumulators_kernel<<<grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), nb,
      static_cast<const int32_t*>(offsets), n, static_cast<uint32_t*>(acc1),
      static_cast<uint32_t*>(acc2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
