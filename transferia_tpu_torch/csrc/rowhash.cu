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
// Every row hashes to two 32-bit lanes.  Each column has a descriptor of
// eight int64 words in device memory:
//   kind (0 fixed, 1 var, 2 dict), seed1, seed2, a, b, c, valid, size
// fixed: a = (n,) uint64 canonical bits
//        h = mix(lo ^ seed); h = mix(h + mix(hi ^ ~seed))
// var:   a = bytes (size of them), b = (n+1,) int32 offsets
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
// shuffles and adds them into out[0..3] (sum1, sum2, xor1, xor2) with one
// atomicAdd / atomicXor per block.  Both are associative and commutative
// mod 2^32, so the result is exact in any order and accumulates across
// launches (one accumulator serves a whole table scan).
//
// Bound on an H100: each input byte is read once.  The source does ~72
// 32-bit operations per 8-byte fixed value (both lanes), ~40 per 4-byte
// dict code and ~6 per var byte plus ~130 per var row; at 3.35 TB/s
// against ~16.7 T integer operations/s (64 INT32 lanes a SM) that would
// make every kind of value bound by operations, but those are
// source-level estimates, not counted from the SASS, so the stated bound
// is the bytes' until they are.  One thread per row walks its own bytes
// in order (neighbouring threads read neighbouring rows, so the lines are
// shared in L1): simple and right; reading the bytes in 16-byte vectors
// is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP1 = 0x01000193u;
constexpr uint32_t kP2 = 0x8DA6B343u;
constexpr uint32_t kNull1 = 0xA5A5A5A5u;
constexpr uint32_t kNull2 = 0x5A5A5A5Au;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kDescWords = 8;
enum Kind { kFixed = 0, kVar = 1, kDict = 2 };

__device__ __forceinline__ uint32_t mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t pow32(uint32_t b, uint64_t e) {
  uint32_t r = 1u;
  while (e) {
    if (e & 1u) r *= b;
    b *= b;
    e >>= 1;
  }
  return r;
}

// both lanes' polynomial accumulators of the canonical block layout of the
// row data[row_start, row_end), clamped to the buffer's n_bytes
__device__ __forceinline__ void var_acc(const uint8_t* __restrict__ data,
                                        int64_t n_bytes, int64_t row_start,
                                        int64_t row_end, uint32_t* a1,
                                        uint32_t* a2) {
  const int64_t start =
      row_start < 0 ? 0 : (row_start > n_bytes ? n_bytes : row_start);
  const int64_t stop =
      row_end < start ? start : (row_end > n_bytes ? n_bytes : row_end);
  const uint8_t* bytes = data + start;
  const int64_t len = stop - start;
  uint32_t s1 = 0u, s2 = 0u, p1 = 1u, p2 = 1u;
  for (int64_t j = 0; j < len; ++j) {
    const uint32_t b = bytes[j];
    s1 += b * p1;
    s2 += b * p2;
    p1 *= kP1;
    p2 *= kP2;
  }
  s1 += 0x80u * p1;  // terminator at position len
  s2 += 0x80u * p2;
  const uint64_t end = static_cast<uint64_t>((len + 9 + 63) / 64) * 64;
  const uint64_t bits = static_cast<uint64_t>(len) * 8u;
  uint32_t q1 = pow32(kP1, end - 8), q2 = pow32(kP2, end - 8);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const uint32_t b = static_cast<uint32_t>((bits >> (8 * (7 - k))) & 0xffu);
    s1 += b * q1;
    s2 += b * q2;
    q1 *= kP1;
    q2 *= kP2;
  }
  *a1 = s1;
  *a2 = s2;
}

__global__ void rowhash_lanes_kernel(const int64_t* __restrict__ desc,
                                     int n_cols, int64_t n, int reduce,
                                     uint32_t* __restrict__ r1_out,
                                     uint32_t* __restrict__ r2_out,
                                     uint32_t* __restrict__ acc) {
  __shared__ uint32_t partial[4][32];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  uint32_t sum1 = 0u, sum2 = 0u, xor1 = 0u, xor2 = 0u;
  for (int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       row < n; row += stride) {
    uint32_t r1 = 0u, r2 = 0u;
    for (int c = 0; c < n_cols; ++c) {
      const int64_t* d = desc + c * kDescWords;
      const int kind = static_cast<int>(d[0]);
      const uint32_t seed1 = static_cast<uint32_t>(d[1]);
      const uint32_t seed2 = static_cast<uint32_t>(d[2]);
      const uint8_t* valid = reinterpret_cast<const uint8_t*>(d[6]);
      uint32_t h1, h2;
      if (valid != nullptr && valid[row] == 0) {
        h1 = kNull1 ^ seed1;
        h2 = kNull2 ^ seed2;
      } else if (kind == kFixed) {
        const uint64_t v = reinterpret_cast<const uint64_t*>(d[3])[row];
        const uint32_t lo = static_cast<uint32_t>(v);
        const uint32_t hi = static_cast<uint32_t>(v >> 32);
        h1 = mix(mix(lo ^ seed1) + mix(hi ^ ~seed1));
        h2 = mix(mix(lo ^ seed2) + mix(hi ^ ~seed2));
      } else if (kind == kVar) {
        const int32_t* off = reinterpret_cast<const int32_t*>(d[4]);
        uint32_t a1, a2;
        var_acc(reinterpret_cast<const uint8_t*>(d[3]), d[7], off[row],
                off[row + 1], &a1, &a2);
        h1 = mix(a1 ^ seed1);
        h2 = mix(a2 ^ seed2);
      } else {
        const int32_t k = static_cast<int32_t>(d[7]);  // pool size
        int32_t code = reinterpret_cast<const int32_t*>(d[3])[row];
        code = code < 0 ? 0 : (code >= k ? k - 1 : code);
        h1 = mix(reinterpret_cast<const uint32_t*>(d[4])[code] ^ seed1);
        h2 = mix(reinterpret_cast<const uint32_t*>(d[5])[code] ^ seed2);
      }
      r1 += mix(h1);
      r2 += mix(h2);
    }
    r1 = mix(r1);
    r2 = mix(r2);
    if (reduce) {
      sum1 += r1;
      sum2 += r2;
      xor1 ^= r1;
      xor2 ^= r2;
    } else {
      r1_out[row] = r1;
      r2_out[row] = r2;
    }
  }
  if (!reduce) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum1 += __shfl_xor_sync(kFullMask, sum1, o);
    sum2 += __shfl_xor_sync(kFullMask, sum2, o);
    xor1 ^= __shfl_xor_sync(kFullMask, xor1, o);
    xor2 ^= __shfl_xor_sync(kFullMask, xor2, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    partial[0][warp] = sum1;
    partial[1][warp] = sum2;
    partial[2][warp] = xor1;
    partial[3][warp] = xor2;
  }
  __syncthreads();
  if (warp != 0) return;
  const bool live = lane < static_cast<int>(blockDim.x >> 5);
  sum1 = live ? partial[0][lane] : 0u;
  sum2 = live ? partial[1][lane] : 0u;
  xor1 = live ? partial[2][lane] : 0u;
  xor2 = live ? partial[3][lane] : 0u;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum1 += __shfl_xor_sync(kFullMask, sum1, o);
    sum2 += __shfl_xor_sync(kFullMask, sum2, o);
    xor1 ^= __shfl_xor_sync(kFullMask, xor1, o);
    xor2 ^= __shfl_xor_sync(kFullMask, xor2, o);
  }
  if (lane == 0) {
    atomicAdd(&acc[0], sum1);
    atomicAdd(&acc[1], sum2);
    atomicXor(&acc[2], xor1);
    atomicXor(&acc[3], xor2);
  }
}

__global__ void var_accumulators_kernel(const uint8_t* __restrict__ data,
                                        int64_t n_bytes,
                                        const int32_t* __restrict__ offsets,
                                        int64_t n,
                                        uint32_t* __restrict__ acc1,
                                        uint32_t* __restrict__ acc2) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    var_acc(data, n_bytes, offsets[i], offsets[i + 1], &acc1[i], &acc2[i]);
  }
}

constexpr int kThreads = 256;

int grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < 4096 ? blocks : 4096);
}

}  // namespace

extern "C" int trt_rowhash_lanes(const void* desc, int n_cols, long long n,
                                 int reduce, void* r1, void* r2, void* acc,
                                 void* stream) {
  if (n <= 0 || n_cols < 0 || (reduce && acc == nullptr) ||
      (!reduce && (r1 == nullptr || r2 == nullptr))) {
    return cudaErrorInvalidValue;
  }
  rowhash_lanes_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(desc), n_cols, n, reduce,
      static_cast<uint32_t*>(r1), static_cast<uint32_t*>(r2),
      static_cast<uint32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trt_var_accumulators(const void* data, long long n_bytes,
                                    const void* offsets, long long n,
                                    void* acc1, void* acc2, void* stream) {
  if (n <= 0 || n_bytes < 0) return cudaErrorInvalidValue;
  var_accumulators_kernel<<<grid_for(n), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n_bytes,
      static_cast<const int32_t*>(offsets), n, static_cast<uint32_t*>(acc1),
      static_cast<uint32_t*>(acc2));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
