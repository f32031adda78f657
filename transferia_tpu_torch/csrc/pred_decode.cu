// K-B: on-device decode of one dispatch-encoded predicate column, and
// K11: the dictionary decode (bit-unpack of codes + clamped pool gather).
//
// K-B replaces the JAX device programs transferia_tpu/ops/decode.py
// `_unpack_core` (line 142) as reached through `unpack_validity` (line 64),
// `delta_prefix_sum` (line 73), `for_frame_decode` (line 91) and
// `unpack_bits` (line 34), which transferia_tpu/ops/dispatch.py
// `decode_pred_device` (line 306) composes.  K11 (`trt_dict_decode`,
// below) replaces `decode_dict_run` (line 44) and `decode_dict_loop`
// (line 126).
//
// Values arrive bit-packed in a little-endian uint32 word stream: value i
// occupies bits [i*bw, (i+1)*bw).  The mode is a launch argument:
//   bits  (0): width 1 -> bool bytes (validity bitmaps, bool data);
//   delta (1): zigzag deltas -> base + inclusive int32 prefix sum;
//   for   (2): frame-of-reference remainders -> mins[i / frame] + rel[i];
//   unpack (3): any width 1..32 -> the raw value as int32 (`unpack_bits`).
// All int32 arithmetic wraps two's-complement, as the reference's does:
// the zigzag decode uses an arithmetic shift of the int32 code, and the
// sums run in uint32 and are reinterpreted.  Word reads past the stream
// clamp to its last word, like jnp.take(mode="clip").
//
// Design: bits and for are elementwise, one thread per value in a
// grid-stride loop.  delta needs a scan: one block of 1024 threads walks
// the column in tiles of 8192 values, each thread scanning 8 consecutive
// values in registers, a warp-shuffle scan across the block, and a running
// carry from tile to tile.  n is at most 1,048,576 (the largest row
// bucket) and usually 32,768 (one pipelined chunk), so one block is a
// simple, correct first version; a multi-block scan is later work.
//
// Bound on an H100: a few integer operations per value against 4-8 bytes
// of traffic per value: bound by bytes.  The single-block scan is far from
// that bound (one SM of 132 is busy).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { kBits = 0, kDelta = 1, kFor = 2, kUnpack = 3 };

constexpr int kScanThreads = 1024;
constexpr int kScanItems = 8;
constexpr int kScanTile = kScanThreads * kScanItems;
constexpr unsigned kFullMask = 0xffffffffu;

// value i of the stream whose every word is XORed with `flip` on load
__device__ __forceinline__ uint32_t unpack(const uint32_t* __restrict__ w,
                                           int n_words, int64_t i, int bw,
                                           uint32_t flip = 0u) {
  const uint64_t start = static_cast<uint64_t>(i) * bw;
  const int wi = static_cast<int>(start >> 5);
  const int off = static_cast<int>(start & 31);
  uint32_t v = (w[min(wi, n_words - 1)] ^ flip) >> off;
  if (off > 0) v |= (w[min(wi + 1, n_words - 1)] ^ flip) << (32 - off);
  if (bw < 32) v &= (1u << bw) - 1u;
  return v;
}

__global__ void decode_elementwise_kernel(int mode,
                                          const uint32_t* __restrict__ words,
                                          int n_words, int64_t n, int bw,
                                          const int32_t* __restrict__ mins,
                                          int frame, void* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const uint32_t v = unpack(words, n_words, i, bw);
    if (mode == kBits) {
      static_cast<uint8_t*>(out)[i] = static_cast<uint8_t>(v & 1u);
    } else if (mode == kUnpack) {
      static_cast<int32_t*>(out)[i] = static_cast<int32_t>(v);
    } else {
      static_cast<int32_t*>(out)[i] = static_cast<int32_t>(
          static_cast<uint32_t>(mins[i / frame]) + v);
    }
  }
}

__global__ void __launch_bounds__(kScanThreads)
    decode_delta_kernel(const uint32_t* __restrict__ words, int n_words,
                        int64_t n, int bw, int32_t base,
                        int32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t carry = static_cast<uint32_t>(base);
  for (int64_t tile = 0; tile < n; tile += kScanTile) {
    const int64_t first = tile + static_cast<int64_t>(tid) * kScanItems;
    uint32_t run[kScanItems];
    uint32_t local = 0;
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t i = first + k;
      uint32_t d = 0;
      if (i < n) {
        const uint32_t zz = unpack(words, n_words, i, bw);
        // (zz >> 1) ^ -(zz & 1) on the int32 code
        d = static_cast<uint32_t>(static_cast<int32_t>(zz) >> 1) ^
            (0u - (zz & 1u));
      }
      local += d;
      run[k] = local;
    }
    // inclusive scan of the per-thread totals across the warp
    uint32_t x = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFullMask, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      uint32_t s = warp_sums[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFullMask, s, o);
        if (lane >= o) s += y;
      }
      warp_sums[lane] = s;
    }
    __syncthreads();
    const uint32_t prefix =
        carry + (warp ? warp_sums[warp - 1] : 0u) + (x - local);
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      const int64_t i = first + k;
      if (i < n) out[i] = static_cast<int32_t>(prefix + run[k]);
    }
    carry += warp_sums[kScanThreads / 32 - 1];
    __syncthreads();  // warp_sums is rewritten by the next tile
  }
}

// K11: value i = pool[clamp(int32(code_i), 0, k - 1)], code_i unpacked at
// width bw from words ^ (carry & 1) -- jnp.take(mode="clip") on the int32
// code, so at bw = 32 a code >= 2^31 is negative and takes entry 0.  With
// a carry (decode_dict_loop) the values are not written: each block sums
// its values in uint32 and adds the sum into carry_out with one atomic,
// and block 0 also adds the incoming carry, so carry_out (zeroed) ends as
// carry_in + sum(values) mod 2^32, the reference's fori_loop body.
__global__ void dict_decode_kernel(const uint32_t* __restrict__ words,
                                   int n_words, int64_t n, int bw,
                                   const int32_t* __restrict__ pool, int k,
                                   const uint32_t* __restrict__ carry_in,
                                   uint32_t* __restrict__ carry_out,
                                   int32_t* __restrict__ out) {
  __shared__ uint32_t warp_sums[32];
  const uint32_t flip = carry_in ? (*carry_in & 1u) : 0u;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  uint32_t sum = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int32_t code =
        static_cast<int32_t>(unpack(words, n_words, i, bw, flip));
    const int32_t value = pool[code < 0 ? 0 : (code >= k ? k - 1 : code)];
    if (carry_out) {
      sum += static_cast<uint32_t>(value);
    } else {
      out[i] = value;
    }
  }
  if (!carry_out) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    sum = lane < (blockDim.x >> 5) ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
    if (lane == 0) {
      if (blockIdx.x == 0 && carry_in) sum += *carry_in;
      atomicAdd(carry_out, sum);
    }
  }
}

}  // namespace

extern "C" int trt_pred_decode(int mode, const void* words, int n_words,
                               long long n, int bw, int base,
                               const void* mins, int frame, void* out,
                               void* stream) {
  if (n <= 0 || n_words <= 0 || bw < 1 || bw > 32 ||
      (mode == kBits && bw != 1) || (mode == kFor && frame <= 0) ||
      mode < kBits || mode > kUnpack) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  if (mode == kDelta) {
    decode_delta_kernel<<<1, kScanThreads, 0, s>>>(
        w, n_words, n, bw, base, static_cast<int32_t*>(out));
  } else {
    constexpr int kThreads = 256;
    const long long blocks = (n + kThreads - 1) / kThreads;
    const int grid = static_cast<int>(blocks < 8192 ? blocks : 8192);
    decode_elementwise_kernel<<<grid, kThreads, 0, s>>>(
        mode, w, n_words, n, bw, static_cast<const int32_t*>(mins), frame,
        out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trt_dict_decode(const void* words, int n_words, long long n,
                               int bw, const void* pool, int k,
                               const void* carry_in, void* carry_out,
                               void* out, void* stream) {
  if (n <= 0 || n_words <= 0 || bw < 1 || bw > 32 || k <= 0 ||
      (carry_out == nullptr) == (out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  constexpr int kThreads = 256;
  const long long blocks = (n + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 4096 ? blocks : 4096);
  dict_decode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, n, bw,
      static_cast<const int32_t*>(pool), k,
      static_cast<const uint32_t*>(carry_in),
      static_cast<uint32_t*>(carry_out), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
