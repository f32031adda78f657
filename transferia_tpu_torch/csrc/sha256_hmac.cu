// K-A: batched SHA-256 / HMAC-SHA256 over pre-padded message blocks.
//
// Replaces the JAX device programs transferia_tpu/ops/sha256.py
// `_sha256_padded` (line 123, with `_compress_batch` line 61 and
// `_bytes_to_words` line 104) and `_hmac_inner_outer_impl` (line 257,
// reached through `hmac_device_core` line 248).
//
// Input: blocks (N, max_blocks*64) uint8, already SHA-padded on the host
// (ops/sha256.py prepare_padded_blocks); n_blocks (N,) int32; an initial
// state (8 words) and, in HMAC mode, an outer state.  Row r compresses
// blocks 0 .. min(n_blocks[r], max_blocks)-1 starting from the initial
// state; a pad row with n_blocks = 0 keeps the initial state, as the
// reference's do.  HMAC mode then compresses one outer block
// [h0..h7, 0x80000000, 0 x6, (64+32)*8] from the outer state.
//
// Design: one thread per row.  The eight state words and the 16-word
// rolling message schedule live in registers (the round loop is fully
// unrolled, so every schedule index is a compile-time constant); the
// round constants sit in __constant__ memory and are read uniformly by
// the warp.  A block is read as four 16-byte loads and byte-swapped with
// __byte_perm.  The loop over blocks stops at the row's own block count,
// so the work done is what the data needs, not the bucket's maximum.
//
// Bound on an H100: SHA-256 is pure 32-bit integer ALU work (no tensor
// cores).  One compression compiles to ~1,400 SASS instructions (mostly
// SHF, LOP3 and IADD3: ~2,232 source-level operations fused; chip_smoke.py
// counts them from the build it runs), against 100 bytes of traffic per
// one-block row (64 in, 4 count, 32 out): it is bound by operations, not
// bytes, at 64 INT32 lanes a SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__constant__ uint32_t kK[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, uint32_t n) {
  return __funnelshift_r(x, x, n);
}

// One SHA-256 compression of the 16 big-endian words in w onto h.
// w is overwritten by the rolling schedule.
__device__ __forceinline__ void compress(uint32_t h[8], uint32_t w[16]) {
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    uint32_t wi;
    if (i < 16) {
      wi = w[i];
    } else {
      const uint32_t x15 = w[(i - 15) & 15];
      const uint32_t x2 = w[(i - 2) & 15];
      const uint32_t s0 = rotr(x15, 7) ^ rotr(x15, 18) ^ (x15 >> 3);
      const uint32_t s1 = rotr(x2, 17) ^ rotr(x2, 19) ^ (x2 >> 10);
      wi = w[i & 15] + s0 + w[(i - 7) & 15] + s1;
      w[i & 15] = wi;
    }
    const uint32_t big_s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = hh + big_s1 + ch + kK[i] + wi;
    const uint32_t big_s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = big_s0 + maj;
    hh = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  h[0] += a;
  h[1] += b;
  h[2] += c;
  h[3] += d;
  h[4] += e;
  h[5] += f;
  h[6] += g;
  h[7] += hh;
}

__global__ void sha256_hmac_kernel(const uint8_t* __restrict__ blocks,
                                   const int32_t* __restrict__ n_blocks,
                                   int n_rows, int max_blocks,
                                   const uint32_t* __restrict__ init,
                                   const uint32_t* __restrict__ outer,
                                   uint32_t* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  uint32_t h[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = init[k];
  const int nb = min(n_blocks[row], max_blocks);
  const uint4* src = reinterpret_cast<const uint4*>(
      blocks + static_cast<size_t>(row) * max_blocks * 64);
  for (int blk = 0; blk < nb; ++blk) {
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = src[blk * 4 + q];
      // little-endian load -> big-endian SHA word
      w[4 * q + 0] = __byte_perm(v.x, 0, 0x0123);
      w[4 * q + 1] = __byte_perm(v.y, 0, 0x0123);
      w[4 * q + 2] = __byte_perm(v.z, 0, 0x0123);
      w[4 * q + 3] = __byte_perm(v.w, 0, 0x0123);
    }
    compress(h, w);
  }
  if (outer != nullptr) {
    // H(K^opad || inner digest): the 32-byte digest plus fixed padding
    // is exactly one block
    uint32_t w[16] = {h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7],
                      0x80000000u, 0u, 0u, 0u, 0u, 0u, 0u,
                      (64u + 32u) * 8u};
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] = outer[k];
    compress(h, w);
  }
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(row) * 8);
  dst[0] = make_uint4(h[0], h[1], h[2], h[3]);
  dst[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

}  // namespace

extern "C" int trt_sha256_hmac(const void* blocks, const void* n_blocks,
                               int n_rows, int max_blocks, const void* init,
                               const void* outer, void* out, void* stream) {
  if (n_rows <= 0 || max_blocks <= 0) return cudaErrorInvalidValue;
  constexpr int kThreads = 128;
  const int grid = (n_rows + kThreads - 1) / kThreads;
  sha256_hmac_kernel<<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(blocks),
      static_cast<const int32_t*>(n_blocks), n_rows, max_blocks,
      static_cast<const uint32_t*>(init),
      static_cast<const uint32_t*>(outer), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
