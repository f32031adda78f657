// K15: the SR fan-in user function, a sign flip by region, on the card.
//
// Replaces the user jax.jit program of bench.py:1015 (`bench_lambda`,
// `jnp.where(region < 400, ids, -ids)`), which the reference's lambda
// transformer (transferia_tpu/transform/plugins/lambda_tf.py:172-229)
// runs on the accelerator for BASELINE config #5.  The JAX package runs
// without x64, so that program sees the int64 ids as int32.  Per row r:
//   out[r] = region[r] < threshold ? (int32)ids[r] : -(int32)ids[r]
// where the cast keeps the low 32 bits and the negation wraps
// (-INT32_MIN == INT32_MIN).  Both are done in uint32 arithmetic, which
// wraps by definition, so no signed overflow is ever computed.
//
// Design: one grid-stride elementwise pass, one row per thread and step;
// neighbouring threads read neighbouring ids and regions, so every load
// and store is coalesced.  The threshold is an argument, not a literal.
//
// Bound on an H100: bytes.  A row reads 8 bytes of ids and 4 of region
// and writes 4; the arithmetic is a compare and a select.  1,048,576 rows
// move 16.8 MB: about 5.0 us at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void region_sign_flip_kernel(const int64_t* __restrict__ ids,
                                        const int32_t* __restrict__ region,
                                        long long n, int threshold,
                                        int32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n; r += stride) {
    const uint32_t low = static_cast<uint32_t>(ids[r]);
    const uint32_t v = region[r] < threshold ? low : 0u - low;
    out[r] = static_cast<int32_t>(v);
  }
}

}  // namespace

extern "C" int trt_region_sign_flip(const void* ids, const void* region,
                                    long long n, int threshold, void* out,
                                    void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  // enough blocks to fill 132 SMs many times over; larger inputs stride
  constexpr long long kMaxBlocks = 132 * 32;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  region_sign_flip_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(ids), static_cast<const int32_t*>(region),
      n, threshold, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
