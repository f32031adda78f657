// K13/K14: the mesh's shard histogram, and the mesh dict route's digest
// gather.
//
// trt_shard_hist replaces the histogram of two JAX device programs:
//   - step mode (K13): transferia_tpu/parallel/mesh.py `_transform_core`
//     (lines 56-76), per device of `sharded_transform_step` (79-126):
//       scores_f32 = float32(scores); keep = ages >= 0 & isfinite(scores_f32)
//       hist[digests[c, r, 0] % n_shards] += keep[r] for every local
//       column c; kept = sum(keep)
//     Scores arrive as float32 or float64 and are cast to float32 BEFORE
//     the finite test, as the reference's placement does (JAX runs
//     without x64, so 1e300 becomes inf and is not kept).
//   - fused mode (K14): transferia_tpu/parallel/fusedmesh.py
//     `per_device` (lines 184-196):
//       keep = pred[r] & valid[r] (valid alone without a predicate)
//       hist[digest0[r, 0] % n_shards] += keep[r]; kept = sum(keep)
//     pred and valid are both packed little-endian bitmap words (bit j
//     of word k = row 32k+j, as kernel K-C packs the keep mask) or both
//     bool bytes (the raw dispatch encoding), so neither needs a
//     conversion launch.
// The cross-device psums of the reference are the caller's: each shard
// writes its own (n_shards + 1,) int32 partial, hist then kept, and the
// caller sums the partials.
//
// Digest words are int32 with the uint32 bits; the bin is the UNSIGNED
// word modulo n_shards, as jnp's uint32 `%`.
//
// Design: a grid-stride loop, one thread per row; a per-block histogram
// of n_shards + 1 ints in shared memory (shared atomics), then one
// global atomic per non-zero bin per block.  Integer arithmetic only, so
// the result is exact and does not depend on the order of the atomics.
// A row's digest word is read only when the row is kept.
//
// Bound on an H100: bytes.  Each kept row reads word 0 of its digest
// row(s), one 32-byte sector each (the rows are 32 bytes apart); every
// row reads its keep bits (or ages and scores, and writes keep and
// scores_f32).  About 3 operations per byte moved: far below the card's
// balance of ~20 32-bit operations per byte.
//
// trt_digest_gather replaces transferia_tpu/parallel/fusedmesh.py lines
// 170-173, `jnp.take(dg, cd, axis=0, mode="clip")`: out[r, w] =
// table[clip(codes[r], 0, n_values - 1), w] over an (n_values, 8) digest
// table.  Out-of-range codes clip, as jnp's "clip" mode does (it does not
// raise).  One thread per (row, word): a warp writes 128 neighbouring
// bytes, and the table (a pool's digests, small) stays in L2.  Bound:
// bytes (4 B of code read and 32 B written per row).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 4096;  // the wrapper's limit, too
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;

__device__ __forceinline__ bool mask_bit(const void* p, long long r,
                                         int bool_layout) {
  if (bool_layout) return static_cast<const uint8_t*>(p)[r] != 0;
  return (static_cast<const uint32_t*>(p)[r >> 5] >> (r & 31)) & 1u;
}

template <bool kStep>
__global__ void shard_hist_kernel(const int32_t* __restrict__ digests,
                                  int n_mats, long long n_rows,
                                  int n_shards, const void* keep,
                                  const void* valid, int bool_layout,
                                  const int32_t* __restrict__ ages,
                                  const void* scores, int scores_f64,
                                  uint8_t* __restrict__ keep_out,
                                  float* __restrict__ scores_out,
                                  int32_t* __restrict__ out) {
  __shared__ int32_t s_hist[kMaxShards + 1];
  for (int i = threadIdx.x; i <= n_shards; i += blockDim.x) s_hist[i] = 0;
  __syncthreads();
  const uint32_t ns = static_cast<uint32_t>(n_shards);
  int kept = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < n_rows; r += stride) {
    bool k;
    if (kStep) {
      const float s =
          scores_f64
              ? __double2float_rn(static_cast<const double*>(scores)[r])
              : static_cast<const float*>(scores)[r];
      // finite: the exponent is not all ones (not inf, not NaN)
      k = ages[r] >= 0 && (__float_as_uint(s) & 0x7f800000u) != 0x7f800000u;
      if (keep_out != nullptr) keep_out[r] = k ? 1 : 0;
      if (scores_out != nullptr) scores_out[r] = s;
    } else {
      k = mask_bit(valid, r, bool_layout) &&
          (keep == nullptr || mask_bit(keep, r, bool_layout));
    }
    if (k) {
      ++kept;
      for (int c = 0; c < n_mats; ++c) {
        const uint32_t w0 = static_cast<uint32_t>(
            digests[(static_cast<long long>(c) * n_rows + r) * 8]);
        atomicAdd(&s_hist[w0 % ns], 1);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    kept += __shfl_down_sync(0xffffffffu, kept, off);
  if ((threadIdx.x & 31) == 0 && kept != 0) atomicAdd(&s_hist[n_shards], kept);
  __syncthreads();
  for (int i = threadIdx.x; i <= n_shards; i += blockDim.x)
    if (s_hist[i] != 0) atomicAdd(&out[i], s_hist[i]);
}

__global__ void digest_gather_kernel(const int32_t* __restrict__ table,
                                     int n_values,
                                     const int32_t* __restrict__ codes,
                                     long long n_rows,
                                     int32_t* __restrict__ out) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= n_rows * 8) return;
  int c = codes[t >> 3];
  c = c < 0 ? 0 : (c >= n_values ? n_values - 1 : c);
  out[t] = table[static_cast<long long>(c) * 8 + (t & 7)];
}

}  // namespace

// mode 0: fused (keep/valid/bool_layout); mode 1: step (ages/scores,
// writes keep_out/scores_out where not null).  `out` must hold zeros.
extern "C" int trt_shard_hist(int mode, const void* digests, int n_mats,
                              long long n_rows, int n_shards,
                              const void* keep, const void* valid,
                              int bool_layout, const void* ages,
                              const void* scores, int scores_f64,
                              void* keep_out, void* scores_out, void* out,
                              void* stream) {
  if (n_rows < 0 || n_mats < 1 || n_shards < 1 || n_shards > kMaxShards ||
      (mode == 0 && (valid == nullptr || n_mats != 1)) ||
      (mode == 1 && (ages == nullptr || scores == nullptr)) ||
      (mode != 0 && mode != 1))
    return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  long long grid = (n_rows + kThreads - 1) / kThreads;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* d = static_cast<const int32_t*>(digests);
  const auto* a = static_cast<const int32_t*>(ages);
  auto* ko = static_cast<uint8_t*>(keep_out);
  auto* so = static_cast<float*>(scores_out);
  auto* o = static_cast<int32_t*>(out);
  if (mode == 1)
    shard_hist_kernel<true><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        d, n_mats, n_rows, n_shards, keep, valid, bool_layout, a, scores,
        scores_f64, ko, so, o);
  else
    shard_hist_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        d, n_mats, n_rows, n_shards, keep, valid, bool_layout, a, scores,
        scores_f64, ko, so, o);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trt_digest_gather(const void* table, int n_values,
                                 const void* codes, long long n_rows,
                                 void* out, void* stream) {
  if (n_rows < 0 || (n_rows > 0 && n_values < 1))
    return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const long long total = n_rows * 8;
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  digest_gather_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(table), n_values,
      static_cast<const int32_t*>(codes), n_rows,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
