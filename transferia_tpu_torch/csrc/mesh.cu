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
// Bound on an H100: the launch and a few dependent L2 round trips at the
// paths' shapes (65,536 rows fused, 262,144 step), then bytes.  Each kept
// row reads word 0 of its digest row(s), one 32-byte sector each (the
// rows are 32 bytes apart, the layout K-A writes); every row reads its
// keep bits (or ages and scores, and writes keep and scores_f32).
//
// Design:
//   - One launch a call, no fill: each launch zeroes the output of the
//     next launch on its stream.  Blocks add their bins into `out` with
//     one global atomic a bin, and `out` was zeroed by the previous launch
//     on the stream (the wrapper keeps that buffer per (device, stream),
//     and makes the first one with zeros); block 0 also zeroes `next`, a
//     buffer the wrapper allocates empty and hands to the following
//     launch.  Launches on one stream run in order, and two streams never
//     share a buffer.  (A ticket taken after a __threadfence(), the last
//     block moving a zero-at-rest accumulator into `out`, was measured
//     slower than the fill it replaced: three dependent L2 round trips at
//     the end of every launch.)
//   - A warp takes 32 rows (a "step"), kUnroll steps at once so that their
//     loads are in flight together.  Packed masks: lanes 0..kUnroll-1 load
//     the steps' keep words and the next kUnroll lanes their validity
//     words, and shuffles hand them to the warp: no lane loads a word
//     another lane holds.  Bool masks and step mode: the row's own loads,
//     and a ballot makes the step's keep word.
//   - n_shards <= 32 (the ballot route): the warp ballots each bit of the
//     rows' bins (5 ballots at most); lane b ANDs them with the keep word
//     into the mask of the kept rows of bin b, and keeps its popcount in a
//     register.  A warp ends with one shared add per bin: no contended
//     per-row atomics.  Above 32 shards, up to kMaxShards, each kept row
//     adds into a shared histogram sized n_shards + 1 (dynamic shared
//     memory).  Both routes count exactly, in any order.
//   - The grid is sized to the card: kUnroll steps a warp, at most
//     kBlocksPerSm blocks an SM, each walking its steps in a grid stride.
//   - Step mode keeps its coalesced per-row writes of keep_out and
//     scores_out and casts float64 scores to float32 before the finite
//     test.
//
// trt_digest_gather replaces transferia_tpu/parallel/fusedmesh.py lines
// 170-173, `jnp.take(dg, cd, axis=0, mode="clip")`: out[r, w] =
// table[clip(codes[r], 0, n_values - 1), w] over an (n_values, 8) digest
// table.  Out-of-range codes clip, as jnp's "clip" mode does (it does not
// raise).  Bound: bytes (4 B of code read and 32 B written per row; the
// table, a pool's digests, read once and kept in L2).  Design: a warp
// takes kGatherGroups groups of 32 rows; each lane loads one row's code of
// a group (each code once, coalesced), and two lanes move each row's 32
// bytes as two 16-byte loads of the table (__ldg) and two 16-byte stores,
// the code handed over by a shuffle, so a warp's store covers 16
// neighbouring rows (512 bytes).  Every group's loads are issued before
// any store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 4096;  // the wrapper's limit, too
constexpr int kBallotShards = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;        // steps of 32 rows a warp loads at once
constexpr int kBlocksPerSm = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGatherGroups = 2;  // 32-row groups a warp gathers

struct HistArgs {
  const int32_t* digests;
  const void* keep;
  const void* valid;
  const int32_t* ages;
  const void* scores;
  uint8_t* keep_out;
  float* scores_out;
  int32_t* out;       // zeros, added into
  int32_t* next;      // zeroed here for the next launch (may be null)
  int next_words;
  long long n_rows;
  int n_mats;
  int n_shards;
  int bin_bits;       // ballot route: bits of n_shards - 1
  int bool_layout;
  int scores_f64;
};

// the keep word of step s (bit j = row 32 s + j), this lane's own row r
template <bool kStep>
__device__ __forceinline__ uint32_t row_keep(const HistArgs& a, long long s,
                                             long long r) {
  bool k = false;
  if (r < a.n_rows) {
    if (kStep) {
      const float sc =
          a.scores_f64
              ? __double2float_rn(__ldg(static_cast<const double*>(a.scores) +
                                        r))
              : __ldg(static_cast<const float*>(a.scores) + r);
      // finite: the exponent is not all ones (not inf, not NaN)
      k = __ldg(a.ages + r) >= 0 &&
          (__float_as_uint(sc) & 0x7f800000u) != 0x7f800000u;
      if (a.keep_out != nullptr) a.keep_out[r] = k ? 1 : 0;
      if (a.scores_out != nullptr) a.scores_out[r] = sc;
    } else {
      const auto* v = static_cast<const uint8_t*>(a.valid);
      const auto* p = static_cast<const uint8_t*>(a.keep);
      k = __ldg(v + r) != 0 && (p == nullptr || __ldg(p + r) != 0);
    }
  }
  return __ballot_sync(kFull, k);
}

template <bool kStep, bool kBallot>
__global__ void __launch_bounds__(kThreads)
    shard_hist_kernel(const __grid_constant__ HistArgs a) {
  extern __shared__ int32_t s_hist[];  // n_shards + 1
  const int ns = a.n_shards;
  const int lane = threadIdx.x & 31;
  if (blockIdx.x == 0 && a.next != nullptr)
    for (int i = threadIdx.x; i < a.next_words; i += kThreads) a.next[i] = 0;
  for (int i = threadIdx.x; i <= ns; i += kThreads) s_hist[i] = 0;
  __syncthreads();
  const long long n_steps = (a.n_rows + 31) >> 5;
  const long long warp =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps * kUnroll;
  int mine = 0;  // ballot route: lane b's count of bin b
  int kept = 0;  // the same in every lane
  for (long long s0 = warp * kUnroll; s0 < n_steps; s0 += stride) {
    uint32_t kw[kUnroll];
    if (kStep || a.bool_layout) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        kw[u] = row_keep<kStep>(a, s0 + u, (s0 + u) * 32 + lane);
    } else {
      // lanes 0..kUnroll-1 load keep words, the next kUnroll validity
      const long long w = s0 + (lane % kUnroll);
      uint32_t word = 0u;
      if (lane < 2 * kUnroll && w < n_steps) {
        const void* src = lane < kUnroll ? a.keep : a.valid;
        word = src == nullptr ? kFull
                              : __ldg(static_cast<const uint32_t*>(src) + w);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t k = __shfl_sync(kFull, word, u);
        const uint32_t v = __shfl_sync(kFull, word, kUnroll + u);
        const long long left = a.n_rows - (s0 + u) * 32;  // rows in step
        kw[u] = left <= 0 ? 0u
                          : (k & v & (left >= 32 ? kFull
                                                 : (1u << left) - 1u));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) kept += __popc(kw[u]);
#pragma unroll 1
    for (int c = 0; c < a.n_mats; ++c) {
      uint32_t bin[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        bin[u] = 0u;
        if ((kw[u] >> lane) & 1u) {
          const long long r = (s0 + u) * 32 + lane;
          bin[u] = static_cast<uint32_t>(__ldg(
                       a.digests +
                       (static_cast<long long>(c) * a.n_rows + r) * 8)) %
                   static_cast<uint32_t>(ns);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (kBallot) {
          uint32_t m = kw[u];
#pragma unroll 1
          for (int j = 0; j < a.bin_bits; ++j) {
            const uint32_t bits = __ballot_sync(kFull, (bin[u] >> j) & 1u);
            m &= ((lane >> j) & 1) ? bits : ~bits;
          }
          mine += __popc(m);
        } else if ((kw[u] >> lane) & 1u) {
          atomicAdd(&s_hist[bin[u]], 1);
        }
      }
    }
  }
  if (kBallot && lane < ns && mine != 0) atomicAdd(&s_hist[lane], mine);
  if (lane == 0 && kept != 0) atomicAdd(&s_hist[ns], kept);
  __syncthreads();
  for (int i = threadIdx.x; i <= ns; i += kThreads)
    if (s_hist[i] != 0) atomicAdd(&a.out[i], s_hist[i]);
}

__global__ void __launch_bounds__(kThreads)
    digest_gather_kernel(const int4* __restrict__ table, int n_values,
                         const int32_t* __restrict__ codes,
                         long long n_rows, int4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const long long base = warp * 32 * kGatherGroups;
  int code[kGatherGroups];
#pragma unroll
  for (int g = 0; g < kGatherGroups; ++g) {
    const long long r = base + g * 32 + lane;
    const int c = r < n_rows ? __ldg(codes + r) : 0;
    code[g] = c < 0 ? 0 : (c >= n_values ? n_values - 1 : c);
  }
  // lane pair (2i, 2i+1) moves row i of the half-group h: 16 bytes each
  int4 v[kGatherGroups][2];
#pragma unroll
  for (int g = 0; g < kGatherGroups; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = __shfl_sync(kFull, code[g], h * 16 + (lane >> 1));
      v[g][h] = __ldg(table + 2 * static_cast<long long>(c) + (lane & 1));
    }
  }
#pragma unroll
  for (int g = 0; g < kGatherGroups; ++g) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = base + g * 32 + h * 16 + (lane >> 1);
      if (r < n_rows) out[2 * r + (lane & 1)] = v[g][h];
    }
  }
}

template <bool kStep>
void launch_hist(const HistArgs& a, int grid, size_t smem, cudaStream_t s) {
  if (a.n_shards <= kBallotShards)
    shard_hist_kernel<kStep, true><<<grid, kThreads, smem, s>>>(a);
  else
    shard_hist_kernel<kStep, false><<<grid, kThreads, smem, s>>>(a);
}

}  // namespace

// mode 0: fused (keep/valid/bool_layout); mode 1: step (ages/scores,
// writes keep_out/scores_out where not null).  `out` (n_shards + 1 ints)
// must hold zeros: the launch adds into it; it zeroes `next_words` ints
// at `next` (null: none) for the next launch on the stream.  One launch
// also for n_rows == 0.
extern "C" int trt_shard_hist(int mode, const void* digests, int n_mats,
                              long long n_rows, int n_shards,
                              const void* keep, const void* valid,
                              int bool_layout, const void* ages,
                              const void* scores, int scores_f64,
                              void* keep_out, void* scores_out, void* out,
                              void* next, int next_words, void* stream) {
  if (n_rows < 0 || n_mats < 1 || n_shards < 1 || n_shards > kMaxShards ||
      out == nullptr || next_words < 0 ||
      (mode == 0 && (valid == nullptr || n_mats != 1)) ||
      (mode == 1 && (ages == nullptr || scores == nullptr)) ||
      (mode != 0 && mode != 1))
    return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  HistArgs a;
  a.digests = static_cast<const int32_t*>(digests);
  a.keep = keep;
  a.valid = valid;
  a.ages = static_cast<const int32_t*>(ages);
  a.scores = scores;
  a.keep_out = static_cast<uint8_t*>(keep_out);
  a.scores_out = static_cast<float*>(scores_out);
  a.out = static_cast<int32_t*>(out);
  a.next = static_cast<int32_t*>(next);
  a.next_words = next_words;
  a.n_rows = n_rows;
  a.n_mats = n_mats;
  a.n_shards = n_shards;
  a.bin_bits = 0;
  while ((1 << a.bin_bits) < n_shards) ++a.bin_bits;
  a.bool_layout = bool_layout;
  a.scores_f64 = scores_f64;
  const long long per_block = 32LL * kUnroll * kWarps;
  long long grid = (n_rows + per_block - 1) / per_block;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (grid > cap) grid = cap;
  if (grid < 1) grid = 1;
  const size_t smem = sizeof(int32_t) * (n_shards + 1);
  const auto s = static_cast<cudaStream_t>(stream);
  // a stale error would make this launch look refused after it had added
  // into `out` and zeroed `next`
  const cudaError_t stale = cudaGetLastError();
  if (stale != cudaSuccess) return static_cast<int>(stale);
  if (mode == 1)
    launch_hist<true>(a, static_cast<int>(grid), smem, s);
  else
    launch_hist<false>(a, static_cast<int>(grid), smem, s);
  return static_cast<int>(cudaGetLastError());
}

// table 16-byte aligned (the wrapper checks it)
extern "C" int trt_digest_gather(const void* table, int n_values,
                                 const void* codes, long long n_rows,
                                 void* out, void* stream) {
  if (n_rows < 0 || (n_rows > 0 && n_values < 1))
    return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const long long per_block = 32LL * kGatherGroups * kWarps;
  const long long grid = (n_rows + per_block - 1) / per_block;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  digest_gather_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), n_values,
      static_cast<const int32_t*>(codes), n_rows, static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
