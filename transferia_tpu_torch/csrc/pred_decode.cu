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
// Bound on an H100: a few integer operations per value against 4-8 bytes
// of traffic per value, so every mode is bound by bytes.  At the shapes
// the transform gives K-B (65,536 values, ~80 KB of words) the bytes take
// ~0.1 us and the real floor is a launch and the memory latency of a few
// dependent steps.
//
// bits, for and unpack are elementwise: one thread per value in a
// grid-stride loop.  delta is a single-pass scan with decoupled look-back
// (Merrill and Garland): a block decodes one tile of 2,048 values (64
// groups of 32, so a tile starts on a word boundary and owns 64*bw whole
// words).  It loads those words coalesced into shared memory, padded one
// word in 32 so that threads reading words bw/8 apart miss each other's
// banks, and each thread unpacks and scans its 4 consecutive values in
// registers, then across the warp with shuffles and across the block.
// The block then publishes its aggregate as one 64-bit status word
// (epoch:31 | inclusive:1 | 32-bit sum), sums its predecessors' words a
// warp at a time back to the first inclusive one, and publishes its
// inclusive prefix.  Tile 0 adds `base`.  Every sum wraps mod 2^32.
//   - Tiles are handed out by an atomic ticket, not by blockIdx, so a
//     block only ever waits on a tile that a running block already holds.
//   - The status words live in a scratch buffer that the wrapper keeps per
//     (device, stream), zeroed once.  Each launch on it has a new epoch,
//     and a status word of an older epoch reads as "not ready", so no
//     launch clears the buffer.  The ticket counter sits in the same
//     buffer and never resets; the wrapper passes its value at the launch
//     (`ticket_base`), since launches on one stream run in order.
//
// K11 is described above `dict_decode_kernel`.

#include <cstdint>
#include <cuda_runtime.h>
#include <utility>

namespace {

enum Mode { kBits = 0, kDelta = 1, kFor = 2, kUnpack = 3 };

constexpr unsigned kFullMask = 0xffffffffu;

// value i of the stream
__device__ __forceinline__ uint32_t unpack(const uint32_t* __restrict__ w,
                                           int n_words, int64_t i, int bw) {
  const uint64_t start = static_cast<uint64_t>(i) * bw;
  const int64_t wi = static_cast<int64_t>(start >> 5);
  const int off = static_cast<int>(start & 31);
  const int64_t last = n_words - 1;
  uint32_t v = w[wi < last ? wi : last] >> off;
  if (off > 0) v |= w[wi + 1 < last ? wi + 1 : last] << (32 - off);
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

// -- K-B delta: single-pass scan with decoupled look-back --------------------

// 512 threads x 4 values: on an H100, over the transform's delta wire at
// 65,536-1,048,576 values, a thread's serial unpack and scan of more values
// cost more than the longer look-back over more, smaller tiles (swept over
// 128-1,024 threads x 4-32 values)
constexpr int kScanThreads = 512;
constexpr int kScanItems = 4;
constexpr int kScanTile = kScanThreads * kScanItems;  // 2,048 values
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanGroups = kScanTile / 32;           // 32-value groups
constexpr int kTileWordsMax = kScanGroups * 32;       // at bw = 32
static_assert(kScanItems % 4 == 0, "values are stored 4 at a time");
constexpr unsigned long long kInclusive = 1ull << 32;
constexpr uint32_t kEpochMax = 0x7fffffffu;
constexpr int kMaxSpins = 1 << 24;  // over a second of polling

// shared slot of tile word j: one pad word per 32
__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long status_word(
    uint32_t epoch, bool inclusive, uint32_t sum) {
  return (static_cast<unsigned long long>(epoch) << 33) |
         (inclusive ? kInclusive : 0ull) | sum;
}

// Warp 0 of tile `tile` (> 0): the sum of every earlier tile, read from
// the status words of this launch's epoch, newest first, 32 at a time,
// back to the first inclusive prefix (tile 0's at the latest).
__device__ uint32_t look_back(const unsigned long long* status, int tile,
                              uint32_t epoch, int lane) {
  uint32_t exclusive = 0;
  for (int newest = tile - 1;; newest -= 32) {
    const int idx = newest - lane;
    unsigned long long s = 0;
    bool ready;
    for (int spins = 0;; ++spins) {
      s = idx >= 0 ? load_status(status + idx) : 0ull;
      ready = idx < 0 || static_cast<uint32_t>(s >> 33) == epoch;
      if (__all_sync(kFullMask, ready)) break;
      // a predecessor that never publishes is a fault: fail, do not hang
      if (spins == kMaxSpins) __trap();
      __nanosleep(64);
    }
    // lanes past tile 0 count as an inclusive prefix of 0
    const unsigned stop =
        __ballot_sync(kFullMask, idx < 0 || (s & kInclusive) != 0);
    uint32_t v = idx >= 0 ? static_cast<uint32_t>(s) : 0u;
    if (stop != 0u && lane > __ffs(stop) - 1) v = 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
    exclusive += v;
    if (stop != 0u) return exclusive;
  }
}

__global__ void __launch_bounds__(kScanThreads)
    decode_delta_kernel(const uint32_t* __restrict__ words, int n_words,
                        int64_t n, int bw, int32_t base,
                        unsigned long long* __restrict__ scratch,
                        unsigned long long ticket_base, uint32_t epoch,
                        int32_t* __restrict__ out) {
  __shared__ uint32_t tile_words[kTileWordsMax + kTileWordsMax / 32];
  __shared__ uint32_t warp_sums[kScanWarps];
  __shared__ uint32_t tile_prefix;
  __shared__ int tile_ticket;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned long long* status = scratch + 1;
  if (tid == 0) {
    tile_ticket = static_cast<int>(atomicAdd(scratch, 1ull) - ticket_base);
  }
  __syncthreads();
  const int tile = tile_ticket;
  if (tile < 0 || tile >= static_cast<int>(gridDim.x)) __trap();
  const int64_t first = static_cast<int64_t>(tile) * kScanTile;

  const int tile_words_n = kScanGroups * bw;
  const int64_t w0 = static_cast<int64_t>(tile) * tile_words_n;
  const int64_t last = n_words - 1;
  for (int j = tid; j < tile_words_n; j += kScanThreads) {
    const int64_t wi = w0 + j;
    tile_words[padded(j)] = __ldg(words + (wi < last ? wi : last));
  }
  __syncthreads();

  const int l0 = tid * kScanItems;
  const uint32_t mask = bw < 32 ? (1u << bw) - 1u : kFullMask;
  uint32_t run[kScanItems];
  uint32_t local = 0;
#pragma unroll
  for (int k = 0; k < kScanItems; ++k) {
    uint32_t d = 0;
    if (first + l0 + k < n) {
      const int bit = (l0 + k) * bw;
      const int wi = bit >> 5;
      const int off = bit & 31;
      uint32_t zz = tile_words[padded(wi)] >> off;
      if (off + bw > 32) zz |= tile_words[padded(wi + 1)] << (32 - off);
      zz &= mask;
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
    uint32_t s = lane < kScanWarps ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 1; o < kScanWarps; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFullMask, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kScanWarps) warp_sums[lane] = s;
    const uint32_t aggregate = __shfl_sync(kFullMask, s, kScanWarps - 1);
    uint32_t exclusive;
    if (tile == 0) {
      exclusive = static_cast<uint32_t>(base);
      if (lane == 0) {
        store_status(status, status_word(epoch, true, exclusive + aggregate));
      }
    } else {
      if (lane == 0) {
        store_status(status + tile, status_word(epoch, false, aggregate));
      }
      exclusive = look_back(status, tile, epoch, lane);
      if (lane == 0) {
        store_status(status + tile,
                     status_word(epoch, true, exclusive + aggregate));
      }
    }
    if (lane == 0) tile_prefix = exclusive;
  }
  __syncthreads();
  const uint32_t prefix =
      tile_prefix + (warp ? warp_sums[warp - 1] : 0u) + (x - local);
  const int64_t i0 = first + l0;
  if (i0 + kScanItems <= n) {
    // kScanItems consecutive values, 16-byte aligned: 16-byte stores
    int4* dst = reinterpret_cast<int4*>(out + i0);
#pragma unroll
    for (int q = 0; q < kScanItems / 4; ++q) {
      dst[q] = make_int4(static_cast<int32_t>(prefix + run[4 * q]),
                         static_cast<int32_t>(prefix + run[4 * q + 1]),
                         static_cast<int32_t>(prefix + run[4 * q + 2]),
                         static_cast<int32_t>(prefix + run[4 * q + 3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < kScanItems; ++k) {
      if (i0 + k < n) out[i0 + k] = static_cast<int32_t>(prefix + run[k]);
    }
  }
}

// -- K11: the dictionary decode ------------------------------------------------
//
// value i = pool[clamp(int32(code_i), 0, k - 1)], code_i unpacked at width
// bw from words ^ (carry & 1) -- jnp.take(mode="clip") on the int32 code,
// so at bw = 32 a code >= 2^31 is negative and takes entry 0.  With a
// carry (decode_dict_loop) the values are not written: each block sums
// its values in uint32 and adds the sum into carry_out with one atomic,
// and block 0 also adds the incoming carry, so carry_out (zeroed) ends as
// carry_in + sum(values) mod 2^32, the reference's fori_loop body.
//
// Bound on an H100: bytes (bw/8 in and 4 out a value, the pool once).
// What holds a gather kernel back is the gather itself: each random
// 4-byte read from a pool in L2 costs a 32-byte sector of its own, so
// 4,194,304 codes over a 512 KB pool move ~134 MB through L2, five times
// the bytes the function needs, and an SM's 256 KB of L1 and shared
// memory holds half that pool at most.  Three designs (a scalar
// grid-stride loop, this one gathering from L2, torch.index_select) all
// took ~0.035 ms there on an H100: that is the L2's rate for random
// sectors, not the kernel's.  The design:
//   - The kernel is templated on bw.  A thread decodes 8 consecutive values
//     (an octet: 8*bw bits that start at bit 0, 8, 16 or 24 of a word),
//     loads the octet's words with __ldg (neighbouring threads read
//     neighbouring words), funnel-shifts them to start at bit 0, and then
//     every word index and shift of the 8 values is a constant, as in the
//     reference's static 32-lane pattern.  Word reads clamp to the stream.
//   - It starts all 8 gathers before any store and writes the values as
//     two 16-byte stores.
//   - Blocks are persistent and stage the pool's first `staged` entries in
//     shared memory once; a code below that reads shared memory, the rest
//     read the pool through the read-only path.  The wrapper stages a
//     40,960-entry prefix, or the whole pool where it is smaller: 160 KB
//     keeps one block an SM, so the prefix is not copied twice into one
//     SM and L1 keeps ~90 KB for the rest.  On the decode path that
//     serves 31 % of the gathers from shared memory (prefixes of 16,384
//     to 57,344 entries were timed there; a cluster of 8 blocks holding
//     the whole pool in distributed shared memory was slower than L2
//     alone).

constexpr int kDictThreads = 512;
constexpr int kDictItems = 8;

template <int BW>
__device__ __forceinline__ void unpack_octet(const uint32_t* __restrict__ w,
                                             int n_words, int64_t u,
                                             uint32_t flip,
                                             uint32_t v[kDictItems]) {
  constexpr int kAligned = (kDictItems * BW + 31) / 32;
  // an octet starts at bit (u * BW % 4) * 8 of its first word
  constexpr bool kWordAligned = BW % 4 == 0;
  constexpr int kLoads = kWordAligned ? kAligned : kAligned + 1;
  const int64_t w0 = (u * BW) >> 2;
  const int64_t last = n_words - 1;
  uint32_t raw[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    raw[j] = __ldg(w + (w0 + j < last ? w0 + j : last)) ^ flip;
  }
  uint32_t a[kAligned];
  if constexpr (kWordAligned) {
#pragma unroll
    for (int j = 0; j < kAligned; ++j) a[j] = raw[j];
  } else {
    const uint32_t off = static_cast<uint32_t>((u * BW) & 3) * 8;
#pragma unroll
    for (int j = 0; j < kAligned; ++j) {
      a[j] = __funnelshift_r(raw[j], raw[j + 1], off);
    }
  }
#pragma unroll
  for (int k = 0; k < kDictItems; ++k) {
    const int p = k * BW;
    const int wi = p >> 5;
    const int sh = p & 31;
    uint32_t x = a[wi] >> sh;
    if (sh != 0 && sh + BW > 32) x |= a[wi + 1] << (32 - sh);
    if constexpr (BW < 32) x &= (1u << BW) - 1u;
    v[k] = x;
  }
}

template <int BW>
__global__ void __launch_bounds__(kDictThreads)
    dict_decode_kernel(const uint32_t* __restrict__ words, int n_words,
                       int64_t n, const int32_t* __restrict__ pool, int k,
                       int staged, const uint32_t* __restrict__ carry_in,
                       uint32_t* __restrict__ carry_out,
                       int32_t* __restrict__ out) {
  extern __shared__ int32_t pool_smem[];
  __shared__ uint32_t warp_sums[kDictThreads / 32];
  const uint32_t flip = carry_in ? (*carry_in & 1u) : 0u;
  const int tid = threadIdx.x;
  for (int j = tid; j < staged; j += kDictThreads) {
    pool_smem[j] = __ldg(pool + j);
  }
  if (staged > 0) __syncthreads();
  const int64_t octets = (n + kDictItems - 1) / kDictItems;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kDictThreads;
  uint32_t sum = 0;
  for (int64_t u = static_cast<int64_t>(blockIdx.x) * kDictThreads + tid;
       u < octets; u += stride) {
    uint32_t v[kDictItems];
    unpack_octet<BW>(words, n_words, u, flip, v);
    int32_t val[kDictItems];
#pragma unroll
    for (int j = 0; j < kDictItems; ++j) {
      const int32_t code = static_cast<int32_t>(v[j]);
      const int c = code < 0 ? 0 : (code >= k ? k - 1 : code);
      val[j] = c < staged ? pool_smem[c] : __ldg(pool + c);
    }
    const int64_t i0 = u * kDictItems;
    if (carry_out) {
#pragma unroll
      for (int j = 0; j < kDictItems; ++j) {
        if (i0 + j < n) sum += static_cast<uint32_t>(val[j]);
      }
    } else if (i0 + kDictItems <= n) {
      int4* dst = reinterpret_cast<int4*>(out + i0);
      dst[0] = make_int4(val[0], val[1], val[2], val[3]);
      dst[1] = make_int4(val[4], val[5], val[6], val[7]);
    } else {
#pragma unroll
      for (int j = 0; j < kDictItems; ++j) {
        if (i0 + j < n) out[i0 + j] = val[j];
      }
    }
  }
  if (!carry_out) return;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    sum = lane < kDictThreads / 32 ? warp_sums[lane] : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(kFullMask, sum, o);
    if (lane == 0) {
      if (blockIdx.x == 0 && carry_in) sum += *carry_in;
      atomicAdd(carry_out, sum);
    }
  }
}

using DictKernel = void (*)(const uint32_t*, int, int64_t, const int32_t*,
                            int, int, const uint32_t*, uint32_t*, int32_t*);

template <int... BWs>
DictKernel dict_kernel_for(int bw, std::integer_sequence<int, BWs...>) {
  static const DictKernel table[] = {dict_decode_kernel<BWs + 1>...};
  return table[bw - 1];
}

}  // namespace

extern "C" int trt_pred_decode(int mode, const void* words, int n_words,
                               long long n, int bw, int base,
                               const void* mins, int frame, void* scratch,
                               int scratch_tiles,
                               unsigned long long ticket_base,
                               unsigned int epoch, void* out, void* stream) {
  if (n <= 0 || n_words <= 0 || bw < 1 || bw > 32 ||
      (mode == kBits && bw != 1) || (mode == kFor && frame <= 0) ||
      mode < kBits || mode > kUnpack) {
    return cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* w = static_cast<const uint32_t*>(words);
  if (mode == kDelta) {
    const long long tiles = (n + kScanTile - 1) / kScanTile;
    if (scratch == nullptr || tiles > scratch_tiles || epoch == 0 ||
        epoch > kEpochMax) {
      return cudaErrorInvalidValue;
    }
    // a stale error would make this launch look refused after it ran, and
    // the wrapper's ticket count would fall behind the counter
    const cudaError_t stale = cudaGetLastError();
    if (stale != cudaSuccess) return static_cast<int>(stale);
    decode_delta_kernel<<<static_cast<int>(tiles), kScanThreads, 0, s>>>(
        w, n_words, n, bw, base, static_cast<unsigned long long*>(scratch),
        ticket_base, epoch, static_cast<int32_t*>(out));
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

// staged: how many of the pool's first entries each block keeps in shared
// memory (0 gathers everything from L2).
extern "C" int trt_dict_decode(const void* words, int n_words, long long n,
                               int bw, const void* pool, int k, int staged,
                               const void* carry_in, void* carry_out,
                               void* out, void* stream) {
  if (n <= 0 || n_words <= 0 || bw < 1 || bw > 32 || k <= 0 ||
      staged < 0 || staged > k ||
      (carry_out == nullptr) == (out == nullptr)) {
    return cudaErrorInvalidValue;
  }
  int device = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(staged) * sizeof(int32_t);
  if (smem + (kDictThreads / 32) * sizeof(uint32_t) >
      static_cast<size_t>(smem_max)) {
    return cudaErrorInvalidValue;
  }
  const DictKernel kernel =
      dict_kernel_for(bw, std::make_integer_sequence<int, 32>{});
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // a persistent grid: as many blocks as fit on the card at once
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kernel), kDictThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const long long octets = (n + kDictItems - 1) / kDictItems;
  const long long blocks = (octets + kDictThreads - 1) / kDictThreads;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(blocks < resident ? blocks : resident);
  kernel<<<grid, kDictThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words, static_cast<int64_t>(n),
      static_cast<const int32_t*>(pool), k, staged,
      static_cast<const uint32_t*>(carry_in),
      static_cast<uint32_t*>(carry_out), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
