// K12: ragged var-width rows -> padded HMAC message blocks, on the card.
//
// Replaces the JAX device program transferia_tpu/ops/raggedpack.py
// `_pack_xla` (lines 41-63), which the reference reaches through
// `pack_blocks_device` (line 66) from `FusedMaskFilterProgram._pack_inputs`
// (transferia_tpu/ops/fused.py:326-345) when TRANSFERIA_TPU_PALLAS_PACK=1.
//
// Input: the column's flat bytes `data` (n_data bytes, no slack) and its
// (n_rows+1,) int32 offsets.  Output: blocks (bucket, width) uint8 with
// width = max_blocks*64, and n_blocks (bucket,) int32.  For a row r <
// n_rows with len = off[r+1]-off[r] and nb = (len+72)/64:
//   out[r, c] = data[off[r]+c]        for c < len
//   out[r, len] = 0x80
//   out[r, nb*64-8 .. nb*64-1] = big-endian bit length (len+64)*8 (the
//       +64 is the virtual HMAC ipad block K-A compresses separately);
//       bytes 0-3 of that field are 0, as the reference's 32-bit shift
//       clamp leaves them
//   every other byte 0; n_blocks[r] = nb.
// Rows n_rows <= r < bucket are all zero with n_blocks = 0, so K-A keeps
// their initial state and the output is deterministic.  The layout is
// the host pack's, prepare_padded_blocks(prefix_len=64), byte for byte.
//
// Design: one thread per 16 output bytes, so a warp writes 512
// neighbouring bytes with uint4 stores.  A thread reads its row's input
// bytes one at a time, only below the row's length and inside the
// buffer, so no slack past the last row is needed and no input can make
// it read outside `data`; the terminator and the length field are laid
// in arithmetically.  A row longer than the bucket's width is cut at the
// width (the wrapper raises before that happens), never written past it.
//
// Bound on an H100: bytes.  It reads off[n] data bytes and 4*(n+1) of
// offsets and writes bucket*width + 4*bucket; the arithmetic per byte is
// a handful of compares.  One 131,072-row ClickBench URL batch (mb = 1)
// writes 8.9 MB: about 2.7 us at 3.35 TB/s.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void ragged_pack_kernel(const uint8_t* __restrict__ data,
                                   long long n_data,
                                   const int32_t* __restrict__ offsets,
                                   int n_rows, int bucket, int width,
                                   uint8_t* __restrict__ blocks,
                                   int32_t* __restrict__ n_blocks) {
  const int vecs = width / 16;  // 16-byte pieces per row
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<long long>(bucket) * vecs) return;
  const int row = static_cast<int>(t / vecs);
  const int c0 = static_cast<int>(t % vecs) * 16;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  int nb = 0;
  if (row < n_rows) {
    const long long start = offsets[row];
    const int len = offsets[row + 1] - offsets[row];
    nb = (len + 72) / 64;
    const int pos = nb * 64 - 8;  // first byte of the length field
    const uint32_t bits = static_cast<uint32_t>(len + 64) * 8u;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int c = c0 + k;
      uint32_t byte = 0u;
      if (c < len) {
        const long long src = start + c;
        if (src >= 0 && src < n_data) byte = data[src];
      } else if (c == len) {
        byte = 0x80u;
      } else if (c >= pos + 4 && c < pos + 8) {
        byte = (bits >> (8 * (pos + 7 - c))) & 0xFFu;
      }
      w[k >> 2] |= byte << (8 * (k & 3));
    }
  }
  reinterpret_cast<uint4*>(blocks + static_cast<size_t>(row) * width +
                           c0)[0] = make_uint4(w[0], w[1], w[2], w[3]);
  if (c0 == 0) n_blocks[row] = nb;
}

}  // namespace

extern "C" int trt_ragged_pack(const void* data, long long n_data,
                               const void* offsets, int n_rows, int bucket,
                               int max_blocks, void* blocks, void* n_blocks,
                               void* stream) {
  if (bucket <= 0 || n_rows < 0 || n_rows > bucket || max_blocks <= 0 ||
      n_data < 0)
    return cudaErrorInvalidValue;
  const int width = max_blocks * 64;
  constexpr int kThreads = 256;
  const long long total = static_cast<long long>(bucket) * (width / 16);
  const long long grid = (total + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  ragged_pack_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), n_data,
      static_cast<const int32_t*>(offsets), n_rows, bucket, width,
      static_cast<uint8_t*>(blocks), static_cast<int32_t*>(n_blocks));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
