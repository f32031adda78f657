// K-C: Kleene three-valued row predicate, with the keep-mask bit pack.
//
// Replaces the JAX device programs transferia_tpu/predicate/device.py
// `compile_mask_jnp` / `_eval3_jnp` / `_cmp_jnp` (lines 113, 131, 191) and
// transferia_tpu/ops/decode.py `pack_mask_words` (line 114), which the
// fused program (transferia_tpu/ops/fused.py:217-219) applies to its keep
// mask.
//
// The predicate AST is lowered on the host (predicate/device.py
// PredProgram) to a postfix program of 16-byte records: n_instr
// instructions {word, y, z, w}, then n_lits IN literals {int64 low word,
// high word, float32 bits, is_float}.  The program lives on the card
// (uploaded once per program and device) and the kernel takes its
// pointer, so a program has no size limit.  An instruction's word holds
// its op (bits 0-2), a fold (bits 3-4), flags (bits 5-7: negate, a NULL
// literal, a float literal), a comparison mask (bits 8-11) and the column
// slot (bits 12-31).  Instructions:
//   TRUE                   (T, U) = (1, 0)
//   CMP  slot mask lit     T = valid & (col ~ lit), U = !valid; the
//                          literal inline: y, z its int64 words, w its
//                          float32 bits
//   CMP_NULL               col op NULL: always UNKNOWN
//   ISNULL slot negate     T = valid == negate, U = false
//   IN   slot first count  SQL IN over the literals y .. y + z - 1
//                          (flags: NOT, a NULL literal), scanned in order
//   AND / OR               binary Kleene fold of the top two entries
//   NOT                    T = !T & !U, U kept
// A leaf (TRUE, CMP, CMP_NULL, ISNULL, IN) pushes its pair, or with a fold
// (AND or OR) combines it into the top entry at once: `a AND b AND c` is
// three leaves, two of them folded, and touches no stack.  A comparison's
// `mask` holds the result for each outcome of comparing the column value
// x with the literal y: bit 0 x < y, bit 1 x == y, bit 2 x > y, bit 3
// unordered (a NaN: only != holds).  So `=` is 0b0010 and `!=` 0b1101,
// and no compare operator is decoded per row.  The top entry lives in
// registers, the ones below it in two 64-bit registers of bits (TRUE,
// UNKNOWN); the lowering emits the child with the larger stack need
// first (Sethi-Ullman order), which keeps the depth at most log2(leaves)
// + 1.
//
// Comparisons follow jnp's weak-type promotion, as the reference traced
// them: an integer column (bool, int8/16/32, uint8/16, date32) against an
// integer or bool literal compares in integer; a float32 column, or any
// float literal, compares in float32.  Float compares are IEEE (the build
// uses no fast-math).
//
// Output: the TRUE mask (UNKNOWN rows do not match).  With `pack` set it
// is packed with __ballot_sync into little-endian uint32 words, bit j of
// word k = row 32k+j; n must then be a multiple of 32.
//
// Bound on an H100: a few bytes per row per referenced column read once,
// one bit (packed) or byte written, and a compare a literal and a fold a
// connective per row.  At the main path's bucket the time goes to the
// launch, the parameters' and the columns' round trips to memory, then
// the interpreter's instructions (chip_smoke.py counts them from the
// SASS).
//
// Design:
//   - Column descriptors by value (__grid_constant__) up to
//     kByValueCols columns; wider predicates point at a descriptor array
//     on the card, which the wrapper copies there with the launch.
//   - One row a thread, so a warp's loads and stores are coalesced and
//     one ballot packs a word.  At the main path's bucket the kernel
//     waits on memory and on the interpreter's dependent steps, and
//     fewer warps hide less of either (2 and 4 rows a thread were slower
//     on every program timed, PERF.md).
//   - A prologue issues every load before any evaluation: for each
//     referenced column (kGroup at a time) the value and validity byte of
//     the thread's row, and the block's first program records.
//     The values land in a shared-memory tile [slot][row] that only their
//     own thread reads, converted to 32 bits (a float32 keeps its bits),
//     and the program in shared memory; one barrier, then the
//     interpreter reads shared memory only.  A predicate over so many
//     columns that the tile does not fit in a block's 48 KB even at 32
//     threads (305 columns) loads each value where an
//     instruction uses it (kTile false); a program too large for what is
//     left reads its records from device memory through the cache (the
//     same generic pointer).
//   - A comparison carries its literal, so it costs one shared load of
//     the program and one of the tile.

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kByValueCols = 16;  // predicate/device.py BY_VALUE_COLS
constexpr int kMaxDepth = 64;     // bits of the stacks
constexpr int kThreads = 256;
constexpr int kGroup = 4;         // columns whose loads are issued together
constexpr size_t kSmemBudget = 48 * 1024;  // a block's default limit
constexpr unsigned kFull = 0xffffffffu;

enum Op {
  kOpTrue = 0,
  kOpCmp = 1,
  kOpCmpNull = 2,
  kOpIsNull = 3,
  kOpIn = 4,
  kOpAnd = 5,
  kOpOr = 6,
  kOpNot = 7,
};
enum Fold { kPush = 0, kFoldAnd = 1, kFoldOr = 2 };
enum Flags { kNegate = 1 << 5, kHasNull = 1 << 6, kLitFloat = 1 << 7 };
enum DType {
  kBool = 0,
  kI8 = 1,
  kU8 = 2,
  kI16 = 3,
  kU16 = 4,
  kI32 = 5,
  kF32 = 6,
};
constexpr int kEqMask = 0b0010;

struct ColDesc {
  const void* data;
  const uint8_t* valid;  // nullptr: every row valid
  int32_t dtype;
  int32_t pad;
};

struct PredArgs {
  ColDesc cols[kByValueCols];  // by value when n_cols <= kByValueCols
  const ColDesc* dev_cols;     // on the card when more
  const int4* prog;            // n_instr instructions, then n_lits literals
  void* out;
  int64_t n;
  int32_t n_instr;
  int32_t n_lits;
  int32_t n_cols;
  int32_t pack;
  int32_t depth;
  int32_t pad;
};

static_assert(sizeof(ColDesc) == 24, "predicate/device.py ColDesc");
static_assert(sizeof(PredArgs) == 440, "predicate/device.py PredArgs");
static_assert(offsetof(PredArgs, dev_cols) == 384, "PredArgs layout");
static_assert(offsetof(PredArgs, n) == 408, "PredArgs layout");
static_assert(offsetof(PredArgs, depth) == 432, "PredArgs layout");

// column s's descriptor: from the parameters (the constant bank) or from
// device memory
template <bool kByValue>
__device__ __forceinline__ ColDesc col_desc(const PredArgs& a, int s) {
  if constexpr (kByValue) return a.cols[s];
  return a.dev_cols[s];
}

// a column value widened to 32 bits (a float32 keeps its bits)
__device__ __forceinline__ int32_t load_value(const ColDesc& d, int64_t row) {
  switch (d.dtype) {
    case kBool:
    case kU8:
      return __ldg(static_cast<const uint8_t*>(d.data) + row);
    case kI8:
      return __ldg(static_cast<const signed char*>(d.data) + row);
    case kI16:
      return __ldg(static_cast<const int16_t*>(d.data) + row);
    case kU16:
      return __ldg(static_cast<const uint16_t*>(d.data) + row);
    default:
      return __ldg(static_cast<const int32_t*>(d.data) + row);
  }
}

// a truth value, 0 or 1 (a 32-bit register: no byte packing of bools)
using Bit = uint32_t;

__device__ __forceinline__ Bit compare(int32_t v, bool col_f32, bool lit_f32,
                                       int64_t ilit, float flit, int mask) {
  int outcome;
  if (col_f32 || lit_f32) {
    const float x = col_f32 ? __int_as_float(v) : static_cast<float>(v);
    outcome = x < flit ? 0 : (x == flit ? 1 : (x > flit ? 2 : 3));
  } else {
    outcome = v < ilit ? 0 : (v == ilit ? 1 : 2);
  }
  return (mask >> outcome) & 1;
}

__device__ __forceinline__ int64_t int_literal(int lo, int hi) {
  return static_cast<int64_t>(
      (static_cast<uint64_t>(static_cast<uint32_t>(hi)) << 32) |
      static_cast<uint32_t>(lo));
}

// (t, u) = (t, u) AND / OR (t2, u2), Kleene: (1, 0) TRUE, (0, 1)
// UNKNOWN, (0, 0) FALSE; a side that is not FALSE has t | u set
__device__ __forceinline__ void kleene(int fold, Bit& t, Bit& u, Bit t2,
                                       Bit u2) {
  const Bit nf1 = t | u, nf2 = t2 | u2;
  if (fold == kFoldAnd) {
    t &= t2;
    u = nf1 & nf2 & (t ^ 1u);
  } else {
    t |= t2;
    u = (nf1 | nf2) & (t ^ 1u);
  }
}

// where the thread's value comes from: the shared tile, or device memory
template <bool kTile, bool kByValue>
struct Row {
  const PredArgs& a;
  const int32_t* val;     // tile: [slot][blockDim]
  const uint8_t* ok;
  const uint8_t* is_f32;  // tile: per slot
  int64_t row;

  __device__ __forceinline__ bool col_f32(int slot) const {
    if constexpr (kTile) return is_f32[slot] != 0;
    return col_desc<kByValue>(a, slot).dtype == kF32;
  }

  __device__ __forceinline__ void fetch(int slot, int32_t& v,
                                        Bit& valid) const {
    if constexpr (kTile) {
      const int i = slot * blockDim.x + threadIdx.x;
      v = val[i];
      valid = ok[i];
    } else {
      const ColDesc d = col_desc<kByValue>(a, slot);
      v = 0;
      valid = 0;
      if (row < a.n) {
        v = load_value(d, row);
        valid = d.valid == nullptr ? 1u : __ldg(d.valid + row);
      }
    }
  }
};

// a leaf's (TRUE, UNKNOWN) pair for the thread's row (validity ANDed in
// without a branch: a row's NULL must not make its warp diverge)
template <bool kTile, bool kByValue>
__device__ __forceinline__ void leaf(const Row<kTile, kByValue>& row,
                                     int4 ins, const int4* lits, int op,
                                     Bit& t, Bit& u) {
  const int slot = static_cast<int>(static_cast<uint32_t>(ins.x) >> 12);
  if (op == kOpCmp) {
    int32_t v;
    Bit valid;
    row.fetch(slot, v, valid);
    t = valid & compare(v, row.col_f32(slot), ins.x & kLitFloat,
                        int_literal(ins.y, ins.z), __int_as_float(ins.w),
                        (ins.x >> 8) & 15);
    u = valid ^ 1u;
  } else if (op == kOpIn) {
    int32_t v;
    Bit valid, m = 0;
    row.fetch(slot, v, valid);
    const bool col_f32 = row.col_f32(slot);
    const int4* list = lits + ins.y;
    // no early exit: a row's match must not make its warp diverge
#pragma unroll 4
    for (int j = 0; j < ins.z; ++j) {
      const int4 lit = list[j];
      m |= compare(v, col_f32, lit.w, int_literal(lit.x, lit.y),
                   __int_as_float(lit.z), kEqMask);
    }
    Bit tt = m & valid;
    Bit ff = (m ^ 1u) & valid & ((ins.x & kHasNull) ? 0u : 1u);
    if (ins.x & kNegate) {
      const Bit tmp = tt;
      tt = ff;
      ff = tmp;
    }
    t = tt;
    u = (tt | ff) ^ 1u;
  } else if (op == kOpIsNull) {
    int32_t v;
    Bit valid;
    row.fetch(slot, v, valid);
    t = valid ^ ((ins.x & kNegate) ? 0u : 1u);
    u = 0;
  } else {
    t = op == kOpTrue;
    u = op == kOpCmpNull;
  }
}

template <bool kTile, bool kByValue>
__global__ void __launch_bounds__(kThreads)
    pred3vl_mask_kernel(const __grid_constant__ PredArgs a,
                        int prog_in_smem) {
  extern __shared__ int4 smem[];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int n_cols = a.n_cols;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * T + tid;
  const int n_prog = prog_in_smem ? a.n_instr + a.n_lits : 0;
  auto* s_val = reinterpret_cast<int32_t*>(smem + n_prog);
  auto* s_ok = reinterpret_cast<uint8_t*>(s_val + (kTile ? n_cols * T : 0));
  uint8_t* s_f32 = s_ok + (kTile ? n_cols * T : 0);

  // prologue: the first program records and every column value in flight
  // before any of them is stored
  int4 first = make_int4(0, 0, 0, 0);
  if (tid < n_prog) first = __ldg(a.prog + tid);
  if constexpr (kTile) {
    for (int s0 = 0; s0 < n_cols; s0 += kGroup) {
      int32_t v[kGroup];
      uint8_t ok[kGroup];
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        v[j] = 0;
        ok[j] = 0;
        if (s0 + j < n_cols) {
          const ColDesc d = col_desc<kByValue>(a, s0 + j);
          if (tid == 0) s_f32[s0 + j] = d.dtype == kF32;
          if (row < a.n) {
            v[j] = load_value(d, row);
            ok[j] = d.valid == nullptr ? 1 : __ldg(d.valid + row);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (s0 + j < n_cols) {
          s_val[(s0 + j) * T + tid] = v[j];
          s_ok[(s0 + j) * T + tid] = ok[j];
        }
      }
    }
  }
  if (tid < n_prog) smem[tid] = first;
  for (int i = tid + T; i < n_prog; i += T) smem[i] = __ldg(a.prog + i);
  __syncthreads();

  const int4* prog = prog_in_smem ? smem : a.prog;
  const int4* lits = prog + a.n_instr;
  const Row<kTile, kByValue> r{a, s_val, s_ok, s_f32, row};
  Bit top_t = 0, top_u = 0;  // the top entry
  uint64_t ts = 0, us = 0;   // the entries below it: TRUE / UNKNOWN bits
  int sp = 0;                // entries below the top
  int4 ins = prog[0];
  for (int pc = 0; pc < a.n_instr; ++pc) {
    // the next record loads while this one runs
    const int4 next = prog[min(pc + 1, a.n_instr - 1)];
    const int op = ins.x & 7;
    if (op < kOpAnd) {
      Bit t, u;
      leaf<kTile, kByValue>(r, ins, lits, op, t, u);
      const int fold = (ins.x >> 3) & 3;
      if (fold != kPush) {
        kleene(fold, top_t, top_u, t, u);
      } else {
        if (pc > 0) {  // the first instruction pushes onto an empty stack
          const uint64_t bit = 1ull << sp;
          ts = (ts & ~bit) | (static_cast<uint64_t>(top_t) << sp);
          us = (us & ~bit) | (static_cast<uint64_t>(top_u) << sp);
          ++sp;
        }
        top_t = t;
        top_u = u;
      }
    } else if (op == kOpNot) {
      top_t = (top_t | top_u) ^ 1u;
    } else {
      --sp;
      kleene(op == kOpAnd ? kFoldAnd : kFoldOr, top_t, top_u,
             static_cast<Bit>(ts >> sp) & 1u, static_cast<Bit>(us >> sp) & 1u);
    }
    ins = next;
  }
  const bool keep = row < a.n && top_t != 0;
  if (a.pack) {
    // n % 32 == 0 and T % 32 == 0: a warp's 32 rows are all in or out
    const uint32_t word = __ballot_sync(kFull, keep);
    if ((tid & 31) == 0 && row < a.n)
      static_cast<uint32_t*>(a.out)[row >> 5] = word;
  } else if (row < a.n) {
    static_cast<uint8_t*>(a.out)[row] = keep ? 1 : 0;
  }
}

}  // namespace

// The block size is kThreads, halved (down to 32) until the value tile
// fits kSmemBudget; with no fit the values load where they are used.  The
// program goes to shared memory when it fits beside the tile.
// (args points at a PredArgs: a type of this file's unnamed namespace
// would give the entry point internal linkage)
extern "C" int trt_pred3vl_mask(const void* args, void* stream) {
  const PredArgs& a = *static_cast<const PredArgs*>(args);
  if (a.n <= 0 || a.n_instr <= 0 || a.n_lits < 0 || a.n_cols < 0 ||
      a.prog == nullptr || a.out == nullptr || a.depth < 1 ||
      a.depth > kMaxDepth || (a.pack && a.n % 32 != 0) ||
      (a.n_cols > kByValueCols && a.dev_cols == nullptr))
    return cudaErrorInvalidValue;
  int threads = kThreads;
  size_t tile_bytes = 0;
  bool tile = false;
  for (int t = kThreads; t >= 32 && !tile; t /= 2) {
    const size_t bytes = static_cast<size_t>(a.n_cols) * (5 * t + 1);
    if (bytes <= kSmemBudget) {
      threads = t;
      tile_bytes = bytes;
      tile = true;
    }
  }
  const size_t prog_bytes =
      16 * (static_cast<size_t>(a.n_instr) + static_cast<size_t>(a.n_lits));
  const int prog_in_smem = tile_bytes + prog_bytes <= kSmemBudget;
  const size_t smem = (prog_in_smem ? prog_bytes : 0) + tile_bytes;
  const long long grid = (a.n + threads - 1) / threads;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(grid);
  const bool by_value = a.n_cols <= kByValueCols;
  if (tile && by_value)
    pred3vl_mask_kernel<true, true><<<g, threads, smem, s>>>(a, prog_in_smem);
  else if (tile)
    pred3vl_mask_kernel<true, false><<<g, threads, smem, s>>>(a, prog_in_smem);
  else if (by_value)
    pred3vl_mask_kernel<false, true><<<g, threads, smem, s>>>(a, prog_in_smem);
  else
    pred3vl_mask_kernel<false, false>
        <<<g, threads, smem, s>>>(a, prog_in_smem);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
