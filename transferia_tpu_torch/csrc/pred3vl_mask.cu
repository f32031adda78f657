// K-C: Kleene three-valued row predicate, with the keep-mask bit pack.
//
// Replaces the JAX device programs transferia_tpu/predicate/device.py
// `compile_mask_jnp` / `_eval3_jnp` / `_cmp_jnp` (lines 113, 131, 191) and
// transferia_tpu/ops/decode.py `pack_mask_words` (line 114), which the
// fused program (transferia_tpu/ops/fused.py:217-219) applies to its keep
// mask.
//
// The predicate AST is lowered on the host (predicate/device.py
// compile_mask_program) to a short postfix program that travels as the
// kernel's by-value parameter block.  Each thread evaluates the program
// for its row on a stack of (TRUE, UNKNOWN) bit pairs held in two 64-bit
// registers.  Instructions:
//   TRUE                  push (T, !U)
//   CMP  slot op lit      T = valid & (col op lit), U = !valid
//   CMP_NULL              col op NULL: always UNKNOWN
//   ISNULL slot negate    T = valid == negate, U = false
//   IN   slot lits flags  SQL IN over a literal range (NULL literal, NOT)
//   AND / OR              binary Kleene fold of the top two entries
//   NOT                   T = !T & !U, U kept
// n-ary AND/OR fold pairwise: the Kleene connectives are associative, and
// the reference's n-ary formulas equal the pairwise fold.
//
// Comparisons follow jnp's weak-type promotion, as the reference traced
// them: an integer column (bool, int8/16/32, uint8/16, date32) against an
// integer or bool literal compares in integer; a float32 column, or any
// float literal, compares in float32.  Float compares are IEEE (the build
// uses no fast-math), so NaN is unequal to everything.
//
// Output: the TRUE mask (UNKNOWN rows do not match).  With `pack` set it
// is packed with __ballot_sync into little-endian uint32 words, bit j of
// word k = row 32k+j; n must then be a multiple of 32.
//
// Bound on an H100: a few bytes per row per referenced column read once,
// one bit (packed) or byte written: bound by bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxInstr = 128;
constexpr int kMaxLits = 64;
constexpr int kMaxCols = 16;
// the host lowering keeps the stack depth <= 64 (predicate/device.py)

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
enum CmpOp { kEq = 0, kNe = 1, kLt = 2, kLe = 3, kGt = 4, kGe = 5 };
enum DType {
  kBool = 0,
  kI8 = 1,
  kU8 = 2,
  kI16 = 3,
  kU16 = 4,
  kI32 = 5,
  kF32 = 6,
};
enum InFlags { kInNegate = 1, kInHasNull = 2 };

struct Program {
  // instr[k] = {op, slot, a, b}; CMP: a = compare op, b = literal index;
  // ISNULL: a = negate; IN: a = first literal, b = count | flags << 16
  int32_t instr[kMaxInstr][4];
  int64_t ilit[kMaxLits];
  float flit[kMaxLits];
  int32_t lit_is_float[kMaxLits];
  const void* data[kMaxCols];
  const uint8_t* valid[kMaxCols];  // nullptr: every row valid
  int32_t dtype[kMaxCols];
  int32_t n_instr;
};
static_assert(sizeof(Program) <= 4096, "kernel parameter block too large");

__device__ __forceinline__ int64_t load_int(const Program& p, int slot,
                                            int64_t row) {
  const void* d = p.data[slot];
  switch (p.dtype[slot]) {
    case kBool:
    case kU8:
      return static_cast<const uint8_t*>(d)[row];
    case kI8:
      return static_cast<const int8_t*>(d)[row];
    case kI16:
      return static_cast<const int16_t*>(d)[row];
    case kU16:
      return static_cast<const uint16_t*>(d)[row];
    default:
      return static_cast<const int32_t*>(d)[row];
  }
}

__device__ __forceinline__ float load_float(const Program& p, int slot,
                                            int64_t row) {
  if (p.dtype[slot] == kF32) return static_cast<const float*>(p.data[slot])[row];
  return static_cast<float>(load_int(p, slot, row));
}

template <typename T>
__device__ __forceinline__ bool compare(T x, T y, int op) {
  switch (op) {
    case kEq:
      return x == y;
    case kNe:
      return x != y;
    case kLt:
      return x < y;
    case kLe:
      return x <= y;
    case kGt:
      return x > y;
    default:
      return x >= y;
  }
}

__device__ __forceinline__ bool cmp_at(const Program& p, int slot,
                                       int64_t row, int op, int lit) {
  if (p.dtype[slot] == kF32 || p.lit_is_float[lit]) {
    return compare(load_float(p, slot, row), p.flit[lit], op);
  }
  return compare(load_int(p, slot, row), p.ilit[lit], op);
}

__device__ __forceinline__ bool valid_at(const Program& p, int slot,
                                         int64_t row) {
  return p.valid[slot] == nullptr || p.valid[slot][row] != 0;
}

__global__ void pred3vl_mask_kernel(const __grid_constant__ Program p,
                                    int64_t n, int pack,
                                    void* __restrict__ out) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (row >= n) return;  // with pack, n % 32 == 0: whole warps leave
  uint64_t ts = 0, us = 0;  // stacks of TRUE / UNKNOWN bits
  int sp = 0;
  for (int pc = 0; pc < p.n_instr; ++pc) {
    const int op = p.instr[pc][0];
    const int slot = p.instr[pc][1];
    const int a = p.instr[pc][2];
    const int b = p.instr[pc][3];
    bool t = false, u = false;
    if (op == kOpTrue) {
      t = true;
    } else if (op == kOpCmp) {
      const bool v = valid_at(p, slot, row);
      t = v && cmp_at(p, slot, row, a, b);
      u = !v;
    } else if (op == kOpCmpNull) {
      u = true;
    } else if (op == kOpIsNull) {
      t = valid_at(p, slot, row) == (a != 0);
    } else if (op == kOpIn) {
      const bool v = valid_at(p, slot, row);
      const int count = b & 0xffff;
      const int flags = b >> 16;
      bool m = false;
      for (int k = 0; k < count; ++k) m = m || cmp_at(p, slot, row, kEq, a + k);
      bool tt = m && v;
      bool ff = !m && v;
      if (flags & kInHasNull) ff = false;
      if (flags & kInNegate) {
        const bool tmp = tt;
        tt = ff;
        ff = tmp;
      }
      t = tt;
      u = !tt && !ff;
    } else {
      --sp;
      const bool t2 = (ts >> sp) & 1u, u2 = (us >> sp) & 1u;
      if (op == kOpNot) {
        t = !t2 && !u2;
        u = u2;
      } else {
        --sp;
        const bool t1 = (ts >> sp) & 1u, u1 = (us >> sp) & 1u;
        const bool f1 = !t1 && !u1, f2 = !t2 && !u2;
        bool f;
        if (op == kOpAnd) {
          t = t1 && t2;
          f = f1 || f2;
        } else {
          t = t1 || t2;
          f = f1 && f2;
        }
        u = !t && !f;
      }
    }
    const uint64_t bit = 1ull << sp;
    ts = t ? (ts | bit) : (ts & ~bit);
    us = u ? (us | bit) : (us & ~bit);
    ++sp;
  }
  const bool keep = (ts >> (sp - 1)) & 1u;
  if (pack) {
    const uint32_t word = __ballot_sync(0xffffffffu, keep);
    if ((threadIdx.x & 31) == 0) static_cast<uint32_t*>(out)[row >> 5] = word;
  } else {
    static_cast<uint8_t*>(out)[row] = keep ? 1 : 0;
  }
}

}  // namespace

extern "C" int trt_pred3vl_mask(const int32_t* instr, int n_instr,
                                const int64_t* ilit, const float* flit,
                                const int32_t* lit_is_float, int n_lits,
                                const void* const* data,
                                const void* const* valid,
                                const int32_t* dtype, int n_cols,
                                long long n, int pack, void* out,
                                void* stream) {
  if (n <= 0 || n_instr <= 0 || n_instr > kMaxInstr || n_lits < 0 ||
      n_lits > kMaxLits || n_cols < 0 || n_cols > kMaxCols ||
      (pack && n % 32 != 0)) {
    return cudaErrorInvalidValue;
  }
  Program p = {};
  for (int k = 0; k < n_instr; ++k) {
    for (int j = 0; j < 4; ++j) p.instr[k][j] = instr[4 * k + j];
  }
  for (int k = 0; k < n_lits; ++k) {
    p.ilit[k] = ilit[k];
    p.flit[k] = flit[k];
    p.lit_is_float[k] = lit_is_float[k];
  }
  for (int k = 0; k < n_cols; ++k) {
    p.data[k] = data[k];
    p.valid[k] = static_cast<const uint8_t*>(valid[k]);
    p.dtype[k] = dtype[k];
  }
  p.n_instr = n_instr;
  constexpr int kThreads = 256;
  const int grid = static_cast<int>((n + kThreads - 1) / kThreads);
  pred3vl_mask_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(p, n, pack, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
