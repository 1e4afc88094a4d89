// One-pass dense grouped aggregation for Hopper (sm_90a).
//
// Replaces cockroach_tpu/ops/pallas/groupagg_large.py:large_group_aggregate
// (the TPU kernel that folds each row block into a VMEM tile with a
// one_hot(gid)^T @ mat product on the MXU: O(n * G) work to add n rows
// into G groups). Here each row goes to its own group, O(n) work.
//
// Output contract (the TPU kernel's, so the caller's limb recombination
// is unchanged): acc_f f32[nf, G] (float sums, f32 shadows of int64
// sums, MIN/MAX rows), acc_i i32[ni, G] (int32 limb sums, counts and
// the REPMIN row: the smallest selected row id of a group, or n), and
// maxabs u64[n_mx]: per int64-sum slot, the largest |value| over the
// rows that pass sel and the slot's mask (|INT64_MIN| = 2^63), which
// feeds the caller's overflow sentinel. Rows whose gid lies outside
// [0, G) add to no group.
//
// Slots. The kernel reads the table's own tensors, each distinct column
// once; a slot names a value column (int64, int32, float32 or float64,
// read in place) and a mask (none, sel, or sel AND a bool column):
//   I64SUM(value, mask, w, k): k int32 rows of w-bit limbs of
//     where(mask, value, 0), the logical shift-and-mask of the int64
//     bit pattern (ops/agg.py limb), plus its f32 shadow row and its
//     max-|value| word;
//   COUNT(mask): one int32 row;
//   FSUM(value, mask): one f32 row (FLOAT sums);
//   MIN/MAX(value, mask): one f32 row; an integer column is reduced by
//     its arithmetic high limb value >> 40 (order-preserving and exact
//     in f32; the caller refines the winner to full width), a float
//     column by its value;
//   ISUM(value): one int32 row of __float2int_rn of an integer-valued
//     f32 column (the pre-built-column interface, which also passes f32
//     sum columns as FSUM and pre-masked MIN/MAX columns with no mask).
// The TPU kernel takes the int64 limbs as pre-built f32 columns because
// Mosaic has no 64-bit lanes; Hopper loads and shifts int64 natively, so
// the limbs are cut here in registers and never stored: at TPC-H Q1 the
// kernel reads 50 B a row (gid, sel, 5 int64 values, 5 masks) where the
// pre-built columns took 249 B.
//
// Bound: device-memory bytes, each distinct column read once, plus the
// outputs written once (TPC-H Q1 at 8,388,608 rows: 419 MB, 0.125 ms at
// 3.35 TB/s). The work per byte is a few integer operations, but the
// per-group adds are warp collectives and shared atomics, so the kernel
// runs at about a third of that bound at Q1.
//
// Design:
// - a grid-stride loop over tiles of ROWS * BLOCK rows. A thread keeps
//   the gid, sel and mask bits of its ROWS rows (strided by BLOCK, so
//   each load is coalesced across the warp) in registers and walks the
//   slots outermost; its ROWS value loads per slot are independent.
// - per tile, each warp discovers the distinct groups of its 32 * ROWS
//   rows once (a ballot and a shuffle per group). When they are at most
//   FEW (TPC-H Q1: 4 live groups), every int32 row is added per group:
//   each lane sums its own rows of the group in registers, one
//   __reduce_add_sync covers the group's 32 * ROWS rows, and lanes
//   0..ng-1 make one atomic add each, to distinct words; counts take a
//   ballot per row position, ANDed with the group's lanes and counted.
//   Limbs above the warp's highest set bit, or zero across the warp (an
//   OR reduction), cost nothing. The shadow of a group's rows is
//   computed from its limb sums: their wrapped int64 sum is exact modulo
//   2^64, and a double estimate (limb sums scaled, less 2^64 per
//   negative row) supplies the wrap count, so it is f32(exact sum of
//   those rows), then added in f32. Past FEW groups each lane makes its
//   own atomic adds, row by row. (Per-warp shared copies of the accumulators, each lane adding
//   its own rows, ran 2x slower at TPC-H Q1 on an H100; so did the same
//   design with the reductions per row position instead of per tile,
//   so neither is kept.)
// - accumulators: one [nf + ni, G] copy per block in shared memory where
//   it fits (flushed to the outputs with one global atomic per nonzero
//   word at the end), else global atomics (TPC-H Q10: G = 150,001).
// - MIN/MAX use the ordered-int view of the float: atomicMin/atomicMax
//   on the int bits when the sign bit is clear, the reversed unsigned
//   order when it is set; a NaN is written as a canonical NaN that both
//   orders keep, so a group with a NaN ends NaN (jnp.min / jnp.max).
//   FLOAT sums and MIN/MAX take per-lane atomics (only `on` reaches
//   them); REPMIN is a min-reduction per group, else atomicMin.
// - max-|value|: a warp max-reduction per slot and tile, an atomicMax
//   into shared memory, one global atomicMax per block.
// - registers are capped so that MIN_BLOCKS blocks share an SM: the
//   loads of one warp wait while others fold.
// - launch points: (BLOCK, ROWS, MIN_BLOCKS) are template parameters,
//   one instantiation per entry of POINTS (the shipped point first,
//   256 x 4 x 4), selected at launch; FEW follows ROWS (at most 32 / ROWS
//   groups fit a warp's membership word). ops/cuda/autotune.py times
//   them. Every point adds the same integers into the same words, so
//   every point gives the same result.
// - no per-call host work beyond filling the argument struct: the column
//   pointers and slots travel by value in the launch's parameter space
//   (caps MAX_COLS, MAX_MASKS, MAX_SLOTS, which the wrapper checks), an
//   init kernel of this library sets the outputs to their identities,
//   and the SM count, the shared memory an SM holds and the kernel's
//   shared-memory attribute are looked up once per process; the grid
//   follows from them and MIN_BLOCKS.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

enum Kind { COUNT = 0, ISUM = 1, I64SUM = 2, FSUM = 3, MIN = 4, MAX = 5 };
enum DType { I64 = 0, I32 = 1, F32 = 2, F64 = 3 };
enum Layout { SHARED = 0, GLOBAL = 1, N_LAYOUTS = 2 };

constexpr int MASK_NONE = -2;  // every row (pre-built columns)
constexpr int MASK_SEL = -1;   // sel alone
constexpr int MAX_COLS = 64;
constexpr int MAX_MASKS = 30;  // mask bits 0..29 of a row's bit word
constexpr int MAX_SLOTS = 64;
constexpr int MM_HI_SHIFT = 40;

// Launch points: threads a block, rows a thread per tile, blocks an SM
// (registers capped at 65536 / (BLOCK * MIN_BLOCKS) a thread). Keep in
// the order of ops/cuda/groupagg_large.py KERNEL_POINTS.
struct Point {
  int block, rows, min_blocks;
};
constexpr Point POINTS[] = {
    {256, 4, 4}, {128, 4, 8}, {512, 4, 2}, {256, 2, 4}, {256, 8, 2}};
constexpr int N_POINTS = sizeof(POINTS) / sizeof(POINTS[0]);

// warp-aggregated adds up to this many groups a tile
template <int ROWS>
struct FewOf {
  static constexpr int value = 32 / ROWS < 8 ? 32 / ROWS : 8;
};
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned SEL_BIT = 1u << 30;
constexpr unsigned ROW_BIT = 1u << 31;  // the row is < n
// dynamic shared memory a block may take: 227 KB less the static words
constexpr int SMEM_DYN_MAX = 232448 - 1024;

struct Slot {
  int kind, col, mask, row;  // row: first int32 row, or the f32 row
  int w, k, frow, mx;        // I64SUM: limb width and count, shadow row,
                             // max-|value| word
};

struct Params {
  const int32_t* gid;
  const uint8_t* sel;
  float* acc_f;                 // [nf, G]
  int32_t* acc_i;               // [ni, G]
  unsigned long long* maxabs;   // [n_mx]
  const void* cols[MAX_COLS];
  const uint8_t* masks[MAX_MASKS];
  Slot slots[MAX_SLOTS];
  unsigned char col_type[MAX_COLS];
  unsigned char frow_kind[MAX_SLOTS];  // FSUM (a sum row), MIN or MAX
  long long n;
  int G, n_slots, n_masks, nf, ni, n_mx, rep_row;
};

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float f_identity(int kind) {
  return kind == MIN ? pos_inf() : (kind == MAX ? neg_inf() : 0.0f);
}

// Ordered-int float MIN/MAX. A float whose sign bit is clear orders like
// its bits as a signed int, one whose sign bit is set (-0.0 included)
// reversed as unsigned. A NaN is written as a canonical NaN that both
// orders keep: 0xffc00000 under MIN (a negative int, and above -inf's
// bits as unsigned), 0x7fc00000 under MAX (above +inf's bits as int, and
// below every sign-set bit pattern as unsigned).
__device__ __forceinline__ void atomic_min_f32(float* addr, float v) {
  if (v != v)
    atomicExch(reinterpret_cast<unsigned int*>(addr), 0xffc00000u);
  else if (__float_as_int(v) >= 0)
    atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

__device__ __forceinline__ void atomic_max_f32(float* addr, float v) {
  if (v != v)
    atomicExch(reinterpret_cast<unsigned int*>(addr), 0x7fc00000u);
  else if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned int*>(addr), __float_as_uint(v));
}

// Fold one MIN/MAX value into *p, skipping the identity.
__device__ __forceinline__ void fold_mm(int kind, float* p, float v) {
  if (kind == MAX) {
    if (v != neg_inf()) atomic_max_f32(p, v);
  } else {
    if (v != pos_inf()) atomic_min_f32(p, v);
  }
}

__device__ __forceinline__ bool mask_pass(int mask, unsigned bits) {
  if (!(bits & ROW_BIT)) return false;
  if (mask == MASK_NONE) return true;
  if (!(bits & SEL_BIT)) return false;
  return mask == MASK_SEL || ((bits >> mask) & 1u);
}

__device__ __forceinline__ long long load_int(const Params& p, int c, int row) {
  const void* base = p.cols[c];
  if (p.col_type[c] == I64)
    return __ldg(static_cast<const long long*>(base) + row);
  return (long long)__ldg(static_cast<const int*>(base) + row);
}

__device__ __forceinline__ float load_float(const Params& p, int c, int row) {
  const void* base = p.cols[c];
  if (p.col_type[c] == F64)
    return __double2float_rn(__ldg(static_cast<const double*>(base) + row));
  return __ldg(static_cast<const float*>(base) + row);
}

// MIN/MAX operand: the high limb of an integer column, a float's value
__device__ __forceinline__ float load_mm(const Params& p, int c, int row) {
  const int t = p.col_type[c];
  if (t == I64 || t == I32)
    return (float)(load_int(p, c, row) >> MM_HI_SHIFT);
  return load_float(p, c, row);
}

// 2^e as a double (0 <= e <= 64), exact
__device__ __forceinline__ double pow2(int e) {
  return __longlong_as_double((long long)(1023 + e) << 52);
}

// A warp's groups in one tile: the distinct groups of its 32 * ROWS
// rows, discovered once, at most FEW of them. Lane j (j < ng) adds for
// group j; memb holds, ROWS bits per group, which of this lane's rows
// are in it, and peers, for lane j, which lanes' row k is in group j
// (so a count is a ballot and a popcount per row position).
template <int ROWS>
struct TileGroups {
  bool few;       // warp-uniform: all valid rows fall in <= FEW groups
  int ng;
  int gmine;
  unsigned memb;
  unsigned peers[ROWS];  // lane j: the lanes whose row k is in group j
};

template <int ROWS>
__device__ __forceinline__ TileGroups<ROWS> tile_groups(
    const int (&g)[ROWS], int lane) {
  constexpr int FEW = FewOf<ROWS>::value;
  static_assert(FEW * ROWS <= 32, "memb holds ROWS bits a group");
  TileGroups<ROWS> t;
  t.few = true;
  t.ng = 0;
  t.gmine = 0;
  t.memb = 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) t.peers[k] = 0;
  unsigned pending = 0;
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
    if (g[k] >= 0) pending |= 1u << k;
  while (true) {
    int cand = -1;  // the group of this lane's first pending row
#pragma unroll
    for (int k = ROWS - 1; k >= 0; --k)
      if ((pending >> k) & 1u) cand = g[k];
    const unsigned b = __ballot_sync(FULL, cand >= 0);
    if (b == 0) break;
    if (t.ng == FEW) {
      t.few = false;
      break;
    }
    const int gs = __shfl_sync(FULL, cand, __ffs(b) - 1);
    unsigned hit = 0;
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      if (g[k] == gs) hit |= 1u << k;
    pending &= ~hit;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const unsigned bk = __ballot_sync(FULL, (hit >> k) & 1u);
      if (lane == t.ng) t.peers[k] = bk;
    }
    t.memb |= hit << (t.ng * ROWS);
    if (lane == t.ng) t.gmine = gs;
    ++t.ng;
  }
  return t;
}

template <int ROWS>
__device__ __forceinline__ unsigned rows_of(const TileGroups<ROWS>& t,
                                            int j) {
  return (t.memb >> (j * ROWS)) & ((1u << ROWS) - 1u);
}

// Per group, the warp's sum of x over the group's rows, left in lane j
// for group j: the rows of a lane add in registers first, so one
// reduction covers the group's 32 * ROWS rows.
template <int ROWS>
__device__ __forceinline__ unsigned group_sums(const unsigned (&x)[ROWS],
                                               const TileGroups<ROWS>& t,
                                               int lane) {
  unsigned mine = 0;
  for (int j = 0; j < t.ng; ++j) {
    const unsigned rows = rows_of(t, j);
    unsigned part = 0;
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      if ((rows >> k) & 1u) part += x[k];
    const unsigned s = __reduce_add_sync(FULL, part);
    if (lane == j) mine = s;
  }
  return mine;
}

template <int LAYOUT, int BLOCK, int ROWS, int MIN_BLOCKS>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
groupagg_large_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ unsigned long long mx_s[MAX_SLOTS];
  const int lane = threadIdx.x & 31;
  const int G = p.G;
  const int n = (int)p.n;
  const long long fwords = (long long)p.nf * G;
  const long long words = fwords + (long long)p.ni * G;
  float* f_acc = p.acc_f;
  int32_t* i_acc = p.acc_i;
  if (LAYOUT == SHARED) {
    f_acc = reinterpret_cast<float*>(smem_raw);
    i_acc = reinterpret_cast<int32_t*>(f_acc + fwords);
    for (long long idx = threadIdx.x; idx < words; idx += BLOCK) {
      if (idx < fwords)
        f_acc[idx] = f_identity(p.frow_kind[idx / G]);
      else
        i_acc[idx - fwords] = (idx - fwords) / G == p.rep_row ? n : 0;
    }
  }
  for (int i = threadIdx.x; i < p.n_mx; i += BLOCK) mx_s[i] = 0ull;
  __syncthreads();

  const long long tile = (long long)BLOCK * ROWS;
  for (long long base = (long long)blockIdx.x * tile; base < n;
       base += (long long)gridDim.x * tile) {
    int row[ROWS], g[ROWS];
    unsigned bits[ROWS];  // ROW_BIT, SEL_BIT, mask bits
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const long long r = base + (long long)k * BLOCK + threadIdx.x;
      row[k] = r < n ? (int)r : 0;
      g[k] = -1;
      bits[k] = 0;
      if (r < n) {
        const int gk = __ldg(&p.gid[r]);
        if (gk >= 0 && gk < G) g[k] = gk;
        bits[k] = ROW_BIT | (__ldg(&p.sel[r]) ? SEL_BIT : 0u);
      }
    }
    for (int m = 0; m < p.n_masks; ++m) {
      const uint8_t* mk = p.masks[m];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if ((bits[k] & ROW_BIT) && __ldg(&mk[row[k]])) bits[k] |= 1u << m;
    }
    const TileGroups<ROWS> tg = tile_groups<ROWS>(g, lane);
    const bool few = tg.few;  // warp-uniform

    for (int s = 0; s < p.n_slots; ++s) {
      const Slot sl = p.slots[s];
      const int c = sl.col;
      if (sl.kind == COUNT) {
        int32_t* acc = &i_acc[(size_t)sl.row * G];
        unsigned act[ROWS];
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
          act[k] = g[k] >= 0 && mask_pass(sl.mask, bits[k]) ? 1u : 0u;
        if (few) {
          unsigned mine = 0;
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
            mine += __popc(__ballot_sync(FULL, act[k]) & tg.peers[k]);
          if (lane < tg.ng && mine) atomicAdd(&acc[tg.gmine], (int)mine);
        } else {
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
            if (act[k]) atomicAdd(&acc[g[k]], 1);
        }
      } else if (sl.kind == ISUM) {
        int32_t* acc = &i_acc[(size_t)sl.row * G];
        unsigned x[ROWS];
        bool any = false;
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          x[k] = g[k] >= 0 && mask_pass(sl.mask, bits[k])
                     ? (unsigned)__float2int_rn(load_float(p, c, row[k]))
                     : 0u;
          any |= x[k] != 0u;
        }
        if (few) {
          if (!__any_sync(FULL, any)) continue;
          const int mine = (int)group_sums(x, tg, lane);
          if (lane < tg.ng && mine) atomicAdd(&acc[tg.gmine], mine);
        } else {
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
            if (x[k]) atomicAdd(&acc[g[k]], (int)x[k]);
        }
      } else if (sl.kind == I64SUM) {
        const int w = sl.w;
        const unsigned long long lmask = (1ull << w) - 1ull;
        const int kfull = (64 + w - 1) / w;
        long long v[ROWS];
        unsigned long long amax = 0;
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          v[k] = mask_pass(sl.mask, bits[k]) ? load_int(p, c, row[k]) : 0;
          const unsigned long long a =
              v[k] < 0 ? 0ull - (unsigned long long)v[k]
                       : (unsigned long long)v[k];
          amax = a > amax ? a : amax;
        }
        {
          const unsigned hi = __reduce_max_sync(FULL, (unsigned)(amax >> 32));
          const unsigned lo = __reduce_max_sync(
              FULL, (unsigned)(amax >> 32) == hi ? (unsigned)amax : 0u);
          const unsigned long long wmax =
              ((unsigned long long)hi << 32) | lo;
          if (lane == 0 && wmax) atomicMax(&mx_s[sl.mx], wmax);
        }
        float* shadow = &f_acc[(size_t)sl.frow * G];
        unsigned long long u[ROWS], orl = 0;
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          u[k] = g[k] >= 0 ? (unsigned long long)v[k] : 0ull;
          orl |= u[k];
        }
        if (few) {
          const unsigned long long orv =
              ((unsigned long long)__reduce_or_sync(FULL, (unsigned)(orl >> 32))
               << 32) |
              __reduce_or_sync(FULL, (unsigned)orl);
          if (orv == 0) continue;
          unsigned long long t = 0;  // the group's sum modulo 2^64
          double est = 0.0;          // the same, approximately, unwrapped
          // limbs above the warp's highest set bit are zero
          const int jend = min(kfull, (64 - __clzll(orv) + w - 1) / w);
          for (int j = 0; j < jend; ++j) {
            const int sh = j * w;
            if (((orv >> sh) & lmask) == 0) continue;
            unsigned lim[ROWS];
#pragma unroll
            for (int k = 0; k < ROWS; ++k)
              lim[k] = (unsigned)((u[k] >> sh) & lmask);
            const unsigned mine = group_sums(lim, tg, lane);
            if (j < sl.k && lane < tg.ng && mine)
              atomicAdd(&i_acc[(size_t)(sl.row + j) * G + tg.gmine],
                        (int)mine);
            t += (unsigned long long)mine << sh;
            est += (double)mine * pow2(sh);
          }
          if (orv >> 63) {
            unsigned nneg = 0;
#pragma unroll
            for (int k = 0; k < ROWS; ++k)
              nneg += __popc(__ballot_sync(FULL, (long long)u[k] < 0) &
                             tg.peers[k]);
            est -= (double)nneg * pow2(64);
          }
          if (lane < tg.ng) {
            const double tw = (double)(long long)t;
            const double wraps = rint((est - tw) * 0x1p-64);
            const double sum = tw + wraps * 0x1p64;
            if (sum != 0.0) atomicAdd(&shadow[tg.gmine], (float)sum);
          }
        } else {
#pragma unroll
          for (int k = 0; k < ROWS; ++k) {
            if (u[k] == 0) continue;
            for (int j = 0; j < sl.k; ++j) {
              const int limb = (int)((u[k] >> (j * w)) & lmask);
              if (limb)
                atomicAdd(&i_acc[(size_t)(sl.row + j) * G + g[k]], limb);
            }
            atomicAdd(&shadow[g[k]], __ll2float_rn((long long)u[k]));
          }
        }
      } else if (sl.kind == FSUM) {
        float* acc = &f_acc[(size_t)sl.row * G];
        float x[ROWS];
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
          x[k] = g[k] >= 0 && mask_pass(sl.mask, bits[k])
                     ? load_float(p, c, row[k]) : 0.0f;
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
          if (x[k] != 0.0f) atomicAdd(&acc[g[k]], x[k]);
      } else {  // MIN, MAX
        float* acc = &f_acc[(size_t)sl.row * G];
        float x[ROWS];
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
          x[k] = g[k] >= 0 && mask_pass(sl.mask, bits[k])
                     ? load_mm(p, c, row[k]) : f_identity(sl.kind);
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
          if (g[k] >= 0) fold_mm(sl.kind, &acc[g[k]], x[k]);
      }
    }

    if (p.rep_row >= 0) {
      int32_t* rep = &i_acc[(size_t)p.rep_row * G];
      if (few) {
        unsigned mine = (unsigned)n;
        for (int j = 0; j < tg.ng; ++j) {
          const unsigned rows = rows_of(tg, j);
          unsigned r = (unsigned)n;
#pragma unroll
          for (int k = 0; k < ROWS; ++k)
            if (((rows >> k) & 1u) && (bits[k] & SEL_BIT))
              r = min(r, (unsigned)row[k]);
          r = __reduce_min_sync(FULL, r);
          if (lane == j) mine = r;
        }
        if (lane < tg.ng && mine < (unsigned)n)
          atomicMin(&rep[tg.gmine], (int)mine);
      } else {
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
          if (g[k] >= 0 && (bits[k] & SEL_BIT)) atomicMin(&rep[g[k]], row[k]);
      }
    }
  }

  __syncthreads();
  if (LAYOUT == SHARED) {
    for (long long idx = threadIdx.x; idx < words; idx += BLOCK) {
      if (idx < fwords) {
        const int kind = p.frow_kind[idx / G];
        const float v = f_acc[idx];
        if (kind == FSUM) {
          if (v != 0.0f) atomicAdd(&p.acc_f[idx], v);
        } else {
          fold_mm(kind, &p.acc_f[idx], v);
        }
      } else {
        const long long j = idx - fwords;
        const int32_t v = i_acc[j];
        if (j / G == p.rep_row) {
          if (v < n) atomicMin(&p.acc_i[j], v);
        } else if (v != 0) {
          atomicAdd(&p.acc_i[j], v);
        }
      }
    }
  }
  for (int i = threadIdx.x; i < p.n_mx; i += BLOCK)
    if (mx_s[i]) atomicMax(&p.maxabs[i], mx_s[i]);
}

// Outputs to their identities: 0 for sums, counts and max-|value|,
// +/-inf for MIN/MAX rows, n for the REPMIN row.
__global__ void groupagg_large_init(const __grid_constant__ Params p) {
  const long long fwords = (long long)p.nf * p.G;
  const long long iwords = (long long)p.ni * p.G;
  const long long total = fwords + iwords + p.n_mx;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    if (idx < fwords) {
      p.acc_f[idx] = f_identity(p.frow_kind[idx / p.G]);
    } else if (idx < fwords + iwords) {
      const long long j = idx - fwords;
      p.acc_i[j] = j / p.G == p.rep_row ? (int32_t)p.n : 0;
    } else {
      p.maxabs[idx - fwords - iwords] = 0ull;
    }
  }
}

// Looked up once per process and device.
struct DeviceInfo {
  bool ready;
  int sms;
  int smem_per_sm;  // shared memory an SM holds, and that a block costs
  int smem_block;   // besides its dynamic bytes (reserved + static)
  bool shared_ready[N_POINTS];  // the shared-memory attribute is set
};
DeviceInfo g_info[16];

cudaError_t device_info(DeviceInfo** out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 16) return cudaErrorInvalidDevice;
  DeviceInfo& d = g_info[dev];
  if (!d.ready) {
    int reserved = 0;
    if ((e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &d.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
             dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(
             &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev)) !=
            cudaSuccess)
      return e;
    d.smem_block = reserved + (int)(sizeof(unsigned long long) * MAX_SLOTS);
    d.ready = true;
  }
  *out = &d;
  return cudaSuccess;
}

// One block per tile up to the blocks the SMs hold at once: MIN_BLOCKS
// an SM by registers (the launch bounds cap them), fewer where the
// shared accumulators do not fit.
template <int LAYOUT, int PT>
cudaError_t launch(DeviceInfo& d, const Params& p, int smem,
                   cudaStream_t stream) {
  constexpr int BLOCK = POINTS[PT].block;
  constexpr int ROWS = POINTS[PT].rows;
  constexpr int MIN_BLOCKS = POINTS[PT].min_blocks;
  auto kernel = groupagg_large_kernel<LAYOUT, BLOCK, ROWS, MIN_BLOCKS>;
  if (LAYOUT == SHARED && !d.shared_ready[PT]) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DYN_MAX);
    if (e != cudaSuccess) return e;
    d.shared_ready[PT] = true;
  }
  int per_sm = d.smem_per_sm / (smem + d.smem_block);
  if (per_sm > MIN_BLOCKS) per_sm = MIN_BLOCKS;
  if (per_sm < 1) per_sm = 1;
  const long long tile = (long long)BLOCK * ROWS;
  long long grid = (p.n + tile - 1) / tile;
  if (grid > (long long)d.sms * per_sm) grid = (long long)d.sms * per_sm;
  if (grid < 1) grid = 1;
  kernel<<<(unsigned)grid, BLOCK, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int LAYOUT>
cudaError_t launch_point(DeviceInfo& d, const Params& p, int smem,
                         int point, cudaStream_t stream) {
  switch (point) {
    case 0: return launch<LAYOUT, 0>(d, p, smem, stream);
    case 1: return launch<LAYOUT, 1>(d, p, smem, stream);
    case 2: return launch<LAYOUT, 2>(d, p, smem, stream);
    case 3: return launch<LAYOUT, 3>(d, p, smem, stream);
    case 4: return launch<LAYOUT, 4>(d, p, smem, stream);
    default: return cudaErrorInvalidValue;
  }
}
static_assert(N_POINTS == 5, "launch_point switches over every point");

}  // namespace

// Initialise the outputs and fold the rows into them, on `stream`
// (asynchronous); returns the cudaError_t of the launches. Host arrays:
// col_ptrs/col_types [n_cols], mask_ptrs [n_masks] (uint8 0/1 columns),
// slots [n_slots * 8] ints (kind, col, mask, row, w, k, frow, mx).
// layout: 0 shared-memory accumulators ((nf + ni) * G * 4 bytes must fit
// in SMEM_DYN_MAX), 1 global atomics. point: an index into POINTS.
extern "C" int groupagg_large_launch(
    const void* gid, const void* sel, void* acc_f, void* acc_i,
    void* maxabs, const long long* col_ptrs, const unsigned char* col_types,
    int n_cols, const long long* mask_ptrs, int n_masks, const int* slots,
    int n_slots, long long n, int G, int nf, int ni, int n_mx, int rep_row,
    int layout, int point, void* stream) {
  if (n_cols < 0 || n_cols > MAX_COLS || n_masks < 0 ||
      n_masks > MAX_MASKS || n_slots < 0 || n_slots > MAX_SLOTS ||
      nf < 1 || nf > MAX_SLOTS || ni < 1 || n_mx < 0 || n_mx > MAX_SLOTS ||
      G < 1 || n < 0 || n >= (1ll << 31) || layout < 0 ||
      layout >= N_LAYOUTS || point < 0 || point >= N_POINTS)
    return (int)cudaErrorInvalidValue;
  Params p;
  memset(&p, 0, sizeof(p));
  p.gid = static_cast<const int32_t*>(gid);
  p.sel = static_cast<const uint8_t*>(sel);
  p.acc_f = static_cast<float*>(acc_f);
  p.acc_i = static_cast<int32_t*>(acc_i);
  p.maxabs = static_cast<unsigned long long*>(maxabs);
  for (int c = 0; c < n_cols; ++c) {
    p.cols[c] = reinterpret_cast<const void*>(col_ptrs[c]);
    p.col_type[c] = col_types[c];
  }
  for (int m = 0; m < n_masks; ++m)
    p.masks[m] = reinterpret_cast<const uint8_t*>(mask_ptrs[m]);
  for (int s = 0; s < n_slots; ++s) {
    Slot& sl = p.slots[s];
    const int* d = slots + 8 * s;
    sl.kind = d[0];
    sl.col = d[1];
    sl.mask = d[2];
    sl.row = d[3];
    sl.w = d[4];
    sl.k = d[5];
    sl.frow = d[6];
    sl.mx = d[7];
    if (sl.kind < COUNT || sl.kind > MAX || sl.mask < MASK_NONE ||
        sl.mask >= n_masks || (sl.kind != COUNT &&
                               (sl.col < 0 || sl.col >= n_cols)))
      return (int)cudaErrorInvalidValue;
    if (sl.kind == I64SUM &&
        (sl.w < 1 || sl.w > 22 || sl.k < 1 || sl.k > (64 + sl.w - 1) / sl.w ||
         sl.row + sl.k > ni || sl.frow < 0 || sl.frow >= nf || sl.mx < 0 ||
         sl.mx >= n_mx))
      return (int)cudaErrorInvalidValue;
    const bool f_row = sl.kind == FSUM || sl.kind == MIN || sl.kind == MAX;
    if (f_row ? sl.row >= nf : (sl.kind != I64SUM && sl.row >= ni))
      return (int)cudaErrorInvalidValue;
    if (sl.row < 0) return (int)cudaErrorInvalidValue;
    if (f_row) p.frow_kind[sl.row] = (unsigned char)sl.kind;
    if (sl.kind == I64SUM) p.frow_kind[sl.frow] = FSUM;
  }
  for (int r = 0; r < nf; ++r)
    if (p.frow_kind[r] != MIN && p.frow_kind[r] != MAX)
      p.frow_kind[r] = FSUM;
  p.n = n;
  p.G = G;
  p.n_slots = n_slots;
  p.n_masks = n_masks;
  p.nf = nf;
  p.ni = ni;
  p.n_mx = n_mx;
  p.rep_row = rep_row < ni ? rep_row : -1;

  DeviceInfo* d = nullptr;
  cudaError_t e = device_info(&d);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long total = (long long)(nf + ni) * G + n_mx;
  long long igrid = (total + 255) / 256;
  if (igrid > (long long)d->sms * 8) igrid = (long long)d->sms * 8;
  if (igrid < 1) igrid = 1;
  groupagg_large_init<<<(unsigned)igrid, 256, 0, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if (layout == GLOBAL)
    return (int)launch_point<GLOBAL>(*d, p, 0, point, s);
  const long long bytes = (long long)(nf + ni) * G * 4;
  if (bytes > SMEM_DYN_MAX) return (int)cudaErrorInvalidValue;
  return (int)launch_point<SHARED>(*d, p, (int)bytes, point, s);
}

// The launch points this library holds, as (block, rows, min_blocks)
// triples into out[0 .. cap); returns how many there are.
extern "C" int groupagg_large_points(int* out, int cap) {
  for (int j = 0; j < N_POINTS && 3 * j + 2 < cap; ++j) {
    out[3 * j] = POINTS[j].block;
    out[3 * j + 1] = POINTS[j].rows;
    out[3 * j + 2] = POINTS[j].min_blocks;
  }
  return N_POINTS;
}

extern "C" const char* groupagg_large_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
