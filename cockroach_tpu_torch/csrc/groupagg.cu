// One-pass small-G grouped COUNT/SUM/MIN/MAX for Hopper (sm_90a).
//
// Replaces cockroach_tpu/ops/pallas/groupagg.py:dense_group_aggregate
// (the TPU kernel that loads one (rows/128, 128) block per grid step and
// folds every (group, slot) pair into a scalar SMEM accumulator with one
// full-tile masked reduction each: G * A reductions per block).
//
// Output contract (the TPU kernel's): acc f32[G, A] and cnt i32[G, A].
// A COUNT slot's result is in cnt (its value column is never read), a
// SUM/MIN/MAX slot's in acc; the other array holds 0 in that column.
// Empty groups hold 0 (COUNT, SUM), +inf (MIN) and -inf (MAX). A row
// contributes to slot a of group g when sel[row] and mask_a[row] hold and
// gid[row] == g; rows whose gid lies outside [0, G) contribute nowhere.
// A NaN value in a group makes its SUM, MIN and MAX NaN, as jnp.sum,
// jnp.min and jnp.max do.
//
// Bound: device-memory bytes. Each distinct column is read once: gid
// 4 B, sel 1 B, and per distinct value column 4 or 8 B and per distinct
// mask 1 B a row (TPC-H Q1F: 66 B a row). The work per byte is a few
// compares and shared-memory loads and stores.
//
// Design:
// - columns: the wrapper deduplicates value and mask columns by storage
//   and hands over a plan: the distinct mask columns, the distinct value
//   columns (float32 or float64, rounded to f32 in registers) and, per
//   slot, its op, its mask (none when the mask is sel itself), its value
//   column and its output column. A row reads every distinct column
//   once, and a mask that is sel costs nothing.
// - loads: each thread takes ROWS = 4 consecutive rows of a tile of
//   ROWS * BLOCK rows, so gid comes as one 16-byte load, sel and each
//   mask as one 4-byte load, a float64 column as two 16-byte loads (the
//   wrapper takes the scalar-load instantiation when a pointer is not
//   aligned for that). Gid, sel and the first NB masks and value columns
//   of the next tile are loaded before this tile is folded, so a thread
//   keeps a few hundred bytes in flight while it works. NB is 8, or 4
//   for blocks of at most 4 slots, whose registers then leave room for
//   more blocks an SM.
// - accumulators, one 32-bit word per (group, slot) and copy; the
//   wrapper picks the strategy from G and A alone:
//   THREAD: every thread owns A words a group in dynamic shared memory,
//   laid out word-major and thread-minor (word (g * A + a) * BLOCK +
//   tid), so the lanes of a warp hit 32 distinct banks whatever their
//   groups. The rows of a thread that share a group are combined in
//   registers first, then each word is updated with a plain load,
//   combine and store: no atomic and no compare-and-swap in the row
//   loop. Taken wherever G * A * 4 * BLOCK bytes fit in 227 KB (TPC-H
//   Q1F: 92 KB a block; registers hold it to two blocks an SM).
//   CTA (thread-private copies do not fit): one [G, A] copy per block.
//   The lanes of a warp that hold one group are found with
//   __match_any_sync and combined with shuffles (counts with a ballot);
//   the lowest of them makes one shared-memory atomic update per slot.
//   (Per-warp copies with plain updates ran no faster than this on an
//   H100 at TPC-H Q1F grouped by return flag and ship mode, G = 32 and
//   A = 15, so there is no third layout.)
// - merge: at the end each block reduces its copies per (g, a) (for
//   THREAD a tree over the threads' words, shuffles inside a warp) and
//   makes one global update per (g, a): atomicAdd for SUM and COUNT, a
//   compare-and-swap loop through a NaN-sticky min/max for MIN and MAX
//   (CUDA has no float atomicMin/atomicMax that keeps a NaN). Identity
//   values are skipped. The grid is as many blocks as fit on the SMs at
//   once, at most one per tile.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { COUNT = 0, SUM = 1, MIN = 2, MAX = 3 };
enum Strategy { THREAD = 0, CTA = 1 };

constexpr int BLOCK = 128;      // threads per block
constexpr int WARPS = BLOCK / 32;
constexpr int ROWS = 4;         // consecutive rows per thread per tile
constexpr int WIDE = 8;         // masks and value columns loaded ahead
constexpr int NARROW = 4;       // the same for blocks of <= NARROW slots
constexpr int MASK_BITS = 31;   // masks kept as one bit per row
constexpr unsigned LIVE = 1u << 31;  // Tile::bits: the row has a group
constexpr unsigned FULL = 0xffffffffu;
static_assert(ROWS == 4, "the row loads and merges are written for 4 rows");

// The plan, an int64 array in device memory:
//   [0, nM)           mask column pointers (uint8, 0 or 1)
//   [nM, nM + nV)     value column pointers
//   [nM + nV, + nV)   1 for a float64 value column, 0 for float32
//   [nM + 2 nV, + A)  per slot, in that order: op | (mask + 1) << 2 (0:
//                     the mask is sel) | (value column + 1) << 16 (0 for
//                     COUNT) | output column << 32
struct Args {
  const int32_t* gid;
  const uint8_t* sel;
  const long long* plan;
  float* acc;    // [G, A]
  int32_t* cnt;  // [G, A]
  long long n;
  int G, A, nM, nV;
};

__device__ __forceinline__ int slot_op(int d) { return d & 3; }
__device__ __forceinline__ int slot_mask(int d) { return (d >> 2) & 0x3fff; }
__device__ __forceinline__ int slot_value(int d) { return (d >> 16) - 1; }

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float identity(int op) {
  return op == MIN ? pos_inf() : (op == MAX ? neg_inf() : 0.0f);
}

// min/max that return a NaN operand (jnp.minimum / jnp.maximum)
__device__ __forceinline__ float combine(int op, float x, float y) {
  if (op == SUM) return x + y;
  if (x != x) return x;
  if (y != y) return y;
  return op == MIN ? fminf(x, y) : fmaxf(x, y);
}

// Fold v into *p atomically (shared or global memory). Identity values
// are skipped.
__device__ __forceinline__ void fold(int op, float* p, float v) {
  if (op == SUM) {
    if (v != 0.0f) atomicAdd(p, v);
    return;
  }
  if (v == identity(op)) return;
  int* ip = reinterpret_cast<int*>(p);
  int old = *reinterpret_cast<volatile int*>(ip);
  while (true) {
    const float next = combine(op, __int_as_float(old), v);
    const int bits = __float_as_int(next);
    if (bits == old) return;
    const int prev = atomicCAS(ip, old, bits);
    if (prev == old) return;
    old = prev;
  }
}

__device__ __forceinline__ float warp_reduce(int op, float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = combine(op, v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// Loads of ROWS consecutive elements from a row that is a multiple of
// ROWS: one vector load, or ROWS scalar loads where the pointer is not
// aligned for it.
template <bool VEC>
__device__ __forceinline__ int4 load_i32x4(const int32_t* p) {
  if (VEC) return __ldg(reinterpret_cast<const int4*>(p));
  return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <bool VEC>
__device__ __forceinline__ unsigned load_u8x4(const uint8_t* p) {
  if (VEC) return __ldg(reinterpret_cast<const unsigned*>(p));
  return (unsigned)__ldg(p) | ((unsigned)__ldg(p + 1) << 8) |
         ((unsigned)__ldg(p + 2) << 16) | ((unsigned)__ldg(p + 3) << 24);
}

// The raw bits of ROWS values: a float64 column fills r0 and r1, a
// float32 column r0.
template <bool VEC>
__device__ __forceinline__ void load_vals(long long col, int f64,
                                          long long row, uint4& r0,
                                          uint4& r1) {
  if (f64) {
    const unsigned long long* p =
        reinterpret_cast<const unsigned long long*>(col) + row;
    if (VEC) {
      r0 = __ldg(reinterpret_cast<const uint4*>(p));
      r1 = __ldg(reinterpret_cast<const uint4*>(p + 2));
    } else {
      const unsigned long long a = __ldg(p), b = __ldg(p + 1),
                               c = __ldg(p + 2), d = __ldg(p + 3);
      r0 = make_uint4((unsigned)a, (unsigned)(a >> 32), (unsigned)b,
                      (unsigned)(b >> 32));
      r1 = make_uint4((unsigned)c, (unsigned)(c >> 32), (unsigned)d,
                      (unsigned)(d >> 32));
    }
  } else {
    const unsigned* p = reinterpret_cast<const unsigned*>(col) + row;
    if (VEC) {
      r0 = __ldg(reinterpret_cast<const uint4*>(p));
    } else {
      r0 = make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
  }
}

__device__ __forceinline__ float f64_bits_to_f32(unsigned lo, unsigned hi) {
  return __double2float_rn(__hiloint2double((int)hi, (int)lo));
}

__device__ __forceinline__ void to_f32(int f64, const uint4& r0,
                                       const uint4& r1, float* x) {
  if (f64) {
    x[0] = f64_bits_to_f32(r0.x, r0.y);
    x[1] = f64_bits_to_f32(r0.z, r0.w);
    x[2] = f64_bits_to_f32(r1.x, r1.y);
    x[3] = f64_bits_to_f32(r1.z, r1.w);
  } else {
    x[0] = __uint_as_float(r0.x);
    x[1] = __uint_as_float(r0.y);
    x[2] = __uint_as_float(r0.z);
    x[3] = __uint_as_float(r0.w);
  }
}

// The loads of one tile that are issued a tile ahead: gid, sel, the
// first NB masks and the first NB value columns of a thread's ROWS rows.
template <int NB>
struct Loads {
  int4 gid;
  unsigned sel;
  unsigned mask[NB];
  uint4 val[NB][2];
};

// A thread's first row of the tile at `base`; row 0 for a thread past n,
// whose loads are discarded.
__device__ __forceinline__ long long row_of(long long base, long long n) {
  const long long row = base + (long long)threadIdx.x * ROWS;
  return row < n ? row : 0;
}

template <bool VEC, int NB>
__device__ __forceinline__ void load_tile(Loads<NB>& L, const Args& a,
                                          const long long* s_ptr,
                                          const int* s_f64, long long r) {
  L.gid = load_i32x4<VEC>(a.gid + r);
  L.sel = load_u8x4<VEC>(a.sel + r);
#pragma unroll
  for (int j = 0; j < NB; ++j)
    L.mask[j] = j < a.nM ? load_u8x4<VEC>(
                               reinterpret_cast<const uint8_t*>(s_ptr[j]) + r)
                         : 0u;
#pragma unroll
  for (int c = 0; c < NB; ++c)
    if (c < a.nV)
      load_vals<VEC>(s_ptr[a.nM + c], s_f64[c], r, L.val[c][0], L.val[c][1]);
}

// x: the rows' values of value column v, from the loads issued ahead
// for v < NB (a switch, so the registers are named by constants), else
// loaded here from row r.
template <bool VEC, int NB>
__device__ __forceinline__ void column_f32(int v, const Loads<NB>& L,
                                           const long long* s_ptr,
                                           const int* s_f64, int nM,
                                           long long r, float* x) {
  static_assert(NB <= 8, "one case per column loaded ahead");
  const int f64 = s_f64[v];
  if (v >= NB) {
    uint4 r0, r1 = make_uint4(0u, 0u, 0u, 0u);
    load_vals<VEC>(s_ptr[nM + v], f64, r, r0, r1);
    to_f32(f64, r0, r1, x);
    return;
  }
#define CASE(j)                                                   \
  case j:                                                         \
    if constexpr (NB > j) to_f32(f64, L.val[j][0], L.val[j][1], x); \
    break;
  switch (v) { CASE(0) CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) }
#undef CASE
}

// Row k of a tile shares its group with an earlier row j: bit DUP(k, j)
// of Tile::dup (rows 1-3; j is the first such row).
#define DUP(k, j) (1u << ((k) * ((k) - 1) / 2 + (j)))

// One thread's ROWS rows of the current tile.
struct Tile {
  long long row;        // the first of them
  int g[ROWS];          // -1: past n, not selected, or gid outside [0, G)
  unsigned bits[ROWS];  // bit j: mask column j holds (j < MASK_BITS); LIVE
  // THREAD: the offset of each row's group (group 0 for a row of none)
  // among this thread's words, and which rows share a group
  int off[ROWS];
  unsigned dup;
  // CTA: the lanes holding the same group id, per row
  unsigned peers[ROWS];
  // per row, 5 shuffle steps of 6 bits: the lane to pull from (bits
  // 0-4) and whether to combine what it gives (bit 5)
  unsigned steps[ROWS];
};

// m[k]: row k counts in a slot with mask mi (0: sel, else mask column
// mi - 1)
__device__ __forceinline__ void row_masks(const Tile& t, int mi,
                                          const long long* s_ptr, bool* m) {
  if (mi > MASK_BITS) {
    const uint8_t* col = reinterpret_cast<const uint8_t*>(s_ptr[mi - 1]);
#pragma unroll
    for (int k = 0; k < ROWS; ++k)
      m[k] = t.g[k] >= 0 && __ldg(col + t.row + k) != 0;
    return;
  }
  const unsigned want = LIVE | (mi ? 1u << (mi - 1) : 0u);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) m[k] = (t.bits[k] & want) == want;
}

// THREAD: the rows' groups as word offsets (A words a group), and
// which rows repeat an earlier row's group
__device__ __forceinline__ void find_dups(Tile& t, int A) {
  int gc[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    gc[k] = max(t.g[k], 0);
    t.off[k] = gc[k] * A * BLOCK + (int)threadIdx.x;
  }
  unsigned dup = 0;
#pragma unroll
  for (int k = 1; k < ROWS; ++k) {
    bool seen = false;
#pragma unroll
    for (int j = 0; j < k; ++j) {
      if (!seen && gc[k] == gc[j]) dup |= DUP(k, j);
      seen = seen || gc[k] == gc[j];
    }
  }
  t.dup = dup;
}

// The shuffle tree that combines the values of the lanes holding one
// group into the lowest of them: at step s every lane pulls from its
// next remaining peer, and the lanes at odd positions drop out.
__device__ __forceinline__ void find_peers(Tile& t, int lane) {
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const unsigned peers = __match_any_sync(FULL, t.g[k]);
    unsigned rest = peers & ~((2u << lane) - 1u);  // peers above this lane
    int rel = __popc(peers & ((1u << lane) - 1u));
    unsigned steps = 0;
#pragma unroll
    for (int s = 0; s < 5; ++s) {
      const int next = __ffs(rest);
      if (next) steps |= (unsigned)((next - 1) | 32) << (6 * s);
      rest &= ~__ballot_sync(FULL, rel & 1);
      rel >>= 1;
    }
    t.peers[k] = peers;
    t.steps[k] = steps;
  }
}

template <int OP>
__device__ __forceinline__ float pick(bool take, float v) {
  return take ? v : identity(OP);
}

// THREAD: each row's contribution to one slot with the contributions of
// the later rows of its group combined into it (as raw bits for COUNT
// and float ops alike). A row of no group contributes the identity.
template <int OP>
__device__ __forceinline__ void merge_rows(unsigned d, const bool* m,
                                           const float* x, unsigned* y) {
  if constexpr (OP == COUNT) {
    const unsigned c0 = m[0], c1 = m[1], c2 = m[2], c3 = m[3];
    y[0] = c0 + ((d & DUP(1, 0)) ? c1 : 0u) + ((d & DUP(2, 0)) ? c2 : 0u) +
           ((d & DUP(3, 0)) ? c3 : 0u);
    y[1] = c1 + ((d & DUP(2, 1)) ? c2 : 0u) + ((d & DUP(3, 1)) ? c3 : 0u);
    y[2] = c2 + ((d & DUP(3, 2)) ? c3 : 0u);
    y[3] = c3;
  } else {
    float v[ROWS];
#pragma unroll
    for (int k = 0; k < ROWS; ++k) v[k] = pick<OP>(m[k], x[k]);
    y[0] = __float_as_uint(combine(
        OP,
        combine(OP, combine(OP, v[0], pick<OP>(d & DUP(1, 0), v[1])),
                pick<OP>(d & DUP(2, 0), v[2])),
        pick<OP>(d & DUP(3, 0), v[3])));
    y[1] = __float_as_uint(
        combine(OP, combine(OP, v[1], pick<OP>(d & DUP(2, 1), v[2])),
                pick<OP>(d & DUP(3, 1), v[3])));
    y[2] = __float_as_uint(combine(OP, v[2], pick<OP>(d & DUP(3, 2), v[3])));
    y[3] = __float_as_uint(v[3]);
  }
}

template <int OP>
__device__ __forceinline__ unsigned apply(unsigned old, unsigned y) {
  if constexpr (OP == COUNT) return old + y;
  return __float_as_uint(combine(OP, __uint_as_float(old), __uint_as_float(y)));
}

// Row k is the first of its group in the tile: it stores the merged
// contribution.
__device__ __forceinline__ bool first_row(unsigned d, int k) {
  const unsigned earlier[ROWS] = {0u, DUP(1, 0), DUP(2, 0) | DUP(2, 1),
                                  DUP(3, 0) | DUP(3, 1) | DUP(3, 2)};
  return !(d & earlier[k]);
}

// THREAD: fold one slot into this thread's word wi (x: the rows'
// values, unused for COUNT). The rows' words are loaded before any is
// stored, and only the first row of each group stores, so every word is
// stored once.
template <int OP>
__device__ __forceinline__ void thread_slot(const Tile& t, unsigned* s_acc,
                                            int wi, const bool* m,
                                            const float* x) {
  unsigned* w[ROWS];
  unsigned old[ROWS], y[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    w[k] = s_acc + t.off[k] + wi * BLOCK;
    old[k] = *w[k];
  }
  merge_rows<OP>(t.dup, m, x, y);
#pragma unroll
  for (int k = 0; k < ROWS; ++k)
    if (first_row(t.dup, k)) *w[k] = apply<OP>(old[k], y[k]);
}

// CTA: fold one slot of the tile's rows into the block's shared copy.
// d: the slot's descriptor.
__device__ __forceinline__ void shared_slot(const Tile& t, unsigned* s_acc,
                                            const long long* s_ptr, int p,
                                            int d, const float* x, int A,
                                            int lane) {
  const int op = slot_op(d);
  bool ms[ROWS];
  row_masks(t, slot_mask(d), s_ptr, ms);
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const bool lead = t.g[k] >= 0 && lane == __ffs(t.peers[k]) - 1;
    unsigned* w = s_acc + max(t.g[k], 0) * A + p;
    if (op == COUNT) {
      const int c = __popc(__ballot_sync(FULL, ms[k]) & t.peers[k]);
      if (lead && c) atomicAdd(reinterpret_cast<int*>(w), c);
    } else {
      float v = ms[k] ? x[k] : identity(op);
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const unsigned f = (t.steps[k] >> (6 * s)) & 63u;
        const float u = __shfl_sync(FULL, v, (int)(f & 31u));
        if (f & 32u) v = combine(op, v, u);
      }
      if (lead) fold(op, reinterpret_cast<float*>(w), v);
    }
  }
}

template <int S, bool VEC, int NB>
__global__ void __launch_bounds__(BLOCK, NB == NARROW ? 4 : 2)
    groupagg_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.G, A = a.A, nM = a.nM, nV = a.nV, GA = G * A;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long* s_ptr = reinterpret_cast<long long*>(smem);
  int* s_slot = reinterpret_cast<int*>(s_ptr + nM + nV);
  int* s_out = s_slot + A;
  int* s_f64 = s_out + A;
  const int desc = (8 * (nM + nV) + 4 * (2 * A + nV) + 15) & ~15;
  unsigned* s_acc = reinterpret_cast<unsigned*>(smem + desc);

  const long long* plan = a.plan;
  for (int i = tid; i < nM + nV; i += BLOCK) s_ptr[i] = __ldg(plan + i);
  for (int i = tid; i < nV; i += BLOCK)
    s_f64[i] = (int)__ldg(plan + nM + nV + i);
  for (int i = tid; i < A; i += BLOCK) {
    const long long d = __ldg(plan + nM + 2 * nV + i);
    s_slot[i] = (int)(d & 0xffffffffLL);
    s_out[i] = (int)(d >> 32);
  }
  __syncthreads();
  const int copies = S == THREAD ? BLOCK : 1;
  for (int i = tid; i < GA * copies; i += BLOCK) {
    const int p = (S == THREAD ? i / BLOCK : i) % A;
    s_acc[i] = __float_as_uint(identity(slot_op(s_slot[p])));  // COUNT: 0
  }
  __syncthreads();

  const int nmb = min(nM, MASK_BITS);
  const long long tile = (long long)BLOCK * ROWS;
  const long long stride = (long long)gridDim.x * tile;
  // The loop bounds are the same for every thread of the block, so whole
  // warps stay converged for the *_sync intrinsics. The next tile's
  // loads are issued before this tile is folded.
  long long base = (long long)blockIdx.x * tile;
  Loads<NB> cur, nxt;
  if (base < a.n) load_tile<VEC, NB>(cur, a, s_ptr, s_f64, row_of(base, a.n));
  for (; base < a.n; base += stride) {
    if (base + stride < a.n)
      load_tile<VEC, NB>(nxt, a, s_ptr, s_f64, row_of(base + stride, a.n));
    Tile t;
    t.row = base + (long long)tid * ROWS;
    const bool in = t.row < a.n;  // n % 4 == 0: all ROWS rows or none
    const long long r = row_of(base, a.n);
    const int gk[ROWS] = {cur.gid.x, cur.gid.y, cur.gid.z, cur.gid.w};
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      const bool ok = in && ((cur.sel >> (8 * k)) & 0xffu) && gk[k] >= 0 &&
                      gk[k] < G;
      t.g[k] = ok ? gk[k] : -1;
      unsigned b = ok ? LIVE : 0u;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        b |= (((cur.mask[j] >> (8 * k)) & 0xffu) ? 1u : 0u) << j;
      t.bits[k] = b;
    }
    for (int j0 = NB; j0 < nmb; j0 += NB) {  // masks not loaded ahead
      unsigned mw[NB];
#pragma unroll
      for (int j = 0; j < NB; ++j)
        mw[j] = j0 + j < nmb
                    ? load_u8x4<VEC>(
                          reinterpret_cast<const uint8_t*>(s_ptr[j0 + j]) + r)
                    : 0u;
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
#pragma unroll
        for (int j = 0; j < NB; ++j)
          t.bits[k] |= (((mw[j] >> (8 * k)) & 0xffu) ? 1u : 0u) << (j0 + j);
    }

    if constexpr (S == THREAD) {
      find_dups(t, A);
      for (int p = 0; p < A; ++p) {
        const int d = s_slot[p];
        bool m[ROWS];
        float x[ROWS];
        row_masks(t, slot_mask(d), s_ptr, m);
        if (slot_op(d) == COUNT) {
          thread_slot<COUNT>(t, s_acc, p, m, x);
          continue;
        }
        column_f32<VEC, NB>(slot_value(d), cur, s_ptr, s_f64, nM, r, x);
        switch (slot_op(d)) {
          case SUM: thread_slot<SUM>(t, s_acc, p, m, x); break;
          case MIN: thread_slot<MIN>(t, s_acc, p, m, x); break;
          default: thread_slot<MAX>(t, s_acc, p, m, x); break;
        }
      }
    } else {
      find_peers(t, lane);
      for (int p = 0; p < A; ++p) {
        const int d = s_slot[p];
        float x[ROWS] = {};
        if (slot_op(d) != COUNT)
          column_f32<VEC, NB>(slot_value(d), cur, s_ptr, s_f64, nM, r, x);
        shared_slot(t, s_acc, s_ptr, p, d, x, A, lane);
      }
    }
    cur = nxt;
  }

  // merge the block's copies into the outputs, one update per (g, a)
  __syncthreads();
  if constexpr (S == THREAD) {
    for (int j = warp; j < GA; j += WARPS) {  // warp-uniform
      const int p = j % A, op = slot_op(s_slot[p]);
      const int o = (j / A) * A + s_out[p];
      const unsigned* w = s_acc + j * BLOCK;
      if (op == COUNT) {
        int c = 0;
#pragma unroll
        for (int i = 0; i < BLOCK; i += 32) c += (int)w[i + lane];
        c = __reduce_add_sync(FULL, c);
        if (lane == 0 && c) atomicAdd(&a.cnt[o], c);
        continue;
      }
      float v = identity(op);
#pragma unroll
      for (int i = 0; i < BLOCK; i += 32)
        v = combine(op, v, __uint_as_float(w[i + lane]));
      v = warp_reduce(op, v);
      if (lane == 0) fold(op, &a.acc[o], v);
    }
  } else {
    for (int j = tid; j < GA; j += BLOCK) {
      const int p = j % A, op = slot_op(s_slot[p]);
      const int o = (j / A) * A + s_out[p];
      if (op == COUNT) {
        if (s_acc[j]) atomicAdd(&a.cnt[o], (int)s_acc[j]);
      } else {
        fold(op, &a.acc[o], __uint_as_float(s_acc[j]));
      }
    }
  }
}

template <int S, bool VEC, int NB = WIDE>
int launch(const Args& a, int smem_bytes, cudaStream_t s) {
  void (*kernel)(Args) = groupagg_kernel<S, VEC, NB>;
  cudaError_t e;
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, BLOCK, smem_bytes)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) per_sm = 1;
  const long long tile = (long long)BLOCK * ROWS;
  long long grid = (a.n + tile - 1) / tile;
  if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  if (grid < 1) grid = 1;
  kernel<<<(unsigned)grid, BLOCK, smem_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch. The caller
// initialises acc to the identities (0, or +/-inf in MIN/MAX columns)
// and cnt to 0 and builds the plan (layout above). vec: every pointer
// is aligned for the vector loads (gid and value columns to 16 bytes,
// sel and masks to 4). Blocks of at most NARROW slots (THREAD only: the
// other layout needs more) load NARROW columns ahead instead of WIDE.
// The launch sizes the layout's shared memory itself.
extern "C" int groupagg_launch(const void* gid, const void* sel,
                               const void* plan, void* acc, void* cnt,
                               long long n, int G, int A, int nM, int nV,
                               int strategy, int vec, void* stream) {
  Args a;
  a.gid = static_cast<const int32_t*>(gid);
  a.sel = static_cast<const uint8_t*>(sel);
  a.plan = static_cast<const long long*>(plan);
  a.acc = static_cast<float*>(acc);
  a.cnt = static_cast<int32_t*>(cnt);
  a.n = n;
  a.G = G;
  a.A = A;
  a.nM = nM;
  a.nV = nV;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the plan's descriptors, then the accumulator copies of G * A words
  const int copies = strategy == THREAD ? BLOCK : 1;
  const int smem_bytes = ((8 * (nM + nV) + 4 * (2 * A + nV) + 15) & ~15) +
                         4 * G * A * copies;
  const bool narrow = A <= NARROW;
  switch (strategy * 2 + (vec ? 1 : 0)) {
    case 0:
      return narrow ? launch<THREAD, false, NARROW>(a, smem_bytes, s)
                    : launch<THREAD, false>(a, smem_bytes, s);
    case 1:
      return narrow ? launch<THREAD, true, NARROW>(a, smem_bytes, s)
                    : launch<THREAD, true>(a, smem_bytes, s);
    case 2: return launch<CTA, false>(a, smem_bytes, s);
    case 3: return launch<CTA, true>(a, smem_bytes, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* groupagg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
