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
// Bound: device-memory bytes. Each row is read once: gid 4 B, sel 1 B,
// and per distinct slot column its value (4 or 8 B) and mask (1 B). The
// work per byte is a handful of compares, shuffles and atomics.
//
// Design (a simple one; making it fast is later work):
// - a grid-stride loop over tiles of ROWS * blockDim rows; each thread
//   keeps the group id of its ROWS rows in registers (-1 for a row that
//   is past n, not selected or out of range) and walks the slots
//   outermost, so the ROWS loads of a slot are independent and coalesced;
// - value and mask columns are read in place through a device array of
//   column pointers (float32 or float64, rounded to f32 in registers);
// - each CTA keeps [G, A] f32 and i32 accumulators in shared memory
//   (G * A * 8 bytes) and merges them into the outputs with global
//   atomics at the end;
// - contention: when every selected row of a warp's 32-row slice falls
//   in one group (always for G = 1, TPC-H Q6), the warp reduces each
//   slot with shuffles first (counts with a ballot) and one lane makes
//   the shared atomic; otherwise each lane makes its own;
// - CUDA has no float atomicMin/atomicMax that keeps a NaN, so MIN/MAX
//   fold with a compare-and-swap loop on the bits through a NaN-sticky
//   min/max.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Op { COUNT = 0, SUM = 1, MIN = 2, MAX = 3 };

struct Args {
  const int32_t* gid;
  const uint8_t* sel;
  // [3 * A] int64: value column pointers, mask column pointers, then one
  // descriptor per slot (bits 0-1 the op, bit 2 set for a float64 column)
  const long long* slots;
  float* acc;    // [G, A]
  int32_t* cnt;  // [G, A]
  long long n;
  int G;
  int A;
};

// rows per thread per tile: independent loads in flight per slot
constexpr int ROWS = 4;
constexpr unsigned FULL = 0xffffffffu;

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
// are skipped, which keeps masked rows out of the atomic traffic.
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

__device__ __forceinline__ const void* slot_ptr(const Args& a, int i) {
  return reinterpret_cast<const void*>(__ldg(a.slots + i));
}

__global__ void groupagg_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = a.G, A = a.A, GA = G * A;
  float* s_acc = reinterpret_cast<float*>(smem_raw);
  int32_t* s_cnt = reinterpret_cast<int32_t*>(s_acc + GA);
  int* s_desc = s_cnt + GA;
  for (int s = threadIdx.x; s < A; s += blockDim.x)
    s_desc[s] = (int)__ldg(a.slots + 2 * A + s);
  __syncthreads();
  for (int idx = threadIdx.x; idx < GA; idx += blockDim.x) {
    s_acc[idx] = identity(s_desc[idx % A] & 3);
    s_cnt[idx] = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockDim.x * ROWS;
  // the loop bound is the same for every thread of the block, so whole
  // warps stay converged for the *_sync intrinsics below
  for (long long base = (long long)blockIdx.x * tile; base < a.n;
       base += (long long)gridDim.x * tile) {
    long long row[ROWS];
    int g[ROWS];     // -1: past n, not selected, or gid outside [0, G)
    int wg[ROWS];    // the warp's one group, -1 for none, -2 for several
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      row[k] = base + (long long)k * blockDim.x + threadIdx.x;
      g[k] = -1;
      if (row[k] < a.n && __ldg(&a.sel[row[k]])) {
        const int gk = __ldg(&a.gid[row[k]]);
        if (gk >= 0 && gk < G) g[k] = gk;
      }
      const int hi = __reduce_max_sync(FULL, g[k]);
      const int lo = (int)__reduce_min_sync(
          FULL, g[k] >= 0 ? (unsigned)g[k] : 0xffffffffu);
      wg[k] = hi < 0 ? -1 : (lo == hi ? hi : -2);
    }
    for (int s = 0; s < A; ++s) {
      const int desc = s_desc[s];
      const int op = desc & 3;
      const uint8_t* mk = static_cast<const uint8_t*>(slot_ptr(a, A + s));
      bool m[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        m[k] = g[k] >= 0 && __ldg(&mk[row[k]]);
      if (op == COUNT) {
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          if (wg[k] == -1) continue;
          if (wg[k] >= 0) {
            const int c = __popc(__ballot_sync(FULL, m[k]));
            if (lane == 0 && c) atomicAdd(&s_cnt[wg[k] * A + s], c);
          } else if (m[k]) {
            atomicAdd(&s_cnt[g[k] * A + s], 1);
          }
        }
        continue;
      }
      const void* vp = slot_ptr(a, s);
      float v[ROWS];
      if (desc & 4) {
        const double* col = static_cast<const double*>(vp);
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
          v[k] = m[k] ? __double2float_rn(__ldg(&col[row[k]])) : identity(op);
      } else {
        const float* col = static_cast<const float*>(vp);
#pragma unroll
        for (int k = 0; k < ROWS; ++k)
          v[k] = m[k] ? __ldg(&col[row[k]]) : identity(op);
      }
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (wg[k] == -1) continue;
        if (wg[k] >= 0) {
          const float r = warp_reduce(op, v[k]);
          if (lane == 0) fold(op, &s_acc[wg[k] * A + s], r);
        } else if (m[k]) {
          fold(op, &s_acc[g[k] * A + s], v[k]);
        }
      }
    }
  }

  __syncthreads();
  for (int idx = threadIdx.x; idx < GA; idx += blockDim.x) {
    const int op = s_desc[idx % A] & 3;
    if (op == COUNT) {
      if (s_cnt[idx]) atomicAdd(&a.cnt[idx], s_cnt[idx]);
    } else {
      fold(op, &a.acc[idx], s_acc[idx]);
    }
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch. The caller
// initialises acc to the identities (0, or +/-inf in MIN/MAX columns)
// and cnt to 0, and sizes smem_bytes as G * A * 8 + A * 4.
extern "C" int groupagg_launch(const void* gid, const void* sel,
                               const void* slots, void* acc, void* cnt,
                               long long n, int G, int A, int smem_bytes,
                               void* stream) {
  Args a;
  a.gid = static_cast<const int32_t*>(gid);
  a.sel = static_cast<const uint8_t*>(sel);
  a.slots = static_cast<const long long*>(slots);
  a.acc = static_cast<float*>(acc);
  a.cnt = static_cast<int32_t*>(cnt);
  a.n = n;
  a.G = G;
  a.A = A;
  const int block = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(groupagg_kernel,
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
           &per_sm, groupagg_kernel, block, smem_bytes)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) per_sm = 1;
  const long long tile = (long long)block * ROWS;
  long long grid = (n + tile - 1) / tile;
  if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  if (grid < 1) grid = 1;
  groupagg_kernel<<<(unsigned)grid, block, smem_bytes, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* groupagg_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
