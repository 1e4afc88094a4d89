// One-pass dense grouped aggregation for Hopper (sm_90a).
//
// Replaces cockroach_tpu/ops/pallas/groupagg_large.py:large_group_aggregate
// (the TPU kernel that folds each row block into a VMEM tile with a
// one_hot(gid)^T @ mat product on the MXU). That product does O(n * G)
// work to add n rows into G groups; on the card each row is instead
// added into its own group with an atomic, O(n) work in all.
//
// Output contract (unchanged from the TPU kernel, so the caller's limb
// recombination is the same):
//   acc_f  f32[nf, G]: rows [0, n_mat_f) float sums of the f32 columns,
//                      then one MIN or MAX row per mm column;
//   acc_i  i32[ni, G]: rows [0, n_mat_i) integer sums of the integer-
//                      valued columns, then (want_rep) the REPMIN row:
//                      the smallest selected row id of the group, or n.
// Rows whose gid lies outside [0, G) contribute nothing. Only REPMIN
// reads `sel`: the caller pre-masks the sum columns to 0 and the MIN/MAX
// columns to their +/-inf identities.
//
// Bound: device-memory bytes. Each row is read once:
// n * (4 * n_mat + 4 * n_mm + 4 + 1) bytes, and the work per byte is a
// few integer and atomic operations.
//
// Design (a simple one; making it fast is later work):
// - a grid-stride loop over tiles of ROWS * blockDim rows; a thread
//   keeps the gid of its ROWS rows in registers and walks the columns
//   outermost, so each column's pointer (from a device array of column
//   pointers: the columns are read in place, never stacked into one
//   matrix) is loaded once per ROWS rows and the ROWS value loads are
//   independent and coalesced across the warp;
// - when (nf + ni) * G * 4 bytes fit in shared memory, each CTA keeps
//   private accumulators there and flushes them with global atomics at
//   the end; otherwise the atomics go straight to global memory;
// - integer columns accumulate in int32 from __float2int_rn(value):
//   order-independent and bit-exact (wrapping like the caller's i32);
// - f32 columns use atomicAdd (their order varies run to run);
// - MIN/MAX use the ordered-int view of the float: atomicMin/atomicMax
//   on the int bits when the sign bit is clear and the reversed unsigned
//   order when it is set; a NaN is written as a canonical NaN that both
//   orders keep (see atomic_min_f32);
// - REPMIN is atomicMin on the row id;
// - zero addends and identity MIN/MAX values are skipped, which takes
//   the pre-masked rows out of the atomic traffic.
// With few groups (TPC-H Q1: G = 12) all threads of a CTA contend for a
// handful of shared-memory words per column; a warp-level pre-reduction
// is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const int32_t* gid;
  const uint8_t* sel;
  // n_mat + n_mm device pointers to [n] columns: the f sum columns,
  // then the i sum columns, then the MIN/MAX columns
  const float* const* cols;
  float* acc_f;       // [nf, G]
  int32_t* acc_i;     // [ni, G]
  long long n;
  int G;
  int n_mat_f;
  int n_mat_i;
  int n_mm;
  unsigned mm_max_mask;  // bit r set: mm column r is a MAX, else MIN
  int want_rep;
  int nf;
  int ni;
};

// rows per thread per tile: independent loads in flight per column
constexpr int ROWS = 4;

__device__ __forceinline__ const float* column(const Args& a, int c) {
  return reinterpret_cast<const float*>(
      __ldg(reinterpret_cast<const unsigned long long*>(a.cols) + c));
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }
__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Ordered-int float MIN/MAX. A float whose sign bit is clear orders like
// its bits as a signed int, one whose sign bit is set (-0.0 included)
// reversed as unsigned. A NaN is written as a canonical NaN that both
// orders keep: 0xffc00000 under MIN (a negative int, and above -inf's
// bits as unsigned), 0x7fc00000 under MAX (above +inf's bits as int, and
// below every sign-set bit pattern as unsigned). So a group with a NaN
// ends NaN, as jnp.min / jnp.max give.
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

__device__ __forceinline__ bool is_max(const Args& a, int r) {
  return (a.mm_max_mask >> r) & 1u;
}

// Fold one mm value into *p, skipping the identity.
__device__ __forceinline__ void fold_mm(const Args& a, int r, float* p,
                                        float v) {
  if (is_max(a, r)) {
    if (v != neg_inf()) atomic_max_f32(p, v);
  } else {
    if (v != pos_inf()) atomic_min_f32(p, v);
  }
}

template <bool SMEM>
__global__ void groupagg_large_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = a.G;
  float* f_acc = a.acc_f;
  int32_t* i_acc = a.acc_i;
  if (SMEM) {
    f_acc = reinterpret_cast<float*>(smem_raw);
    i_acc = reinterpret_cast<int32_t*>(smem_raw) + (size_t)a.nf * G;
    for (int idx = threadIdx.x; idx < a.nf * G; idx += blockDim.x) {
      const int r = idx / G - a.n_mat_f;
      float v = 0.0f;
      if (r >= 0 && r < a.n_mm) v = is_max(a, r) ? neg_inf() : pos_inf();
      f_acc[idx] = v;
    }
    for (int idx = threadIdx.x; idx < a.ni * G; idx += blockDim.x) {
      const bool rep_row = a.want_rep && idx / G == a.n_mat_i;
      i_acc[idx] = rep_row ? (int32_t)a.n : 0;
    }
    __syncthreads();
  }

  const long long tile = (long long)blockDim.x * ROWS;
  for (long long base = (long long)blockIdx.x * tile; base < a.n;
       base += (long long)gridDim.x * tile) {
    long long row[ROWS];
    int g[ROWS];  // -1: past n or gid outside [0, G)
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
      row[k] = base + (long long)k * blockDim.x + threadIdx.x;
      g[k] = -1;
      if (row[k] < a.n) {
        const int gk = __ldg(&a.gid[row[k]]);
        if (gk >= 0 && gk < G) g[k] = gk;
      }
    }
    for (int c = 0; c < a.n_mat_f; ++c) {
      const float* col = column(a, c);
      float v[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        v[k] = g[k] >= 0 ? __ldg(&col[row[k]]) : 0.0f;
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (v[k] != 0.0f) atomicAdd(&f_acc[(size_t)c * G + g[k]], v[k]);
    }
    for (int c = 0; c < a.n_mat_i; ++c) {
      const float* col = column(a, a.n_mat_f + c);
      int v[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        v[k] = g[k] >= 0 ? __float2int_rn(__ldg(&col[row[k]])) : 0;
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (v[k] != 0) atomicAdd(&i_acc[(size_t)c * G + g[k]], v[k]);
    }
    for (int r = 0; r < a.n_mm; ++r) {
      const float* col = column(a, a.n_mat_f + a.n_mat_i + r);
      float* acc = &f_acc[(size_t)(a.n_mat_f + r) * G];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (g[k] >= 0) fold_mm(a, r, &acc[g[k]], __ldg(&col[row[k]]));
    }
    if (a.want_rep) {
      int32_t* rep = &i_acc[(size_t)a.n_mat_i * G];
#pragma unroll
      for (int k = 0; k < ROWS; ++k)
        if (g[k] >= 0 && __ldg(&a.sel[row[k]]))
          atomicMin(&rep[g[k]], (int)row[k]);
    }
  }

  if (SMEM) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < a.nf * G; idx += blockDim.x) {
      const int r = idx / G - a.n_mat_f;
      const float v = f_acc[idx];
      if (r < 0) {
        if (v != 0.0f) atomicAdd(&a.acc_f[idx], v);
      } else if (r < a.n_mm) {
        fold_mm(a, r, &a.acc_f[idx], v);
      }
    }
    for (int idx = threadIdx.x; idx < a.ni * G; idx += blockDim.x) {
      const int32_t v = i_acc[idx];
      if (a.want_rep && idx / G == a.n_mat_i) {
        if (v < a.n) atomicMin(&a.acc_i[idx], v);
      } else if (v != 0) {
        atomicAdd(&a.acc_i[idx], v);
      }
    }
  }
}

template <bool SMEM>
cudaError_t launch(const Args& a, int block, int smem_bytes,
                   cudaStream_t stream) {
  cudaError_t e;
  if (SMEM && smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(groupagg_large_kernel<SMEM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return e;
  }
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, groupagg_large_kernel<SMEM>, block, smem_bytes)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) per_sm = 1;
  long long grid = (a.n + (long long)block * ROWS - 1) / ((long long)block * ROWS);
  if (grid > (long long)sms * per_sm) grid = (long long)sms * per_sm;
  if (grid < 1) grid = 1;
  groupagg_large_kernel<SMEM><<<(unsigned)grid, block, smem_bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch. smem_bytes
// > 0 selects the shared-memory accumulators (the caller sizes it as
// (nf + ni) * G * 4). The caller initialises acc_f / acc_i to the
// identities: 0 for sums, +/-inf for MIN/MAX rows, n for REPMIN.
extern "C" int groupagg_large_launch(
    const void* gid, const void* sel, const void* cols,
    void* acc_f, void* acc_i, long long n, int G, int n_mat_f, int n_mat_i,
    int n_mm, unsigned mm_max_mask, int want_rep, int nf, int ni,
    int smem_bytes, void* stream) {
  Args a;
  a.gid = static_cast<const int32_t*>(gid);
  a.sel = static_cast<const uint8_t*>(sel);
  a.cols = static_cast<const float* const*>(cols);
  a.acc_f = static_cast<float*>(acc_f);
  a.acc_i = static_cast<int32_t*>(acc_i);
  a.n = n;
  a.G = G;
  a.n_mat_f = n_mat_f;
  a.n_mat_i = n_mat_i;
  a.n_mm = n_mm;
  a.mm_max_mask = mm_max_mask;
  a.want_rep = want_rep;
  a.nf = nf;
  a.ni = ni;
  const int block = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (smem_bytes > 0) return (int)launch<true>(a, block, smem_bytes, s);
  return (int)launch<false>(a, block, 0, s);
}

extern "C" const char* groupagg_large_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
