// Batched small Cholesky factorization and Cholesky solve (kernels K3a and
// K3b), one warp per lane.
//
// Replaces the Pallas TPU kernels srbx/ops/pallas_linalg.py::_chol_kernel
// (K3a, entered through pallas_linalg.cholesky) and ::_cho_solve_kernel (K3b,
// pallas_linalg.cho_solve). The step-fused batched IPM
// (qp_batch.solve with backend="pallas") calls them on every iteration:
//   * K3a: M = L L' of M = P + G'WG + delta_p I (k = n: 41, 17 or 13) and of
//     the Schur complement S = A M^-1 A' + delta_d I (k = me: 28, 4 or 1);
//   * K3b: (L L') X = R for R = A' (M^-1 A': k 41, r 28) and for single
//     right-hand sides (r = 1).
//
// Layout: batch-leading, as the IPM's batched products leave the operands:
// M and L (B, k, k), R and X (B, k, r), row-major and contiguous. A lane's
// operands are one contiguous run, read and written coalesced by its warp;
// any B is taken (no padding lanes, no lanes-last transpose).
//
// What bounds it on an H100: latency of the sequential column steps, not
// bytes. At B = 131072, k = 41 in f32 the factorization needs M's lower
// triangle read once and L written once (1.33 GB, 0.40 ms at 3.35 TB/s) and
// does k^3/3 operations per lane (3 GFLOP), but each lane's k column steps
// depend on each other.
// The design keeps the lane's matrix (and right-hand sides) in shared memory
// (k = 41: 6.7 KB f32 / 13.4 KB f64 for K3a, 11.3 / 22.6 KB at r = 28 for
// K3b), spreads each column step over the warp's 32 threads, and runs up to
// four lanes per block so that several warps share an SM's schedulers. K3a
// gives each thread rows of the trailing triangle; K3b gives each thread a
// column of the right-hand sides and, for r < 32, a fixed group of rows, so
// its loops carry no integer division of indices (spreading flattened
// (row, column) entries instead costs a division per entry).
//
// Semantics kept from the TPU kernels (they change numbers):
//   * column j of the factorization is divided by sqrt(a_jj), its diagonal
//     entry included (L_jj = a_jj / sqrt(a_jj)); the substitutions divide by
//     L_jj. No stored reciprocals.
//   * the square root is not guarded: a lane whose matrix is not positive
//     definite comes out non-finite, in that lane only (the IPM's NaN freeze
//     relies on it);
//   * only the lower triangles of M (K3a) and of L (K3b) are used, and the
//     strict upper triangle of L is written as exact zeros. Both kernels
//     still copy all k x k entries into shared memory in one flat,
//     coalesced loop: on an H100, copying only the lower triangle (row by
//     row, or flat with the upper entries masked) made each kernel 6-52 %
//     slower (scripts/torch_time_k3.py). A lane's result does not depend on
//     its upper triangles.
// Every update is a rounded product followed by a rounded subtraction
// (__fmul_rn / __fsub_rn: no fused multiply-add), so a lane's result is
// bitwise the one of the plain PyTorch column loop
// (srbx_torch/ops/pallas_linalg.py::batch_cholesky_plain and
// batch_cho_solve_plain).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxK = 64;
constexpr int kMaxR = 64;
constexpr int kMaxWarpsPerBlock = 4;
constexpr size_t kMaxSmem = 227 * 1024;

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
cholesky_kernel(const T* __restrict__ M, T* __restrict__ L_out, long long batch, int k) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x / kWarp;
  const int t = threadIdx.x % kWarp;
  const long long lane = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (lane >= batch) return;  // whole warps leave together

  T* a = reinterpret_cast<T*>(smem_raw) + (size_t)warp * k * k;
  const T* m = M + lane * k * k;
  for (int e = t; e < k * k; e += kWarp) a[e] = m[e];
  __syncwarp();

  for (int j = 0; j < k; ++j) {
    const T d = dev_sqrt(a[j * k + j]);
    __syncwarp();
    for (int i = j + t; i < k; i += kWarp) a[i * k + j] = a[i * k + j] / d;
    __syncwarp();
    // right-looking update of the lower trailing triangle, one row a thread
    for (int i = j + 1 + t; i < k; i += kWarp) {
      const T lij = a[i * k + j];
      for (int c = j + 1; c <= i; ++c)
        a[i * k + c] = sub_rn(a[i * k + c], mul_rn(lij, a[c * k + j]));
    }
    __syncwarp();
  }

  T* l = L_out + lane * k * k;
  for (int e = t; e < k * k; e += kWarp) l[e] = (e % k <= e / k) ? a[e] : T(0);
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kMaxWarpsPerBlock)
cho_solve_kernel(const T* __restrict__ L, const T* __restrict__ R, T* __restrict__ X_out,
                 long long batch, int k, int r) {
  extern __shared__ unsigned char smem_raw[];
  const int warp = threadIdx.x / kWarp;
  const int t = threadIdx.x % kWarp;
  const long long lane = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (lane >= batch) return;

  T* l = reinterpret_cast<T*>(smem_raw) + (size_t)warp * k * (k + r);
  T* x = l + k * k;
  const T* lg = L + lane * k * k;
  const T* rg = R + lane * k * r;
  for (int e = t; e < k * k; e += kWarp) l[e] = lg[e];
  for (int e = t; e < k * r; e += kWarp) x[e] = rg[e];
  __syncwarp();

  // Work split: each thread owns one column c of X and, where r < 32, one
  // of G = 32 / r groups of rows (i = g, g + G, ...); for r >= 32 a thread
  // owns the columns t, t + 32, ... and every row. No index division inside
  // the loops.
  const int groups = r >= kWarp ? 1 : kWarp / r;
  const int g = r >= kWarp ? 0 : t / r;
  const int c0 = r >= kWarp ? t : t % r;
  const int cstep = r >= kWarp ? kWarp : r;  // r < 32: one column a thread
  const bool active = r >= kWarp || t < groups * r;

  // forward substitution L Y = R: row j is final once divided by L_jj, then
  // every later row drops its multiple of it
  for (int j = 0; j < k; ++j) {
    const T ljj = l[j * k + j];
    if (active && g == 0)
      for (int c = c0; c < r; c += cstep) x[j * r + c] = x[j * r + c] / ljj;
    __syncwarp();
    if (active)
      for (int c = c0; c < r; c += cstep) {
        const T yj = x[j * r + c];
        for (int i = j + 1 + g; i < k; i += groups)
          x[i * r + c] = sub_rn(x[i * r + c], mul_rn(l[i * k + j], yj));
      }
    __syncwarp();
  }
  // back substitution L' X = Y
  for (int j = k - 1; j >= 0; --j) {
    const T ljj = l[j * k + j];
    if (active && g == 0)
      for (int c = c0; c < r; c += cstep) x[j * r + c] = x[j * r + c] / ljj;
    __syncwarp();
    if (active)
      for (int c = c0; c < r; c += cstep) {
        const T xj = x[j * r + c];
        for (int i = g; i < j; i += groups)
          x[i * r + c] = sub_rn(x[i * r + c], mul_rn(l[j * k + i], xj));
      }
    __syncwarp();
  }

  T* xg = X_out + lane * k * r;
  for (int e = t; e < k * r; e += kWarp) xg[e] = x[e];
}

// Lanes per block: up to four, as many as fit the shared memory.
int warps_per_block(size_t lane_bytes) {
  const size_t fit = kMaxSmem / lane_bytes;
  return fit < (size_t)kMaxWarpsPerBlock ? (int)fit : kMaxWarpsPerBlock;
}

template <typename T>
int launch_cholesky(const void* M, void* L, long long batch, int k, void* stream) {
  if (k < 1 || k > kMaxK) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const size_t lane_bytes = sizeof(T) * (size_t)k * k;
  const int warps = warps_per_block(lane_bytes);
  const size_t smem = lane_bytes * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cholesky_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (batch + warps - 1) / warps;
  cholesky_kernel<T><<<(unsigned)blocks, kWarp * warps, smem, (cudaStream_t)stream>>>(
      (const T*)M, (T*)L, batch, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cho_solve(const void* L, const void* R, void* X, long long batch, int k, int r,
                     void* stream) {
  if (k < 1 || k > kMaxK || r < 1 || r > kMaxR) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const size_t lane_bytes = sizeof(T) * (size_t)k * (k + r);
  const int warps = warps_per_block(lane_bytes);
  const size_t smem = lane_bytes * warps;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cho_solve_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (batch + warps - 1) / warps;
  cho_solve_kernel<T><<<(unsigned)blocks, kWarp * warps, smem, (cudaStream_t)stream>>>(
      (const T*)L, (const T*)R, (T*)X, batch, k, r);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes.
extern "C" int srbx_pallas_cholesky_f32(const void* M, void* L, long long batch, int k,
                                        void* stream) {
  return launch_cholesky<float>(M, L, batch, k, stream);
}

extern "C" int srbx_pallas_cholesky_f64(const void* M, void* L, long long batch, int k,
                                        void* stream) {
  return launch_cholesky<double>(M, L, batch, k, stream);
}

extern "C" int srbx_pallas_cho_solve_f32(const void* L, const void* R, void* X, long long batch,
                                         int k, int r, void* stream) {
  return launch_cho_solve<float>(L, R, X, batch, k, r, stream);
}

extern "C" int srbx_pallas_cho_solve_f64(const void* L, const void* R, void* X, long long batch,
                                         int k, int r, void* stream) {
  return launch_cho_solve<double>(L, R, X, batch, k, r, stream);
}

namespace {

// Warps resident per SM for a launch of K3a (r = 0) or K3b at (k, r).
template <typename T>
int resident_warps(int k, int r) {
  const size_t lane_bytes = sizeof(T) * (size_t)k * (k + r);
  const int warps = warps_per_block(lane_bytes);
  const size_t smem = lane_bytes * warps;
  int blocks = 0;
  cudaError_t err = cudaSuccess;
  if (r == 0) {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(cholesky_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cholesky_kernel<T>,
                                                          kWarp * warps, smem);
  } else {
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(cho_solve_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, cho_solve_kernel<T>,
                                                          kWarp * warps, smem);
  }
  return err == cudaSuccess ? blocks * warps : -1;
}

}  // namespace

// The same in f32 or, with f64 != 0, double; -1 on a shape the kernels
// refuse.
extern "C" int srbx_pallas_resident_warps(int f64, int k, int r) {
  if (k < 1 || k > kMaxK || r < 0 || r > kMaxR) return -1;
  return f64 ? resident_warps<double>(k, r) : resident_warps<float>(k, r);
}
