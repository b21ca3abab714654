// Batched small SPD solve and inverse (kernels K2a and K2b), one warp per
// lane.
//
// Replaces the Pallas TPU kernels srbx/ops/spd.py::_solve_kernel (K2a,
// entered through spd.solve) and ::_inv_kernel (K2b, spd.inverse). Per lane:
// D = L L' by Cholesky, then (L L') X = B by forward and back substitution,
// with B the caller's right-hand sides (K2a) or the identity (K2b). On the
// whole-body path k = 18 (the mass matrix; K2a with r = 1, K2b with r = 18)
// and k = 12 (the swing operational-space matrix, K2b).
//
// Layout: batch-leading, as at the JAX package's API: D (B, k, k), B and X
// (B, k, r), row-major and contiguous. A lane's operands are one contiguous
// run, so its warp reads and writes them coalesced; nothing is transposed to
// lanes-last, and any B is taken (no identity padding lanes).
//
// What bounds it on an H100: neither bytes nor operations, but latency. At
// B = 4096, k = 18 the whole inverse moves 21 MB in f64 (D read once, D^-1
// written once: 6 us at 3.35 TB/s) and does about 0.06 GFLOP, while each
// lane's Cholesky is k dependent column steps. The design keeps a lane's D
// and X in shared memory (k*(k+r) values), spreads each column step over the
// warp's threads (one row each), and runs the substitution one right-hand
// side per thread where there are several (the inverse), or one row per
// thread where there is one (the physics solve). Four lanes per block.
//
// Arithmetic kept from the TPU kernel: column j is divided by sqrt(a_jj),
// its diagonal entry included (L_jj = a_jj / sqrt(a_jj)), and the
// substitutions divide by L_jj. Only the lower triangle is updated (the TPU
// kernel also updates the stale upper one, which nothing reads).

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxK = 32;
constexpr int kMaxR = 32;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }

// In-place lower Cholesky of the k x k row-major L in shared memory.
template <typename T>
__device__ __forceinline__ void cholesky(T* L, int k, int t) {
  for (int j = 0; j < k; ++j) {
    const T d = dev_sqrt(L[j * k + j]);
    __syncwarp();
    const int i = j + t;
    if (i < k) L[i * k + j] = L[i * k + j] / d;
    __syncwarp();
    const int row = j + 1 + t;
    if (row < k) {
      const T lij = L[row * k + j];
      for (int m = j + 1; m <= row; ++m) L[row * k + m] -= lij * L[m * k + j];
    }
    __syncwarp();
  }
}

// (L L') X = X in place, X (k, r) row-major in shared memory.
template <typename T>
__device__ __forceinline__ void substitute(const T* L, T* X, int k, int r, int t) {
  if (r > 1) {
    // one right-hand side per thread: no synchronisation inside
    for (int c = t; c < r; c += kWarp) {
      for (int j = 0; j < k; ++j) {
        const T y = X[j * r + c] / L[j * k + j];
        X[j * r + c] = y;
        for (int i = j + 1; i < k; ++i) X[i * r + c] -= L[i * k + j] * y;
      }
      for (int j = k - 1; j >= 0; --j) {
        const T x = X[j * r + c] / L[j * k + j];
        X[j * r + c] = x;
        for (int i = 0; i < j; ++i) X[i * r + c] -= L[j * k + i] * x;
      }
    }
    __syncwarp();
    return;
  }
  // one right-hand side: one row per thread at every step
  for (int j = 0; j < k; ++j) {
    const T y = X[j] / L[j * k + j];
    __syncwarp();
    if (t == 0) X[j] = y;
    const int i = j + 1 + t;
    if (i < k) X[i] -= L[i * k + j] * y;
    __syncwarp();
  }
  for (int j = k - 1; j >= 0; --j) {
    const T x = X[j] / L[j * k + j];
    __syncwarp();
    if (t == 0) X[j] = x;
    if (t < j) X[t] -= L[j * k + t] * x;
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
spd_kernel(const T* __restrict__ D, const T* __restrict__ Bm, T* __restrict__ X_out,
           long long batch, int k, int r, int identity_rhs) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int warp = threadIdx.x / kWarp;
  const int t = threadIdx.x % kWarp;
  const long long lane = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (lane >= batch) return;  // whole warps leave together

  T* L = smem + (long long)warp * k * (k + r);
  T* X = L + k * k;
  const T* d = D + lane * k * k;
  for (int e = t; e < k * k; e += kWarp) L[e] = d[e];
  if (identity_rhs) {
    for (int e = t; e < k * r; e += kWarp) X[e] = (e / r == e % r) ? T(1) : T(0);
  } else {
    const T* b = Bm + lane * k * r;
    for (int e = t; e < k * r; e += kWarp) X[e] = b[e];
  }
  __syncwarp();

  cholesky<T>(L, k, t);
  substitute<T>(L, X, k, r, t);

  T* x = X_out + lane * k * r;
  for (int e = t; e < k * r; e += kWarp) x[e] = X[e];
}

template <typename T>
int launch(const void* D, const void* Bm, void* X, long long batch, int k, int r,
           int identity_rhs, void* stream) {
  if (k < 1 || k > kMaxK || r < 1 || r > kMaxR) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  const size_t smem = sizeof(T) * (size_t)kWarpsPerBlock * k * (k + r);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        spd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  spd_kernel<T><<<(unsigned)blocks, kWarp * kWarpsPerBlock, smem, (cudaStream_t)stream>>>(
      (const T*)D, (const T*)Bm, (T*)X, batch, k, r, identity_rhs);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes.
extern "C" int srbx_spd_solve_f32(const void* D, const void* Bm, void* X, long long batch, int k,
                                  int r, void* stream) {
  return launch<float>(D, Bm, X, batch, k, r, 0, stream);
}

extern "C" int srbx_spd_solve_f64(const void* D, const void* Bm, void* X, long long batch, int k,
                                  int r, void* stream) {
  return launch<double>(D, Bm, X, batch, k, r, 0, stream);
}

extern "C" int srbx_spd_inverse_f32(const void* D, void* X, long long batch, int k, void* stream) {
  return launch<float>(D, nullptr, X, batch, k, k, 1, stream);
}

extern "C" int srbx_spd_inverse_f64(const void* D, void* X, long long batch, int k, void* stream) {
  return launch<double>(D, nullptr, X, batch, k, k, 1, stream);
}
