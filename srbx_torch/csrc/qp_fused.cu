// Fused Mehrotra predictor-corrector IPM, inequality-only form, one thread
// per lane.
//
// Replaces the Pallas TPU kernel srbx/ops/qp_fused.py::_make_kernel in its
// noeq form (entered through solve_lanes_last). Each lane solves
//     min 1/2 x'Px + c'x   s.t.  Gx <= h
// with n = N (13 on the NMPC path) and mi <= MAX_MI runtime inequality rows,
// from a least-squares cold start or a caller-given x0.
//
// Layout: every operand is lanes-last, (rows, cols, B) row-major, so thread t
// reads P[(i*N+j)*B + t]: the 32 threads of a warp read 32 neighbouring
// values, one coalesced transaction per matrix entry.
//
// What bounds it on an H100: device-memory traffic for G. At mi = 52 and
// B = 131072, G is 354 MB per solve in f32, far above the 50 MB L2, and the
// IPM re-reads it about 8 times an iteration (factor, two right-hand sides,
// two step directions, refinement, residuals). This first version keeps the
// per-lane state (M as a packed lower triangle, the iterates, the cached
// residuals) in registers and local memory and streams P, c, G and h from
// device memory on every use. Staging G in shared memory or fusing the
// passes is later work.
//
// Semantics kept from the TPU kernel (they change numbers):
//   * M = P + G' diag(w) G + delta I, factored in place with the diagonal
//     stored as 1/L_jj (IEEE 1/sqrt, no rsqrt);
//   * sigma = clip((mu_aff / max(mu, sigma_min))^3, 0, 1);
//   * the step-length sentinel finfo.max / 4;
//   * the least-squares cold start, skipped when has_x0;
//   * residuals rx, rz cached from one iteration's convergence test to the
//     next iteration's directions;
//   * the NaN freeze: a step with a non-finite iterate is not taken and the
//     lane is done;
//   * the OSQP-style relative residual test.
// Maxima and minima propagate NaN, as jnp.maximum does.
//
// Early exit is per lane: a thread stops when its lane is done. The TPU
// kernel stops when its whole tile is done and freezes done lanes until then,
// so x, z and s are the same; only stat[3] differs (the TPU stores the tile's
// iteration count, this kernel the lane's own). The maximum over lanes is the
// same under both.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kMaxMi = 64;
constexpr int kThreads = 128;
constexpr int kStatRows = 8;

template <typename T>
__device__ __forceinline__ T big_value();
template <>
__device__ __forceinline__ float big_value<float>() { return FLT_MAX / 4.0f; }
template <>
__device__ __forceinline__ double big_value<double>() { return DBL_MAX / 4.0; }

// NaN-propagating max / min (jnp.maximum / jnp.minimum semantics).
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T>
__device__ __forceinline__ T nmin(T a, T b) { return (a != a || a < b) ? a : b; }

__device__ __forceinline__ float dev_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double dev_abs(double v) { return fabs(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ bool dev_finite(float v) { return isfinite(v); }
__device__ __forceinline__ bool dev_finite(double v) { return isfinite(v); }

// Index of (i, j), j <= i, in a packed lower triangle.
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

template <typename T, int N>
struct Lane {
  // Operand pointers already offset to this lane; stride B between entries.
  const T* __restrict__ P;
  const T* __restrict__ c;
  const T* __restrict__ G;
  const T* __restrict__ h;
  long long B;
  int mi;

  __device__ __forceinline__ T p(int i, int j) const { return P[(long long)(i * N + j) * B]; }
  __device__ __forceinline__ T cv(int i) const { return c[(long long)i * B]; }
  __device__ __forceinline__ T hv(int r) const { return h[(long long)r * B]; }
  __device__ __forceinline__ void g_row(int r, T* gr) const {
    const T* row = G + (long long)r * N * B;
#pragma unroll
    for (int k = 0; k < N; ++k) gr[k] = row[(long long)k * B];
  }
};

// In-place lower Cholesky of packed M, diagonal stored as 1/L_jj.
template <typename T, int N>
__device__ __forceinline__ void cholesky(T* L) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T di = T(1) / dev_sqrt(L[tri(j, j)]);
    L[tri(j, j)] = di;
#pragma unroll
    for (int i = j + 1; i < N; ++i) L[tri(i, j)] *= di;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
#pragma unroll
      for (int k = j + 1; k <= i; ++k) L[tri(i, k)] -= L[tri(i, j)] * L[tri(k, j)];
    }
  }
}

// In-place solve (L L') x = b with L from cholesky().
template <typename T, int N>
__device__ __forceinline__ void cho_solve(const T* L, T* b) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const T yj = b[j] * L[tri(j, j)];
    b[j] = yj;
#pragma unroll
    for (int i = j + 1; i < N; ++i) b[i] -= L[tri(i, j)] * yj;
  }
#pragma unroll
  for (int j = N - 1; j >= 0; --j) {
    const T xj = b[j] * L[tri(j, j)];
    b[j] = xj;
#pragma unroll
    for (int i = 0; i < j; ++i) b[i] -= L[tri(j, i)] * xj;
  }
}

// M = P + dp I + G' diag(w) G, factored. w = z * sinv, or 1 when unit_w.
template <typename T, int N>
__device__ __forceinline__ void factor(const Lane<T, N>& op, const T* z, const T* sinv,
                                       bool unit_w, T dp, T* L) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) L[tri(i, j)] = op.p(i, j) + (i == j ? dp : T(0));
  }
  for (int r = 0; r < op.mi; ++r) {
    T gr[N];
    op.g_row(r, gr);
    const T wr = unit_w ? T(1) : z[r] * sinv[r];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T wgi = wr * gr[i];
#pragma unroll
      for (int j = 0; j <= i; ++j) L[tri(i, j)] += wgi * gr[j];
    }
  }
  cholesky<T, N>(L);
}

// dx = M^-1 r1, then `refine` rounds of refinement against the
// unregularised operator P + G' diag(w) G.
template <typename T, int N>
__device__ __forceinline__ void kkt_solve_refined(const Lane<T, N>& op, const T* L, const T* z,
                                                  const T* sinv, int refine, const T* r1, T* dx) {
#pragma unroll
  for (int k = 0; k < N; ++k) dx[k] = r1[k];
  cho_solve<T, N>(L, dx);
  for (int it = 0; it < refine; ++it) {
    T gt[N];
#pragma unroll
    for (int k = 0; k < N; ++k) gt[k] = T(0);
    for (int r = 0; r < op.mi; ++r) {
      T gr[N];
      op.g_row(r, gr);
      T gd = T(0);
#pragma unroll
      for (int k = 0; k < N; ++k) gd += gr[k] * dx[k];
      const T u = (z[r] * sinv[r]) * gd;
#pragma unroll
      for (int k = 0; k < N; ++k) gt[k] += gr[k] * u;
    }
    T t[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      T px = T(0);
#pragma unroll
      for (int l = 0; l < N; ++l) px += op.p(k, l) * dx[l];
      t[k] = r1[k] - (px + gt[k]);
    }
    cho_solve<T, N>(L, t);
#pragma unroll
    for (int k = 0; k < N; ++k) dx[k] += t[k];
  }
}

// ds = -rz - G dx, dz = (rc - z ds) * sinv.
template <typename T, int N>
__device__ __forceinline__ void step_dirs(const Lane<T, N>& op, const T* dx, const T* rz,
                                          const T* rc, const T* z, const T* sinv, T* ds, T* dz) {
  for (int r = 0; r < op.mi; ++r) {
    T gr[N];
    op.g_row(r, gr);
    T gd = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) gd += gr[k] * dx[k];
    ds[r] = -rz[r] - gd;
    dz[r] = (rc[r] - z[r] * ds[r]) * sinv[r];
  }
}

// r1 = -rx - G' (rc * sinv + w * rz).
template <typename T, int N>
__device__ __forceinline__ void rhs(const Lane<T, N>& op, const T* rx, const T* rz, const T* rc,
                                    const T* z, const T* sinv, T* r1) {
  T acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = T(0);
  for (int r = 0; r < op.mi; ++r) {
    T gr[N];
    op.g_row(r, gr);
    const T v = rc[r] * sinv[r] + (z[r] * sinv[r]) * rz[r];
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] += gr[k] * v;
  }
#pragma unroll
  for (int k = 0; k < N; ++k) r1[k] = -rx[k] - acc[k];
}

// Largest step in (0, 1] keeping v + a dv >= 0.
template <typename T>
__device__ __forceinline__ T step_len(const T* v, const T* dv, int m) {
  T lo = big_value<T>();
  for (int r = 0; r < m; ++r) {
    const T ratio = dv[r] < T(0) ? -v[r] / dv[r] : big_value<T>();
    lo = nmin(lo, ratio);
  }
  return nmin(T(1), lo);
}

// Residuals and the convergence test. With rx_out / rz_out set, the residual
// vectors are cached for the next iteration.
template <typename T, int N>
__device__ __forceinline__ bool conv_test(const Lane<T, N>& op, const T* x, const T* s, const T* z,
                                          T tol_res, T abstol, T* rx_out, T* rz_out, T* res_out,
                                          T* gap_out) {
  T gtz[N];
#pragma unroll
  for (int k = 0; k < N; ++k) gtz[k] = T(0);
  T prim = T(0), prim_res = T(0), gap = T(0);
  for (int r = 0; r < op.mi; ++r) {
    T gr[N];
    op.g_row(r, gr);
    T gx = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) gx += gr[k] * x[k];
#pragma unroll
    for (int k = 0; k < N; ++k) gtz[k] += gr[k] * z[r];
    const T hr = op.hv(r);
    const T rzr = gx + s[r] - hr;
    if (rz_out) rz_out[r] = rzr;
    prim = nmax(prim, nmax(dev_abs(gx), dev_abs(hr)));
    prim_res = nmax(prim_res, dev_abs(rzr));
    gap += s[r] * z[r];
  }
  T dual = T(0), rx_max = T(0), xpx = T(0), cx = T(0);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T px = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) px += op.p(k, l) * x[l];
    const T ck = op.cv(k);
    const T rxk = px + ck + gtz[k];
    if (rx_out) rx_out[k] = rxk;
    dual = nmax(dual, nmax(nmax(dev_abs(px), dev_abs(ck)), dev_abs(gtz[k])));
    rx_max = nmax(rx_max, dev_abs(rxk));
    xpx += x[k] * px;
    cx += ck * x[k];
  }
  const T res = nmax(rx_max / nmax(dual, T(1)), prim_res / nmax(prim, T(1)));
  const T obj = T(0.5) * xpx + cx;
  if (res_out) *res_out = res;
  if (gap_out) *gap_out = gap;
  return res <= tol_res && gap <= abstol * (T(1) + dev_abs(obj));
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
qp_fused_noeq_kernel(const T* __restrict__ P, const T* __restrict__ c, const T* __restrict__ G,
                     const T* __restrict__ h, const T* __restrict__ x0, T* __restrict__ x_out,
                     T* __restrict__ z_out, T* __restrict__ s_out, T* __restrict__ stat,
                     long long B, int mi, double abstol, double reltol, double reg_primal,
                     double sigma_min, double step_frac, int max_iters, int refine, int has_x0) {
  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;

  const Lane<T, N> op{P + lane, c + lane, G + lane, h + lane, B, mi};
  const T tol_res = T(abstol + reltol);
  const T tol_abs = T(abstol);
  const T dp = T(reg_primal);
  const T smin = T(sigma_min);
  const T sfrac = T(step_frac);
  const T mi_t = T(mi);

  T L[N * (N + 1) / 2];
  T x[N], rx[N], r1[N], dx[N];
  T s[kMaxMi], z[kMaxMi], sinv[kMaxMi], rz[kMaxMi], rc[kMaxMi], ds[kMaxMi], dz[kMaxMi];

  // ------------------------------ start ------------------------------ //
  if (has_x0) {
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = x0[lane + (long long)k * B];
  } else {
    factor<T, N>(op, z, sinv, true, T(1), L);
    T acc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = T(0);
    for (int r = 0; r < mi; ++r) {
      T gr[N];
      op.g_row(r, gr);
      const T hr = op.hv(r);
#pragma unroll
      for (int k = 0; k < N; ++k) acc[k] += gr[k] * hr;
    }
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = -op.cv(k) + acc[k];
    cho_solve<T, N>(L, x);
  }
  T s_min = big_value<T>();
  for (int r = 0; r < mi; ++r) {
    T gr[N];
    op.g_row(r, gr);
    T gx = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) gx += gr[k] * x[k];
    s[r] = op.hv(r) - gx;
    s_min = r == 0 ? s[r] : nmin(s_min, s[r]);
  }
  const T shift = nmax(T(0), T(-1.5) * s_min) + T(1);
  for (int r = 0; r < mi; ++r) {
    s[r] = s[r] + shift;
    z[r] = T(1);
  }
  conv_test<T, N>(op, x, s, z, tol_res, tol_abs, rx, rz, nullptr, nullptr);

  // --------------------------- iterations ---------------------------- //
  int iters = 0;
  for (int it = 0; it < max_iters; ++it) {
    ++iters;
    T sz = T(0);
    for (int r = 0; r < mi; ++r) {
      sz += s[r] * z[r];
      sinv[r] = T(1) / s[r];
    }
    const T mu = sz / mi_t;
    factor<T, N>(op, z, sinv, false, dp, L);

    // affine (predictor) direction
    for (int r = 0; r < mi; ++r) rc[r] = -s[r] * z[r];
    rhs<T, N>(op, rx, rz, rc, z, sinv, r1);
    kkt_solve_refined<T, N>(op, L, z, sinv, refine, r1, dx);
    step_dirs<T, N>(op, dx, rz, rc, z, sinv, ds, dz);
    const T ap_a = step_len<T>(s, ds, mi);
    const T ad_a = step_len<T>(z, dz, mi);
    T sz_aff = T(0);
    for (int r = 0; r < mi; ++r) sz_aff += (s[r] + ap_a * ds[r]) * (z[r] + ad_a * dz[r]);
    const T ratio = (sz_aff / mi_t) / nmax(mu, smin);
    const T sigma = nmin(nmax(ratio * (ratio * ratio), T(0)), T(1));

    // combined (corrector) direction
    for (int r = 0; r < mi; ++r) rc[r] = sigma * mu - s[r] * z[r] - ds[r] * dz[r];
    rhs<T, N>(op, rx, rz, rc, z, sinv, r1);
    kkt_solve_refined<T, N>(op, L, z, sinv, refine, r1, dx);
    step_dirs<T, N>(op, dx, rz, rc, z, sinv, ds, dz);
    const T ap = sfrac * step_len<T>(s, ds, mi);
    const T ad = sfrac * step_len<T>(z, dz, mi);

    bool finite = true;
#pragma unroll
    for (int k = 0; k < N; ++k) finite &= dev_finite(x[k] + ap * dx[k]);
    for (int r = 0; r < mi; ++r) {
      finite &= dev_finite(s[r] + ap * ds[r]);
      finite &= dev_finite(z[r] + ad * dz[r]);
    }
    if (!finite) break;  // NaN freeze: the step is not taken, the lane is done
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = x[k] + ap * dx[k];
    for (int r = 0; r < mi; ++r) {
      s[r] = s[r] + ap * ds[r];
      z[r] = z[r] + ad * dz[r];
    }
    if (conv_test<T, N>(op, x, s, z, tol_res, tol_abs, rx, rz, nullptr, nullptr)) break;
  }

  // ---------------------------- epilogue ----------------------------- //
  T res, gap;
  const bool conv = conv_test<T, N>(op, x, s, z, tol_res, tol_abs, nullptr, nullptr, &res, &gap);
#pragma unroll
  for (int k = 0; k < N; ++k) x_out[lane + (long long)k * B] = x[k];
  for (int r = 0; r < mi; ++r) {
    z_out[lane + (long long)r * B] = z[r];
    s_out[lane + (long long)r * B] = s[r];
  }
  stat[lane] = res;
  stat[lane + B] = gap / mi_t;
  stat[lane + 2 * B] = conv ? T(1) : T(0);
  stat[lane + 3 * B] = T(iters);
#pragma unroll
  for (int row = 4; row < kStatRows; ++row) stat[lane + row * B] = T(0);
}

constexpr int kN = 13;

template <typename T>
int launch(const void* P, const void* c, const void* G, const void* h, const void* x0, void* x,
           void* z, void* s, void* stat, long long B, int mi, double abstol, double reltol,
           double reg_primal, double sigma_min, double step_frac, int max_iters, int refine,
           int has_x0, void* stream) {
  if (mi < 1 || mi > kMaxMi) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const long long blocks = (B + kThreads - 1) / kThreads;
  qp_fused_noeq_kernel<T, kN><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)P, (const T*)c, (const T*)G, (const T*)h, (const T*)x0, (T*)x, (T*)z, (T*)s,
      (T*)stat, B, mi, abstol, reltol, reg_primal, sigma_min, step_frac, max_iters, refine,
      has_x0);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes. reg_dual regularises the equality
// (Schur) stage, which the noeq form does not have; it is taken so that the
// entry carries every scalar of QpConfig that the TPU kernel reads.
extern "C" int srbx_qp_fused_noeq_f32(const void* P, const void* c, const void* G, const void* h,
                                      const void* x0, void* x, void* z, void* s, void* stat,
                                      long long B, int mi, double abstol, double reltol,
                                      double reg_primal, double reg_dual, double sigma_min,
                                      double step_frac, int max_iters, int refine, int has_x0,
                                      void* stream) {
  (void)reg_dual;
  return launch<float>(P, c, G, h, x0, x, z, s, stat, B, mi, abstol, reltol, reg_primal,
                       sigma_min, step_frac, max_iters, refine, has_x0, stream);
}

extern "C" int srbx_qp_fused_noeq_f64(const void* P, const void* c, const void* G, const void* h,
                                      const void* x0, void* x, void* z, void* s, void* stat,
                                      long long B, int mi, double abstol, double reltol,
                                      double reg_primal, double reg_dual, double sigma_min,
                                      double step_frac, int max_iters, int refine, int has_x0,
                                      void* stream) {
  (void)reg_dual;
  return launch<double>(P, c, G, h, x0, x, z, s, stat, B, mi, abstol, reltol, reg_primal,
                        sigma_min, step_frac, max_iters, refine, has_x0, stream);
}
