// Fused Mehrotra predictor-corrector IPM, general form (equality and
// inequality rows), one warp per lane (kernel K1b).
//
// Replaces the Pallas TPU kernel srbx/ops/qp_fused.py::_make_kernel with
// noeq=False, entered through qp_fused.solve (via qp_batch.solve with
// backend="fused"). Each lane solves
//     min 1/2 x'Px + c'x   s.t.  Ax = b,  Gx <= h
// with n = N and me = ME fixed at compile time (43 and 30: the whole-body
// low-level QP) and mi <= kMaxMi runtime inequality rows (45 on that path),
// from the regularised least-squares KKT start, optionally overwriting x by
// a caller-given x0.
//
// Layout: batch-leading, as at the JAX package's API: P (B, N, N), c (B, N),
// A (B, ME, N), b (B, ME), G (B, mi, N), h (B, mi), x0 (B, N); outputs x
// (B, N), y (B, ME), z and s (B, mi), stat (B, 8). One lane's operands are
// one contiguous run, so its warp reads and writes them coalesced; nothing is
// transposed to lanes-last, and any B is taken (no padding lanes).
//
// What bounds it on an H100: per-lane latency, not bytes. A lane's state
// does not fit a thread (M 43x43, M^-1 A' 43x30, S 30x30: 16 KB in f32, 32 KB
// in f64, against K1a's 91-value triangle that already spills), and every
// iteration runs three dependent Cholesky factorizations and several
// triangular solves whose column steps are sequential. The operands
// (P, A, G, c, b, h: 21 KB per lane in f32) are read from device memory once
// and the outputs written once: at B = 4096 that is 88 MB in f32, 26 us at
// 3.35 TB/s, far below what the sequential steps take. The design:
//   * one warp per lane, one lane per block; the lane's operands and all of
//     its IPM state sit in dynamic shared memory (40 KB in f32 at mi 45,
//     80 KB in f64), so nothing is re-read from device memory;
//   * every matrix product spreads its rows or entries over the 32 threads;
//     a Cholesky column step spreads its rows; M^-1 A' runs one right-hand
//     side per thread; vector reductions are warp shuffles;
//   * per-lane early exit: the warp stops when its lane is done.
//
// Semantics kept from the TPU kernel (they change numbers):
//   * M = P + G' diag(w) G + delta_p I and S = A M^-1 A' + delta_d I, each
//     factored in place with the diagonal stored as 1/L_jj (IEEE 1/sqrt);
//   * KKT solves t = M^-1 r1, dy = S^-1 (A t - r2), dx = t - M^-1 A' dy, with
//     `refine` rounds of refinement against the unregularised operator;
//   * sigma = clip((mu_aff / max(mu, sigma_min))^3, 0, 1); the step-length
//     sentinel finfo.max / 4;
//   * residuals rx, ry, rz cached from one iteration's convergence test to
//     the next iteration's directions;
//   * the NaN freeze: a step with a non-finite x, s or z is not taken and
//     the lane is done (y is not checked, as on the TPU);
//   * the OSQP-style relative residual test.
// Maxima and minima propagate NaN, as jnp.maximum does.
//
// Early exit is per lane; the TPU kernel stops a tile when all of its lanes
// are done and freezes done lanes until then, so x, y, z and s are the same;
// stat[3] holds the lane's own iteration count (the TPU the tile's), and the
// maximum over lanes is the same under both.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxMi = 64;
constexpr int kStatRows = 8;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T big_value();
template <>
__device__ __forceinline__ float big_value<float>() { return FLT_MAX / 4.0f; }
template <>
__device__ __forceinline__ double big_value<double>() { return DBL_MAX / 4.0; }

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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmax(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = nmin(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// In-place lower Cholesky of the k x k row-major L, diagonal stored as
// 1/L_jj. Only the lower triangle is read and written.
template <typename T>
__device__ __forceinline__ void cholesky(T* L, int k, int t) {
  for (int j = 0; j < k; ++j) {
    const T di = T(1) / dev_sqrt(L[j * k + j]);
    __syncwarp();
    if (t == 0) L[j * k + j] = di;
    for (int i = j + 1 + t; i < k; i += kWarp) L[i * k + j] *= di;
    __syncwarp();
    for (int i = j + 1 + t; i < k; i += kWarp) {
      const T lij = L[i * k + j];
      for (int m = j + 1; m <= i; ++m) L[i * k + m] -= lij * L[m * k + j];
    }
    __syncwarp();
  }
}

// (L L') x = x in place for one right-hand side, one row per thread.
template <typename T>
__device__ __forceinline__ void cho_solve_vec(const T* L, int k, T* x, int t) {
  for (int j = 0; j < k; ++j) {
    const T yj = x[j] * L[j * k + j];
    __syncwarp();
    if (t == 0) x[j] = yj;
    for (int i = j + 1 + t; i < k; i += kWarp) x[i] -= L[i * k + j] * yj;
    __syncwarp();
  }
  for (int j = k - 1; j >= 0; --j) {
    const T xj = x[j] * L[j * k + j];
    __syncwarp();
    if (t == 0) x[j] = xj;
    for (int i = t; i < j; i += kWarp) x[i] -= L[j * k + i] * xj;
    __syncwarp();
  }
}

// (L L') X = X in place for X (k, r) row-major, one right-hand side per
// thread.
template <typename T>
__device__ __forceinline__ void cho_solve_cols(const T* L, int k, T* X, int r, int t) {
  for (int col = t; col < r; col += kWarp) {
    for (int j = 0; j < k; ++j) {
      const T yj = X[j * r + col] * L[j * k + j];
      X[j * r + col] = yj;
      for (int i = j + 1; i < k; ++i) X[i * r + col] -= L[i * k + j] * yj;
    }
    for (int j = k - 1; j >= 0; --j) {
      const T xj = X[j * r + col] * L[j * k + j];
      X[j * r + col] = xj;
      for (int i = 0; i < j; ++i) X[i * r + col] -= L[j * k + i] * xj;
    }
  }
  __syncwarp();
}

// One lane's operands and IPM state, all in shared memory.
template <typename T, int N, int ME>
struct Lane {
  int mi, t;
  T *P, *A, *G, *M, *MAt, *S;
  T *c, *x, *rx, *dx, *r1, *tn, *ddx;        // N
  T *b, *y, *ry, *dy, *r2, *tme, *ddy;       // ME
  T *h, *s, *z, *rz, *sinv, *rc, *ds, *dz, *tm;  // mi

  static __host__ __device__ size_t count(int mi) {
    return (size_t)N * N * 2 + (size_t)ME * N * 2 + (size_t)mi * N + (size_t)ME * ME
           + 7 * N + 7 * ME + 9 * (size_t)mi;
  }

  __device__ void carve(T* p) {
    P = p; p += N * N;
    A = p; p += ME * N;
    G = p; p += mi * N;
    M = p; p += N * N;
    MAt = p; p += N * ME;
    S = p; p += ME * ME;
    T** nv[] = {&c, &x, &rx, &dx, &r1, &tn, &ddx};
    for (T** q : nv) { *q = p; p += N; }
    T** mv[] = {&b, &y, &ry, &dy, &r2, &tme, &ddy};
    for (T** q : mv) { *q = p; p += ME; }
    T** iv[] = {&h, &s, &z, &rz, &sinv, &rc, &ds, &dz, &tm};
    for (T** q : iv) { *q = p; p += mi; }
  }

  __device__ __forceinline__ T g_dot(int r, const T* v) const {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += G[r * N + k] * v[k];
    return acc;
  }
  __device__ __forceinline__ T a_dot(int r, const T* v) const {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += A[r * N + k] * v[k];
    return acc;
  }
  __device__ __forceinline__ T p_dot(int k, const T* v) const {
    T acc = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) acc += P[k * N + l] * v[l];
    return acc;
  }
  __device__ __forceinline__ T gt_dot(int k, const T* v) const {
    T acc = T(0);
    for (int r = 0; r < mi; ++r) acc += G[r * N + k] * v[r];
    return acc;
  }
  __device__ __forceinline__ T at_dot(int k, const T* v) const {
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < ME; ++r) acc += A[r * N + k] * v[r];
    return acc;
  }

  // M = P + dp I + G' diag(w) G (w = z * sinv, or 1 when unit_w), factored;
  // M^-1 A'; S = A M^-1 A' + dd I, factored.
  __device__ void factor(bool unit_w, T dp, T dd) {
    for (int e = t; e < N * N; e += kWarp) {
      const int i = e / N, j = e % N;
      if (j > i) continue;
      T acc = P[e] + (i == j ? dp : T(0));
      for (int r = 0; r < mi; ++r) {
        const T wr = unit_w ? T(1) : z[r] * sinv[r];
        acc += (wr * G[r * N + i]) * G[r * N + j];
      }
      M[e] = acc;
    }
    for (int e = t; e < N * ME; e += kWarp) {
      const int k = e / ME, r = e % ME;
      MAt[e] = A[r * N + k];
    }
    __syncwarp();
    cholesky<T>(M, N, t);
    cho_solve_cols<T>(M, N, MAt, ME, t);
    for (int e = t; e < ME * ME; e += kWarp) {
      const int r = e / ME, q = e % ME;
      if (q > r) continue;
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < N; ++k) acc += A[r * N + k] * MAt[k * ME + q];
      if (r == q) acc += dd;
      S[e] = acc;
    }
    __syncwarp();
    cholesky<T>(S, ME, t);
  }

  // M dx + A' dy = r1, A dx - dd dy = r2 (dd folded into S).
  __device__ void kkt_solve(const T* rr1, const T* rr2, T* ox, T* oy) {
    for (int k = t; k < N; k += kWarp) ox[k] = rr1[k];
    __syncwarp();
    cho_solve_vec<T>(M, N, ox, t);
    for (int r = t; r < ME; r += kWarp) oy[r] = a_dot(r, ox) - rr2[r];
    __syncwarp();
    cho_solve_vec<T>(S, ME, oy, t);
    for (int k = t; k < N; k += kWarp) {
      T acc = T(0);
#pragma unroll
      for (int r = 0; r < ME; ++r) acc += MAt[k * ME + r] * oy[r];
      ox[k] = ox[k] - acc;
    }
    __syncwarp();
  }

  // kkt_solve + `refine` rounds of refinement against [P+G'WG A'; A 0].
  __device__ void kkt_solve_refined(const T* rr1, const T* rr2, int refine) {
    kkt_solve(rr1, rr2, dx, dy);
    for (int it = 0; it < refine; ++it) {
      for (int r = t; r < mi; r += kWarp) tm[r] = (z[r] * sinv[r]) * g_dot(r, dx);
      __syncwarp();
      for (int k = t; k < N; k += kWarp)
        tn[k] = rr1[k] - ((p_dot(k, dx) + gt_dot(k, tm)) + at_dot(k, dy));
      for (int r = t; r < ME; r += kWarp) tme[r] = rr2[r] - a_dot(r, dx);
      __syncwarp();
      kkt_solve(tn, tme, ddx, ddy);
      for (int k = t; k < N; k += kWarp) dx[k] += ddx[k];
      for (int r = t; r < ME; r += kWarp) dy[r] += ddy[r];
      __syncwarp();
    }
  }

  // r1 = -rx - G' (rc * sinv + w * rz).
  __device__ void rhs() {
    for (int r = t; r < mi; r += kWarp) tm[r] = rc[r] * sinv[r] + (z[r] * sinv[r]) * rz[r];
    __syncwarp();
    for (int k = t; k < N; k += kWarp) r1[k] = -rx[k] - gt_dot(k, tm);
    __syncwarp();
  }

  // ds = -rz - G dx, dz = (rc - z ds) * sinv.
  __device__ void step_dirs() {
    for (int r = t; r < mi; r += kWarp) {
      const T dsr = -rz[r] - g_dot(r, dx);
      ds[r] = dsr;
      dz[r] = (rc[r] - z[r] * dsr) * sinv[r];
    }
    __syncwarp();
  }

  // Largest step in (0, 1] keeping v + a dv >= 0.
  __device__ T step_len(const T* v, const T* dv) const {
    T lo = big_value<T>();
    for (int r = t; r < mi; r += kWarp) {
      const T ratio = dv[r] < T(0) ? -v[r] / dv[r] : big_value<T>();
      lo = nmin(lo, ratio);
    }
    return nmin(T(1), warp_min(lo));
  }

  // Residuals and the convergence test; with `store`, rx, ry, rz are cached.
  __device__ bool conv_test(bool store, T tol_res, T abstol, T* res_out, T* gap_out) {
    T prim = T(0), prim_res = T(0), gap = T(0);
    for (int r = t; r < mi; r += kWarp) {
      const T gx = g_dot(r, x);
      const T rzr = gx + s[r] - h[r];
      if (store) rz[r] = rzr;
      prim = nmax(prim, nmax(dev_abs(gx), dev_abs(h[r])));
      prim_res = nmax(prim_res, dev_abs(rzr));
      gap += s[r] * z[r];
    }
    for (int r = t; r < ME; r += kWarp) {
      const T ax = a_dot(r, x);
      const T ryr = ax - b[r];
      if (store) ry[r] = ryr;
      prim = nmax(prim, nmax(dev_abs(ax), dev_abs(b[r])));
      prim_res = nmax(prim_res, dev_abs(ryr));
    }
    T dual = T(0), rx_max = T(0), xpx = T(0), cx = T(0);
    for (int k = t; k < N; k += kWarp) {
      const T px = p_dot(k, x);
      const T gtz = gt_dot(k, z);
      const T aty = at_dot(k, y);
      const T rxk = ((px + c[k]) + gtz) + aty;
      if (store) rx[k] = rxk;
      dual = nmax(dual, nmax(nmax(dev_abs(px), dev_abs(c[k])), dev_abs(gtz)));
      dual = nmax(dual, dev_abs(aty));
      rx_max = nmax(rx_max, dev_abs(rxk));
      xpx += x[k] * px;
      cx += c[k] * x[k];
    }
    prim = warp_max(prim);
    prim_res = warp_max(prim_res);
    gap = warp_sum(gap);
    dual = warp_max(dual);
    rx_max = warp_max(rx_max);
    xpx = warp_sum(xpx);
    cx = warp_sum(cx);
    __syncwarp();
    const T res = nmax(rx_max / nmax(dual, T(1)), prim_res / nmax(prim, T(1)));
    const T obj = T(0.5) * xpx + cx;
    if (res_out) *res_out = res;
    if (gap_out) *gap_out = gap;
    return res <= tol_res && gap <= abstol * (T(1) + dev_abs(obj));
  }
};

template <typename T, int N, int ME>
__global__ void __launch_bounds__(kWarp)
qp_general_kernel(const T* __restrict__ P, const T* __restrict__ c, const T* __restrict__ A,
                  const T* __restrict__ b, const T* __restrict__ G, const T* __restrict__ h,
                  const T* __restrict__ x0, T* __restrict__ x_out, T* __restrict__ y_out,
                  T* __restrict__ z_out, T* __restrict__ s_out, T* __restrict__ stat,
                  int mi, double abstol, double reltol, double reg_primal, double reg_dual,
                  double sigma_min, double step_frac, int max_iters, int refine, int has_x0) {
  extern __shared__ unsigned char smem_raw[];
  const long long lane = blockIdx.x;
  const int t = threadIdx.x;

  Lane<T, N, ME> w;
  w.mi = mi;
  w.t = t;
  w.carve(reinterpret_cast<T*>(smem_raw));

  const T tol_res = T(abstol + reltol);
  const T tol_abs = T(abstol);
  const T dp = T(reg_primal);
  const T dd = T(reg_dual);
  const T smin = T(sigma_min);
  const T sfrac = T(step_frac);
  const T mi_t = T(mi);

  // ------------------------------ load ------------------------------- //
  for (int e = t; e < N * N; e += kWarp) w.P[e] = P[lane * N * N + e];
  for (int e = t; e < ME * N; e += kWarp) w.A[e] = A[lane * ME * N + e];
  for (int e = t; e < mi * N; e += kWarp) w.G[e] = G[lane * mi * N + e];
  for (int k = t; k < N; k += kWarp) w.c[k] = c[lane * N + k];
  for (int r = t; r < ME; r += kWarp) w.b[r] = b[lane * ME + r];
  for (int r = t; r < mi; r += kWarp) w.h[r] = h[lane * mi + r];
  __syncwarp();

  // ------------------------------ start ------------------------------ //
  w.factor(true, T(1), dd);
  for (int k = t; k < N; k += kWarp) w.r1[k] = -w.c[k] + w.gt_dot(k, w.h);
  __syncwarp();
  w.kkt_solve(w.r1, w.b, w.x, w.y);
  if (has_x0) {
    for (int k = t; k < N; k += kWarp) w.x[k] = x0[lane * N + k];
    __syncwarp();
  }
  T s_min = big_value<T>();
  for (int r = t; r < mi; r += kWarp) {
    const T sr = w.h[r] - w.g_dot(r, w.x);
    w.s[r] = sr;
    s_min = nmin(s_min, sr);
  }
  s_min = warp_min(s_min);
  const T shift = nmax(T(0), T(-1.5) * s_min) + T(1);
  for (int r = t; r < mi; r += kWarp) {
    w.s[r] = w.s[r] + shift;
    w.z[r] = T(1);
  }
  __syncwarp();
  w.conv_test(true, tol_res, tol_abs, nullptr, nullptr);

  // --------------------------- iterations ---------------------------- //
  int iters = 0;
  for (int it = 0; it < max_iters; ++it) {
    ++iters;
    T sz = T(0);
    for (int r = t; r < mi; r += kWarp) {
      sz += w.s[r] * w.z[r];
      w.sinv[r] = T(1) / w.s[r];
    }
    const T mu = warp_sum(sz) / mi_t;
    __syncwarp();
    w.factor(false, dp, dd);

    // affine (predictor) direction
    for (int r = t; r < mi; r += kWarp) w.rc[r] = -w.s[r] * w.z[r];
    for (int r = t; r < ME; r += kWarp) w.r2[r] = -w.ry[r];
    __syncwarp();
    w.rhs();
    w.kkt_solve_refined(w.r1, w.r2, refine);
    w.step_dirs();
    const T ap_a = w.step_len(w.s, w.ds);
    const T ad_a = w.step_len(w.z, w.dz);
    T sz_aff = T(0);
    for (int r = t; r < mi; r += kWarp)
      sz_aff += (w.s[r] + ap_a * w.ds[r]) * (w.z[r] + ad_a * w.dz[r]);
    const T ratio = (warp_sum(sz_aff) / mi_t) / nmax(mu, smin);
    const T sigma = nmin(nmax(ratio * (ratio * ratio), T(0)), T(1));

    // combined (corrector) direction
    __syncwarp();
    for (int r = t; r < mi; r += kWarp)
      w.rc[r] = sigma * mu - w.s[r] * w.z[r] - w.ds[r] * w.dz[r];
    __syncwarp();
    w.rhs();
    w.kkt_solve_refined(w.r1, w.r2, refine);
    w.step_dirs();
    const T ap = sfrac * w.step_len(w.s, w.ds);
    const T ad = sfrac * w.step_len(w.z, w.dz);

    bool finite = true;
    for (int k = t; k < N; k += kWarp) finite &= dev_finite(w.x[k] + ap * w.dx[k]);
    for (int r = t; r < mi; r += kWarp) {
      finite &= dev_finite(w.s[r] + ap * w.ds[r]);
      finite &= dev_finite(w.z[r] + ad * w.dz[r]);
    }
    if (!__all_sync(kFull, finite)) break;  // NaN freeze: step not taken, lane done
    for (int k = t; k < N; k += kWarp) w.x[k] = w.x[k] + ap * w.dx[k];
    for (int r = t; r < ME; r += kWarp) w.y[r] = w.y[r] + ad * w.dy[r];
    for (int r = t; r < mi; r += kWarp) {
      w.s[r] = w.s[r] + ap * w.ds[r];
      w.z[r] = w.z[r] + ad * w.dz[r];
    }
    __syncwarp();
    if (w.conv_test(true, tol_res, tol_abs, nullptr, nullptr)) break;
  }

  // ---------------------------- epilogue ----------------------------- //
  T res, gap;
  const bool conv = w.conv_test(false, tol_res, tol_abs, &res, &gap);
  for (int k = t; k < N; k += kWarp) x_out[lane * N + k] = w.x[k];
  for (int r = t; r < ME; r += kWarp) y_out[lane * ME + r] = w.y[r];
  for (int r = t; r < mi; r += kWarp) {
    z_out[lane * mi + r] = w.z[r];
    s_out[lane * mi + r] = w.s[r];
  }
  if (t < kStatRows) {
    T v = T(0);
    if (t == 0) v = res;
    if (t == 1) v = gap / mi_t;
    if (t == 2) v = conv ? T(1) : T(0);
    if (t == 3) v = T(iters);
    stat[lane * kStatRows + t] = v;
  }
}

constexpr int kN = 43;
constexpr int kMe = 30;

template <typename T>
int launch(const void* P, const void* c, const void* A, const void* b, const void* G,
           const void* h, const void* x0, void* x, void* y, void* z, void* s, void* stat,
           long long B, int n, int me, int mi, double abstol, double reltol, double reg_primal,
           double reg_dual, double sigma_min, double step_frac, int max_iters, int refine,
           int has_x0, void* stream) {
  if (n != kN || me != kMe || mi < 1 || mi > kMaxMi) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  if (B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * Lane<T, kN, kMe>::count(mi);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qp_general_kernel<T, kN, kMe>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  qp_general_kernel<T, kN, kMe><<<(unsigned)B, kWarp, smem, (cudaStream_t)stream>>>(
      (const T*)P, (const T*)c, (const T*)A, (const T*)b, (const T*)G, (const T*)h,
      (const T*)x0, (T*)x, (T*)y, (T*)z, (T*)s, (T*)stat, mi, abstol, reltol, reg_primal,
      reg_dual, sigma_min, step_frac, max_iters, refine, has_x0);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, bound with ctypes.
extern "C" int srbx_qp_general_f32(const void* P, const void* c, const void* A, const void* b,
                                   const void* G, const void* h, const void* x0, void* x, void* y,
                                   void* z, void* s, void* stat, long long B, int n, int me,
                                   int mi, double abstol, double reltol, double reg_primal,
                                   double reg_dual, double sigma_min, double step_frac,
                                   int max_iters, int refine, int has_x0, void* stream) {
  return launch<float>(P, c, A, b, G, h, x0, x, y, z, s, stat, B, n, me, mi, abstol, reltol,
                       reg_primal, reg_dual, sigma_min, step_frac, max_iters, refine, has_x0,
                       stream);
}

extern "C" int srbx_qp_general_f64(const void* P, const void* c, const void* A, const void* b,
                                   const void* G, const void* h, const void* x0, void* x, void* y,
                                   void* z, void* s, void* stat, long long B, int n, int me,
                                   int mi, double abstol, double reltol, double reg_primal,
                                   double reg_dual, double sigma_min, double step_frac,
                                   int max_iters, int refine, int has_x0, void* stream) {
  return launch<double>(P, c, A, b, G, h, x0, x, y, z, s, stat, B, n, me, mi, abstol, reltol,
                        reg_primal, reg_dual, sigma_min, step_frac, max_iters, refine, has_x0,
                        stream);
}
