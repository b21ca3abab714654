// Fused Mehrotra predictor-corrector IPM, inequality-only form (kernel K1a):
// one thread group (a half-warp) per lane, the lane's operands staged once
// in shared memory.
//
// Replaces the Pallas TPU kernel srbx/ops/qp_fused.py::_make_kernel in its
// noeq form (entered through solve_lanes_last). Each lane solves
//     min 1/2 x'Px + c'x   s.t.  Gx <= h
// with n = N (13 on the NMPC path) and mi <= kMaxMi runtime inequality rows,
// from a least-squares cold start or a caller-given x0.
//
// Layout: every operand is lanes-last, (rows, cols, B) row-major. A block
// holds kLanes consecutive lanes; it copies their P, c, G, h (and x0) into
// shared memory with neighbouring threads on neighbouring lanes, so every
// load is a run of kLanes contiguous values, and it writes x, z, s and stat
// back the same way at the end. Each operand is read from device memory once
// and each output written once.
//
// What bounds it on an H100. At mi 48 and B = 131072 in f32 the solve must
// move 516 MB (0.154 ms at 3.35 TB/s) and do 5 GFLOP (0.08 ms at 67
// TFLOP/s). Nothing is re-read from device memory and no row array is
// indexed at run time, so nothing spills; what bounds the kernel is instruction issue inside the SM: per lane and iteration a few
// thousand shared-memory, shuffle and arithmetic instructions, of which the
// sum of M = P + G'WG takes the most, then the Cholesky, G'v and the solves.
// The design:
//   * kGroup = 16 threads per lane (two lanes a warp: a 13-wide vector
//     operation leaves 3 of 16 threads idle, not 19 of 32), 16 lanes per
//     block. Row r of G belongs to thread r mod kGroup; that row's s, z,
//     1/s, rz, rc, ds and dz sit in the thread's registers (R =
//     ceil(mi / kGroup) rows each, a template parameter, so no array is
//     indexed at run time and nothing spills);
//   * n-vectors (x's rows, dx, r1, rx, c) belong to thread k < N;
//   * G dx and the step directions are local to a row's owner; G'v is
//     summed by thread k over the rows in order, reading v from a shared
//     vector; step lengths, mu and the test's norms are shuffle reductions;
//   * M = P + G'WG: thread t sums strips t, t + kGroup, ... of kStrip
//     neighbouring entries of a row of the lower triangle, over the rows in
//     order, the strip sharing the row's w g_ri;
//     then thread i factors row i of M in registers, taking column j from
//     its owner by shuffle, and writes L back to shared memory;
//   * the 13 x 13 triangular solves run by row, one shuffle per column;
//   * all synchronisation inside the IPM is within the lane's group
//     (__syncwarp with the group's mask), so a lane that stops early leaves
//     no barrier behind; the block synchronises only after the load and
//     before the store, which every thread reaches.
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
// Early exit is per lane: a group stops when its lane is done. The TPU
// kernel stops when its whole tile is done and freezes done lanes until then,
// so x, z and s are the same; only stat[3] differs (the TPU stores the tile's
// iteration count, this kernel the lane's own). The maximum over lanes is the
// same under both.

#include <cuda_runtime.h>

#include <cfloat>

namespace {

constexpr int kMaxMi = 64;
constexpr int kGroup = 16;                 // threads per lane
constexpr int kThreads = 256;
constexpr int kLanes = kThreads / kGroup;  // lanes per block
constexpr int kStatRows = 8;
static_assert(kGroup < 32 && (32 % kGroup) == 0, "groups split a warp");

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

// M = P + G'WG is summed in strips of kStrip entries of a row, which share
// the row's w g_ri; strips<N>() of them cover the lower triangle.
constexpr int kStrip = 4;
template <int N>
__host__ __device__ constexpr int strips() {
  int n = 0;
  for (int i = 0; i < N; ++i) n += (i + kStrip) / kStrip;
  return n;
}

// Shared-memory values per lane: G (mi x N), P (N x N), L (packed), the
// row-vector scratch v and the staged h (mi each), and x, dx, c (N each).
template <int N>
__host__ __device__ constexpr int lane_stride(int mi) {
  return mi * N + N * N + N * (N + 1) / 2 + 2 * mi + 3 * N;
}

// One lane's view: its shared memory and its thread group.
template <typename T, int N>
struct Lane {
  T *G, *P, *L, *v, *hs, *xs, *dxs, *cs;
  int mi, t;
  unsigned mask;

  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  __device__ __forceinline__ T bcast(T a, int src) const {
    return __shfl_sync(mask, a, src, kGroup);
  }
  __device__ __forceinline__ T sum(T a) const {
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) a += __shfl_xor_sync(mask, a, o, kGroup);
    return a;
  }
  __device__ __forceinline__ T max(T a) const {
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) a = nmax(a, __shfl_xor_sync(mask, a, o, kGroup));
    return a;
  }
  __device__ __forceinline__ T min(T a) const {
#pragma unroll
    for (int o = kGroup / 2; o > 0; o >>= 1) a = nmin(a, __shfl_xor_sync(mask, a, o, kGroup));
    return a;
  }
  __device__ __forceinline__ bool all(bool a) const { return __all_sync(mask, a); }

  __device__ __forceinline__ int row(int q) const { return t + q * kGroup; }
  __device__ __forceinline__ bool has_row(int q) const { return row(q) < mi; }

  // G_r . u for the shared n-vector u.
  __device__ __forceinline__ T g_dot(int r, const T* u) const {
    const T* g = G + r * N;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += g[k] * u[k];
    return acc;
  }
  // sum_r G[r][k] v[r] over the rows in order (thread k < N).
  __device__ __forceinline__ T gt_dot(int k) const {
    T acc = T(0);
    for (int r = 0; r < mi; ++r) acc += G[r * N + k] * v[r];
    return acc;
  }
  __device__ __forceinline__ T p_dot(int k, const T* u) const {
    T acc = T(0);
#pragma unroll
    for (int l = 0; l < N; ++l) acc += P[k * N + l] * u[l];
    return acc;
  }

  // M = P + dp I + G' diag(v) G into L (v already in shared memory, one
  // value per row), then its Cholesky factor, diagonal stored as 1/L_jj.
  __device__ void factor(T dp) const {
    // strips of kStrip neighbouring entries of one row of the lower
    // triangle; thread t sums strips t, t + kGroup, ...
    for (int st = t; st < strips<N>(); st += kGroup) {
      int i = 0, j0 = st;
      while (j0 >= (i + kStrip) / kStrip) {
        j0 -= (i + kStrip) / kStrip;
        ++i;
      }
      j0 *= kStrip;
      T acc[kStrip];
#pragma unroll
      for (int u = 0; u < kStrip; ++u) {
        const int j = j0 + u;
        acc[u] = j <= i ? P[i * N + j] + (i == j ? dp : T(0)) : T(0);
      }
      // entries past the row's end read values that are never stored
      for (int r = 0; r < mi; ++r) {
        const T wgi = v[r] * G[r * N + i];
        const T* g = G + r * N + j0;
#pragma unroll
        for (int u = 0; u < kStrip; ++u) acc[u] += wgi * g[u];
      }
#pragma unroll
      for (int u = 0; u < kStrip; ++u)
        if (j0 + u <= i) L[tri(i, j0 + u)] = acc[u];
    }
    sync();
    // thread i holds row i; column j's entries come from their owners
    T lr[N];
    const int i = t;
#pragma unroll
    for (int k = 0; k < N; ++k) lr[k] = (i < N && k <= i) ? L[tri(i < N ? i : 0, k)] : T(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T di = T(1) / dev_sqrt(bcast(lr[j], j));
      if (i == j) lr[j] = di;
      if (i > j) lr[j] *= di;
#pragma unroll
      for (int k = j + 1; k < N; ++k) {
        const T lkj = bcast(lr[j], k);
        if (i >= k && i < N) lr[k] -= lr[j] * lkj;
      }
    }
    sync();
    if (i < N) {
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k <= i) L[tri(i, k)] = lr[k];
    }
    sync();
  }

  // (L L') x = b for b held by thread k < N; returns thread k's x_k.
  __device__ T cho_solve(T b) const {
    const int k = t;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const T yj = bcast(b, j) * L[tri(j, j)];
      if (k == j) b = yj;
      else if (k > j && k < N) b -= L[tri(k < N ? k : 0, j)] * yj;
    }
#pragma unroll
    for (int j = N - 1; j >= 0; --j) {
      const T xj = bcast(b, j) * L[tri(j, j)];
      if (k == j) b = xj;
      else if (k < j) b -= L[tri(j, k < j ? k : 0)] * xj;
    }
    return b;
  }
};

// Blocks of kThreads per SM that the registers must allow: as many as the
// lanes' shared memory takes, three in f32; in f64, where it leaves room for
// one block at mi > 26, one.
template <typename T>
constexpr int min_blocks() { return sizeof(T) == 4 ? 3 : 1; }

template <typename T, int N, int R>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
qp_fused_noeq_kernel(const T* __restrict__ P, const T* __restrict__ c, const T* __restrict__ G,
                     const T* __restrict__ h, const T* __restrict__ x0, T* __restrict__ x_out,
                     T* __restrict__ z_out, T* __restrict__ s_out, T* __restrict__ stat,
                     long long B, int mi, double abstol, double reltol, double reg_primal,
                     double sigma_min, double step_frac, int max_iters, int refine, int has_x0) {
  extern __shared__ unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int stride = lane_stride<N>(mi);
  const long long lane0 = (long long)blockIdx.x * kLanes;
  const int tid = threadIdx.x;

  // ------------------------------ load ------------------------------- //
  // lane l's region: G | P | L | v | hs | xs | dxs | cs
  const int offG = 0, offP = mi * N, offL = offP + N * N, offV = offL + N * (N + 1) / 2;
  const int offH = offV + mi, offX = offH + mi, offDX = offX + N, offC = offDX + N;
  auto stage = [&](const T* src, int entries, int off) {
    for (int idx = tid; idx < entries * kLanes; idx += kThreads) {
      const int l = idx % kLanes, e = idx / kLanes;
      if (lane0 + l < B) smem[l * stride + off + e] = src[(long long)e * B + lane0 + l];
    }
  };
  stage(G, mi * N, offG);
  stage(P, N * N, offP);
  stage(h, mi, offH);
  stage(c, N, offC);
  if (has_x0) stage(x0, N, offX);
  __syncthreads();

  const int l = tid / kGroup;
  const long long lane = lane0 + l;
  const int t = tid % kGroup;
  T* base = smem + l * stride;
  Lane<T, N> w;
  w.G = base + offG; w.P = base + offP; w.L = base + offL; w.v = base + offV;
  w.hs = base + offH; w.xs = base + offX; w.dxs = base + offDX; w.cs = base + offC;
  w.mi = mi;
  w.t = t;
  w.mask = ((1u << kGroup) - 1u) << ((tid % 32) / kGroup * kGroup);

  T res = T(0), gap = T(0);
  bool conv = false;
  int iters = 0;
  if (lane < B) {
    const T tol_res = T(abstol + reltol);
    const T tol_abs = T(abstol);
    const T dp = T(reg_primal);
    const T smin = T(sigma_min);
    const T sfrac = T(step_frac);
    const T mi_t = T(mi);
    const bool kown = t < N;
    const int k = kown ? t : 0;

    // per-row state of the rows this thread owns
    T s[R], z[R], sinv[R], rz[R], ds[R], dz[R], rc[R];
    T rx = T(0);                         // thread k's cached dual residual
    const T ck = w.cs[k];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      s[q] = z[q] = sinv[q] = rz[q] = ds[q] = dz[q] = rc[q] = T(0);
    }

    // Residuals and the convergence test from x in xs; rx and rz cached.
    // Writes v (= z) and reads it back; every thread gets the same answer.
    auto conv_test = [&](bool store, T* res_out, T* gap_out) {
      T prim = T(0), prim_res = T(0), sz = T(0);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (!w.has_row(q)) continue;
        const int r = w.row(q);
        const T gx = w.g_dot(r, w.xs);
        const T hq = w.hs[r];
        const T rzr = gx + s[q] - hq;
        if (store) rz[q] = rzr;
        prim = nmax(prim, nmax(dev_abs(gx), dev_abs(hq)));
        prim_res = nmax(prim_res, dev_abs(rzr));
        sz += s[q] * z[q];
        w.v[r] = z[q];
      }
      w.sync();
      T dual = T(0), rx_max = T(0), xpx = T(0), cx = T(0);
      if (kown) {
        const T gtz = w.gt_dot(k);
        const T px = w.p_dot(k, w.xs);
        const T xk = w.xs[k];
        const T rxk = px + ck + gtz;
        if (store) rx = rxk;
        dual = nmax(nmax(dev_abs(px), dev_abs(ck)), dev_abs(gtz));
        rx_max = dev_abs(rxk);
        xpx = xk * px;
        cx = ck * xk;
      }
      w.sync();
      prim = w.max(prim);
      prim_res = w.max(prim_res);
      sz = w.sum(sz);
      dual = w.max(dual);
      rx_max = w.max(rx_max);
      xpx = w.sum(xpx);
      cx = w.sum(cx);
      const T rs = nmax(rx_max / nmax(dual, T(1)), prim_res / nmax(prim, T(1)));
      const T obj = T(0.5) * xpx + cx;
      if (res_out) *res_out = rs;
      if (gap_out) *gap_out = sz;
      return rs <= tol_res && sz <= tol_abs * (T(1) + dev_abs(obj));
    };

    // dx = M^-1 r1 with `refine` rounds against P + G' diag(w) G; dx left
    // in dxs and returned by thread k.
    auto kkt_solve_refined = [&](T r1) {
      T dx = w.cho_solve(r1);
      for (int it = 0; it < refine; ++it) {
        if (kown) w.dxs[k] = dx;
        w.sync();
#pragma unroll
        for (int q = 0; q < R; ++q)
          if (w.has_row(q)) w.v[w.row(q)] = (z[q] * sinv[q]) * w.g_dot(w.row(q), w.dxs);
        w.sync();
        T tk = T(0);
        if (kown) tk = r1 - (w.p_dot(k, w.dxs) + w.gt_dot(k));
        w.sync();
        dx += w.cho_solve(tk);
      }
      if (kown) w.dxs[k] = dx;
      w.sync();
      return dx;
    };

    // r1 = -rx - G' (rc * sinv + w * rz), by thread k.
    auto rhs = [&]() {
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (w.has_row(q))
          w.v[w.row(q)] = rc[q] * sinv[q] + (z[q] * sinv[q]) * rz[q];
      w.sync();
      const T r1 = kown ? -rx - w.gt_dot(k) : T(0);
      w.sync();
      return r1;
    };

    // ds = -rz - G dx, dz = (rc - z ds) * sinv, dx in dxs.
    auto step_dirs = [&]() {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (!w.has_row(q)) continue;
        ds[q] = -rz[q] - w.g_dot(w.row(q), w.dxs);
        dz[q] = (rc[q] - z[q] * ds[q]) * sinv[q];
      }
    };

    // Largest step in (0, 1] keeping u + a du >= 0.
    auto step_len = [&](const T (&u)[R], const T (&du)[R]) {
      T lo = big_value<T>();
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (!w.has_row(q)) continue;
        const T ratio = du[q] < T(0) ? -u[q] / du[q] : big_value<T>();
        lo = nmin(lo, ratio);
      }
      return nmin(T(1), w.min(lo));
    };

    // ---------------------------- start ------------------------------ //
    if (!has_x0) {
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (w.has_row(q)) w.v[w.row(q)] = T(1);
      w.sync();
      w.factor(T(1));
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (w.has_row(q)) w.v[w.row(q)] = w.hs[w.row(q)];
      w.sync();
      const T b = kown ? -ck + w.gt_dot(k) : T(0);
      w.sync();
      const T xk = w.cho_solve(b);
      if (kown) w.xs[k] = xk;
      w.sync();
    }
    T s_min = big_value<T>();
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!w.has_row(q)) continue;
      s[q] = w.hs[w.row(q)] - w.g_dot(w.row(q), w.xs);
      s_min = nmin(s_min, s[q]);
    }
    s_min = w.min(s_min);
    const T shift = nmax(T(0), T(-1.5) * s_min) + T(1);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!w.has_row(q)) continue;
      s[q] = s[q] + shift;
      z[q] = T(1);
    }
    conv_test(true, nullptr, nullptr);

    // -------------------------- iterations --------------------------- //
    for (int it = 0; it < max_iters; ++it) {
      ++iters;
      T sz = T(0);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (!w.has_row(q)) continue;
        sz += s[q] * z[q];
        sinv[q] = T(1) / s[q];
        w.v[w.row(q)] = z[q] * sinv[q];
      }
      const T mu = w.sum(sz) / mi_t;
      w.sync();
      w.factor(dp);

      // affine (predictor) direction
#pragma unroll
      for (int q = 0; q < R; ++q) rc[q] = -s[q] * z[q];
      kkt_solve_refined(rhs());
      step_dirs();
      const T ap_a = step_len(s, ds);
      const T ad_a = step_len(z, dz);
      T sz_aff = T(0);
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (w.has_row(q)) sz_aff += (s[q] + ap_a * ds[q]) * (z[q] + ad_a * dz[q]);
      const T ratio = (w.sum(sz_aff) / mi_t) / nmax(mu, smin);
      const T sigma = nmin(nmax(ratio * (ratio * ratio), T(0)), T(1));

      // combined (corrector) direction
#pragma unroll
      for (int q = 0; q < R; ++q) rc[q] = sigma * mu - s[q] * z[q] - ds[q] * dz[q];
      w.sync();
      const T dx = kkt_solve_refined(rhs());
      step_dirs();
      const T ap = sfrac * step_len(s, ds);
      const T ad = sfrac * step_len(z, dz);

      bool finite = !kown || dev_finite(w.xs[k] + ap * dx);
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (!w.has_row(q)) continue;
        finite &= dev_finite(s[q] + ap * ds[q]);
        finite &= dev_finite(z[q] + ad * dz[q]);
      }
      if (!w.all(finite)) break;  // NaN freeze: the step is not taken, the lane is done
      w.sync();
      if (kown) w.xs[k] = w.xs[k] + ap * dx;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        s[q] = s[q] + ap * ds[q];
        z[q] = z[q] + ad * dz[q];
      }
      w.sync();
      if (conv_test(true, nullptr, nullptr)) break;
    }

    // -------------------------- epilogue ----------------------------- //
    w.sync();
    conv = conv_test(false, &res, &gap);
    // stage z and s over G's first rows (no longer read) for the store
    w.sync();
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!w.has_row(q)) continue;
      w.G[w.row(q)] = z[q];
      w.G[mi + w.row(q)] = s[q];
    }
    if (t == 0) {
      T* st = w.G + 2 * mi;
      st[0] = res;
      st[1] = gap / mi_t;
      st[2] = conv ? T(1) : T(0);
      st[3] = T(iters);
#pragma unroll
      for (int row = 4; row < kStatRows; ++row) st[row] = T(0);
    }
  }
  __syncthreads();

  // ------------------------------ store ------------------------------ //
  auto unstage = [&](T* dst, int entries, int off) {
    for (int idx = tid; idx < entries * kLanes; idx += kThreads) {
      const int ll = idx % kLanes, e = idx / kLanes;
      if (lane0 + ll < B) dst[(long long)e * B + lane0 + ll] = smem[ll * stride + off + e];
    }
  };
  unstage(x_out, N, offX);
  unstage(z_out, mi, offG);
  unstage(s_out, mi, offG + mi);
  unstage(stat, kStatRows, offG + 2 * mi);
}

constexpr int kN = 13;
constexpr int kMaxR = kMaxMi / kGroup;
static_assert(kN >= 2 + kStatRows, "z, s and stat fit in G's region for any mi >= 1");

template <typename T, int R>
size_t smem_bytes(int mi) { return sizeof(T) * (size_t)kLanes * lane_stride<kN>(mi); }

// Warps of this instantiation resident on one SM at mi rows, or -1.
template <typename T, int R>
int resident_warps_r(int mi) {
  int blocks = 0;
  auto kernel = qp_fused_noeq_kernel<T, kN, R>;
  const size_t smem = smem_bytes<T, R>(mi);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) !=
          cudaSuccess)
    return -1;
  return blocks * kThreads / 32;
}

template <typename T, int R = 1>
int resident_warps(int mi) {
  if (mi < 1 || mi > kMaxMi) return -1;
  if (mi <= R * kGroup || R == kMaxR) return resident_warps_r<T, R>(mi);
  if constexpr (R < kMaxR) return resident_warps<T, R + 1>(mi);
  return -1;
}

template <typename T, int R>
int launch_r(const void* P, const void* c, const void* G, const void* h, const void* x0, void* x,
             void* z, void* s, void* stat, long long B, int mi, double abstol, double reltol,
             double reg_primal, double sigma_min, double step_frac, int max_iters, int refine,
             int has_x0, void* stream) {
  const long long blocks = (B + kLanes - 1) / kLanes;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<T, R>(mi);
  auto kernel = qp_fused_noeq_kernel<T, kN, R>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)P, (const T*)c, (const T*)G, (const T*)h, (const T*)x0, (T*)x, (T*)z, (T*)s,
      (T*)stat, B, mi, abstol, reltol, reg_primal, sigma_min, step_frac, max_iters, refine,
      has_x0);
  return (int)cudaGetLastError();
}

// Rows per thread: the smallest R with R * kGroup >= mi.
template <typename T, int R = 1>
int launch(const void* P, const void* c, const void* G, const void* h, const void* x0, void* x,
           void* z, void* s, void* stat, long long B, int mi, double abstol, double reltol,
           double reg_primal, double sigma_min, double step_frac, int max_iters, int refine,
           int has_x0, void* stream) {
  if (mi < 1 || mi > kMaxMi) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  if (mi <= R * kGroup || R == kMaxR)
    return launch_r<T, R>(P, c, G, h, x0, x, z, s, stat, B, mi, abstol, reltol, reg_primal,
                          sigma_min, step_frac, max_iters, refine, has_x0, stream);
  if constexpr (R < kMaxR)
    return launch<T, R + 1>(P, c, G, h, x0, x, z, s, stat, B, mi, abstol, reltol, reg_primal,
                            sigma_min, step_frac, max_iters, refine, has_x0, stream);
  return (int)cudaErrorInvalidValue;
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

// Warps resident per SM for a launch at mi rows (f64 != 0: double), or -1.
extern "C" int srbx_qp_fused_noeq_resident_warps(int f64, int mi) {
  return f64 ? resident_warps<double>(mi) : resident_warps<float>(mi);
}
