// Fused Mehrotra predictor-corrector IPM, general form (equality and
// inequality rows), kernel K1b: one block of kThreads threads per lane.
//
// Replaces the Pallas TPU kernel srbx/ops/qp_fused.py::_make_kernel with
// noeq=False, entered through qp_fused.solve (via qp_batch.solve with
// backend="fused"). Each lane solves
//     min 1/2 x'Px + c'x   s.t.  Ax = b,  Gx <= h
// with n = N and me = ME fixed at compile time and mi runtime inequality
// rows, from the regularised least-squares KKT start, optionally
// overwriting x by a caller-given x0. Four shapes, chosen by (n, me) at
// launch: (43, 30), the whole-body low-level QP, and (25, 12), its reduced
// build with the 18 output-defect variables eliminated
// (srbx/lowlevel.py::ll_qp_build_reduced), both at mi 45 on their paths and
// built for mi <= 64; (41, 28), the uncondensed NMPC QP, and (17, 4), the
// condensed one with the simplex rows kept (srbx/ocp.py), at mi 28 to 116
// on their paths and built for mi <= 128.
//
// Layout: batch-leading, as at the JAX package's API: P (B, N, N), c (B, N),
// A (B, ME, N), b (B, ME), G (B, mi, N), h (B, mi), x0 (B, N); outputs x
// (B, N), y (B, ME), z and s (B, mi), stat (B, 8). One lane's operands are
// one contiguous run, so its block reads and writes them coalesced; any B is
// taken (no padding lanes).
//
// What bounds it on an H100: per-lane latency and instruction issue, not
// bytes. At B = 4096 in f32 the solve moves 88 MB (26 us at 3.35 TB/s) and
// does 16 GFLOP on the trot QPs (0.24 ms at 67 TFLOP/s); every iteration
// runs two 43- and 30-wide Cholesky factorizations, a 43 x 30 triangular
// solve and six KKT solves (with two rounds of refinement), each a chain of
// dependent column steps. The KKT solves take the largest share of a
// lane's time, the Cholesky factorizations and M^-1 A' most of the rest,
// so the design spreads each of them over the lane's threads and keeps
// enough lanes on an SM to hide their latency:
//   * kThreads = 64 threads (2 warps) per lane, one lane per block; 8 lanes
//     fit an SM in f32 (16 warps): A and G, M and S as packed lower
//     triangles, M^-1 A' and a few vectors in shared memory (25.0 KB at
//     mi 45 in f32, 50.0 KB in f64); P stays in device memory and is read
//     through the cache (7.4 KB a lane);
//   * M = P + G'WG and S = A M^-1 A' as register-tiled products, each
//     thread a 2 x 2 block of the lower triangle summed over the rows in
//     order, with no division per entry and no thread on the upper half;
//   * a right-looking Cholesky whose trailing update is spread over
//     (row, column) pairs on a grid of threads, each thread's updates
//     independent of each other;
//   * M^-1 A' as a column-blocked triangular solve: column q on lane q of
//     every warp, rows spread over the warps, one barrier per column step;
//   * the 43- and 30-wide vector solves in warp 0 by row, one shuffle per
//     column, with no barrier; per-row quantities of G in the registers of
//     thread r; reductions by warp shuffles and one barrier;
//   * per-lane early exit: the block stops when its lane is done.
// The (25, 12) instantiation is the same design at smaller widths: a lane's
// vectors fit one slot of warp 0, its 9.3 KB of shared memory (f32, mi 45)
// let more lanes share an SM, and __launch_bounds__ asks for 12 of them.
// (41, 28) is the (43, 30) design; (17, 4) the (25, 12) one. Above 64 rows
// each thread owns R = 2 of them, t and t + kThreads (a template parameter,
// so the rows' state stays in registers); mi <= 64 runs the R = 1 build,
// the same code as before the second row was added.
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

constexpr int kThreads = 64;                // threads per lane (one block)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxR = 2;                    // inequality rows per thread
constexpr int kMaxMi = kThreads * kMaxR;    // 128
constexpr int kStatRows = 8;
constexpr int kRed = 8;                     // reduction slots per warp
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads % 32 == 0 && kThreads >= kStatRows, "rows fit the block");

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

// Index of (i, j), j <= i, in a packed lower triangle.
__host__ __device__ constexpr int tri(int i, int j) { return i * (i + 1) / 2 + j; }

// (I, J), J <= I, of block `blk` of a packed lower triangle of blocks.
__device__ __forceinline__ void tri_block(int blk, int& I, int& J) {
  I = 0;
  while (tri(I + 1, 0) <= blk) ++I;
  J = blk - tri(I, 0);
}

// In-place lower Cholesky of the packed k x k L by the whole block, the
// diagonal stored as 1/L_jj. The trailing update of each column step is
// spread over (row, column) pairs on a kRows x kCols grid; each thread holds
// its columns' L_mj in registers and updates two rows at a time, so its
// shared-memory updates are independent of each other.
template <typename T, int K>
__device__ void block_cholesky(T* L, int t) {
  constexpr int kCols = 16, kRows = kThreads / kCols, kV = (K + kCols - 1) / kCols;
  const int tx = t % kCols, ty = t / kCols;
  for (int j = 0; j < K; ++j) {
    const T di = T(1) / dev_sqrt(L[tri(j, j)]);
    if (t < K - 1 - j) L[tri(j + 1 + t, j)] *= di;
    __syncthreads();
    if (t == 0) L[tri(j, j)] = di;
    T cm[kV];
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int m = j + 1 + tx + kCols * v;
      cm[v] = m < K ? L[tri(m, j)] : T(0);
    }
    for (int i = j + 1 + ty; i < K; i += 2 * kRows) {
      const int i2 = i + kRows;
      const bool two = i2 < K;
      T* r1 = L + tri(i, 0);
      T* r2 = L + tri(two ? i2 : i, 0);
      const T l1 = r1[j], l2 = two ? r2[j] : T(0);
      T a1[kV], a2[kV];
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int m = j + 1 + tx + kCols * v;
        a1[v] = m <= i ? r1[m] : T(0);
        a2[v] = (two && m <= i2) ? r2[m] : T(0);
      }
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int m = j + 1 + tx + kCols * v;
        if (m <= i) r1[m] = a1[v] - l1 * cm[v];
        if (two && m <= i2) r2[m] = a2[v] - l2 * cm[v];
      }
    }
    __syncthreads();
  }
}

// (L L') x = b in warp 0, element i of b in slot i / 32 of lane i % 32. Each
// column step loads the next step's L entries before its shuffle, so the
// loads are off the chain of dependent steps, and selects each slot's new
// value instead of branching on the row, so the warp never diverges between
// shuffles; the column loops are unrolled by four, not fully (the three
// inlined KKT solves would make a large kernel).
template <typename T, int K, int S>
__device__ __forceinline__ void warp_cho_solve(const T* L, T (&b)[S], int lane) {
  static_assert(S <= 2, "at most 64 rows");
  int base[S];
  T lnext[S];
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int i = lane + 32 * q;
    base[q] = tri(i < K ? i : 0, 0);
    lnext[q] = (i > 0 && i < K) ? L[base[q]] : T(0);
  }
  T dnext = L[0];
#pragma unroll 4
  for (int j = 0; j < K; ++j) {
    const T d = dnext;
    T lc[S];
#pragma unroll
    for (int q = 0; q < S; ++q) lc[q] = lnext[q];
    if (j + 1 < K) {
      dnext = L[tri(j + 1, j + 1)];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int i = lane + 32 * q;
        lnext[q] = (i > j + 1 && i < K) ? L[base[q] + j + 1] : T(0);
      }
    }
    const T src = (S > 1 && j >= 32) ? b[S - 1] : b[0];
    const T yj = __shfl_sync(kFull, src, j & 31) * d;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int i = lane + 32 * q;
      const T upd = b[q] - lc[q] * yj;
      b[q] = i == j ? yj : ((i > j && i < K) ? upd : b[q]);
    }
  }
  int row = tri(K - 1, 0);
#pragma unroll
  for (int q = 0; q < S; ++q) {
    const int i = lane + 32 * q;
    lnext[q] = i < K - 1 ? L[row + i] : T(0);
  }
  dnext = L[row + K - 1];
#pragma unroll 4
  for (int j = K - 1; j >= 0; --j) {
    const T d = dnext;
    T lc[S];
#pragma unroll
    for (int q = 0; q < S; ++q) lc[q] = lnext[q];
    if (j > 0) {
      row = tri(j - 1, 0);
      dnext = L[row + j - 1];
#pragma unroll
      for (int q = 0; q < S; ++q) {
        const int i = lane + 32 * q;
        lnext[q] = i < j - 1 ? L[row + i] : T(0);
      }
    }
    const T src = (S > 1 && j >= 32) ? b[S - 1] : b[0];
    const T xj = __shfl_sync(kFull, src, j & 31) * d;
#pragma unroll
    for (int q = 0; q < S; ++q) {
      const int i = lane + 32 * q;
      const T upd = b[q] - lc[q] * xj;
      b[q] = i == j ? xj : (i < j ? upd : b[q]);
    }
  }
}

template <int N, int ME>
struct Shape {
  static constexpr int kNS = (N + 31) / 32;    // warp-0 slots of an n-vector
  static constexpr int kMS = (ME + 31) / 32;   // and of an me-vector
  // values per lane in shared memory: A, G, L_M, X = M^-1 A', L_S, the
  // vectors x, dx, px (N), y, dy (ME), the row vector v (mi), the solve's
  // scratch (N + ME) and the reduction slots
  static __host__ __device__ constexpr int count(int mi) {
    return ME * N + mi * N + N * (N + 1) / 2 + N * ME + ME * (ME + 1) / 2 + 3 * N + 2 * ME +
           mi + N + ME + kWarps * kRed;
  }
};

template <typename T, int N, int ME>
struct Lane {
  static constexpr int NS = Shape<N, ME>::kNS, MS = Shape<N, ME>::kMS;
  const T* __restrict__ P;        // this lane's P in device memory
  T *A, *G, *LM, *X, *LS, *xs, *dxs, *pxs, *ys, *dys, *v, *tN, *tME, *red;
  int mi, t, warp, lane;

  __device__ void carve(T* p) {
    A = p; p += ME * N;
    G = p; p += mi * N;
    LM = p; p += N * (N + 1) / 2;
    X = p; p += N * ME;
    LS = p; p += ME * (ME + 1) / 2;
    xs = p; p += N;
    dxs = p; p += N;
    pxs = p; p += N;
    ys = p; p += ME;
    dys = p; p += ME;
    v = p; p += mi;
    tN = p; p += N;
    tME = p; p += ME;
    red = p;
  }

  __device__ __forceinline__ T g_dot(int r, const T* u) const {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += G[r * N + k] * u[k];
    return acc;
  }
  __device__ __forceinline__ T a_dot(int r, const T* u) const {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < N; ++k) acc += A[r * N + k] * u[k];
    return acc;
  }
  __device__ __forceinline__ T gt_dot(int k, const T* u) const {
    T acc = T(0);
    for (int r = 0; r < mi; ++r) acc += G[r * N + k] * u[r];
    return acc;
  }
  __device__ __forceinline__ T at_dot(int k, const T* u) const {
    T acc = T(0);
#pragma unroll
    for (int r = 0; r < ME; ++r) acc += A[r * N + k] * u[r];
    return acc;
  }

  // out = P u (u and out n-vectors in shared memory), by the whole block:
  // thread k < N sums row k of P in order, its loads all independent.
  // Ends with a barrier.
  __device__ void p_mul(const T* u, T* out) const {
    if (t < N) {
      const T* prow = P + t * N;
      T acc = T(0);
#pragma unroll
      for (int l = 0; l < N; ++l) acc += prow[l] * u[l];
      out[t] = acc;
    }
    __syncthreads();
  }

  // Block-wide reductions of NSUM sums, NMAX maxima and NMIN minima, each
  // combined over the warps in order, so every thread gets the same value.
  template <int NSUM, int NMAX, int NMIN>
  __device__ void reduce(T* sums, T* maxs, T* mins) const {
    static_assert(NSUM + NMAX + NMIN <= kRed, "reduction slots");
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int i = 0; i < NSUM; ++i) sums[i] += __shfl_xor_sync(kFull, sums[i], o);
#pragma unroll
      for (int i = 0; i < NMAX; ++i) maxs[i] = nmax(maxs[i], __shfl_xor_sync(kFull, maxs[i], o));
#pragma unroll
      for (int i = 0; i < NMIN; ++i) mins[i] = nmin(mins[i], __shfl_xor_sync(kFull, mins[i], o));
    }
    if (lane == 0) {
      T* slot = red + warp * kRed;
#pragma unroll
      for (int i = 0; i < NSUM; ++i) slot[i] = sums[i];
#pragma unroll
      for (int i = 0; i < NMAX; ++i) slot[NSUM + i] = maxs[i];
#pragma unroll
      for (int i = 0; i < NMIN; ++i) slot[NSUM + NMAX + i] = mins[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < NSUM; ++i) {
      sums[i] = red[i];
      for (int w = 1; w < kWarps; ++w) sums[i] += red[w * kRed + i];
    }
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      maxs[i] = red[NSUM + i];
      for (int w = 1; w < kWarps; ++w) maxs[i] = nmax(maxs[i], red[w * kRed + NSUM + i]);
    }
#pragma unroll
    for (int i = 0; i < NMIN; ++i) {
      mins[i] = red[NSUM + NMAX + i];
      for (int w = 1; w < kWarps; ++w)
        mins[i] = nmin(mins[i], red[w * kRed + NSUM + NMAX + i]);
    }
    __syncthreads();
  }

  // M = P + dp I + G' diag(v) G (v in shared memory), factored; X = M^-1 A';
  // S = A X + dd I, factored. By the whole block; ends with a barrier.
  __device__ void factor(T dp, T dd) {
    // M in 2 x 2 blocks of the lower triangle, summed over rows in order
    constexpr int kMB = (N + 1) / 2;
    for (int blk = t; blk < tri(kMB, 0); blk += kThreads) {
      int I, J;
      tri_block(blk, I, J);
      const int i0 = 2 * I, j0 = 2 * J;
      const int i1 = i0 + 1 < N ? i0 + 1 : i0, j1 = j0 + 1 < N ? j0 + 1 : j0;
      T a00 = P[i0 * N + j0] + (i0 == j0 ? dp : T(0));
      T a01 = P[i0 * N + j1] + (i0 == j1 ? dp : T(0));
      T a10 = P[i1 * N + j0] + (i1 == j0 ? dp : T(0));
      T a11 = P[i1 * N + j1] + (i1 == j1 ? dp : T(0));
      for (int r = 0; r < mi; ++r) {
        const T* g = G + r * N;
        const T wr = v[r];
        const T w0 = wr * g[i0], w1 = wr * g[i1];
        const T g0 = g[j0], g1 = g[j1];
        a00 += w0 * g0;
        a01 += w0 * g1;
        a10 += w1 * g0;
        a11 += w1 * g1;
      }
      LM[tri(i0, j0)] = a00;
      if (j0 + 1 < N && j0 + 1 <= i0) LM[tri(i0, j0 + 1)] = a01;
      if (i0 + 1 < N) {
        LM[tri(i0 + 1, j0)] = a10;
        if (j0 + 1 < N) LM[tri(i0 + 1, j0 + 1)] = a11;
      }
    }
    // X = A' (row k of X is column k of A)
    for (int e = t; e < N * ME; e += kThreads) X[e] = A[(e % ME) * N + e / ME];
    __syncthreads();
    block_cholesky<T, N>(LM, t);

    // X = M^-1 X: column q on lane q of each warp, row i on warp i % kWarps;
    // each warp updates four of its rows at a time, independently
    const bool col = lane < ME;
    for (int j = 0; j < N; ++j) {
      if (warp == j % kWarps && col) X[j * ME + lane] *= LM[tri(j, j)];
      __syncthreads();
      if (col) {
        const T yj = X[j * ME + lane];
        const int first = j + 1 + ((warp - j - 1) % kWarps + kWarps) % kWarps;
        for (int i = first; i < N; i += 4 * kWarps) {
          T xv[4], lv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = i + u * kWarps;
            xv[u] = r < N ? X[r * ME + lane] : T(0);
            lv[u] = r < N ? LM[tri(r, j)] : T(0);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = i + u * kWarps;
            if (r < N) X[r * ME + lane] = xv[u] - lv[u] * yj;
          }
        }
      }
    }
    for (int j = N - 1; j >= 0; --j) {
      if (warp == j % kWarps && col) X[j * ME + lane] *= LM[tri(j, j)];
      __syncthreads();
      if (col) {
        const T xj = X[j * ME + lane];
        const T* lrow = LM + tri(j, 0);
        for (int i = warp; i < j; i += 4 * kWarps) {
          T xv[4], lv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = i + u * kWarps;
            xv[u] = r < j ? X[r * ME + lane] : T(0);
            lv[u] = r < j ? lrow[r] : T(0);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = i + u * kWarps;
            if (r < j) X[r * ME + lane] = xv[u] - lv[u] * xj;
          }
        }
      }
    }
    __syncthreads();

    // S = A X + dd I in 2 x 2 blocks of the lower triangle
    constexpr int kSB = (ME + 1) / 2;
    for (int blk = t; blk < tri(kSB, 0); blk += kThreads) {
      int I, J;
      tri_block(blk, I, J);
      const int r0 = 2 * I, q0 = 2 * J;
      const int r1 = r0 + 1 < ME ? r0 + 1 : r0, q1 = q0 + 1 < ME ? q0 + 1 : q0;
      T a00 = T(0), a01 = T(0), a10 = T(0), a11 = T(0);
#pragma unroll 4
      for (int k = 0; k < N; ++k) {
        const T x0 = A[r0 * N + k], x1 = A[r1 * N + k];
        const T m0 = X[k * ME + q0], m1 = X[k * ME + q1];
        a00 += x0 * m0;
        a01 += x0 * m1;
        a10 += x1 * m0;
        a11 += x1 * m1;
      }
      LS[tri(r0, q0)] = r0 == q0 ? a00 + dd : a00;
      if (q0 + 1 < ME && q0 + 1 <= r0) LS[tri(r0, q0 + 1)] = a01;
      if (r0 + 1 < ME) {
        LS[tri(r0 + 1, q0)] = a10;
        if (q0 + 1 < ME) LS[tri(r0 + 1, q0 + 1)] = r0 + 1 == q0 + 1 ? a11 + dd : a11;
      }
    }
    __syncthreads();
    block_cholesky<T, ME>(LS, t);
  }

  // Warp 0: M ox + A' oy = r1, A ox - dd oy = r2 (dd folded into S).
  __device__ void kkt_solve(const T (&r1)[NS], const T (&r2)[MS], T (&ox)[NS],
                            T (&oy)[MS]) const {
#pragma unroll
    for (int q = 0; q < NS; ++q) ox[q] = r1[q];
    warp_cho_solve<T, N, NS>(LM, ox, lane);
#pragma unroll
    for (int q = 0; q < NS; ++q)
      if (lane + 32 * q < N) tN[lane + 32 * q] = ox[q];
    __syncwarp();
#pragma unroll
    for (int q = 0; q < MS; ++q) {
      const int r = lane + 32 * q;
      oy[q] = r < ME ? a_dot(r, tN) - r2[q] : T(0);
    }
    warp_cho_solve<T, ME, MS>(LS, oy, lane);
#pragma unroll
    for (int q = 0; q < MS; ++q)
      if (lane + 32 * q < ME) tME[lane + 32 * q] = oy[q];
    __syncwarp();
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int k = lane + 32 * q;
      if (k < N) {
        T acc = T(0);
#pragma unroll
        for (int r = 0; r < ME; ++r) acc += X[k * ME + r] * tME[r];
        ox[q] = ox[q] - acc;
      }
    }
    __syncwarp();
  }
};

// Blocks per SM that the registers must allow. At n 43 as many lanes as the
// shared memory takes, 8 in f32 and 4 in f64 (25.0 and 50.0 KB a lane at
// mi 45). At n 25 a lane's shared memory is 9.3 KB in f32 (18.6 in f64), so
// 24 lanes would fit an SM; its n- and me-vectors take one warp-0 slot
// each instead of two, and 12 f32 lanes (80 registers a thread) or 8 f64
// lanes are asked for. At n 41 a lane takes 30.8 / 34.8 KB in f32 at mi
// 92 / 116 (61.5 / 69.6 KB in f64): 6 f32 and 3 f64 lanes fit at any mi
// up to 116. At n 17 a lane takes 9.9 KB in f32 at mi 116: registers set
// the occupancy, as at n 25; the second row a thread (R = 2) costs
// registers, so fewer lanes are asked for there.
template <typename T, int N, int R>
constexpr int min_blocks() {
  constexpr bool f32 = sizeof(T) == 4;
  if (N == 43) return f32 ? 8 : 4;
  if (N == 41) return f32 ? 6 : 3;
  if (N == 17 && R > 1) return f32 ? 10 : 6;
  return f32 ? 12 : 8;
}

template <typename T, int N, int ME, int R>
__global__ void __launch_bounds__(kThreads, min_blocks<T, N, R>())
qp_general_kernel(const T* __restrict__ P, const T* __restrict__ c, const T* __restrict__ A,
                  const T* __restrict__ b, const T* __restrict__ G, const T* __restrict__ h,
                  const T* __restrict__ x0, T* __restrict__ x_out, T* __restrict__ y_out,
                  T* __restrict__ z_out, T* __restrict__ s_out, T* __restrict__ stat,
                  int mi, double abstol, double reltol, double reg_primal, double reg_dual,
                  double sigma_min, double step_frac, int max_iters, int refine, int has_x0) {
  extern __shared__ unsigned char smem_raw[];
  using L = Lane<T, N, ME>;
  constexpr int NS = L::NS, MS = L::MS;
  const long long lane_idx = blockIdx.x;
  const int t = threadIdx.x;

  L w;
  w.mi = mi;
  w.t = t;
  w.warp = t / 32;
  w.lane = t % 32;
  w.P = P + lane_idx * N * N;
  w.carve(reinterpret_cast<T*>(smem_raw));
  const bool w0 = w.warp == 0;
  // thread t owns inequality rows t + kThreads q, q < R
  auto row_of = [&](int q) { return t + kThreads * q; };
  auto has_row = [&](int q) { return row_of(q) < mi; };

  const T tol_res = T(abstol + reltol);
  const T tol_abs = T(abstol);
  const T dp = T(reg_primal);
  const T dd = T(reg_dual);
  const T smin = T(sigma_min);
  const T sfrac = T(step_frac);
  const T mi_t = T(mi);

  // ------------------------------ load ------------------------------- //
  for (int e = t; e < ME * N; e += kThreads) w.A[e] = A[lane_idx * ME * N + e];
  for (int e = t; e < mi * N; e += kThreads) w.G[e] = G[lane_idx * mi * N + e];
  // per-row state of the thread's rows; warp 0 holds the n- and me-vectors
  // by slot
  T hr[R], s[R], z[R], sinv[R], rz[R], rc[R], ds[R], dz[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    hr[q] = has_row(q) ? h[lane_idx * mi + row_of(q)] : T(0);
    s[q] = z[q] = sinv[q] = rz[q] = rc[q] = ds[q] = dz[q] = T(0);
  }
  T cv[NS], rx[NS], r1[NS], dx[NS];
  T bv[MS], ry[MS], r2[MS], dy[MS];
#pragma unroll
  for (int q = 0; q < NS; ++q) {
    const int k = w.lane + 32 * q;
    cv[q] = (w0 && k < N) ? c[lane_idx * N + k] : T(0);
    rx[q] = r1[q] = dx[q] = T(0);
  }
#pragma unroll
  for (int q = 0; q < MS; ++q) {
    const int r = w.lane + 32 * q;
    bv[q] = (w0 && r < ME) ? b[lane_idx * ME + r] : T(0);
    ry[q] = r2[q] = dy[q] = T(0);
  }
  auto n_idx = [&](int q) { return w.lane + 32 * q; };

  // Residuals and the convergence test of (x, y, s, z) in xs, ys, s, z;
  // with `store`, rx, ry, rz are cached. Every thread gets the same answer.
  auto conv_test = [&](bool store, T* res_out, T* gap_out) {
    T maxs[4] = {T(0), T(0), T(0), T(0)};   // prim, prim_res, dual, rx_max
    T sums[3] = {T(0), T(0), T(0)};         // gap, x'Px, c'x
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!has_row(q)) continue;
      const int r = row_of(q);
      const T gx = w.g_dot(r, w.xs);
      const T rzr = gx + s[q] - hr[q];
      if (store) rz[q] = rzr;
      maxs[0] = nmax(maxs[0], nmax(dev_abs(gx), dev_abs(hr[q])));
      maxs[1] = nmax(maxs[1], dev_abs(rzr));
      sums[0] += s[q] * z[q];
      w.v[r] = z[q];
    }
    if (w0) {
#pragma unroll
      for (int q = 0; q < MS; ++q) {
        const int r = n_idx(q);
        if (r >= ME) continue;
        const T ax = w.a_dot(r, w.xs);
        const T ryr = ax - bv[q];
        if (store) ry[q] = ryr;
        maxs[0] = nmax(maxs[0], nmax(dev_abs(ax), dev_abs(bv[q])));
        maxs[1] = nmax(maxs[1], dev_abs(ryr));
      }
    }
    w.p_mul(w.xs, w.pxs);                   // ends with a barrier
    if (w0) {
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const int k = n_idx(q);
        if (k >= N) continue;
        const T px = w.pxs[k];
        const T gtz = w.gt_dot(k, w.v);
        const T aty = w.at_dot(k, w.ys);
        const T rxk = ((px + cv[q]) + gtz) + aty;
        if (store) rx[q] = rxk;
        maxs[2] = nmax(maxs[2], nmax(nmax(dev_abs(px), dev_abs(cv[q])), dev_abs(gtz)));
        maxs[2] = nmax(maxs[2], dev_abs(aty));
        maxs[3] = nmax(maxs[3], dev_abs(rxk));
        const T xk = w.xs[k];
        sums[1] += xk * px;
        sums[2] += cv[q] * xk;
      }
    }
    w.template reduce<3, 4, 0>(sums, maxs, nullptr);
    const T res = nmax(maxs[3] / nmax(maxs[2], T(1)), maxs[1] / nmax(maxs[0], T(1)));
    const T obj = T(0.5) * sums[1] + sums[2];
    if (res_out) *res_out = res;
    if (gap_out) *gap_out = sums[0];
    return res <= tol_res && sums[0] <= tol_abs * (T(1) + dev_abs(obj));
  };

  // dx, dy of the KKT system with `refine` rounds of refinement against
  // [P + G'WG, A'; A, 0]; by the whole block, dx and dy left in dxs and dys
  // and in warp 0's slots. Ends with a barrier.
  auto kkt_solve_refined = [&]() {
    if (w0) {
      w.kkt_solve(r1, r2, dx, dy);
#pragma unroll
      for (int q = 0; q < NS; ++q)
        if (n_idx(q) < N) w.dxs[n_idx(q)] = dx[q];
#pragma unroll
      for (int q = 0; q < MS; ++q)
        if (n_idx(q) < ME) w.dys[n_idx(q)] = dy[q];
    }
    __syncthreads();
    for (int it = 0; it < refine; ++it) {
#pragma unroll
      for (int q = 0; q < R; ++q)
        if (has_row(q)) w.v[row_of(q)] = (z[q] * sinv[q]) * w.g_dot(row_of(q), w.dxs);
      w.p_mul(w.dxs, w.pxs);                // ends with a barrier
      if (w0) {
        T tn[NS], tme[MS], ddx[NS], ddy[MS];
#pragma unroll
        for (int q = 0; q < NS; ++q) {
          const int k = n_idx(q);
          tn[q] = k < N ? r1[q] - ((w.pxs[k] + w.gt_dot(k, w.v)) + w.at_dot(k, w.dys)) : T(0);
        }
#pragma unroll
        for (int q = 0; q < MS; ++q) {
          const int r = n_idx(q);
          tme[q] = r < ME ? r2[q] - w.a_dot(r, w.dxs) : T(0);
        }
        w.kkt_solve(tn, tme, ddx, ddy);
#pragma unroll
        for (int q = 0; q < NS; ++q) {
          dx[q] += ddx[q];
          if (n_idx(q) < N) w.dxs[n_idx(q)] = dx[q];
        }
#pragma unroll
        for (int q = 0; q < MS; ++q) {
          dy[q] += ddy[q];
          if (n_idx(q) < ME) w.dys[n_idx(q)] = dy[q];
        }
      }
      __syncthreads();
    }
  };

  // r1 = -rx - G' (rc * sinv + w * rz) in warp 0's slots.
  auto rhs = [&]() {
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (has_row(q)) w.v[row_of(q)] = rc[q] * sinv[q] + (z[q] * sinv[q]) * rz[q];
    __syncthreads();
    if (w0) {
#pragma unroll
      for (int q = 0; q < NS; ++q)
        r1[q] = n_idx(q) < N ? -rx[q] - w.gt_dot(n_idx(q), w.v) : T(0);
    }
  };

  // ds = -rz - G dx, dz = (rc - z ds) * sinv, and the two step lengths
  // (largest a in (0, 1] keeping s + a ds >= 0 and z + a dz >= 0).
  auto step_dirs_len = [&](T* ap, T* ad) {
    T mins[2] = {big_value<T>(), big_value<T>()};
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!has_row(q)) continue;
      ds[q] = -rz[q] - w.g_dot(row_of(q), w.dxs);
      dz[q] = (rc[q] - z[q] * ds[q]) * sinv[q];
      mins[0] = nmin(mins[0], ds[q] < T(0) ? -s[q] / ds[q] : big_value<T>());
      mins[1] = nmin(mins[1], dz[q] < T(0) ? -z[q] / dz[q] : big_value<T>());
    }
    w.template reduce<0, 0, 2>(nullptr, nullptr, mins);
    *ap = nmin(T(1), mins[0]);
    *ad = nmin(T(1), mins[1]);
  };

  // ------------------------------ start ------------------------------ //
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (has_row(q)) w.v[row_of(q)] = T(1);
  __syncthreads();
  w.factor(T(1), dd);
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (has_row(q)) w.v[row_of(q)] = hr[q];
  __syncthreads();
  if (w0) {
#pragma unroll
    for (int q = 0; q < NS; ++q)
      r1[q] = n_idx(q) < N ? -cv[q] + w.gt_dot(n_idx(q), w.v) : T(0);
    T xv[NS], yv[MS];
    w.kkt_solve(r1, bv, xv, yv);
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int k = n_idx(q);
      if (k < N) w.xs[k] = has_x0 ? x0[lane_idx * N + k] : xv[q];
    }
#pragma unroll
    for (int q = 0; q < MS; ++q)
      if (n_idx(q) < ME) w.ys[n_idx(q)] = yv[q];
  }
  __syncthreads();
  {
    T mins[1] = {big_value<T>()};
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!has_row(q)) continue;
      s[q] = hr[q] - w.g_dot(row_of(q), w.xs);
      mins[0] = nmin(mins[0], s[q]);
    }
    w.template reduce<0, 0, 1>(nullptr, nullptr, mins);
    const T shift = nmax(T(0), T(-1.5) * mins[0]) + T(1);
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!has_row(q)) continue;
      s[q] = s[q] + shift;
      z[q] = T(1);
    }
  }
  conv_test(true, nullptr, nullptr);

  // --------------------------- iterations ---------------------------- //
  int iters = 0;
  for (int it = 0; it < max_iters; ++it) {
    ++iters;
    T sums[1] = {T(0)};
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!has_row(q)) continue;
      sums[0] += s[q] * z[q];
      sinv[q] = T(1) / s[q];
      w.v[row_of(q)] = z[q] * sinv[q];
    }
    w.template reduce<1, 0, 0>(sums, nullptr, nullptr);
    const T mu = sums[0] / mi_t;
    w.factor(dp, dd);

    // affine (predictor) direction
#pragma unroll
    for (int q = 0; q < R; ++q) rc[q] = -s[q] * z[q];
#pragma unroll
    for (int q = 0; q < MS; ++q) r2[q] = -ry[q];
    rhs();
    kkt_solve_refined();
    T ap_a, ad_a;
    step_dirs_len(&ap_a, &ad_a);
    T aff[1] = {T(0)};
#pragma unroll
    for (int q = 0; q < R; ++q)
      if (has_row(q)) aff[0] += (s[q] + ap_a * ds[q]) * (z[q] + ad_a * dz[q]);
    w.template reduce<1, 0, 0>(aff, nullptr, nullptr);
    const T ratio = (aff[0] / mi_t) / nmax(mu, smin);
    const T sigma = nmin(nmax(ratio * (ratio * ratio), T(0)), T(1));

    // combined (corrector) direction
#pragma unroll
    for (int q = 0; q < R; ++q) rc[q] = sigma * mu - s[q] * z[q] - ds[q] * dz[q];
    rhs();
    kkt_solve_refined();
    T ap, ad;
    step_dirs_len(&ap, &ad);
    ap = sfrac * ap;
    ad = sfrac * ad;

    bool finite = true;
    if (w0) {
#pragma unroll
      for (int q = 0; q < NS; ++q)
        if (n_idx(q) < N) finite &= dev_finite(w.xs[n_idx(q)] + ap * dx[q]);
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!has_row(q)) continue;
      finite &= dev_finite(s[q] + ap * ds[q]);
      finite &= dev_finite(z[q] + ad * dz[q]);
    }
    if (!__syncthreads_and(finite)) break;  // NaN freeze: step not taken, lane done
    if (w0) {
#pragma unroll
      for (int q = 0; q < NS; ++q) {
        const int k = n_idx(q);
        if (k < N) w.xs[k] = w.xs[k] + ap * dx[q];
      }
#pragma unroll
      for (int q = 0; q < MS; ++q) {
        const int r = n_idx(q);
        if (r < ME) w.ys[r] = w.ys[r] + ad * dy[q];
      }
    }
#pragma unroll
    for (int q = 0; q < R; ++q) {
      if (!has_row(q)) continue;
      s[q] = s[q] + ap * ds[q];
      z[q] = z[q] + ad * dz[q];
    }
    __syncthreads();
    if (conv_test(true, nullptr, nullptr)) break;
  }

  // ---------------------------- epilogue ----------------------------- //
  T res, gap;
  const bool conv = conv_test(false, &res, &gap);
  if (w0) {
#pragma unroll
    for (int q = 0; q < NS; ++q)
      if (n_idx(q) < N) x_out[lane_idx * N + n_idx(q)] = w.xs[n_idx(q)];
#pragma unroll
    for (int q = 0; q < MS; ++q)
      if (n_idx(q) < ME) y_out[lane_idx * ME + n_idx(q)] = w.ys[n_idx(q)];
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    if (!has_row(q)) continue;
    z_out[lane_idx * mi + row_of(q)] = z[q];
    s_out[lane_idx * mi + row_of(q)] = s[q];
  }
  if (t < kStatRows) {
    T val = T(0);
    if (t == 0) val = res;
    if (t == 1) val = gap / mi_t;
    if (t == 2) val = conv ? T(1) : T(0);
    if (t == 3) val = T(iters);
    stat[lane_idx * kStatRows + t] = val;
  }
}

template <typename T, int N, int ME>
size_t smem_bytes(int mi) { return sizeof(T) * (size_t)Shape<N, ME>::count(mi); }

template <typename T, int N, int ME, int R>
cudaError_t prepare(size_t smem) {
  auto kernel = qp_general_kernel<T, N, ME, R>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int N_, int ME_, int R_>
struct Inst {
  static constexpr int N = N_, ME = ME_, R = R_;
};

// Calls f(Inst<N, ME, R>{}) for the instantiation that serves (n, me) at mi
// rows, or returns `refused` where none does: (43, 30) and (25, 12) are
// built for mi <= 64 (one row a thread), (41, 28) and (17, 4) for mi <= 128
// (R = 1 up to 64 rows, 2 above).
template <typename F>
int dispatch(int n, int me, int mi, int refused, F f) {
  if (mi < 1 || mi > kMaxMi) return refused;
  const bool two = mi > kThreads;
  if (n == 43 && me == 30 && !two) return f(Inst<43, 30, 1>{});
  if (n == 25 && me == 12 && !two) return f(Inst<25, 12, 1>{});
  if (n == 41 && me == 28) return two ? f(Inst<41, 28, 2>{}) : f(Inst<41, 28, 1>{});
  if (n == 17 && me == 4) return two ? f(Inst<17, 4, 2>{}) : f(Inst<17, 4, 1>{});
  return refused;
}

template <typename T>
int launch(const void* P, const void* c, const void* A, const void* b, const void* G,
           const void* h, const void* x0, void* x, void* y, void* z, void* s, void* stat,
           long long B, int n, int me, int mi, double abstol, double reltol, double reg_primal,
           double reg_dual, double sigma_min, double step_frac, int max_iters, int refine,
           int has_x0, void* stream) {
  if (B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return dispatch(n, me, mi, (int)cudaErrorInvalidValue, [&](auto inst) {
    using I = decltype(inst);
    if (B <= 0) return 0;
    const size_t smem = smem_bytes<T, I::N, I::ME>(mi);
    const cudaError_t err = prepare<T, I::N, I::ME, I::R>(smem);
    if (err != cudaSuccess) return (int)err;
    qp_general_kernel<T, I::N, I::ME, I::R><<<(unsigned)B, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)P, (const T*)c, (const T*)A, (const T*)b, (const T*)G, (const T*)h,
        (const T*)x0, (T*)x, (T*)y, (T*)z, (T*)s, (T*)stat, mi, abstol, reltol, reg_primal,
        reg_dual, sigma_min, step_frac, max_iters, refine, has_x0);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int resident_warps(int n, int me, int mi) {
  return dispatch(n, me, mi, -1, [&](auto inst) {
    using I = decltype(inst);
    const size_t smem = smem_bytes<T, I::N, I::ME>(mi);
    int blocks = 0;
    if (prepare<T, I::N, I::ME, I::R>(smem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, qp_general_kernel<T, I::N, I::ME, I::R>, kThreads, smem) != cudaSuccess)
      return -1;
    return blocks * kWarps;
  });
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

// Warps resident per SM at (n, me) and mi rows (f64 != 0: double), or -1.
extern "C" int srbx_qp_general_resident_warps(int f64, int n, int me, int mi) {
  return f64 ? resident_warps<double>(n, me, mi) : resident_warps<float>(n, me, mi);
}
