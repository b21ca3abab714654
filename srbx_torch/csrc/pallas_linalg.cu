// Batched small Cholesky factorization and Cholesky solve (kernels K3a and
// K3b), each lane's rows or right-hand sides kept in registers.
//
// Replaces the Pallas TPU kernels srbx/ops/pallas_linalg.py::_chol_kernel
// (K3a, entered through pallas_linalg.cholesky) and ::_cho_solve_kernel (K3b,
// pallas_linalg.cho_solve). The step-fused batched IPM
// (qp_batch.solve with backend="pallas") calls them on every iteration:
//   * K3a: M = L L' of M = P + G'WG + delta_p I (k = n: 41, 17 or 13) and of
//     the Schur complement S = A M^-1 A' + delta_d I (k = me: 28, 4 or 1);
//   * K3b: (L L') X = R for R = A' (M^-1 A': k 41, r 28) and for single
//     right-hand sides (r = 1), most of its launches.
//
// Layout: batch-leading, as the IPM's batched products leave the operands:
// M and L (B, k, k), R and X (B, k, r), row-major and contiguous; any B.
//
// What bounds them on an H100. Bytes, in the limit: at B = 131072 in f32,
// K3a at k 41 must read M's lower triangle and write L (1.33 GB, 0.40 ms at
// 3.35 TB/s), K3b at (41, 1) read L's lower triangle (0.148 ms). In fact
// the instruction rate and each lane's chain of dependent column steps (k for
// K3a, 2k for K3b, each a division by a square root or by L_jj, a
// broadcast and an update) bound them, and a division whose numerator is
// an exact zero, which the IPM's matrices hold many of, takes the slow path
// of CUDA's IEEE division unless it is turned aside (div_rn). An update
// through shared memory costs three shared-memory instructions, so the
// lane's data sits in registers where an update needs it, and an update is
// a register multiply and subtract:
//   * K3a: a group of G threads a lane (a warp; a half-warp in f32 up to
//     k 32); thread t owns rows t, 2G - 1 - t, 2G + t, ... of the lower
//     triangle in registers (a balanced share). At column step j the owner
//     of row j broadcasts a_jj by shuffle, every owner divides its column-j
//     entries, the column goes to a small shared buffer (two, alternating,
//     so one __syncwarp a step), and every thread reads it back 16 bytes at
//     a time, all threads the same address, to update its rows.
//   * K3b, r = 1: a group of G threads a lane (8 up to k 32, 16 above);
//     thread t owns x_i for rows i = t, t + G, ... in registers, L stays in
//     the lane's stage and each thread reads its rows' entries of column j
//     (forward) or row j (back). x_j reaches the group by one shuffle a
//     step, and every thread divides it by the same L_jj, so no step
//     branches on the owner; the step loops are rolled (unrolled by 4).
//   * K3b, r > 1: a warp a lane, thread c owns column c of X (c, c + 32) in
//     registers; L's lower triangle sits in shared memory in rows padded to
//     16 bytes, read by all threads at once, 16 bytes a load. The forward
//     pass runs by rows (x_i less its row of L times y, in column order), the
//     back pass by columns.
// Where registers are indexed by row or column, the row capacity K (16, 32,
// 48, 64) is a template parameter, so no register array is indexed at run
// time; k <= K is handled by guards.
// Loads and stores: a lane's block is read from device memory once, with
// cp.async (16 bytes a copy where the 16-byte phase allows, and the pieces
// that hold only entries above the diagonal not read; K3b at r > 1 copies
// the lower triangle an element at a time into its padded rows), and
// written once (K3a through its stage, 16 bytes a store; K3b's X straight
// from the registers, coalesced). A block's groups loop over lanes, with one
// stage a group: the next lane's copy starts when the current lane is done
// with the stage, and the other groups on the SM run meanwhile. (A second
// stage, to overlap that copy with the current lane, halves the lanes that
// fit an SM and measured slower.) All synchronisation is within a lane's
// group (__syncwarp with the group's mask); a group past B neither reads nor
// writes, and there is no block-wide barrier.
//
// Semantics kept from the TPU kernels (they change numbers):
//   * column j of the factorization is divided by sqrt(a_jj), its diagonal
//     entry included (L_jj = a_jj / sqrt(a_jj)); the substitutions divide by
//     L_jj. No stored reciprocals.
//   * the square root is not guarded: a lane whose matrix is not positive
//     definite comes out non-finite, in that lane only (the IPM's NaN freeze
//     relies on it);
//   * only the lower triangles of M (K3a) and of L (K3b) are used, and the
//     strict upper triangle of L is written as exact zeros. A lane's result
//     does not depend on its upper triangles.
// Every update is a rounded product followed by a rounded subtraction
// (__fmul_rn / __fsub_rn: no fused multiply-add), applied to each entry in
// ascending column order (descending in the back pass), so a lane's result
// is bitwise the one of the plain PyTorch column loop
// (srbx_torch/ops/pallas_linalg.py::batch_cholesky_plain and
// batch_cho_solve_plain).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxK = 64;
constexpr int kMaxR = 64;
constexpr int kThreads = 64;  // threads per block of K3a and of K3b at r > 1
constexpr int kSolve1Threads = kWarp;  // of K3b at r = 1 (f64 k 64 fits)

// Threads per lane, measured (PERF.md, section 6): K3a a half-warp in f32
// up to k 32 and a warp otherwise (a half-warp at k 41 holds three rows a
// thread and ran 1.8x slower); K3b at r = 1 a quarter-warp up to k 32 and a
// half-warp above (at k 41 a quarter-warp resides as few lanes and hides
// less of each step's latency).
template <typename T, int K>
__host__ __device__ constexpr int chol_group() {
  return sizeof(T) == 4 && K <= 32 ? 16 : kWarp;
}
template <int K>
__host__ __device__ constexpr int solve1_group() {
  return K <= 32 ? 8 : 16;
}

// The row capacity of the instantiation that serves k.
constexpr int capacity(int k) { return k <= 16 ? 16 : k <= 32 ? 32 : k <= 48 ? 48 : 64; }

// Elements of T in 16 bytes, and n rounded up to a multiple of them.
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int round16(int n) {
  return (n + vec<T>() - 1) / vec<T>() * vec<T>();
}

// Shared-memory elements of one stage: K3a's holds the flat k x k block, with
// room for its 16-byte phase and for row k - 1 read K entries wide; K3b's at
// r = 1 the flat block; K3b's at r > 1 the lower triangle in rows padded to
// 16 bytes.
template <typename T, int K>
__host__ __device__ constexpr int chol_stage_len(int k) { return round16<T>(k * k + K + vec<T>()); }
template <typename T>
__host__ __device__ constexpr int solve1_stage_len(int k) { return round16<T>(k * k + vec<T>()); }
template <typename T>
__host__ __device__ constexpr int solve_stage_len(int k) { return k * round16<T>(k); }

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// x / d, IEEE. The division's fast path hands a zero numerator to its slow
// path, and the IPM's M and A' hold many exact zeros: a zero over a
// positive divisor is returned as is (the same signed zero). K3b at r = 1
// divides without it (no gain there on the cycle's inputs).
template <typename T>
__device__ __forceinline__ T div_rn(T x, T d) {
  if (x == T(0) && d > T(0)) return x;
  return x / d;
}

// 16 bytes of shared memory, and their element e (e known at compile time).
__device__ __forceinline__ float4 load16(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ double2 load16(const double* p) {
  return *reinterpret_cast<const double2*>(p);
}
__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}
__device__ __forceinline__ double elem(const double2& v, int e) { return e == 0 ? v.x : v.y; }

// G consecutive threads of a warp that serve one lane.
template <int G>
struct Group {
  int t;          // thread within the group
  unsigned mask;  // the group's threads in its warp

  __device__ __forceinline__ Group()
      : t((int)threadIdx.x % G),
        mask((0xffffffffu >> (kWarp - G)) << ((int)threadIdx.x % kWarp / G * G)) {}
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
  template <typename T>
  __device__ __forceinline__ T bcast(T v, int src) const {
    return __shfl_sync(mask, v, src, G);
  }
};

// Element offset at which a block copied from or to p keeps p's 16-byte
// phase in a 16-byte-aligned shared buffer.
template <typename T>
__device__ __forceinline__ int phase(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(T));
}

// Starts the asynchronous copy of the k x k block at src (global) into
// buf + phase(src) (shared): 16 bytes a copy, singly before the first and
// after the last 16-byte boundary; a 16-byte piece that holds only entries
// above the diagonal is not copied.
template <typename T, int G>
__device__ __forceinline__ void stage_lower(T* buf, const T* src, int k, int t) {
  constexpr int V = vec<T>();
  const int n = k * k;
  const int ph = phase(src);
  T* dst = buf + ph;
  const int head = min(n, (V - ph) % V);
  const int body = (n - head) / V;
  const int tail = head + body * V;
  if (t < head) __pipeline_memcpy_async(dst + t, src + t, sizeof(T));
  if (t < n - tail) __pipeline_memcpy_async(dst + tail + t, src + tail + t, sizeof(T));
  const float rk = 1.0f / (float)k;
  for (int q = t; q < body; q += G) {
    const int e = head + q * V;
    // e's row, e / k: exact in float, as e < 2^12 and e + 0.5 lies at least
    // 0.5 / k from a multiple of k
    const int row = (int)(((float)e + 0.5f) * rk);
    const int col = e - row * k;
    if (col <= row || col + V > k) __pipeline_memcpy_async(dst + e, src + e, 16);
  }
}

// Starts the asynchronous copy of the lower triangle of the k x k block at
// src (global) into rows of kp elements at buf (shared), an element a copy.
template <typename T>
__device__ __forceinline__ void stage_rows(T* buf, const T* src, int k, int kp, int t) {
  for (int p = t; p < k * (k + 1) / 2; p += kWarp) {
    // p's row, the largest i with i (i + 1) / 2 <= p: exact in float, since
    // sqrtf rounds correctly and the root of an 8p + 1 < 129^2 that is not
    // a square lies at least 1/258 from an integer
    const int i = (int)((sqrtf((float)(8 * p + 1)) - 1.0f) * 0.5f);
    const int c = p - i * (i + 1) / 2;
    __pipeline_memcpy_async(buf + i * kp + c, src + i * k + c, sizeof(T));
  }
}

// Writes the n elements staged at buf + phase(dst) (shared) to dst (global),
// 16 bytes a store, singly at the ends.
template <typename T, int G>
__device__ __forceinline__ void unstage(T* dst, const T* buf, int n, int t) {
  constexpr int V = vec<T>();
  const int ph = phase(dst);
  const T* src = buf + ph;
  const int head = min(n, (V - ph) % V);
  const int body = (n - head) / V;
  const int tail = head + body * V;
  if (t < head) dst[t] = src[t];
  if (t < n - tail) dst[tail + t] = src[tail + t];
  for (int q = t; q < body; q += G) {
    const int e = head + q * V;
    *reinterpret_cast<int4*>(dst + e) = *reinterpret_cast<const int4*>(src + e);
  }
}

// K3a: M = L L', a group of G threads a lane, its rows in registers.
template <typename T, int K, int G>
__global__ void __launch_bounds__(kThreads)
cholesky_kernel(const T* __restrict__ M, T* __restrict__ L, long long batch, int k) {
  constexpr int S = (K + G - 1) / G;  // rows a thread owns
  constexpr int V = vec<T>();
  constexpr int KC = round16<T>(K);  // length of a column buffer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Group<G> grp;
  const int groups = kThreads / G;
  const int n = k * k;
  T* buf = reinterpret_cast<T*>(smem_raw) +
           (size_t)((int)threadIdx.x / G) * (chol_stage_len<T, K>(k) + 2 * KC);
  T* colbuf = buf + chol_stage_len<T, K>(k);
  const long long stride = (long long)gridDim.x * groups;
  long long lane = (long long)blockIdx.x * groups + (int)threadIdx.x / G;
  if (lane >= batch) return;  // the whole group leaves

  int row[S], rowc[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    row[s] = s * G + ((s & 1) ? G - 1 - grp.t : grp.t);
    rowc[s] = min(row[s], k - 1);  // rows past k read row k - 1, unused
  }

  stage_lower<T, G>(buf, M + lane * n, k, grp.t);
  __pipeline_commit();
  for (; lane < batch; lane += stride) {
    const long long next = lane + stride;
    __pipeline_wait_prior(0);
    grp.sync();

    // a[s][c] = entry (row[s], c); entries right of the diagonal are unused
    T a[S][K];
    {
      const T* in = buf + phase(M + lane * n);
#pragma unroll
      for (int s = 0; s < S; ++s)
#pragma unroll
        for (int c = 0; c < K; ++c)
          if (c < (s + 1) * G) a[s][c] = in[rowc[s] * k + c];
    }

#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j < k) {
        const int sj = j / G;  // row j's owner: slot sj of thread tj
        const int tj = (sj & 1) ? G - 1 - j % G : j % G;
        const T d = dev_sqrt(grp.bcast(a[sj][j], tj));
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (j < (s + 1) * G && row[s] >= j && row[s] < k) a[s][j] = div_rn(a[s][j], d);
        // column j to the buffer: every row's owner stores its entry (the
        // positions at or above j are read by no update)
        T* col = colbuf + (j & 1) * KC;
#pragma unroll
        for (int s = 0; s < S; ++s)
          if (j + 1 < (s + 1) * G && row[s] < k) col[row[s]] = a[s][j];
        grp.sync();
        // the trailing update, column j + 1 first; columns past k update
        // only entries right of the diagonal
#pragma unroll
        for (int q = 0; q < KC / V; ++q) {
          if ((q + 1) * V > j + 1) {
            const auto v = load16(col + q * V);
#pragma unroll
            for (int e = 0; e < V; ++e)
#pragma unroll
              for (int s = 0; s < S; ++s)
                if (q * V + e > j && q * V + e < (s + 1) * G && q * V + e < K)
                  a[s][q * V + e] = sub_rn(a[s][q * V + e], mul_rn(a[s][j], elem(v, e)));
          }
        }
      }
    }

    // L, zeros right of the diagonal, through the stage with L's phase
    {
      T* out = buf + phase(L + lane * n);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (row[s] < k) {
#pragma unroll
          for (int c = 0; c < K; ++c)
            if (c < k) out[row[s] * k + c] = (c < (s + 1) * G && c <= row[s]) ? a[s][c] : T(0);
        }
    }
    grp.sync();
    unstage<T, G>(L + lane * n, buf, n, grp.t);
    grp.sync();  // the stage is free for the next lane
    if (next < batch) stage_lower<T, G>(buf, M + next * n, k, grp.t);
    __pipeline_commit();
  }
}

// K3b at r = 1: a group of G threads a lane. Thread t owns x_i for rows
// i = t, t + G, ... in registers; L stays in the stage, each thread reading
// its rows' entries of column j (forward) or row j (back), and x_j reaches
// the group by one shuffle a step. Every thread divides the same x_j by the
// same L_jj, so no step branches on the owner.
template <typename T, int K, int G>
__global__ void __launch_bounds__(kSolve1Threads)
cho_solve1_kernel(const T* __restrict__ L, const T* __restrict__ R, T* __restrict__ X,
                  long long batch, int k) {
  constexpr int S = (K + G - 1) / G;  // rows a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Group<G> grp;
  const int groups = kSolve1Threads / G;
  const int n = k * k;
  T* buf = reinterpret_cast<T*>(smem_raw) +
           (size_t)((int)threadIdx.x / G) * solve1_stage_len<T>(k);
  const long long stride = (long long)gridDim.x * groups;
  long long lane = (long long)blockIdx.x * groups + (int)threadIdx.x / G;
  if (lane >= batch) return;

  T xn[S];  // the right-hand side, loaded a lane ahead
#pragma unroll
  for (int s = 0; s < S; ++s)
    xn[s] = s * G + grp.t < k ? R[lane * k + s * G + grp.t] : T(0);
  stage_lower<T, G>(buf, L + lane * n, k, grp.t);
  __pipeline_commit();
  for (; lane < batch; lane += stride) {
    const long long next = lane + stride;
    T x[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      x[s] = xn[s];
      if (next < batch && s * G + grp.t < k) xn[s] = R[next * k + s * G + grp.t];
    }
    __pipeline_wait_prior(0);
    grp.sync();
    const T* l = buf + phase(L + lane * n);

    // forward: y_j = x_j / L_jj, then x_i -= L_ij y_j for i > j
#pragma unroll
    for (int sj = 0; sj < S; ++sj) {
      const int steps = min(G, k - sj * G);
#pragma unroll 4
      for (int tj = 0; tj < steps; ++tj) {
        const int j = sj * G + tj;
        const T y = grp.bcast(x[sj], tj) / l[j * k + j];
        if (grp.t == tj) x[sj] = y;
        if (grp.t > tj && sj * G + grp.t < k)
          x[sj] = sub_rn(x[sj], mul_rn(l[(sj * G + grp.t) * k + j], y));
#pragma unroll
        for (int s = sj + 1; s < S; ++s)
          if (s * G + grp.t < k) x[s] = sub_rn(x[s], mul_rn(l[(s * G + grp.t) * k + j], y));
      }
    }
    // back: x_j /= L_jj, then x_i -= L_ji x_j for i < j
#pragma unroll
    for (int sj = S - 1; sj >= 0; --sj) {
#pragma unroll 4
      for (int tj = min(G - 1, k - 1 - sj * G); tj >= 0; --tj) {
        const T* lj = l + (sj * G + tj) * k;  // row j of L
        const T y = grp.bcast(x[sj], tj) / lj[sj * G + tj];
        if (grp.t == tj) x[sj] = y;
        if (grp.t < tj) x[sj] = sub_rn(x[sj], mul_rn(lj[sj * G + grp.t], y));
#pragma unroll
        for (int s = 0; s < sj; ++s) x[s] = sub_rn(x[s], mul_rn(lj[s * G + grp.t], y));
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s * G + grp.t < k) X[lane * k + s * G + grp.t] = x[s];
    grp.sync();  // the stage is free for the next lane
    if (next < batch) stage_lower<T, G>(buf, L + next * n, k, grp.t);
    __pipeline_commit();
  }
}

// K3b at r > 1: a warp a lane, thread c solving column c (and c + 32) in
// registers, L's lower triangle in shared memory.
// (The bound asks for one resident block per SM at least: with no minimum
// given, ptxas held the f32 K 48 build to 128 registers and spilled.)
template <typename T, int K>
__global__ void __launch_bounds__(kThreads, 1)
cho_solve_kernel(const T* __restrict__ L, const T* __restrict__ R, T* __restrict__ X,
                 long long batch, int k, int r) {
  constexpr int V = vec<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Group<kWarp> grp;
  const int groups = kThreads / kWarp;
  const int n = k * k;
  const int kp = round16<T>(k);
  T* buf = reinterpret_cast<T*>(smem_raw) + (size_t)((int)threadIdx.x / kWarp) * solve_stage_len<T>(k);
  const long long stride = (long long)gridDim.x * groups;
  long long lane = (long long)blockIdx.x * groups + (int)threadIdx.x / kWarp;
  if (lane >= batch) return;

  stage_rows<T>(buf, L + lane * n, k, kp, grp.t);
  __pipeline_commit();
  for (; lane < batch; lane += stride) {
    const long long next = lane + stride;
    __pipeline_wait_prior(0);
    grp.sync();
    const T* l = buf;
    const T* rl = R + lane * k * r;
    T* xl = X + lane * k * r;
#pragma unroll 1
    for (int c0 = 0; c0 < r; c0 += kWarp) {
      const int c = c0 + grp.t;
      const bool active = c < r;
      T x[K];
#pragma unroll
      // an idle column holds ones, not zeros: no slow divisions
      for (int i = 0; i < K; ++i) x[i] = (i < k && active) ? rl[i * r + c] : T(1);
      // forward, by rows: x_i -= L_ij y_j for j < i in order, y_i = x_i / L_ii
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i < k) {
          const T* li = l + i * kp;
#pragma unroll
          for (int q = 0; q < K / V; ++q) {
            if (q * V < i) {
              const auto v = load16(li + q * V);
#pragma unroll
              for (int e = 0; e < V; ++e)
                if (q * V + e < i) x[i] = sub_rn(x[i], mul_rn(elem(v, e), x[q * V + e]));
            }
          }
          x[i] = div_rn(x[i], li[i]);
        }
      }
      // back, by columns: x_j /= L_jj, then x_i -= L_ji x_j for i < j
#pragma unroll
      for (int jj = 0; jj < K; ++jj) {
        const int j = K - 1 - jj;
        if (j < k) {
          const T* lj = l + j * kp;
          x[j] = div_rn(x[j], lj[j]);
#pragma unroll
          for (int q = 0; q < K / V; ++q) {
            if (q * V < j) {
              const auto v = load16(lj + q * V);
#pragma unroll
              for (int e = 0; e < V; ++e)
                if (q * V + e < j) x[q * V + e] = sub_rn(x[q * V + e], mul_rn(elem(v, e), x[j]));
            }
          }
        }
      }
      if (active) {
#pragma unroll
        for (int i = 0; i < K; ++i)
          if (i < k) xl[i * r + c] = x[i];
      }
    }
    grp.sync();  // the stage is free for the next lane
    if (next < batch) stage_rows<T>(buf, L + next * n, k, kp, grp.t);
    __pipeline_commit();
  }
}

// How a launch is laid out; the same fields as srbx_pallas_launch_geometry.
struct Geometry {
  int group;          // threads per lane
  int lanes;          // lanes per block
  int smem;           // shared-memory bytes per block
  int capacity;       // row capacity K
  int blocks_per_sm;  // resident blocks per SM
  int grid;           // blocks launched: at most the resident ones
};

// Fills geo for kern and, unless it is only asked for (no operands), is
// ready to launch it: a grid of at most the blocks resident at once, whose
// groups loop over the lanes.
template <typename Kern>
cudaError_t plan(Kern kern, int threads, int group, int cap, size_t smem, long long batch,
                 Geometry* geo) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int lanes = threads / group;
  const long long need = (batch + lanes - 1) / lanes;
  const long long most = (long long)per_sm * sms;
  *geo = Geometry{group, lanes, (int)smem, cap, per_sm, (int)(need < most ? need : most)};
  return cudaSuccess;
}

template <typename T, int K>
cudaError_t cholesky_at(const T* M, T* L, long long batch, int k, cudaStream_t stream,
                        Geometry* geo) {
  constexpr int G = chol_group<T, K>();
  const size_t smem =
      sizeof(T) * (size_t)(kThreads / G) * (chol_stage_len<T, K>(k) + 2 * round16<T>(K));
  void (*kern)(const T*, T*, long long, int) = cholesky_kernel<T, K, G>;
  const cudaError_t err = plan(kern, kThreads, G, K, smem, batch, geo);
  if (err != cudaSuccess || M == nullptr) return err;
  kern<<<geo->grid, kThreads, smem, stream>>>(M, L, batch, k);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t cho_solve_at(const T* L, const T* R, T* X, long long batch, int k, int r,
                         cudaStream_t stream, Geometry* geo) {
  cudaError_t err;
  if (r == 1) {
    constexpr int G = solve1_group<K>();
    const size_t smem = sizeof(T) * (size_t)(kSolve1Threads / G) * solve1_stage_len<T>(k);
    void (*kern)(const T*, const T*, T*, long long, int) = cho_solve1_kernel<T, K, G>;
    err = plan(kern, kSolve1Threads, G, K, smem, batch, geo);
    if (err != cudaSuccess || L == nullptr) return err;
    kern<<<geo->grid, kSolve1Threads, smem, stream>>>(L, R, X, batch, k);
  } else {
    const size_t smem = sizeof(T) * (size_t)(kThreads / kWarp) * solve_stage_len<T>(k);
    void (*kern)(const T*, const T*, T*, long long, int, int) = cho_solve_kernel<T, K>;
    err = plan(kern, kThreads, kWarp, K, smem, batch, geo);
    if (err != cudaSuccess || L == nullptr) return err;
    kern<<<geo->grid, kThreads, smem, stream>>>(L, R, X, batch, k, r);
  }
  return cudaGetLastError();
}

// K3a (r = 0) or K3b at (k, r), through the instantiation of k's capacity;
// with null operands it only fills geo.
template <typename T>
cudaError_t dispatch(const void* A, const void* R, void* Y, long long batch, int k, int r,
                     cudaStream_t stream, Geometry* geo) {
  const T* a = (const T*)A;
  const T* b = (const T*)R;
  T* y = (T*)Y;
  switch (capacity(k)) {
    case 16:
      return r == 0 ? cholesky_at<T, 16>(a, y, batch, k, stream, geo)
                    : cho_solve_at<T, 16>(a, b, y, batch, k, r, stream, geo);
    case 32:
      return r == 0 ? cholesky_at<T, 32>(a, y, batch, k, stream, geo)
                    : cho_solve_at<T, 32>(a, b, y, batch, k, r, stream, geo);
    case 48:
      return r == 0 ? cholesky_at<T, 48>(a, y, batch, k, stream, geo)
                    : cho_solve_at<T, 48>(a, b, y, batch, k, r, stream, geo);
    default:
      return r == 0 ? cholesky_at<T, 64>(a, y, batch, k, stream, geo)
                    : cho_solve_at<T, 64>(a, b, y, batch, k, r, stream, geo);
  }
}

template <typename T>
int launch(const void* A, const void* R, void* Y, long long batch, int k, int r, void* stream) {
  if (k < 1 || k > kMaxK || r < 0 || r > kMaxR) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  Geometry geo;
  return (int)dispatch<T>(A, R, Y, batch, k, r, (cudaStream_t)stream, &geo);
}

}  // namespace

// C entry points, bound with ctypes.
extern "C" int srbx_pallas_cholesky_f32(const void* M, void* L, long long batch, int k,
                                        void* stream) {
  return launch<float>(M, nullptr, L, batch, k, 0, stream);
}

extern "C" int srbx_pallas_cholesky_f64(const void* M, void* L, long long batch, int k,
                                        void* stream) {
  return launch<double>(M, nullptr, L, batch, k, 0, stream);
}

extern "C" int srbx_pallas_cho_solve_f32(const void* L, const void* R, void* X, long long batch,
                                         int k, int r, void* stream) {
  if (r < 1) return (int)cudaErrorInvalidValue;
  return launch<float>(L, R, X, batch, k, r, stream);
}

extern "C" int srbx_pallas_cho_solve_f64(const void* L, const void* R, void* X, long long batch,
                                         int k, int r, void* stream) {
  if (r < 1) return (int)cudaErrorInvalidValue;
  return launch<double>(L, R, X, batch, k, r, stream);
}

// The launch of K3a (r = 0) or K3b at (k, r) for batch lanes, in f32 or,
// with f64 != 0, f64: out[0..5] = threads per lane, lanes per block, shared
// bytes per block, row capacity, resident blocks per SM, blocks in the
// grid. Returns 0, or a CUDA error code on a shape the kernels refuse.
extern "C" int srbx_pallas_launch_geometry(int f64, int k, int r, long long batch, int* out) {
  if (k < 1 || k > kMaxK || r < 0 || r > kMaxR || batch < 0) return (int)cudaErrorInvalidValue;
  Geometry geo{};
  const cudaError_t err = f64 ? dispatch<double>(nullptr, nullptr, nullptr, batch, k, r, 0, &geo)
                              : dispatch<float>(nullptr, nullptr, nullptr, batch, k, r, 0, &geo);
  if (err != cudaSuccess) return (int)err;
  const int fields[6] = {geo.group, geo.lanes, geo.smem, geo.capacity, geo.blocks_per_sm, geo.grid};
  for (int i = 0; i < 6; ++i) out[i] = fields[i];
  return 0;
}

// Warps resident per SM for K3a (r = 0) or K3b at (k, r), in f32 or, with
// f64 != 0, f64; -1 on a shape the kernels refuse.
extern "C" int srbx_pallas_resident_warps(int f64, int k, int r) {
  int out[6];
  if (srbx_pallas_launch_geometry(f64, k, r, 1, out) != 0) return -1;
  return out[4] * out[1] * out[0] / kWarp;
}
