// Batched small SPD solve and inverse (kernels K2a and K2b): one launch per
// call, each lane's factorization and substitution in one group of threads,
// the factor in registers.
//
// Replaces the Pallas TPU kernels srbx/ops/spd.py::_solve_kernel (K2a,
// entered through spd.solve) and ::_inv_kernel (K2b, spd.inverse). Per lane:
// D = L L' by Cholesky, then (L L') X = B by forward and back substitution,
// with B the caller's right-hand sides (K2a) or the identity (K2b). On the
// whole-body path k = 18 (the mass matrix; K2a with r = 1, K2b) and k = 12
// (the swing operational-space matrix, K2b), at B = 4096.
//
// Layout: batch-leading, as at the JAX package's API: D (B, k, k), B and X
// (B, k, r), row-major and contiguous; any B, 1 <= k <= 32, 1 <= r <= 32.
//
// What bounds it on an H100. Bytes, in the limit: at B = 4096, k = 18 in
// f32 the inverse must read D's lower triangle and write D^-1 (8.1 MB,
// 2.4 us at 3.35 TB/s), the solve read the triangle and the right-hand
// sides and write X (3.4 MB, 1.0 us). In fact instruction issue and each
// lane's chain of dependent steps bound it: k column steps of the
// factorization (a square root, a division, a broadcast and an update
// each), then 2k substitution steps. At B = 4096 a launch is one wave of
// about 31 lanes an SM, so the SM's issue slots are shared by few lanes
// and every instruction a warp issues for an idle thread is lost. Per
// lane, the kernel is K3a followed by K3b on the same lane, with device
// routines taken from K3's (pallas_linalg.cu). They are a copy: moved into
// a header both sources included, they cost K3a at k 28 and K3b at
// (41, 28) 2-2.5 % in turns and made K3a's f32 K 32 build spill.
//   * factor (chol_rows): a group of G = 16 threads a lane (two lanes a
//     warp) owns the lower triangle's rows in registers, a balanced share
//     (rows t and 31 - t at k 18); each column step broadcasts a_jj by
//     shuffle, divides the owners' entries, passes the column through a
//     double buffer in shared memory and updates each thread's rows in
//     registers, 16 bytes of the column a load, skipping the pieces past
//     column k - 1;
//   * hand-off: the owners write L's lower triangle to the lane's stage in
//     shared memory (rows of an odd number of elements for r = 1, so that
//     reading a column hits distinct banks; rows padded to 16 bytes for
//     r > 1, read 16 bytes at a time); L never goes to device memory;
//   * substitute, r = 1 (solve1, K2a on the path): x in registers, row i on
//     thread i mod G, one shuffle a step, rolled step loops;
//   * substitute, r > 1 and the identity (solve_cols, K2b): thread c owns
//     column c of X (c, c + 16) in registers and reads L by 16-byte
//     broadcasts. For the identity X is never read from memory: column c
//     starts as e_c in registers. Its rows above c stay exact zeros
//     through the forward pass (a zero over L_ii is returned as is, an
//     update by y_j = 0 leaves them as they are), bitwise what the plain
//     loop computes there; the second 16 columns' forward pass starts at
//     row 16, as all of the group's columns are zero above it.
// Row capacities K 16, 24 and 32 (k 12, 18 and up to 32) keep the
// registers a thread holds near k. Measured in turns (PERF.md section 6):
// a half-warp beat a warp at every path shape (K2a 14.1 against 18.9 us,
// K2b k 18 21.6 against 23.5 us, B 4096) and a quarter-warp for the
// one-column solve did not beat it; a look-ahead factorization (column
// j + 1 divided while column j's trailing update runs), fully unrolled
// solve steps and a plain division in the factorization each lost.
// Loads and stores: a lane's D (the pieces with lower-triangle entries) and
// its right-hand sides are copied once into its stage with cp.async, and X
// is written once from the registers, coalesced. A block's groups loop over
// lanes (a grid of at most the resident blocks); the next lane's copy starts
// when the stage is free. All synchronisation is within a lane's group.
//
// Arithmetic kept from the TPU kernel: column j is divided by sqrt(a_jj),
// its diagonal entry included (L_jj = a_jj / sqrt(a_jj)); the substitutions
// divide by L_jj, with no stored reciprocals; the square root is not
// guarded, so a lane that is not positive definite comes out non-finite, in
// that lane only; only the lower triangle of D is read. Every update is a
// rounded product and a rounded subtraction (no fused multiply-add), applied
// to each entry in the plain loop's column order, and every division and
// square root is IEEE, so a lane's result is bitwise the one of the plain
// PyTorch loop (srbx_torch/ops/spd.py::solve_plain and inverse_plain).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kWarp = 32;

// Elements of T in 16 bytes, and n rounded up to a multiple of them.
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }
template <typename T>
__host__ __device__ constexpr int round16(int n) {
  return (n + vec<T>() - 1) / vec<T>() * vec<T>();
}

// Shared-memory elements that hold a flat k x k block staged by stage_lower
// with room for its 16-byte phase and for row k - 1 read K entries wide (as
// load_rows reads it).
template <typename T, int K>
__host__ __device__ constexpr int chol_stage_len(int k) { return round16<T>(k * k + K + vec<T>()); }

__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// x / d, IEEE. The division's fast path hands a zero numerator to its slow
// path, and many operands hold exact zeros: a zero over a positive divisor
// is returned as is (the same signed zero, bitwise the IEEE quotient).
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

// Starts the asynchronous copy of the n elements at src (global) into
// buf + phase(src) (shared), as stage_lower copies, all of them.
template <typename T, int G>
__device__ __forceinline__ void stage_all(T* buf, const T* src, int n, int t) {
  constexpr int V = vec<T>();
  const int ph = phase(src);
  T* dst = buf + ph;
  const int head = min(n, (V - ph) % V);
  const int body = (n - head) / V;
  const int tail = head + body * V;
  if (t < head) __pipeline_memcpy_async(dst + t, src + t, sizeof(T));
  if (t < n - tail) __pipeline_memcpy_async(dst + tail + t, src + tail + t, sizeof(T));
  for (int q = t; q < body; q += G)
    __pipeline_memcpy_async(dst + head + q * V, src + head + q * V, 16);
}

// The rows thread t of a group of G owns in chol_rows: slot s holds row
// s G + t (s even) or s G + G - 1 - t (s odd); rowc is the row clamped to
// k - 1 (rows past k read row k - 1, unused).
template <int K, int G>
struct RowShare {
  static constexpr int S = (K + G - 1) / G;  // rows a thread owns
  int row[S], rowc[S];

  __device__ __forceinline__ RowShare(int t, int k) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      row[s] = s * G + ((s & 1) ? G - 1 - t : t);
      rowc[s] = min(row[s], k - 1);
    }
  }
};

// a[s][c] = entry (row[s], c) of the flat k x k block at in (shared);
// entries right of the diagonal are read but unused.
template <typename T, int K, int G>
__device__ __forceinline__ void load_rows(T (&a)[RowShare<K, G>::S][K], const RowShare<K, G>& rs,
                                          const T* in, int k) {
#pragma unroll
  for (int s = 0; s < RowShare<K, G>::S; ++s)
#pragma unroll
    for (int c = 0; c < K; ++c)
      if (c < (s + 1) * G) a[s][c] = in[rs.rowc[s] * k + c];
}

// M = L L' in place on the rows in a (load_rows), column by column;
// colbuf (shared) holds 2 round16(K) elements. Ends with the group
// synchronised (after every thread's last read of its stage).
template <typename T, int K, int G>
__device__ __forceinline__ void chol_rows(T (&a)[RowShare<K, G>::S][K], const RowShare<K, G>& rs,
                                          T* colbuf, int k, const Group<G>& grp) {
  constexpr int S = RowShare<K, G>::S;
  constexpr int V = vec<T>();
  constexpr int KC = round16<T>(K);  // length of a column buffer
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < k) {
      const int sj = j / G;  // row j's owner: slot sj of thread tj
      const int tj = (sj & 1) ? G - 1 - j % G : j % G;
      const T d = dev_sqrt(grp.bcast(a[sj][j], tj));
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (j < (s + 1) * G && rs.row[s] >= j && rs.row[s] < k) a[s][j] = div_rn(a[s][j], d);
      // column j to the buffer: every row's owner stores its entry (the
      // positions at or above j are read by no update)
      T* col = colbuf + (j & 1) * KC;
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (j + 1 < (s + 1) * G && rs.row[s] < k) col[rs.row[s]] = a[s][j];
      grp.sync();
      // the trailing update, column j + 1 first; 16-byte pieces past
      // column k - 1 are skipped
#pragma unroll
      for (int q = 0; q < KC / V; ++q) {
        if ((q + 1) * V > j + 1 && q * V < k) {
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
}

// (L L') x = x in place for one right-hand side, a group of G a lane:
// x[s] is row s G + t; L's lower triangle is read at l[i ld + j] (shared).
// Every thread divides the same x_j by the same L_jj, so no step branches
// on the owner.
template <typename T, int K, int G>
__device__ __forceinline__ void solve1(T (&x)[(K + G - 1) / G], const T* l, int ld, int k,
                                       const Group<G>& grp) {
  constexpr int S = (K + G - 1) / G;  // rows a thread owns
  // forward: y_j = x_j / L_jj, then x_i -= L_ij y_j for i > j
#pragma unroll
  for (int sj = 0; sj < S; ++sj) {
    const int steps = min(G, k - sj * G);
#pragma unroll 4
    for (int tj = 0; tj < steps; ++tj) {
      const int j = sj * G + tj;
      const T y = grp.bcast(x[sj], tj) / l[j * ld + j];
      if (grp.t == tj) x[sj] = y;
      if (grp.t > tj && sj * G + grp.t < k)
        x[sj] = sub_rn(x[sj], mul_rn(l[(sj * G + grp.t) * ld + j], y));
#pragma unroll
      for (int s = sj + 1; s < S; ++s)
        if (s * G + grp.t < k) x[s] = sub_rn(x[s], mul_rn(l[(s * G + grp.t) * ld + j], y));
    }
  }
  // back: x_j /= L_jj, then x_i -= L_ji x_j for i < j
#pragma unroll
  for (int sj = S - 1; sj >= 0; --sj) {
#pragma unroll 4
    for (int tj = min(G - 1, k - 1 - sj * G); tj >= 0; --tj) {
      const T* lj = l + (sj * G + tj) * ld;  // row j of L
      const T y = grp.bcast(x[sj], tj) / lj[sj * G + tj];
      if (grp.t == tj) x[sj] = y;
      if (grp.t < tj) x[sj] = sub_rn(x[sj], mul_rn(lj[sj * G + grp.t], y));
#pragma unroll
      for (int s = 0; s < sj; ++s) x[s] = sub_rn(x[s], mul_rn(lj[s * G + grp.t], y));
    }
  }
}

// (L L') x = x in place for the column of X in x (k entries), L's lower
// triangle in shared memory at l in rows of kp elements (a multiple of 16
// bytes, l 16-byte aligned).
// With kFrom, the forward pass starts at row `from` (a multiple of 16
// bytes' elements, the same for the whole group): the rows above it hold
// exact zeros in every column the group solves, and the plain loop leaves
// them so (0 / L_ii is +0, and an update by y_j = +0 changes nothing).
template <typename T, int K, bool kFrom>
__device__ __forceinline__ void solve_cols(T (&x)[K], const T* l, int kp, int k, int from) {
  constexpr int V = vec<T>();
  // forward, by rows: x_i -= L_ij y_j for j < i in order, y_i = x_i / L_ii
#pragma unroll
  for (int i = 0; i < K; ++i) {
    if (i < k && (!kFrom || i >= from)) {
      const T* li = l + i * kp;
#pragma unroll
      for (int q = 0; q < K / V; ++q) {
        if (q * V < i && (!kFrom || (q + 1) * V > from)) {
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
}

// How a launch is laid out.
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

constexpr int kMaxK = 32;
constexpr int kMaxR = 32;
constexpr int kThreads = 64;  // threads per block

// What the right-hand sides are: one column, several, or the identity.
enum Rhs { kOne = 0, kMany = 1, kIdentity = 2 };

// Row capacities: k up to 16, 24 (the mass matrix's k 18) and 32.
constexpr int spd_capacity(int k) { return k <= 16 ? 16 : k <= 24 ? 24 : 32; }

constexpr int kGroup = 16;     // threads per lane (two lanes a warp)

// Elements between two rows of L in the stage.
template <typename T, int MODE>
__host__ __device__ constexpr int l_stride(int k) {
  return MODE == kOne ? (k | 1) : round16<T>(k);
}

// Shared-memory elements of one lane's stage: D (then L), the two column
// buffers, and the right-hand sides with room for their 16-byte phase.
template <typename T, int K, int MODE>
__host__ __device__ constexpr int stage_len(int k) {
  return round16<T>(chol_stage_len<T, K>(k) > k * l_stride<T, MODE>(k)
                        ? chol_stage_len<T, K>(k)
                        : k * l_stride<T, MODE>(k));
}
template <typename T, int K, int MODE>
__host__ __device__ constexpr int group_len(int k, int r) {
  return stage_len<T, K, MODE>(k) + 2 * round16<T>(K) +
         (MODE == kIdentity ? 0 : round16<T>(k * r + vec<T>()));
}

// (One resident block per SM at least: with no minimum given, ptxas held
// the f32 builds to 96 registers and spilled.)
template <typename T, int K, int G, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
spd_lane_kernel(const T* __restrict__ D, const T* __restrict__ Bm, T* __restrict__ X,
                long long batch, int k, int r) {
  constexpr int S = RowShare<K, G>::S;  // rows a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Group<G> grp;
  const int groups = kThreads / G;
  const int n = k * k;
  const int ld = l_stride<T, MODE>(k);
  T* buf = reinterpret_cast<T*>(smem_raw) +
           (size_t)((int)threadIdx.x / G) * group_len<T, K, MODE>(k, r);
  T* colbuf = buf + stage_len<T, K, MODE>(k);
  T* rbuf = colbuf + 2 * round16<T>(K);
  const long long stride = (long long)gridDim.x * groups;
  long long lane = (long long)blockIdx.x * groups + (int)threadIdx.x / G;
  if (lane >= batch) return;  // the whole group leaves

  const RowShare<K, G> rs(grp.t, k);
  stage_lower<T, G>(buf, D + lane * n, k, grp.t);
  if (MODE != kIdentity) stage_all<T, G>(rbuf, Bm + lane * k * r, k * r, grp.t);
  __pipeline_commit();
  for (; lane < batch; lane += stride) {
    const long long next = lane + stride;
    __pipeline_wait_prior(0);
    grp.sync();
    {
      T a[S][K];
      load_rows<T, K, G>(a, rs, buf + phase(D + lane * n), k);
      chol_rows<T, K, G>(a, rs, colbuf, k, grp);
      // L's lower triangle to the stage (every thread has read its rows of
      // D: chol_rows ends synchronised after the last read)
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (rs.row[s] < k) {
#pragma unroll
          for (int c = 0; c < K; ++c)
            if (c < (s + 1) * G && c <= rs.row[s]) buf[rs.row[s] * ld + c] = a[s][c];
        }
    }
    grp.sync();
    if (MODE == kOne) {
      const T* rb = rbuf + phase(Bm + lane * k);
      T x[S];
#pragma unroll
      for (int s = 0; s < S; ++s) x[s] = s * G + grp.t < k ? rb[s * G + grp.t] : T(0);
      solve1<T, K, G>(x, buf, ld, k, grp);
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s * G + grp.t < k) X[lane * k + s * G + grp.t] = x[s];
    } else {
      const T* rb = MODE == kIdentity ? nullptr : rbuf + phase(Bm + lane * k * r);
      T* xl = X + lane * k * r;
#pragma unroll 1
      for (int c0 = 0; c0 < r; c0 += G) {
        const int c = c0 + grp.t;
        const bool active = c < r;
        T x[K];
        // an idle column holds ones, not zeros: no slow divisions
#pragma unroll
        for (int i = 0; i < K; ++i)
          x[i] = !(i < k && active) ? T(1)
                 : MODE == kIdentity ? (i == c ? T(1) : T(0))
                                     : rb[i * r + c];
        // identity columns past the first 16 start their forward pass at
        // their first column's row (at K 16 there are none: one pass, and
        // the unused branch measured 19 % slower at B 65536)
        if (MODE == kIdentity && K > G && c0 > 0)
          solve_cols<T, K, true>(x, buf, ld, k, c0);
        else
          solve_cols<T, K, false>(x, buf, ld, k, 0);
        if (active) {
#pragma unroll
          for (int i = 0; i < K; ++i)
            if (i < k) xl[i * r + c] = x[i];
        }
      }
    }
    grp.sync();  // the stage is free for the next lane
    if (next < batch) {
      stage_lower<T, G>(buf, D + next * n, k, grp.t);
      if (MODE != kIdentity) stage_all<T, G>(rbuf, Bm + next * k * r, k * r, grp.t);
    }
    __pipeline_commit();
  }
}

template <typename T, int K, int MODE>
cudaError_t spd_at(const T* D, const T* Bm, T* X, long long batch, int k, int r,
                   cudaStream_t stream, Geometry* geo) {
  constexpr int G = kGroup;
  const size_t smem = sizeof(T) * (size_t)(kThreads / G) * group_len<T, K, MODE>(k, r);
  void (*kern)(const T*, const T*, T*, long long, int, int) = spd_lane_kernel<T, K, G, MODE>;
  const cudaError_t err = plan(kern, kThreads, G, K, smem, batch, geo);
  if (err != cudaSuccess || D == nullptr) return err;
  kern<<<geo->grid, kThreads, smem, stream>>>(D, Bm, X, batch, k, r);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t spd_mode(const T* D, const T* Bm, T* X, long long batch, int k, int r,
                     cudaStream_t stream, Geometry* geo) {
  if (r == 0) return spd_at<T, K, kIdentity>(D, Bm, X, batch, k, k, stream, geo);
  if (r == 1) return spd_at<T, K, kOne>(D, Bm, X, batch, k, 1, stream, geo);
  return spd_at<T, K, kMany>(D, Bm, X, batch, k, r, stream, geo);
}

// The solve at (k, r), or with r = 0 the inverse (r = k, the identity as
// right-hand sides), through the instantiation of k's capacity; with null
// operands it only fills geo.
template <typename T>
cudaError_t dispatch(const void* D, const void* Bm, void* X, long long batch, int k, int r,
                     cudaStream_t stream, Geometry* geo) {
  const T* d = (const T*)D;
  const T* b = (const T*)Bm;
  T* x = (T*)X;
  switch (spd_capacity(k)) {
    case 16:
      return spd_mode<T, 16>(d, b, x, batch, k, r, stream, geo);
    case 24:
      return spd_mode<T, 24>(d, b, x, batch, k, r, stream, geo);
    default:
      return spd_mode<T, 32>(d, b, x, batch, k, r, stream, geo);
  }
}

template <typename T>
int launch(const void* D, const void* Bm, void* X, long long batch, int k, int r, void* stream) {
  if (k < 1 || k > kMaxK || r < 0 || r > kMaxR) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return 0;
  Geometry geo;
  return (int)dispatch<T>(D, Bm, X, batch, k, r, (cudaStream_t)stream, &geo);
}

}  // namespace

// C entry points, bound with ctypes.
extern "C" int srbx_spd_solve_f32(const void* D, const void* Bm, void* X, long long batch, int k,
                                  int r, void* stream) {
  if (r < 1) return (int)cudaErrorInvalidValue;
  return launch<float>(D, Bm, X, batch, k, r, stream);
}

extern "C" int srbx_spd_solve_f64(const void* D, const void* Bm, void* X, long long batch, int k,
                                  int r, void* stream) {
  if (r < 1) return (int)cudaErrorInvalidValue;
  return launch<double>(D, Bm, X, batch, k, r, stream);
}

extern "C" int srbx_spd_inverse_f32(const void* D, void* X, long long batch, int k, void* stream) {
  return launch<float>(D, nullptr, X, batch, k, 0, stream);
}

extern "C" int srbx_spd_inverse_f64(const void* D, void* X, long long batch, int k, void* stream) {
  return launch<double>(D, nullptr, X, batch, k, 0, stream);
}

// The launch of the solve at (k, r), or with r = 0 of the inverse, for batch
// lanes, in f32 or, with f64 != 0, f64: out[0..5] = threads per lane, lanes
// per block, shared bytes per block, row capacity, resident blocks per SM,
// blocks in the grid. Returns 0, or a CUDA error code on a shape the kernels
// refuse.
extern "C" int srbx_spd_launch_geometry(int f64, int k, int r, long long batch, int* out) {
  if (k < 1 || k > kMaxK || r < 0 || r > kMaxR || batch < 0) return (int)cudaErrorInvalidValue;
  Geometry geo{};
  const cudaError_t err = f64 ? dispatch<double>(nullptr, nullptr, nullptr, batch, k, r, 0, &geo)
                              : dispatch<float>(nullptr, nullptr, nullptr, batch, k, r, 0, &geo);
  if (err != cudaSuccess) return (int)err;
  const int fields[6] = {geo.group, geo.lanes, geo.smem, geo.capacity, geo.blocks_per_sm, geo.grid};
  for (int i = 0; i < 6; ++i) out[i] = fields[i];
  return 0;
}

// Warps resident per SM for the solve at (k, r), or with r = 0 the inverse,
// in f32 or, with f64 != 0, f64; -1 on a shape the kernels refuse.
extern "C" int srbx_spd_resident_warps(int f64, int k, int r) {
  int out[6];
  if (srbx_spd_launch_geometry(f64, k, r, 1, out) != 0) return -1;
  return out[4] * out[1] * out[0] / kWarp;
}
