// K1: batched Cholesky factor plus explicit inverse factor for Hopper.
//
// For each SPD block D[b] (n x n, row-major, n a multiple of 8, n <= 512)
// computes the lower Cholesky factor L[b] (D = L L^T) and L^{-1}[b], both
// with a zero strict upper triangle, and ok[b] = 1 when the factorization
// succeeded and every entry of L^{-1}[b] is finite.  A block whose pivot is
// not safely positive gets ok[b] = 0 and L, L^{-1} filled with NaN, the
// contract of the reference's `_chol_linv`.
//
// The pivot test.  The computed pivot p_j = D_jj - sum_{k<j} L_jk^2 is a
// sum of at most n rounded terms, each at most D_jj in size: it carries a
// rounding error of at most about n u D_jj (u = eps/2, the dtype's unit
// roundoff), and of about sqrt(n) u D_jj in a typical run (the
// probabilistic error model of Higham and Mary, SIAM J. Sci. Comput.
// 41(5), 2019).  LAPACK's potrf fails a block only when its own computed
// pivot is <= 0, so on a block whose least pivot is round-off it fails or
// factors by the sign of that round-off.  A block fails here when some
// pivot is <= 0, NaN or inf (checked as the diagonal tile is factored) or
// has
//     p_j = L_jj^2 <= c(n) * u * D_jj      (D_jj: the block's own entry)
// (checked once the block is factored, from L's diagonal, off the chain of
// dependent pivots), where c(n) differs by dtype:
//   * f64: c = 2 n, twice the worst-case error.  Two backward-stable
//     Choleskys' pivots differ by at most about that, so K1 fails every block
//     that LAPACK, or any other such factorization, could fail, and a
//     solve's f64 steps do not rest on the sign of one pivot's round-off
//     (an interior-point endgame over blocks singular to working
//     precision: K1 fails them and the solver regularizes, as LAPACK does
//     when its round-off falls below zero).  A pivot below ~5.3e-15 D_jj
//     at n = 24 (1.4e-14 at n = 64).
//   * f32: c = sqrt(n), the typical error.  The worst case would be 64
//     eps at n = 64, above the least pivots (6.5-13.5 eps D_jj) of the
//     f32-preconditioned deep levels of block cyclic reduction, which f32
//     factors and LAPACK passes; it would fail them all.  A pivot below
//     ~2.9e-7 D_jj at n = 24 (4.8e-7 at n = 64).
// The wrapper states the same test (solvers/chol_linv.py
// `pivot_threshold`).
//
// Replaces the TPU Pallas kernels `_chol_inv_kernel` (solvers/pallas_chol.py
// :38, launched by `_chol_inv_call` :157) and `_chol_inv_kernel2` (:90,
// launched by `_chol_inv_call2` :140) of the reference package, which
// compute the same function.
//
// What bounds it on an H100.  The bytes are one read of D and one write
// each of L and L^{-1}; the work is 2n^3/3 flops per block.  At the band
// shapes (n = 64) the bytes bound is a few microseconds, far below what a
// chain of n dependent column steps costs, so in practice the bound is the
// critical path inside one block: its barriers, its rsqrt chain and its
// dependent FMAs.  At n = 512 with few blocks the work (89 MFLOP per
// block) bounds it, and one SM alone cannot reach it.
//
// Design: one blocked right-looking algorithm on 8x8 tiles, shared by all
// paths.  Per panel k (8 columns):
//   * the diagonal tile (k,k) is factored by one warp entirely in registers
//     (every lane redundantly; one rsqrt per column gives both L[j][j] and
//     its reciprocal) and inverted there: Dinv = L[k][k]^{-1}, which is
//     also X[k][k] of X = L^{-1}.  Every pivot is checked here for <= 0,
//     NaN and inf (the rest of the pivot test above runs once the block is
//     factored);
//   * phase A: TRSM of the panel, L[i][k] L[k][k]^T = A[i][k], and row k
//     of X, L[k][k] X[k][j] = B[k][j] (j < k), both by forward substitution
//     with one row or column of 8 per lane (a product with Dinv instead
//     lost two orders of magnitude of backward error on the
//     ill-conditioned deep levels of block cyclic reduction);
//   * phase B: the trailing SYRK update A[i][j] -= L[i][k] L[j][k]^T and the
//     forward-substitution update B[i][j] -= L[i][k] X[k][j] (j <= k), one
//     8x8 output tile per task.  The warp that owns tile (k+1,k+1) updates
//     it first and factors it at once, so the next panel needs no extra
//     barrier.
// That is 2 team barriers per panel (2n/8 in all, against 2n before).
// Tasks are dealt to the team's warps round-robin; each warp walks only
// its own tasks (no division by a runtime size).  Each task is two m8n8k4
// f64 DMMA (mma.sync, the FP64 tensor cores) in f64, and FFMA in f32 (TF32
// would change the results).
//
// Two paths, chosen by the wrapper's launch plan (solvers/chol_linv.py
// `launch_plan`, which passes its configuration to the entry points):
//   1. up to the shared-memory limit (f64 n <= 120, f32 n <= 168): one CTA
//      per block, L and X in shared memory (rows padded by 4 elements when
//      that still fits, against bank conflicts), loaded by cp.async;
//      device memory is touched once per element.  A CTA has 8, 4, 2 or 1
//      warps: the most with which the batch still runs in one wave, so
//      many small blocks do not leave 7 of 8 warps idle.  At n = 64 the
//      CTA takes 70 KB and at most 85 registers a
//      thread, so 3 CTAs share an SM and the 344 blocks of the first BCR
//      level run in one wave.
//   2. above it: L and X live in the output buffers (a block is at most
//      2 MB and stays in the 50 MB L2).  One thread-block cluster of 8
//      CTAs (16 above n = 256) per block shares the tile tasks, so a block
//      gets several SMs' tensor cores and L2 bandwidth; the team barrier is
//      the cluster barrier, and loads bypass L1 (ld.global.cg).
// No atomics (the result is the same bit for bit from run to run), no
// allocation, the caller's stream; every entry point returns
// cudaGetLastError() after its launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSharedBytes = 232448;  // 227 KB per block on sm_90
constexpr int kPathCta = 1, kPathCluster = 2;

__device__ __forceinline__ double nan_of(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}
__device__ __forceinline__ float nan_of(float) {
  return __int_as_float(0x7fc00000);
}

// c(n) u of the pivot test (u = eps / 2): 2 n u in f64, sqrt(n) u in f32
__device__ __forceinline__ double pivot_constant(double, int n) {
  return 2.0 * n * 0x1p-53;
}
__device__ __forceinline__ float pivot_constant(float, int n) {
  return sqrtf(float(n)) * 0x1p-24f;
}

// The pivot test on a factored block: true when some L_jj^2 <= c(n) u
// D_jj (or is NaN), the same in every thread of the calling CTA (a
// barrier).  Ld holds L with leading dimension ld, Db the block's D.
template <typename T, class M>
__device__ bool pivot_test_fails(const T* Ld, int ld,
                                 const T* __restrict__ Db, int n) {
  const T cn = pivot_constant(T(0), n);
  int bad = 0;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const T l = M::ld(Ld + j * ld + j);
    bad |= !(l * l > cn * Db[j * n + j]);
  }
  return __syncthreads_or(bad) != 0;
}

// Asynchronous copy of one element from device to shared memory.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(static_cast<int>(sizeof(T))));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Where the working copies of L and X live.
struct SharedMem {
  template <typename T>
  __device__ __forceinline__ static T ld(const T* p) { return *p; }
};
struct GlobalMem {   // written by other SMs of the cluster: skip L1
  template <typename T>
  __device__ __forceinline__ static T ld(const T* p) { return __ldcg(p); }
};

// The warps that share one block's tile tasks, and their barrier.
struct CtaTeam {
  int w, nw;
  __device__ void sync() const { __syncthreads(); }
};
struct ClusterTeam {   // barrier.cluster: release on arrive, acquire on
  int w, nw;            // wait, at cluster scope -- every reader is in it
  __device__ void sync() const { cg::this_cluster().sync(); }
};

// One warp's 8x8 output tile: lane (g = lane/4, t = lane%4) holds
// C[g][2t] and C[g][2t+1], the accumulator layout of mma.m8n8k4.f64, and
// moves them as one 2-vector.  Every tile row starts 16-byte aligned: ld
// and tile columns are multiples of 4 elements.
template <typename T> struct Vec2;
template <> struct Vec2<double> { using type = double2; };
template <> struct Vec2<float> { using type = float2; };

template <typename T, class M>
__device__ __forceinline__ void tile_load(T acc[2], const T* C, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const auto v = M::ld(
      reinterpret_cast<const typename Vec2<T>::type*>(C + g * ld + 2 * t));
  acc[0] = v.x;
  acc[1] = v.y;
}

template <typename T>
__device__ __forceinline__ void tile_store(T* C, int ld, const T acc[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  typename Vec2<T>::type v;
  v.x = acc[0];
  v.y = acc[1];
  *reinterpret_cast<typename Vec2<T>::type*>(C + g * ld + 2 * t) = v;
}

// acc += sgn * P Q (kQT false) or sgn * P Q^T (kQT true); P, Q 8x8 tiles.
template <bool kQT, class M>
__device__ __forceinline__ void tile_mma(double acc[2], const double* P,
                                         const double* Q, int ld,
                                         double sgn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; kk += 4) {
    // A (8x4, row): A[g][t]; B (4x8, col): B[t][g]
    const double a = sgn * M::ld(P + g * ld + kk + t);
    const double b = kQT ? M::ld(Q + g * ld + kk + t)
                         : M::ld(Q + (kk + t) * ld + g);
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(acc[0]), "+d"(acc[1])
        : "d"(a), "d"(b));
  }
}

// f32: FFMA (TF32 would change the results).  P's row g and, for P Q^T,
// Q's rows 2t and 2t+1 come as float4s.
template <bool kQT, class M>
__device__ __forceinline__ void tile_mma(float acc[2], const float* P,
                                         const float* Q, int ld, float sgn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float a[8], b0[8], b1[8];
  auto row8 = [&](const float* src, float* dst) {
    const float4* v = reinterpret_cast<const float4*>(src);
    const float4 lo = M::ld(v), hi = M::ld(v + 1);
    dst[0] = lo.x; dst[1] = lo.y; dst[2] = lo.z; dst[3] = lo.w;
    dst[4] = hi.x; dst[5] = hi.y; dst[6] = hi.z; dst[7] = hi.w;
  };
  row8(P + g * ld, a);
  if (kQT) {
    row8(Q + (2 * t) * ld, b0);
    row8(Q + (2 * t + 1) * ld, b1);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float2 v =
          M::ld(reinterpret_cast<const float2*>(Q + k * ld + 2 * t));
      b0[k] = v.x;
      b1[k] = v.y;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    acc[0] = fmaf(sgn * a[k], b0[k], acc[0]);
    acc[1] = fmaf(sgn * a[k], b1[k], acc[1]);
  }
}

// Factor the 8x8 diagonal tile at Lt in place (zeros above its diagonal)
// and write its inverse to Xt.  Every lane of the calling warp factors the
// whole tile in registers, then computes the one column of the inverse it
// stores: lane (r0 = lane/8, c = lane%8) stores rows r0 and r0+4 of
// column c.  Returns true when a pivot failed (<= 0, NaN or inf), the same
// on every lane.
template <typename T, class M>
__device__ bool factor_diag(T* Lt, T* Xt, int ld) {
  const int lane = threadIdx.x & 31, c = lane & 7, r0 = lane >> 3;
  T a[8][8], y[8], rd[8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int cc = 0; cc <= r; ++cc) a[r][cc] = M::ld(Lt + r * ld + cc);
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const T p = a[j][j];
    bad |= !(p > T(0)) || isinf(p);
    // one rsqrt gives both 1/L[j][j] and L[j][j]: the column's critical
    // path is one MUFU-seeded Newton sequence instead of sqrt and divide
    rd[j] = rsqrt(p);
    a[j][j] = p * rd[j];
#pragma unroll
    for (int i = j + 1; i < 8; ++i) a[i][j] *= rd[j];
#pragma unroll
    for (int cc = j + 1; cc < 8; ++cc)
#pragma unroll
      for (int i = cc; i < 8; ++i) a[i][cc] -= a[i][j] * a[cc][j];
  }
  // column c of Y = L^{-1}: y[i] = rd[i] (delta_ic - sum_{m<i} a[i][m] y[m]);
  // rows above c come out exactly 0
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    T s = (i == c) ? T(1) : T(0);
#pragma unroll
    for (int m = 0; m < i; ++m) s -= a[i][m] * y[m];
    y[i] = s * rd[i];
  }
  // pick this lane's entries out of the unrolled registers
  T l0 = T(0), l1 = T(0), x0 = T(0), x1 = T(0);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r == r0) { x0 = y[r]; x1 = y[r + 4]; }
#pragma unroll
    for (int cc = 0; cc <= r; ++cc)
      if (r == r0 && cc == c) l0 = a[r][cc];
#pragma unroll
    for (int cc = 0; cc <= r + 4; ++cc)
      if (r == r0 && cc == c) l1 = a[r + 4][cc];
  }
  __syncwarp();   // every lane has read the tile before any lane writes
  Lt[r0 * ld + c] = l0;
  Lt[(r0 + 4) * ld + c] = l1;
  Xt[r0 * ld + c] = x0;
  Xt[(r0 + 4) * ld + c] = x1;
  __syncwarp();
  return bad;
}

// Forward substitution with the factored diagonal tile L11 on up to 32
// vectors of 8, one per lane: v[c] = (v[c] - sum_{m<c} L11[c][m] v[m]) /
// L11[c][c].  Lane l's vector starts at V + l * lane_step, its entries
// elem_step apart.  Both of phase A's solves are this: the panel's TRSM
// X L11^T = A works on rows of A, row k of X = L^{-1}, L11 X[k][j] = B[k][j],
// on columns of B.  Substitution is the backward-stable order; a product
// with L11^{-1} lost two orders of magnitude of backward error on the
// ill-conditioned deep levels of block cyclic reduction.  The reciprocals
// of L11's diagonal are the diagonal of X11 = L11^{-1} (exactly:
// factor_diag stores them there), so the chain has no divide.
template <typename T, class M>
__device__ __forceinline__ void subst8(T* V, int lane_step, int elem_step,
                                       const T* L11, const T* X11, int ld,
                                       int count) {
  const int lane = threadIdx.x & 31;
  T l[8][8], rd[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    rd[r] = M::ld(X11 + r * ld + r);
#pragma unroll
    for (int c = 0; c < r; ++c) l[r][c] = M::ld(L11 + r * ld + c);
  }
  if (lane >= count) return;
  T* v = V + lane * lane_step;
  T x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = M::ld(v + c * elem_step);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    T acc = x[c];
#pragma unroll
    for (int m = 0; m < c; ++m) acc -= l[c][m] * x[m];
    x[c] = acc * rd[c];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c * elem_step] = x[c];
}

// The blocked factorization of one block by a team of warps.  On entry Lb
// holds D (only its lower triangle is read) and Xb zeros, both with
// leading dimension ld; on exit the lower triangles of Lb and Xb hold L and
// X = L^{-1}, and Xb's strict upper triangle is still zero.  Team warp 0
// factors every diagonal tile and sets *failed on a bad pivot.  Ends with a
// team barrier.
template <typename T, class M, class Team>
__device__ void factor_block(T* Lb, T* Xb, int n, int ld, const Team& team,
                             int* failed) {
  const int nt = n >> 3, lane = threadIdx.x & 31;
  auto Lt = [=](int i, int j) { return Lb + 8 * (i * ld + j); };
  auto Xt = [=](int i, int j) { return Xb + 8 * (i * ld + j); };
  // in phase B warp 0 also factors the next diagonal tile: deal from warp 1
  const int first_b = team.nw > 1 ? 1 : 0;
  if (team.w == 0 && factor_diag<T, M>(Lt(0, 0), Xt(0, 0), ld) && lane == 0)
    *failed = 1;
  team.sync();
  for (int k = 0; k < nt; ++k) {
    // phase A: the panel's TRSM (32 rows of the panel per task) and row k
    // of X (32 columns per task), both by substitution with L[k][k]
    const int r0 = 8 * (k + 1);
    const int nrow = (n - r0 + 31) >> 5, ncol = (8 * k + 31) >> 5;
    for (int t = team.w; t < nrow + ncol; t += team.nw) {
      if (t < nrow)
        subst8<T, M>(Lb + (r0 + 32 * t) * ld + 8 * k, ld, 1, Lt(k, k),
                     Xt(k, k), ld, n - r0 - 32 * t);
      else
        subst8<T, M>(Xb + 8 * k * ld + 32 * (t - nrow), 1, ld, Lt(k, k),
                     Xt(k, k), ld, 8 * k - 32 * (t - nrow));
    }
    team.sync();
    if (k == nt - 1) break;
    // phase B: trailing SYRK and the forward-substitution update
    if (team.w == 0) {
      T acc[2];
      tile_load<T, M>(acc, Lt(k + 1, k + 1), ld);
      tile_mma<true, M>(acc, Lt(k + 1, k), Lt(k + 1, k), ld, T(-1));
      tile_store(Lt(k + 1, k + 1), ld, acc);
      __syncwarp();
      if (factor_diag<T, M>(Lt(k + 1, k + 1), Xt(k + 1, k + 1), ld) &&
          lane == 0)
        *failed = 1;
    }
    // row i's tasks are j = 0..i: j <= k updates X[i][j], j > k is the
    // SYRK tile (i, j); row k+1 stops before its diagonal tile (warp 0's)
    int p = team.w - first_b, i = k + 1;
    if (p < 0) p += team.nw;
    while (i < nt) {
      const int len = (i == k + 1) ? k + 1 : i + 1;
      if (p >= len) {
        p -= len;
        ++i;
        continue;
      }
      T acc[2];
      if (p <= k) {
        tile_load<T, M>(acc, Xt(i, p), ld);
        tile_mma<false, M>(acc, Lt(i, k), Xt(k, p), ld, T(-1));
        tile_store(Xt(i, p), ld, acc);
      } else {
        tile_load<T, M>(acc, Lt(i, p), ld);
        tile_mma<true, M>(acc, Lt(i, k), Lt(p, k), ld, T(-1));
        tile_store(Lt(i, p), ld, acc);
      }
      p += team.nw;
    }
    team.sync();
  }
}

// Path 1: one CTA per block, the block's L and X in shared memory.
template <typename T>
__global__ void __launch_bounds__(256, 3)
chol_linv_smem_kernel(const T* __restrict__ D, T* __restrict__ L,
                      T* __restrict__ Linv, int* __restrict__ ok, int n,
                      int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int failed;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  T* Ls = reinterpret_cast<T*>(smem_raw);
  T* Xs = Ls + n * ld;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const T* Db = D + base;
  T* Lb = L + base;
  T* Xb = Linv + base;

  if (threadIdx.x == 0) failed = 0;
  // D's rows go to shared memory by cp.async, all in flight at once; the
  // strict upper triangle comes along, is never read, and is masked at the
  // store
  for (int r = warp; r < n; r += nwarps)
    for (int c = lane; c < n; c += 32) {
      cp_async(Ls + r * ld + c, Db + r * n + c);
      Xs[r * ld + c] = T(0);
    }
  cp_async_wait_all();
  const CtaTeam team{warp, nwarps};
  team.sync();
  factor_block<T, SharedMem>(Ls, Xs, n, ld, team, &failed);

  const bool bad =
      pivot_test_fails<T, SharedMem>(Ls, ld, Db, n) || failed != 0;
  int nonfinite = 0;
  for (int r = warp; r < n; r += nwarps)
    for (int c = lane; c < n; c += 32) {
      if (bad) {
        Lb[r * n + c] = nan_of(T(0));
        Xb[r * n + c] = nan_of(T(0));
      } else {
        const T xv = Xs[r * ld + c];
        nonfinite |= !isfinite(xv);
        Lb[r * n + c] = c <= r ? Ls[r * ld + c] : T(0);
        Xb[r * n + c] = xv;
      }
    }
  const int any = __syncthreads_or(nonfinite);
  if (threadIdx.x == 0) ok[blockIdx.x] = (!bad && !any) ? 1 : 0;
}

// Path 2: L and X in the output buffers; one cluster of CTAs per block.
template <typename T>
__global__ void __launch_bounds__(256)
chol_linv_cluster_kernel(const T* __restrict__ D, T* __restrict__ L,
                         T* __restrict__ Linv, int* __restrict__ ok,
                         int n) {
  __shared__ int failed, nonfinite;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int cs = static_cast<int>(cluster.num_blocks());
  const int b = blockIdx.x / cs;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpc = blockDim.x >> 5;
  const ClusterTeam team{rank * wpc + warp, cs * wpc};
  const size_t base = static_cast<size_t>(b) * n * n;
  const T* Db = D + base;
  T* Lb = L + base;
  T* Xb = Linv + base;

  if (threadIdx.x == 0) failed = 0;
  for (int r = team.w; r < n; r += team.nw)
#pragma unroll 4
    for (int c = lane; c < n; c += 32) {
      Lb[r * n + c] = c <= r ? Db[r * n + c] : T(0);
      Xb[r * n + c] = T(0);
    }
  team.sync();
  // only rank 0's warp 0 factors diagonal tiles, so only rank 0's flag moves
  factor_block<T, GlobalMem>(Lb, Xb, n, n, team, &failed);

  // every CTA of the cluster tests all of L's diagonal, so all agree
  const bool bad = pivot_test_fails<T, GlobalMem>(Lb, n, Db, n) ||
                   *cluster.map_shared_rank(&failed, 0) != 0;
  int nf = 0;
  for (int r = team.w; r < n; r += team.nw)
    for (int c = lane; c < n; c += 32) {
      if (bad) {
        Lb[r * n + c] = nan_of(T(0));
        Xb[r * n + c] = nan_of(T(0));
      } else {
        nf |= !isfinite(__ldcg(Xb + r * n + c));
      }
    }
  nf = __syncthreads_or(nf);
  if (threadIdx.x == 0) nonfinite = nf;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    int any = 0;
    for (int q = 0; q < cs; ++q) any |= *cluster.map_shared_rank(&nonfinite, q);
    ok[b] = (!bad && !any) ? 1 : 0;
  }
  cluster.sync();   // no CTA leaves while rank 0 reads its shared memory
}

// The launch configuration comes from the wrapper's plan
// (solvers/chol_linv.py `launch_plan`): path, ctas (CTAs per block: 1 on
// path 1, the cluster size on path 2), threads, dynamic shared bytes and
// the shared-memory leading dimension ld.
template <typename T>
int launch(const T* D, T* L, T* Linv, int* ok, int nb, int n, int path,
           int ctas, int threads, int smem, int ld, cudaStream_t stream) {
  if (nb <= 0) return 0;
  const bool shape_ok = n >= 8 && n <= 512 && n % 8 == 0 && threads >= 32 &&
                        threads <= 256 && threads % 32 == 0 && ctas >= 1 &&
                        smem >= 0 && smem <= kMaxSharedBytes;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  if (path == kPathCta) {
    const long need = 2L * n * ld * sizeof(T);
    if (ld < n || need > smem || ctas != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t e = cudaFuncSetAttribute(
        chol_linv_smem_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    chol_linv_smem_kernel<T><<<nb, threads, smem, stream>>>(D, L, Linv, ok,
                                                            n, ld);
  } else if (path == kPathCluster) {
    if (ctas > 16 || smem != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (ctas > 8) {   // 16 CTAs is a non-portable cluster size on H100
      cudaError_t e = cudaFuncSetAttribute(
          chol_linv_cluster_kernel<T>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nb * ctas);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, chol_linv_cluster_kernel<T>, D,
                                       L, Linv, ok, n);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ixm_chol_linv_f64(const double* D, double* L, double* Linv,
                                 int* ok, int nb, int n, int path,
                                 int ctas, int threads, int smem, int ld,
                                 void* stream) {
  return launch<double>(D, L, Linv, ok, nb, n, path, ctas, threads, smem,
                        ld, static_cast<cudaStream_t>(stream));
}

extern "C" int ixm_chol_linv_f32(const float* D, float* L, float* Linv,
                                 int* ok, int nb, int n, int path,
                                 int ctas, int threads, int smem, int ld,
                                 void* stream) {
  return launch<float>(D, L, Linv, ok, nb, n, path, ctas, threads, smem,
                       ld, static_cast<cudaStream_t>(stream));
}
