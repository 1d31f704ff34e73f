// K2: one level of block cyclic reduction's Schur update, for Hopper.
//
// A level of BCR (solvers/block_tridiag.py `_bcr_factor`) over m diagonal
// blocks D[0..m-1] (n x n) and couplings Epad[0..m-1] (Epad[j] couples row
// block j+1 to column block j; Epad[m-1] is zero) eliminates the m_odd =
// m/2 odd blocks.  K1 factors them, D[2k+1] = L_k L_k^T.  K2 then computes,
// for each odd block k, in the Gram form of the plain version
// (solvers/bcr_level.py `bcr_level_reference`),
//     W1 = L_k^{-1} Epad[2k+1]^T,   W2 = L_k^{-1} Epad[2k],
//     Rc_k = W2^T W2 -> subtracted from D_new[k],
//     Lc_k = W1^T W1 -> subtracted from D_new[k+1]   (k+1 < m_even),
//     E_new[k] = -W1^T W2                             (k+1 < m_even),
// where D_new[j] starts as D[2j] (the m_even = (m+1)/2 surviving blocks).
// E_new goes into the next level's Epad buffer, and the CTA of the last odd
// block writes that buffer's zero tail, so no level concatenates one.
// D_new is written with its odd blocks first (position j/2 for odd j,
// m_even/2 + j/2 for even j), so the next level's K1 reads them as one
// contiguous batch.
//
// Replaces no TPU kernel: the reference package leaves this update to XLA
// (solvers/block_tridiag.py `_bcr_factor`, with W = L^{-1} X a product with
// the inverse factor on the TPU).  It was added because on the card the
// level's torch route (two cuBLAS batched triangular solves, three batched
// products and some ten elementwise passes and copies over the level's
// blocks) took several times K1's time and about a tenth of the level's
// bound.
//
// What bounds it on an H100.  Counting each block read and written once,
// a level moves 3 m_odd + 2 m_even + (m_even - 1) blocks of n^2 elements:
// 1.08 GB at quad-16000's first level (5,500 odd blocks of 64 in f64),
// 0.323 ms at 3.35 TB/s, and 0.646 ms over its 14 levels.  The work is
// two triangular solves with n right-hand sides (n^3 FMA) and three
// products (the two Gram products symmetric), about 4 n^3 flops: 2.1
// MFLOP a block at n = 64, 11.5 GFLOP at the first level, 0.17 ms at the
// 67 TFLOP/s of the f64 tensor cores.  So a level is bound by its bytes.
// In practice the chain of each block's substitution and the CTAs'
// latency bound it: a small level, of one wave or less, waits on one
// CTA's chain in each of the two stages below.
//
// Design.  One CTA per odd block; L, W2, 1 / L_jj and W1^T in shared
// memory (3 n ld + n elements: 105 KB at n = 64 in f64, two CTAs an SM).
// W1 is kept transposed, Y = W1^T = Epad[2k+1] L^{-T}, solved by rows, so
// Epad[2k+1] loads as it lies.  The solves are forward substitution on
// 8x8 tiles, as K1's phase A (the backward-stable order; a product with
// the inverse tile lost two orders of magnitude of backward error on the
// ill-conditioned deep levels, K1's note), but left-looking: W2's column
// tiles and Y's row tiles are independent of one another, so each is one
// warp's task from start to end, with no CTA barrier inside the solve.  A
// warp takes up to four tasks at once; per panel it subtracts the panel's
// products with the finished panels (four independent chains of m8n8k4
// f64 DMMA in f64, FFMA in f32: TF32 would change the results), then eight
// lanes a task substitute the panel's eight vectors.  The products then
// read shared memory and write device memory tile by tile: the lower tiles
// of the two Gram products, each mirrored into the upper triangle (so
// every D_new is exactly symmetric, and every entry is written by one
// lane), and every tile of E_new.
//
// Two paths, by the wrapper's plan.  "smem": the above, one CTA an odd
// block, while three blocks fit a CTA's shared memory (f64 n <= 96, f32
// n <= 136).  "global": larger blocks keep W2 and W1^T in a device
// workspace of one slot a CTA (2 n^2 + n elements) and read L where K1
// left it; the grid is capped (two CTAs an SM, at most the workspace the
// wrapper allows) and each CTA takes the odd blocks k = blockIdx.x,
// blockIdx.x + gridDim.x, ...  The arithmetic, and so every bit, is the
// "smem" path's: only where the operands lie differs, and the caches
// carry them.
//
// Two stages, one launch each, for the plain version's order of
// operations.  D_new[j] takes a contribution from odd blocks j-1 (Lc) and
// j (Rc); the plain version forms (D[2j] - Lc_{j-1}) - Rc_j, each product
// summed in the order of its inner index.  Stage 1 writes D_new[k+1] =
// D[2k+2] - Lc_k and E_new[k]; stage 2 solves W2 again and subtracts Rc_k
// from D_new[k].  Within a stage each block has one writer, so there are
// no atomics, each sum has the plain version's order, and a factorization
// returns the same bits from run to run.  (The iterates of an interior-
// point solve over such factorizations follow their round-off: one order
// of the two subtractions or another moves quad-16000's iteration count
// by one or more, in the plain version as here.)  No allocation, the
// caller's stream; every entry point returns cudaGetLastError() after its
// launch.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxSharedBytes = 232448;  // 227 KB per block on sm_90

// 16-byte asynchronous copy from device to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One warp's 8x8 tile: lane (g = lane/4, t = lane%4) holds C[g][2t] and
// C[g][2t+1], the accumulator layout of mma.m8n8k4.f64.  Rows start
// 16-byte aligned (ld and tile columns are multiples of 4 elements).
template <typename T> struct Vec2;
template <> struct Vec2<double> { using type = double2; };
template <> struct Vec2<float> { using type = float2; };

template <typename T>
__device__ __forceinline__ void tile_load(T acc[2], const T* C, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const auto v =
      *reinterpret_cast<const typename Vec2<T>::type*>(C + g * ld + 2 * t);
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

// acc += sgn * op(P) op(Q) over one 8-deep step, op the transpose where
// kPT / kQT; P, Q 8x8 tiles in shared memory with leading dimension ld.
template <bool kPT, bool kQT>
__device__ __forceinline__ void tile_mma(double acc[2], const double* P,
                                         const double* Q, int ld,
                                         double sgn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 8; kk += 4) {
    // A (8x4, row): A[g][t]; B (4x8, col): B[t][g]
    const double a =
        sgn * (kPT ? P[(kk + t) * ld + g] : P[g * ld + kk + t]);
    const double b = kQT ? Q[g * ld + kk + t] : Q[(kk + t) * ld + g];
    asm volatile(
        "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(acc[0]), "+d"(acc[1])
        : "d"(a), "d"(b));
  }
}

template <bool kPT, bool kQT>
__device__ __forceinline__ void tile_mma(float acc[2], const float* P,
                                         const float* Q, int ld, float sgn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float a = sgn * (kPT ? P[k * ld + g] : P[g * ld + k]);
    const float b0 = kQT ? Q[(2 * t) * ld + k] : Q[k * ld + 2 * t];
    const float b1 = kQT ? Q[(2 * t + 1) * ld + k] : Q[k * ld + 2 * t + 1];
    acc[0] = fmaf(a, b0, acc[0]);
    acc[1] = fmaf(a, b1, acc[1]);
  }
}

// Forward substitution with the 8x8 lower tile L11 on one vector of 8 in
// place: v[c] = (v[c] - sum_{q<c} L11[c][q] v[q]) / L11[c][c], with the
// reciprocals rd[c] = 1 / L11[c][c] given.  The vector's entries lie
// elem_step apart: a column of W2's tile (elem_step ld) or a row of Y's
// (elem_step 1), since Y L^T = E is L y = e for each row.
template <typename T>
__device__ __forceinline__ void subst8(T* v, int elem_step, const T* L11,
                                       const T* rd, int ld) {
  T x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = v[c * elem_step];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    T acc = x[c];
#pragma unroll
    for (int q = 0; q < c; ++q) acc -= L11[c * ld + q] * x[q];
    x[c] = acc * rd[c];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) v[c * elem_step] = x[c];
}

// Tile (i, j) of a symmetric block B (leading dimension n) from the
// accumulator of a lower tile, i >= j, and its mirror (j, i).  On a
// diagonal tile only the lane of the lower entry writes an entry and its
// mirror, so each entry has one writer.
template <typename T>
__device__ __forceinline__ void store_sym(T* B, int n, int i, int j,
                                          const T v[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int c = 2 * t + e;
    if (i != j || c <= g) B[(8 * i + g) * n + 8 * j + c] = v[e];
    if (i != j || c < g) B[(8 * j + c) * n + 8 * i + g] = v[e];
  }
}

// Odd block k's two stages (the plain version's order: every surviving
// block is D - Lc, then - Rc).  Stage 1 solves W2 and Y, writes
// D_new[k+1] = D[2k+2] - Lc_k and E_new[k] (and for k = 0 copies D[0] into
// D_new[0]); stage 2 solves W2 again and subtracts Rc_k from D_new[k].
// Lf: K1's factors of the level's odd blocks (m_odd, n, n).  Epad: the
// level's couplings (m, n, n).  Dsrc: the level's even blocks, block j at
// Dsrc + j src_stride n^2.  Dnew: the next level's m_even blocks, odd
// ones first.  Enext: the next level's Epad (m_even, n, n), or null when
// m_even = 1.  ws: null on the "smem" path (L, W2, 1 / L_jj and Y in
// shared memory, rows of ld), else this CTA's workspace slot (W2, 1 / L_jj
// and Y, ld = n; L read from Lf).
template <typename T>
__device__ __forceinline__ void level_block(
    int k, const T* __restrict__ Lf, const T* __restrict__ Epad,
    const T* __restrict__ Dsrc, int src_stride, T* Dnew,
    T* __restrict__ Enext, int m, int n, int ld, int stage, T* ws,
    T* smem) {
  const int m_odd = m >> 1, m_even = (m + 1) >> 1;
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int nt = n >> 3;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* Ls = ws ? Lf + k * nn : smem;
  T* W = ws ? ws : smem + n * ld;   // Epad[2k], then W2 = L^{-1} Epad[2k]
  T* rdiag = W + n * ld;                 // 1 / L_jj
  T* Y = rdiag + n;   // Epad[2k+1], then W1^T = Epad[2k+1] L^{-T}
  const int odd_next = m_even >> 1;
  auto pos = [=](int j) { return (j & 1) ? (j >> 1) : odd_next + (j >> 1); };
  const bool next = k + 1 < m_even;     // Lc_k and E_new[k] exist

  if (stage == 1) {
    if (k == 0) {           // D_new[0] = D[0]
      const T* src = Dsrc;
      T* dst = Dnew + pos(0) * nn;
      for (int q = threadIdx.x; q < n * n; q += blockDim.x) dst[q] = src[q];
    }
    if (k == m_odd - 1 && Enext != nullptr) {   // the next zero tail
      T* tail = Enext + static_cast<size_t>(m_even - 1) * nn;
      for (int q = threadIdx.x; q < n * n; q += blockDim.x) tail[q] = T(0);
    }
    if (!next) return;
  }
  const int ntask = stage == 1 ? 2 * nt : nt;   // W2's column tiles, Y's rows

  // Epad[2k], (stage 1) Epad[2k+1] and (on the "smem" path) L_k to the
  // working copies, 16 bytes a copy
  {
    const int per_row = n * static_cast<int>(sizeof(T)) / 16;
    const int per_block = n * per_row;
    const int step = 16 / static_cast<int>(sizeof(T));
    const T* src[3] = {Epad + 2 * k * nn, Epad + (2 * k + 1) * nn,
                       Lf + k * nn};
    T* dst[3] = {W, Y, smem};
    for (int b = 0; b < 3; ++b) {
      if ((b == 1 && stage != 1) || (b == 2 && ws)) continue;
      for (int q = threadIdx.x; q < per_block; q += blockDim.x) {
        const int r = q / per_row, c = (q - r * per_row) * step;
        if (ws)
          *reinterpret_cast<int4*>(dst[b] + r * ld + c) =
              *reinterpret_cast<const int4*>(src[b] + r * n + c);
        else
          cp_async16(dst[b] + r * ld + c, src[b] + r * n + c);
      }
    }
    if (!ws) cp_async_wait_all();
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    rdiag[j] = T(1) / Ls[j * ld + j];
  __syncthreads();

  // The solves.  W2's column tiles and Y's row tiles are independent of
  // one another: task t < nt is W2's tile column t, task nt + r Y's tile
  // row r.  A warp takes up to four tasks at once (t0 + s nw) and solves
  // them left-looking, panel by panel, with no barrier but its own: the
  // panel's tiles less their products with the finished panels (four
  // independent DMMA chains), then eight lanes a task substitute the
  // panel's eight vectors.
  {
    const int lane = threadIdx.x & 31, slot = lane >> 3, e = lane & 7;
    for (int t0 = warp; t0 < ntask; t0 += 4 * nw) {
      for (int p = 0; p < nt; ++p) {
        T acc[4][2];
        T* tile[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int t = t0 + s * nw;
          tile[s] = t < nt ? W + 8 * (p * ld + t)
                           : Y + 8 * ((t - nt) * ld + p);
          if (t < ntask) tile_load(acc[s], tile[s], ld);
        }
        for (int q = 0; q < p; ++q) {
          const T* Lpq = Ls + 8 * (p * ld + q);
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int t = t0 + s * nw;
            if (t < nt)         // W2(p, t) -= L(p, q) W2(q, t)
              tile_mma<false, false>(acc[s], Lpq, W + 8 * (q * ld + t), ld,
                                     T(-1));
            else if (t < ntask)   // Y(r, p) -= Y(r, q) L(p, q)^T
              tile_mma<false, true>(acc[s], Y + 8 * ((t - nt) * ld + q),
                                    Lpq, ld, T(-1));
          }
        }
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (t0 + s * nw < ntask) tile_store(tile[s], ld, acc[s]);
        __syncwarp();
        const int t = t0 + slot * nw;
        if (t < ntask) {
          const bool col = t < nt;
          T* v = col ? W + 8 * p * ld + 8 * t + e
                     : Y + (8 * (t - nt) + e) * ld + 8 * p;
          subst8(v, col ? ld : 1, Ls + 8 * (p * ld + p), rdiag + 8 * p, ld);
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();

  // The products, each tile's sum in the order of q, as a plain product
  // accumulates.  Stage 1: Lc_k's lower tiles into D_new[k+1] from
  // D[2k+2], then E_new[k]; stage 2: Rc_k's lower tiles out of D_new[k].
  const int nlow = nt * (nt + 1) / 2;
  const int ntasks = stage == 1 ? nlow + nt * nt : nlow;
  const T* d_in = stage == 1
      ? Dsrc + static_cast<size_t>(k + 1) * src_stride * nn
      : Dnew + pos(k) * nn;
  T* d_out = Dnew + pos(stage == 1 ? k + 1 : k) * nn;
  for (int t = warp; t < ntasks; t += nw) {
    T acc[2] = {T(0), T(0)};
    if (t < nlow) {
      int i = 0, j = t;
      while (j > i) j -= ++i;
      T d[2];
      tile_load(d, d_in + 8 * (i * n + j), n);
      if (stage == 2) {   // Rc(i, j) = sum_q W2(q, i)^T W2(q, j)
        for (int q = 0; q < nt; ++q)
          tile_mma<true, false>(acc, W + 8 * (q * ld + i),
                                W + 8 * (q * ld + j), ld, T(-1));
      } else {            // Lc(i, j) = sum_q Y(i, q) Y(j, q)^T
        for (int q = 0; q < nt; ++q)
          tile_mma<false, true>(acc, Y + 8 * (i * ld + q),
                                Y + 8 * (j * ld + q), ld, T(-1));
      }
      acc[0] = d[0] + acc[0];
      acc[1] = d[1] + acc[1];
      __syncwarp();
      store_sym(d_out, n, i, j, acc);
    } else {              // E_new(i, j) = -sum_q Y(i, q) W2(q, j)
      const int u = t - nlow, i = u / nt, j = u % nt;
      for (int q = 0; q < nt; ++q)
        tile_mma<false, false>(acc, Y + 8 * (i * ld + q),
                               W + 8 * (q * ld + j), ld, T(-1));
      tile_store(Enext + k * nn + 8 * (i * n + j), n, acc);
    }
  }
}

// One CTA a group of odd blocks: k = blockIdx.x, blockIdx.x + gridDim.x,
// ...  (one each on the "smem" path, whose grid is the level's odd
// blocks).  scratch: null on the "smem" path, else the "global" path's
// workspace, one slot of 2 n ld + n elements a CTA.
template <typename T>
__global__ void __launch_bounds__(256, 2)
bcr_level_kernel(const T* __restrict__ Lf, const T* __restrict__ Epad,
                 const T* __restrict__ Dsrc, int src_stride, T* Dnew,
                 T* __restrict__ Enext, int m, int n, int ld, int stage,
                 T* scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  T* ws = scratch ? scratch + static_cast<size_t>(blockIdx.x) *
                                  (2 * static_cast<size_t>(n) * ld + n)
                  : nullptr;
  for (int k = blockIdx.x; k < (m >> 1); k += gridDim.x) {
    level_block(k, Lf, Epad, Dsrc, src_stride, Dnew, Enext, m, n, ld, stage,
                ws, smem);
    __syncthreads();        // the working copies are the next block's
  }
}

// The launch configuration comes from the wrapper's plan
// (solvers/bcr_level.py `launch_plan`): ctas, threads, the stage's dynamic
// shared bytes and the leading dimension ld of the working copies; on the
// "global" path (scratch not null) no shared memory, ld = n and a
// workspace of ctas slots.
template <typename T>
int launch(const T* L, const T* Epad, const T* Dsrc, int src_stride,
           T* Dnew, T* Enext, int m, int n, int stage, int ctas, int threads,
           int smem, int ld, T* scratch, cudaStream_t stream) {
  const int m_odd = m / 2;
  if (m_odd <= 0) return 0;
  const long need = ((stage == 1 ? 3L : 2L) * n * ld + n) * sizeof(T);
  const bool path = scratch ? (ld == n && smem == 0)
                            : (need <= smem && ctas == m_odd);
  const bool ok = path && n >= 8 && n % 8 == 0 && ld >= n && ld % 4 == 0 &&
                  ctas >= 1 && ctas <= m_odd && threads >= 32 &&
                  threads <= 256 && threads % 32 == 0 &&
                  (stage == 1 || stage == 2) && src_stride >= 1 &&
                  smem <= kMaxSharedBytes &&
                  ((m + 1) / 2 > 1) == (Enext != nullptr);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      bcr_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  bcr_level_kernel<T><<<ctas, threads, smem, stream>>>(
      L, Epad, Dsrc, src_stride, Dnew, Enext, m, n, ld, stage, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ixm_bcr_level_f64(const double* L, const double* Epad,
                                 const double* Dsrc, int src_stride,
                                 double* Dnew, double* Enext, int m, int n,
                                 int stage, int ctas, int threads, int smem,
                                 int ld, double* scratch, void* stream) {
  return launch<double>(L, Epad, Dsrc, src_stride, Dnew, Enext, m, n,
                        stage, ctas, threads, smem, ld, scratch,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int ixm_bcr_level_f32(const float* L, const float* Epad,
                                 const float* Dsrc, int src_stride,
                                 float* Dnew, float* Enext, int m, int n,
                                 int stage, int ctas, int threads, int smem,
                                 int ld, float* scratch, void* stream) {
  return launch<float>(L, Epad, Dsrc, src_stride, Dnew, Enext, m, n, stage,
                       ctas, threads, smem, ld, scratch,
                       static_cast<cudaStream_t>(stream));
}
