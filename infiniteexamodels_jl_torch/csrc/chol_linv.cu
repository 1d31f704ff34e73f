// K1: batched Cholesky factor plus explicit inverse factor for Hopper.
//
// For each SPD block D[b] (n x n, row-major, n a multiple of 8, n <= 512)
// computes the lower Cholesky factor L[b] (D = L L^T) and L^{-1}[b], both
// with a zero strict upper triangle, and ok[b] = 1 when the factorization
// succeeded and every entry of L^{-1}[b] is finite.  A block that is not
// SPD (a pivot <= 0, NaN or inf) gets ok[b] = 0 and L, L^{-1} filled with
// NaN, the contract of the reference's `_chol_linv`.
//
// Replaces the TPU Pallas kernels `_chol_inv_kernel` (solvers/pallas_chol.py
// :38, launched by `_chol_inv_call` :157) and `_chol_inv_kernel2` (:90,
// launched by `_chol_inv_call2` :140) of the reference package, which
// compute the same function.
//
// What bounds it on an H100: the work is tiny (n^3/3 + n^3/6 flops per
// block, ~0.12 GFLOP f64 for one quad-1000 factorization) and the data is
// one read of D plus one write each of L and L^{-1} (~68 MB at quad-1000,
// ~20 us at 3.35 TB/s).  So the bound is memory traffic, and in practice
// latency: the column loop is a chain of n dependent steps with block-wide
// barriers, and the deep block-cyclic-reduction levels launch batches of
// 1..43 blocks that leave most of the 132 SMs idle.
//
// Design (simple and right first): one CTA per block.  When the block and
// its inverse fit in shared memory (2 n^2 sizeof(T) <= 227 KB: n <= 120 in
// f64, n <= 168 in f32) both live there and device memory is touched once
// per element (coalesced load of D, coalesced stores of L and L^{-1}).
// Larger blocks work in place in the output buffers.  The Cholesky is
// right-looking, column by column: the column scale runs with threads
// across rows and the rank-1 trailing update with threads across the
// trailing triangle.  The inverse runs one thread per column, since the
// columns of L^{-1} are independent forward substitutions and need no
// barrier.  The kernel allocates nothing and launches on the caller's
// stream; every entry point returns cudaGetLastError() after its launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB per block on sm_90

__device__ __forceinline__ double nan_of(double) {
  return __longlong_as_double(0x7ff8000000000000LL);
}
__device__ __forceinline__ float nan_of(float) {
  return __int_as_float(0x7fc00000);
}

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
chol_linv_kernel(const T* __restrict__ D, T* __restrict__ L,
                 T* __restrict__ Linv, int* __restrict__ ok, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int failed;

  const size_t nn = static_cast<size_t>(n) * n;
  const size_t base = static_cast<size_t>(blockIdx.x) * nn;
  const T* Db = D + base;
  T* Lb = L + base;
  T* Xb = Linv + base;
  // working copies: shared memory, or the output buffers themselves
  T* W = kShared ? reinterpret_cast<T*>(smem_raw) : Lb;
  T* X = kShared ? reinterpret_cast<T*>(smem_raw) + nn : Xb;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  if (tid == 0) failed = 0;
  // lower triangle of D; the strict upper triangle of L is zero
  for (size_t e = tid; e < nn; e += nthr) {
    const int r = static_cast<int>(e / n), c = static_cast<int>(e % n);
    W[e] = (c <= r) ? Db[e] : T(0);
  }
  __syncthreads();

  // right-looking Cholesky, one column per step
  for (int j = 0; j < n; ++j) {
    const T pivot = W[j * n + j];
    // every thread read the same pivot after the barrier, so this branch
    // is uniform across the block
    if (!(pivot > T(0)) || isinf(pivot)) {
      if (tid == 0) failed = 1;
      break;
    }
    const T d = sqrt(pivot);
    for (int i = j + 1 + tid; i < n; i += nthr) W[i * n + j] /= d;
    __syncthreads();
    if (tid == 0) W[j * n + j] = d;
    const int m = n - j - 1;
    for (int e = tid; e < m * m; e += nthr) {
      const int i = j + 1 + e / m, c = j + 1 + e % m;
      if (c <= i) W[i * n + c] -= W[i * n + j] * W[c * n + j];
    }
    __syncthreads();
  }
  __syncthreads();
  const bool bad = failed != 0;

  // L^{-1} by forward substitution, one thread per column:
  // X[c][c] = 1 / L[c][c];  X[r][c] = -(sum_{k=c}^{r-1} L[r][k] X[k][c]) / L[r][r]
  if (!bad) {
    for (int c = tid; c < n; c += nthr) {
      for (int r = 0; r < c; ++r) X[r * n + c] = T(0);
      X[c * n + c] = T(1) / W[c * n + c];
      for (int r = c + 1; r < n; ++r) {
        T s = T(0);
        for (int k = c; k < r; ++k) s += W[r * n + k] * X[k * n + c];
        X[r * n + c] = -s / W[r * n + r];
      }
    }
  }
  __syncthreads();

  int nonfinite = 0;
  for (size_t e = tid; e < nn; e += nthr) {
    if (bad) {
      Lb[e] = nan_of(T(0));
      Xb[e] = nan_of(T(0));
    } else {
      const T xv = X[e];
      if (!isfinite(xv)) nonfinite = 1;
      if (kShared) {
        Lb[e] = W[e];
        Xb[e] = xv;
      }
    }
  }
  const int any_nonfinite = __syncthreads_or(nonfinite);
  if (tid == 0) ok[blockIdx.x] = (!bad && !any_nonfinite) ? 1 : 0;
}

template <typename T>
int launch(const T* D, T* L, T* Linv, int* ok, int nb, int n,
           cudaStream_t stream) {
  if (nb <= 0) return 0;
  const size_t bytes = 2 * static_cast<size_t>(n) * n * sizeof(T);
  if (bytes <= kMaxSharedBytes) {
    cudaError_t e = cudaFuncSetAttribute(
        chol_linv_kernel<T, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    chol_linv_kernel<T, true><<<nb, kThreads, bytes, stream>>>(
        D, L, Linv, ok, n);
  } else {
    chol_linv_kernel<T, false><<<nb, kThreads, 0, stream>>>(
        D, L, Linv, ok, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ixm_chol_linv_f64(const double* D, double* L, double* Linv,
                                 int* ok, int nb, int n, void* stream) {
  return launch<double>(D, L, Linv, ok, nb, n,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int ixm_chol_linv_f32(const float* D, float* L, float* Linv,
                                 int* ok, int nb, int n, void* stream) {
  return launch<float>(D, L, Linv, ok, nb, n,
                       static_cast<cudaStream_t>(stream));
}
