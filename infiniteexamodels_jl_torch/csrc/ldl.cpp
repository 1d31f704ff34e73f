// Sparse symmetric LDL^T factorization (up-looking, etree-based), on the
// host CPU.
//
// The PyTorch port's host linear solver (linear_solver="ldl_cpp", alias
// "ma27"): the role MA27 plays under Ipopt in the reference stack
// (README.md:36-41 of the reference) -- an in-process sparse symmetric
// factorization of the condensed KKT with exact inertia (the sign count of
// D).  solvers/cpp_ldl.py builds this file with the host C++ compiler at
// first use (utils/host_build.py) and binds it with ctypes; the IPM's
// tensors move to host memory for each factorization and back.
//
// Algorithm: classic up-looking LDL^T with elimination-tree pattern
// computation (no pivoting).  Intended for quasidefinite / regularized KKT
// matrices, where LDL^T without pivoting is backward stable.
//
// C ABI (ctypes):
//   ldl_symbolic(n, Ap, Ai, Lp, parent, work)        -> Lnz total
//   ldl_numeric(n, Ap, Ai, Ax, Lp, parent, Li, Lx, D, work_i, work_x)
//       -> number of nonpositive pivots (inertia signal), or -1-k on a
//          zero pivot at column k
//   ldl_solve(n, Lp, Li, Lx, D, b)                   (in place)
//
// The matrix is given in CSC (== CSR for symmetric) with the UPPER triangle
// (column-major: for column j, rows i <= j).

#include <cstdint>
#include <cmath>

extern "C" {

// symbolic analysis: elimination tree + column counts -> Lp (size n+1)
// work: size n ints (flag array)
int64_t ldl_symbolic(int64_t n, const int64_t* Ap, const int64_t* Ai,
                     int64_t* Lp, int64_t* parent, int64_t* work) {
    int64_t* flag = work;
    int64_t* Lnz = Lp + 1;  // reuse; shifted so prefix-sum is easy
    for (int64_t j = 0; j < n; ++j) {
        parent[j] = -1;
        flag[j] = j;
        Lnz[j] = 0;
    }
    for (int64_t j = 0; j < n; ++j) {
        for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
            int64_t i = Ai[p];
            if (i >= j) continue;  // upper triangle entries only (i < j)
            // walk from i up the etree until reaching a node already
            // associated with column j
            for (int64_t k = i; flag[k] != j; k = parent[k]) {
                if (parent[k] == -1) parent[k] = j;
                ++Lnz[k];          // L(j,k) is nonzero
                flag[k] = j;
            }
        }
        flag[j] = j;
    }
    Lp[0] = 0;
    for (int64_t j = 0; j < n; ++j) Lp[j + 1] += Lp[j];
    return Lp[n];
}

// numeric factorization; returns count of pivots <= 0 (for inertia checks)
// or -1-k when column k produced an exactly-zero pivot.
// work_i: 2n ints (flag + pattern stack), work_x: n doubles (+ n ints for
// column fill counters packed after the stack)
int64_t ldl_numeric(int64_t n, const int64_t* Ap, const int64_t* Ai,
                    const double* Ax, const int64_t* Lp,
                    const int64_t* parent, int64_t* Li, double* Lx,
                    double* D, int64_t* work_i, double* work_x) {
    int64_t* flag = work_i;
    int64_t* pattern = work_i + n;
    int64_t* Lfill = work_i + 2 * n;   // next free slot per column
    double* y = work_x;
    int64_t neg = 0;
    for (int64_t j = 0; j < n; ++j) {
        y[j] = 0.0;
        flag[j] = -1;
        Lfill[j] = Lp[j];
    }
    for (int64_t j = 0; j < n; ++j) {
        // scatter column j of A (upper triangle) and collect the pattern of
        // row j of L as an etree walk, depth-sorted via a stack
        int64_t top = n;
        flag[j] = j;
        y[j] = 0.0;
        for (int64_t p = Ap[j]; p < Ap[j + 1]; ++p) {
            int64_t i = Ai[p];
            if (i > j) continue;
            y[i] += Ax[p];
            int64_t len = 0;
            for (int64_t k = i; flag[k] != j; k = parent[k]) {
                pattern[len++] = k;
                flag[k] = j;
            }
            while (len > 0) pattern[--top] = pattern[--len];
        }
        double dj = y[j];
        y[j] = 0.0;
        // eliminate along the pattern (ascending column order)
        for (int64_t t = top; t < n; ++t) {
            int64_t k = pattern[t];
            double yk = y[k];
            y[k] = 0.0;
            double ljk = yk / D[k];
            // apply existing column k of L to y
            for (int64_t p = Lp[k]; p < Lfill[k]; ++p)
                y[Li[p]] -= Lx[p] * yk;
            // store L(j,k)
            int64_t slot = Lfill[k]++;
            Li[slot] = j;
            Lx[slot] = ljk;
            dj -= ljk * yk;
        }
        if (dj == 0.0 || !std::isfinite(dj)) return -1 - j;
        if (dj < 0.0) ++neg;
        D[j] = dj;
    }
    return neg;
}

// triangular solves: L z = b (unit diag), D w = z, L^T x = w; in place.
void ldl_solve(int64_t n, const int64_t* Lp, const int64_t* Li,
               const double* Lx, const double* D, double* b) {
    for (int64_t j = 0; j < n; ++j) {
        double bj = b[j];
        for (int64_t p = Lp[j]; p < Lp[j + 1]; ++p) b[Li[p]] -= Lx[p] * bj;
    }
    for (int64_t j = 0; j < n; ++j) b[j] /= D[j];
    for (int64_t j = n - 1; j >= 0; --j) {
        double bj = b[j];
        for (int64_t p = Lp[j]; p < Lp[j + 1]; ++p) bj -= Lx[p] * b[Li[p]];
        b[j] = bj;
    }
}

}  // extern "C"
