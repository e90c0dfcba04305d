// Batched dense Cholesky factor and fused two-sweep solve, one thread per
// problem.
//
// Replaces the Pallas kernels of osqp_solver_tpu/ops/pallas_dense.py:
// factor_lane_major (body _factor_kernel) and solve_lane_major (body
// _solve_kernel).  M = L L' for the reduced KKT matrix P + sigma I + A' R A of
// each problem of a DenseQP batch.
//
// Layout (batch-trailing, "lane-major"): M and Lt are (n, n, B), rhs and x are
// (n, B); element [i, j, b] sits at (i*n + j)*B + b, so the 32 threads of a
// warp read 32 adjacent values of one entry.  Lt[j] holds column j of L:
// Lt[j, i] = L[i, j] for i >= j, and zero above the diagonal.  n is a run-time
// argument: one build serves every problem size.
//
// Factor: right-looking, in place in the output buffer.  The lower triangle
// of M is copied into Lt (transposed; the zeros above the diagonal written),
// then each column j is scaled by its pivot and subtracted from the trailing
// columns.  One n = 64 problem's triangle is 2080 values, which fits neither
// in registers nor, for a block of 32 problems, in shared memory; at B = 1024
// the whole working set (16.8 MB) stays in the 50 MB L2.  The pivot is an
// exact sqrt and the scaling an exact divide (the reference avoids the TPU's
// approximate rsqrt for the same reason: its error compounds over n
// rank-1 updates).  A pivot that is not positive (or NaN) becomes NaN, so the
// column and every later column of that problem come out NaN, as a failed
// dense Cholesky gives in the reference: the solver's blow-up test flags it,
// no error is raised.
//
// Solve: L z = b (forward, axpy form: column j of L streamed from Lt[j]), then
// L' x = z (backward, dot form: row k of L' is Lt[k]).  The n-vector lives in
// dynamic shared memory, one column per thread ([entry][thread]: no bank
// conflicts, no barrier); 32 threads x 4 bytes x n, above 48 KB (n > 384)
// only after cudaFuncSetAttribute, up to the 227 KB a block can have
// (n <= 1816).
//
// Bound on an H100: bytes on paper (factor: read the lower triangle of M,
// write all of Lt; solve: read the lower triangle of Lt, rhs, write x), the
// latency of each thread's serial chain in practice: B = 1024 problems are 32
// warps, one per SM, and each thread walks n^3/6 (factor) or n^2 (solve)
// dependent updates through L1/L2.
#include "lane_platform.cuh"

// Loads issued together in the inner loops (see below).
constexpr int UNROLL = 8;

__host__ __device__ __forceinline__ size_t at(int i, int j, int n, int B,
                                              int b) {
    return ((size_t)i * n + j) * (size_t)B + b;
}

__global__ void dense_factor_kernel(const real* __restrict__ M,
                                    real* __restrict__ Lt, int n, int B) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    for (int j = 0; j < n; ++j) {
        for (int i = 0; i < j; ++i) Lt[at(j, i, n, B, b)] = real(0);
        for (int i = j; i < n; ++i)
            Lt[at(j, i, n, B, b)] = M[at(i, j, n, B, b)];
    }
    for (int j = 0; j < n; ++j) {
        real* col = Lt + at(j, 0, n, B, b);  // column j of L, stride B
        const real piv = col[(size_t)j * B];
        const real d = piv > real(0) ? sqrt(piv) : real(NAN);
        col[(size_t)j * B] = d;
        for (int i = j + 1; i < n; ++i)
            col[(size_t)i * B] = col[(size_t)i * B] / d;
        for (int k = j + 1; k < n; ++k) {
            const real c = col[(size_t)k * B];
            real* dst = Lt + at(k, 0, n, B, b);
            int i = k;
            // Groups of UNROLL: every load of a group is issued before its
            // stores (the compiler cannot prove that entries B apart do not
            // alias), so a group's loads overlap instead of serialising.
            for (; i + UNROLL <= n; i += UNROLL) {
                real cv[UNROLL], dv[UNROLL];
#pragma unroll
                for (int u = 0; u < UNROLL; ++u) {
                    cv[u] = col[(size_t)(i + u) * B];
                    dv[u] = dst[(size_t)(i + u) * B];
                }
#pragma unroll
                for (int u = 0; u < UNROLL; ++u)
                    dst[(size_t)(i + u) * B] = dv[u] - cv[u] * c;
            }
            for (; i < n; ++i)
                dst[(size_t)i * B] = dst[(size_t)i * B] - col[(size_t)i * B] * c;
        }
    }
}

__global__ void dense_solve_kernel(const real* __restrict__ Lt,
                                   const real* __restrict__ rhs,
                                   real* __restrict__ x, int n, int B) {
    LANE_SMEM_DECL();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    real* v = lane_smem + threadIdx.x;  // v[i * LANE_BLOCK]
    for (int i = 0; i < n; ++i)
        v[i * LANE_BLOCK] = rhs[(size_t)i * B + b];
    // Forward: z_j = v_j / L_jj, then v_i -= z_j L_ij below the diagonal.
    // Both sweeps load the factor in groups of UNROLL ahead of the
    // arithmetic, so that a group's loads overlap.
    for (int j = 0; j < n; ++j) {
        const real* col = Lt + at(j, 0, n, B, b);
        const real zj = v[j * LANE_BLOCK] / col[(size_t)j * B];
        v[j * LANE_BLOCK] = zj;
        int i = j + 1;
        for (; i + UNROLL <= n; i += UNROLL) {
            real cv[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) cv[u] = col[(size_t)(i + u) * B];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                v[(i + u) * LANE_BLOCK] = v[(i + u) * LANE_BLOCK] - zj * cv[u];
        }
        for (; i < n; ++i)
            v[i * LANE_BLOCK] = v[i * LANE_BLOCK] - zj * col[(size_t)i * B];
    }
    // Backward: x_k = (z_k - sum_{i>k} L_ik x_i) / L_kk.
    for (int k = n - 1; k >= 0; --k) {
        const real* col = Lt + at(k, 0, n, B, b);
        real s = real(0);
        int i = k + 1;
        for (; i + UNROLL <= n; i += UNROLL) {
            real cv[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) cv[u] = col[(size_t)(i + u) * B];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u)
                s = s + cv[u] * v[(i + u) * LANE_BLOCK];
        }
        for (; i < n; ++i) s = s + col[(size_t)i * B] * v[i * LANE_BLOCK];
        v[k * LANE_BLOCK] = (v[k * LANE_BLOCK] - s) / col[(size_t)k * B];
    }
    for (int i = 0; i < n; ++i) x[(size_t)i * B + b] = v[i * LANE_BLOCK];
}

extern "C" int dense_factor_launch(const void* M, void* Lt, int n, int B,
                                   void* stream) {
    const int grid = (B + LANE_BLOCK - 1) / LANE_BLOCK;
    LANE_LAUNCH(dense_factor_kernel, grid, LANE_BLOCK, stream, (const real*)M,
                (real*)Lt, n, B);
    return LANE_LAST_ERROR();
}

// Shared memory of one solve block: the n-vector of each of its threads.
extern "C" int dense_solve_smem_bytes(int n) {
    return n * LANE_BLOCK * (int)sizeof(real);
}

extern "C" int dense_solve_launch(const void* Lt, const void* rhs, void* x,
                                  int n, int B, void* stream) {
    const int grid = (B + LANE_BLOCK - 1) / LANE_BLOCK;
    const int smem = dense_solve_smem_bytes(n);
#ifndef LANE_HOST_EMULATION
    if (smem > 48 * 1024) {
        const int err = (int)cudaFuncSetAttribute(
            (const void*)dense_solve_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != 0) return err;
    }
#endif
    LANE_LAUNCH_SMEM(dense_solve_kernel, grid, LANE_BLOCK, smem, stream,
                     (const real*)Lt, (const real*)rhs, (real*)x, n, B);
    return LANE_LAST_ERROR();
}
