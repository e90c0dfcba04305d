// Batched block-tridiagonal Cholesky factor and two-sweep solve, one thread
// per problem, full (B2 x B2) blocks.
//
// Replaces the Pallas kernels of osqp_solver_tpu/ops/pallas_tridiag.py:
// factor_lane_major (body _factor_kernel) and solve_lane_major (body
// _solve_kernel).  M = C C' with block-bidiagonal C: diagonal blocks chol
// (lower-triangular), sub-diagonal blocks gain.
//
//   factor:  G_{t-1} = L_{t-1} C_{t-1}^{-T},  C_t = chol(D_t - G_{t-1} G_{t-1}')
//   solve:   w_t = C_t^{-1} (b_t - G_{t-1} w_{t-1}),  x_t = C_t^{-T} (w_t - G_t' x_{t+1})
//
// Layout (batch-trailing): diag/chol (W, B2, B2, B), lower/gain (W-1, B2, B2,
// B), rhs/x (W, B2, B); element [t, i, j, b] sits at ((t*B2 + i)*B2 + j)*B + b,
// so the 32 threads of a warp read 32 adjacent values of one entry.
//
// Both kernels walk the horizon and stage the NEXT step's blocks into shared
// memory with per-thread 4-byte cp.async (two stages, each thread its own
// column: no bank conflicts, no barrier) while the current step computes:
// one warp's ~220 independent row loads per step overlap instead of
// stalling the step's arithmetic one batch at a time.
//
// Factor: S_t (the packed lower half, B2(B2+1)/2 values) is factored in
// registers.  C_{t-1} and G_{t-1} (B2^2 values) would not fit beside it in
// the 255-register file, so they live in shared memory too.  G is formed row
// by row, as the reference's _gain_rows, with one reciprocal per pivot.  The
// upper triangle of chol is written as zeros.  A non-positive pivot turns the
// whole block C_t into NaN, as a failed dense Cholesky does in the reference
// (and so every later block of that problem): statuses depend on it, no
// error is raised.
//
// Solve: the forward sweep writes w_t into x (read back by the same thread in
// the backward sweep, which overwrites it with x_t); w_{t-1} / x_{t+1} are
// carried in registers.
//
// Bound: a chain of W dependent B2 x B2 steps per thread; bytes on paper (each
// step touches 2 B2^2 values), the latency of that chain in practice: B=1024
// problems are 32 warps, one per SM.
#include "lane_platform.cuh"

#ifndef B2
#error "compile with -DB2=<block size>"
#endif

constexpr int NT = B2 * (B2 + 1) / 2;  // packed lower triangle
constexpr int NF = B2 * B2;            // full block

__host__ __device__ constexpr int TRI(int i, int j) {
    return i * (i + 1) / 2 + j;
}

// One stage of either kernel: a packed lower triangle (chol of step t, or the
// lower half of D_t) and a full block (G, or L_{t-1}).
constexpr int O_TRI = 0;
constexpr int O_FULL = NT;
constexpr int STAGE = NT + NF;

// Rows of this thread's column of a shared-memory tile.
struct Col {
    real* p;
    __device__ __forceinline__ real& operator[](int k) const {
        return p[k * LANE_BLOCK];
    }
};

// Start the copies of block t of a (.., B2, B2, B) array into one stage:
// its lower triangle (TRI_ONLY) or all of it, and commit nothing.
template <bool TRI_ONLY, int DST>
__device__ __forceinline__ void stage_block(const real* a, int t, int B,
                                            int b, real* sg) {
    // B is made opaque so that each address is one multiply-add rather than
    // one 64-bit induction pointer per entry kept alive across the loop.
    int Bv = B;
#ifndef LANE_HOST_EMULATION
    asm volatile("" : "+r"(Bv));
#endif
    const real* base = a + ((size_t)t * NF) * (size_t)B + b;
#pragma unroll
    for (int i = 0; i < B2; ++i)
#pragma unroll
        for (int j = 0; j < (TRI_ONLY ? i + 1 : B2); ++j)
            cp_async4(sg + (DST + (TRI_ONLY ? TRI(i, j) : i * B2 + j)) *
                               LANE_BLOCK,
                      base + (i * B2 + j) * Bv);
}

// Stage of step t: the triangle of block tt of `tri` and, when tf >= 0, the
// full block tf of `full`; one commit group.
__device__ __forceinline__ void stage_step(const real* tri, int tt,
                                           const real* full, int tf, int B,
                                           int b, real* sg) {
    stage_block<true, O_TRI>(tri, tt, B, b, sg);
    if (tf >= 0) stage_block<false, O_FULL>(full, tf, B, b, sg);
    cp_async_commit();
}

__global__ void tridiag_factor_kernel(const real* __restrict__ diag,
                                      const real* __restrict__ lower,
                                      real* __restrict__ chol,
                                      real* __restrict__ gain, int W, int B) {
    LANE_SMEM_DECL();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t Bs = (size_t)B;
    real* own = lane_smem + threadIdx.x;
    const Col Cp{own};                       // C_{t-1}: NT rows
    const Col G{own + NT * LANE_BLOCK};      // G_{t-1}: NF rows
    real* stages = own + STAGE * LANE_BLOCK; // two stages: D_t, L_{t-1}

    stage_step(diag, 0, lower, -1, B, b, stages);
    for (int t = 0; t < W; ++t) {
        if (t + 1 < W) {
            stage_step(diag, t + 1, lower, t, B, b,
                       stages + ((t + 1) & 1) * STAGE * LANE_BLOCK);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        real* sg = stages + (t & 1) * STAGE * LANE_BLOCK;
        const Col D{sg + O_TRI * LANE_BLOCK}, L{sg + O_FULL * LANE_BLOCK};

        real S[NT];
#pragma unroll
        for (int k = 0; k < NT; ++k) S[k] = D[k];

        if (t > 0) {
            // G_{t-1}[i][j] = (L[i][j] - sum_{k<j} G[i][k] C[j][k]) / C[j][j].
            real inv[B2];
#pragma unroll
            for (int j = 0; j < B2; ++j) inv[j] = real(1) / Cp[TRI(j, j)];
            real* gout = gain + ((size_t)(t - 1) * NF) * Bs + b;
#pragma unroll 1
            for (int i = 0; i < B2; ++i) {
#pragma unroll
                for (int j = 0; j < B2; ++j) {
                    real s = L[i * B2 + j];
#pragma unroll
                    for (int k = 0; k < j; ++k)
                        s = s - G[i * B2 + k] * Cp[TRI(j, k)];
                    const real g = s * inv[j];
                    G[i * B2 + j] = g;
                    gout[(size_t)(i * B2 + j) * Bs] = g;
                }
            }
            // S_t = D_t - G G'.
#pragma unroll
            for (int i = 0; i < B2; ++i) {
#pragma unroll
                for (int j = 0; j <= i; ++j) {
                    real acc = S[TRI(i, j)];
#pragma unroll
                    for (int k = 0; k < B2; ++k)
                        acc = acc - G[i * B2 + k] * G[j * B2 + k];
                    S[TRI(i, j)] = acc;
                }
            }
        }

        // Cholesky in place, column by column, one reciprocal per pivot.
        bool bad = false;
#pragma unroll
        for (int j = 0; j < B2; ++j) {
            real s = S[TRI(j, j)];
#pragma unroll
            for (int k = 0; k < j; ++k) s = s - S[TRI(j, k)] * S[TRI(j, k)];
            bad = bad || !(s > real(0));
            const real d = sqrt(s);
            const real r = real(1) / d;
            S[TRI(j, j)] = d;
#pragma unroll
            for (int i = j + 1; i < B2; ++i) {
                real v = S[TRI(i, j)];
#pragma unroll
                for (int k = 0; k < j; ++k) v = v - S[TRI(i, k)] * S[TRI(j, k)];
                S[TRI(i, j)] = v * r;
            }
        }
        const real nan = real(NAN);
        real* cout = chol + ((size_t)t * NF) * Bs + b;
#pragma unroll
        for (int i = 0; i < B2; ++i) {
#pragma unroll
            for (int j = 0; j < B2; ++j) {
                real c = real(0);
                if (j <= i) {
                    c = bad ? nan : S[TRI(i, j)];
                    Cp[TRI(i, j)] = c;
                }
                cout[(size_t)(i * B2 + j) * Bs] = c;
            }
        }
    }
}

__global__ void tridiag_solve_kernel(const real* __restrict__ chol,
                                     const real* __restrict__ gain,
                                     const real* __restrict__ rhs,
                                     real* __restrict__ x, int W, int B) {
    LANE_SMEM_DECL();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t Bs = (size_t)B;
    real* stages = lane_smem + threadIdx.x;  // two stages: C_t, G
    auto row = [&](int t, int i) -> size_t {
        return ((size_t)t * B2 + i) * Bs + b;
    };

    real c[B2];  // w_{t-1}, then x_{t+1}
#pragma unroll
    for (int i = 0; i < B2; ++i) c[i] = real(0);

    // Forward: step t reads C_t and G_{t-1}.
    stage_step(chol, 0, gain, -1, B, b, stages);
    for (int t = 0; t < W; ++t) {
        if (t + 1 < W) {
            stage_step(chol, t + 1, gain, t, B, b,
                       stages + ((t + 1) & 1) * STAGE * LANE_BLOCK);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        real* sg = stages + (t & 1) * STAGE * LANE_BLOCK;
        const Col C{sg + O_TRI * LANE_BLOCK}, G{sg + O_FULL * LANE_BLOCK};
        real v[B2];
#pragma unroll
        for (int i = 0; i < B2; ++i) {
            real acc = real(0);
            if (t > 0) {
#pragma unroll
                for (int j = 0; j < B2; ++j) acc = acc + G[i * B2 + j] * c[j];
            }
            v[i] = rhs[row(t, i)] - acc;
        }
#pragma unroll
        for (int i = 0; i < B2; ++i) {
            real acc = v[i];
#pragma unroll
            for (int j = 0; j < i; ++j) acc = acc - C[TRI(i, j)] * v[j];
            v[i] = acc / C[TRI(i, i)];
        }
#pragma unroll
        for (int i = 0; i < B2; ++i) {
            x[row(t, i)] = v[i];
            c[i] = v[i];
        }
    }

    // Backward: step t reads C_t and G_t (none at t = W-1).
    stage_step(chol, W - 1, gain, -1, B, b,
               stages + ((W - 1) & 1) * STAGE * LANE_BLOCK);
    for (int t = W - 1; t >= 0; --t) {
        if (t > 0) {
            stage_step(chol, t - 1, gain, t - 1, B, b,
                       stages + ((t - 1) & 1) * STAGE * LANE_BLOCK);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        real* sg = stages + (t & 1) * STAGE * LANE_BLOCK;
        const Col C{sg + O_TRI * LANE_BLOCK}, G{sg + O_FULL * LANE_BLOCK};
        real v[B2];
#pragma unroll
        for (int i = 0; i < B2; ++i) {
            real acc = real(0);
            if (t < W - 1) {
#pragma unroll
                for (int j = 0; j < B2; ++j) acc = acc + G[j * B2 + i] * c[j];
            }
            v[i] = x[row(t, i)] - acc;
        }
#pragma unroll
        for (int i = B2 - 1; i >= 0; --i) {
            real acc = v[i];
#pragma unroll
            for (int j = i + 1; j < B2; ++j) acc = acc - C[TRI(j, i)] * v[j];
            v[i] = acc / C[TRI(i, i)];
        }
#pragma unroll
        for (int i = 0; i < B2; ++i) {
            x[row(t, i)] = v[i];
            c[i] = v[i];
        }
    }
}

// Dynamic shared memory of each kernel: the factor keeps C_{t-1} and G_{t-1}
// beside its two stages, the solve only its two stages.
constexpr int FACTOR_SMEM = 3 * STAGE * LANE_BLOCK * (int)sizeof(real);
constexpr int SOLVE_SMEM = 2 * STAGE * LANE_BLOCK * (int)sizeof(real);

static int allow_smem(const void* fn, int bytes) {
#ifndef LANE_HOST_EMULATION
    // More than the 48 KB a kernel gets without asking.
    return (int)cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
#else
    (void)fn;
    (void)bytes;
    return 0;
#endif
}

extern "C" int tridiag_factor_launch(const void* diag, const void* lower,
                                     void* chol, void* gain, int W, int B,
                                     void* stream) {
    const int grid = (B + LANE_BLOCK - 1) / LANE_BLOCK;
    const int attr =
        allow_smem((const void*)tridiag_factor_kernel, FACTOR_SMEM);
    if (attr != 0) return attr;
    LANE_LAUNCH_SMEM(tridiag_factor_kernel, grid, LANE_BLOCK, FACTOR_SMEM,
                     stream, (const real*)diag, (const real*)lower,
                     (real*)chol, (real*)gain, W, B);
    return LANE_LAST_ERROR();
}

extern "C" int tridiag_solve_launch(const void* chol, const void* gain,
                                    const void* rhs, void* x, int W, int B,
                                    void* stream) {
    const int grid = (B + LANE_BLOCK - 1) / LANE_BLOCK;
    const int attr = allow_smem((const void*)tridiag_solve_kernel, SOLVE_SMEM);
    if (attr != 0) return attr;
    LANE_LAUNCH_SMEM(tridiag_solve_kernel, grid, LANE_BLOCK, SOLVE_SMEM,
                     stream, (const real*)chol, (const real*)gain,
                     (const real*)rhs, (real*)x, W, B);
    return LANE_LAST_ERROR();
}
