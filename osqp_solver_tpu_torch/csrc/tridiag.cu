// Batched block-tridiagonal Cholesky factor and two-sweep solve, full
// (B2 x B2) blocks.
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
// so adjacent problems read adjacent values of one entry.
//
// Factor (one thread per problem): it walks the horizon and stages the NEXT
// step's blocks into shared memory with per-thread 4-byte cp.async (two
// stages, each thread its own column: no bank conflicts, no barrier) while
// the current step computes.  S_t (the packed lower half, B2(B2+1)/2 values)
// is factored in registers.  C_{t-1} and G_{t-1} (B2^2 values) would not fit
// beside it in the 255-register file, so they live in shared memory too.  G
// is formed row by row, as the reference's _gain_rows, with one reciprocal
// per pivot.  The upper triangle of chol is written as zeros.  A
// non-positive pivot turns the whole block C_t into NaN, as a failed dense
// Cholesky does in the reference (and so every later block of that
// problem): statuses depend on it, no error is raised.  Bound: a chain of W
// dependent B2 x B2 steps per thread; B=1024 problems are 32 warps, one per
// SM.
//
// Solve (a group of threads per problem).  One thread per problem left
// B = 1024 at 32 single-warp blocks (100 of 132 SMs idle) and B = 1 at one
// thread, each step a chain of 144 + 78 multiply-adds and 12 divisions with
// rhs read from device memory on it and w_t written there and read back.
// Here:
//   - a group of SG threads (the smallest power of two >= B2: 16 at B2 = 12)
//     works on one problem; a block holds Q adjacent problems (4 while the
//     blocks still cover 7/8 of the SMs, fewer for small batches: B = 1024
//     is 256 blocks, B = 1 one group);
//   - a producer warp stages step t+2's C_t (its lower triangle), gain block
//     and rhs_t (t-2 backward) with cp.async into a ring of three [row][SQS]
//     tiles while the groups solve step t, one __syncthreads a step; a
//     producer thread's copies are unrolled (stage_tile_copies): as a loop
//     their address arithmetic, not the groups' arithmetic, set the step
//     time;
//   - lane i < B2 forms row i of the step's right-hand side (rhs_t -
//     G_{t-1} w_{t-1}; backward w_t - G_t' x_{t+1}) from the previous step's
//     vector, which every lane holds in registers, and leaves it in the
//     group's slot (one __syncwarp); the gain block is staged so that lane
//     i's row is a column of the tile (2-way bank conflicts at most);
//   - every lane then solves the whole triangular system in registers, row
//     by row with j ascending, as the one-thread kernel did, each division
//     rounded as the division rounds it but without its branch to a slow
//     path (div_rn: the pivots' reciprocals are taken off the chain), so
//     the rows' multiply-adds interleave: x is bit for bit that kernel's;
//   - the forward sweep keeps w_t on chip (W B2 values a problem) for the
//     backward sweep, or, where the launch plan finds no room, writes it into
//     x, from where the producer stages it back.  Nothing on a step's chain
//     reads device memory.
// Bound: bytes on paper (each step's blocks read once a sweep); in practice
// each problem's chain of 2W steps, each B2 divisions and the multiply-adds
// between them.
#include <cstdint>
#include <initializer_list>

#include "lane_platform.cuh"

#ifndef B2
#error "compile with -DB2=<block size>"
#endif

constexpr int NT = B2 * (B2 + 1) / 2;  // packed lower triangle
constexpr int NF = B2 * B2;            // full block

__host__ __device__ constexpr int TRI(int i, int j) {
    return i * (i + 1) / 2 + j;
}

// ---- the factor: one thread per problem.  One stage: the lower half of D_t
// (packed) and the full block L_{t-1}.
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

// ---- the solve: a group of SG threads per problem.
constexpr int SG = pow2_at_least(B2) < 4 ? 4 : pow2_at_least(B2);
static_assert(SG <= 32, "a group is at most one warp (B2 <= 32)");
// Problems per block at most (log2), stages of the ring, producer threads,
// and the tile's row stride (one column a problem).
constexpr int S_QLOG_MAX = 2;
constexpr int S_NSTAGE = 3;
constexpr int S_PRODUCERS = group_producers(SG);
constexpr int SQS = 1 << S_QLOG_MAX;
// One stage: the lower triangle of C_t (NT rows), the gain block (NF rows;
// forward G_{t-1} transposed, backward G_t), and rhs_t forward or w_t
// backward (B2 rows, when w is not kept on chip).
constexpr int S_C = 0, S_G = NT, S_V = NT + NF, S_ROWS = NT + NF + B2;
using STile = TileCol<SQS>;

__host__ __device__ constexpr int solve_producer_base(int qlog) {
    return group_producer_base(SG << qlog);
}
__host__ __device__ constexpr int solve_threads(int qlog) {
    return solve_producer_base(qlog) + S_PRODUCERS;
}
// Shared values: the ring, a slot of SG values per group, and (w on chip)
// w_t of every step, [t][i][SQS].
__host__ __device__ constexpr long long solve_smem_bytes(int W, int qlog,
                                                         bool w_on_chip) {
    return ((long long)S_NSTAGE * S_ROWS * SQS + (long long)SG * (1 << qlog) +
            (w_on_chip ? (long long)W * B2 * SQS : 0)) *
           (long long)sizeof(real);
}

struct SolvePlan {
    int qlog, Q, w_on_chip, smem, blocks, threads;
};

// Problems per block as the chunk kernel plans them; w on chip when the
// shared memory of the launch fits in budget (bytes), else in x.
static SolvePlan solve_plan_for(int W, int B, int budget, int sms) {
    const int qlog = group_qlog(B, sms, S_QLOG_MAX), Q = 1 << qlog;
    const bool on = solve_smem_bytes(W, qlog, true) <= budget;
    return SolvePlan{qlog, Q, on, (int)solve_smem_bytes(W, qlog, on),
                     (B + Q - 1) / Q, solve_threads(qlog)};
}

// Start this producer's copies of step t into stage t % S_NSTAGE and commit
// them: C_t's lower triangle; forward G_{t-1} transposed (t > 0) and rhs_t,
// backward G_t (t < W-1) and, w in x, w_t.
template <bool BWD, bool WSM>
__device__ __forceinline__ void solve_issue(const Stager& s, const real* chol,
                                            const real* gain, const real* v,
                                            real* ring, int t, int W) {
    real* sg = ring + (t % S_NSTAGE) * S_ROWS * SQS;
    const size_t blk = (size_t)NF * s.B, vec = (size_t)B2 * s.B;
    stage_tile_copies<SQS, S_PRODUCERS, NF>(s, chol + t * blk + s.b0,
                                          sg + S_C * SQS, [](int k) {
                                              const int i = k / B2, j = k % B2;
                                              return j <= i ? TRI(i, j) : -1;
                                          });
    if (!BWD && t > 0)
        stage_tile_copies<SQS, S_PRODUCERS, NF>(
            s, gain + (t - 1) * blk + s.b0, sg + S_G * SQS,
            [](int k) { return (k % B2) * B2 + k / B2; });
    if (BWD && t < W - 1)
        stage_tile_copies<SQS, S_PRODUCERS, NF>(s, gain + t * blk + s.b0,
                                              sg + S_G * SQS,
                                              [](int k) { return k; });
    if (!BWD || !WSM)
        stage_tile_copies<SQS, S_PRODUCERS, B2>(s, v + t * vec + s.b0,
                                              sg + S_V * SQS,
                                              [](int k) { return k; });
    cp_async_commit();
}

// The step's triangular solve in every lane: y from the group's right-hand
// side r[] (in the slot) and the lower triangle L[] of C_t (in registers),
// row by row with j ascending and a division per row rounded as the
// division rounds it (div_rn, from the pivots' reciprocals rl[] taken as
// soon as L is loaded), as the one-thread kernel formed them: forward
// C y = r, backward C' y = r.
template <bool BWD>
__device__ __forceinline__ void solve_rows(const real* L, const real* rl,
                                           const real* r, real* y) {
    real v[B2];
#pragma unroll
    for (int k = 0; k < B2; ++k) v[k] = r[k];
    if (!BWD) {
#pragma unroll
        for (int i = 0; i < B2; ++i) {
            real acc = v[i];
#pragma unroll
            for (int j = 0; j < i; ++j) acc = fma_rn(-L[TRI(i, j)], y[j], acc);
            y[i] = div_rn(acc, L[TRI(i, i)], rl[i]);
        }
    } else {
#pragma unroll
        for (int i = B2 - 1; i >= 0; --i) {
            real acc = v[i];
#pragma unroll
            for (int j = i + 1; j < B2; ++j)
                acc = fma_rn(-L[TRI(j, i)], y[j], acc);
            y[i] = div_rn(acc, L[TRI(i, i)], rl[i]);
        }
    }
}

// What lane i of a group needs of step t, loaded into registers at the top
// of the step: the lower triangle of C_t and its pivots' reciprocals,
// entries j*B2 + i of the staged gain block (forward G_{t-1}[i][j], the
// block staged transposed; backward G_t[j][i]), and row i of rhs_t
// (forward) or w_t (backward).
struct StepOperands {
    real L[NT], rl[B2], gr[B2], v;
};

template <bool BWD, bool WSM>
__device__ __forceinline__ void load_step(const real* sg, const real* wsm_t,
                                          int i, StepOperands& o) {
    const STile C{sg + S_C * SQS}, Gt{sg + S_G * SQS}, V{sg + S_V * SQS};
#pragma unroll
    for (int k = 0; k < NT; ++k) o.L[k] = C[k];
#pragma unroll
    for (int k = 0; k < B2; ++k) o.rl[k] = rcp_rn(o.L[TRI(k, k)]);
    const int r = i < B2 ? i : 0;  // lanes past B2: a row of the tile, unused
#pragma unroll
    for (int j = 0; j < B2; ++j) o.gr[j] = Gt[j * B2 + r];
    o.v = BWD && WSM ? wsm_t[r * SQS] : V[r];
}

// One sweep, step u = 0..W-1 on t = u (forward) or W-1-u (backward):
// forward w_t = C_t^{-1} (rhs_t - G_{t-1} w_{t-1}), into wsm (w on chip)
// or x; backward x_t = C_t^{-T} (w_t - G_t' x_{t+1}), into x.  c[] holds
// the previous step's vector in every lane, zero at the first step.  vec is
// rhs forward and x backward (where w_t is staged from when not on chip).
template <bool BWD, bool WSM>
__device__ __forceinline__ void solve_sweep(
    const Stager& s, bool stager, bool idle, bool valid, int i, int g,
    const real* chol, const real* gain, const real* vec, real* ring,
    real* slot, real* wsm, real* xb, int W, int B, real* c) {
    auto step = [&](int u) { return BWD ? W - 1 - u : u; };
    if (stager)
        for (int u = 0; u < S_NSTAGE - 1; ++u) {
            if (u < W) solve_issue<BWD, WSM>(s, chol, gain, vec, ring, step(u), W);
            else cp_async_commit();
        }
    StepOperands o;
    for (int u = 0; u < W; ++u) {
        const int t = step(u);
        // Step u has landed (every step commits one group, empty past the
        // horizon), the whole block's with the barrier, and nobody reads the
        // stage the next issue overwrites any more.
        cp_async_wait<S_NSTAGE - 2>();
        __syncthreads();
        if (stager) {
            if (u + S_NSTAGE - 1 < W)
                solve_issue<BWD, WSM>(s, chol, gain, vec, ring,
                                      step(u + S_NSTAGE - 1), W);
            else
                cp_async_commit();
        }
        if (idle) continue;
        load_step<BWD, WSM>(ring + (t % S_NSTAGE) * S_ROWS * SQS + g,
                            wsm + t * B2 * SQS, i, o);
        if (i < B2) {
            real acc = real(0);
            if (u > 0) {
#pragma unroll
                for (int j = 0; j < B2; ++j) acc = fma_rn(o.gr[j], c[j], acc);
            }
            slot[i] = o.v - acc;
        }
        lane_group_sync(g, SG);
        solve_rows<BWD>(o.L, o.rl, slot, c);
        if (i < B2) {
            real ci = c[0];
#pragma unroll
            for (int k = 1; k < B2; ++k)
                if (i == k) ci = c[k];
            if (!BWD && WSM)
                wsm[(t * B2 + i) * SQS] = ci;
            else if (valid)
                xb[(size_t)(t * B2 + i) * B] = ci;
        }
    }
}

// WSM: w_t kept in shared memory (else in x).
template <bool WSM>
__global__ void __launch_bounds__(solve_threads(S_QLOG_MAX), 1)
    tridiag_solve_kernel(const real* __restrict__ chol,
                         const real* __restrict__ gain,
                         const real* __restrict__ rhs, real* x, int W, int B,
                         int qlog, int x4) {
    LANE_SMEM_DECL();
    const int tid = threadIdx.x, pbase = solve_producer_base(qlog);
    const bool idle = tid >= (SG << qlog), stager = tid >= pbase;
    const int g = tid / SG, i = tid % SG;
    const int b0 = blockIdx.x << qlog, b = b0 + g;
    const bool valid = !idle && b < B;
    const Stager s = make_stager(B, b0, qlog, tid - pbase, x4);
    real* ring = lane_smem;
    real* slot = ring + S_NSTAGE * S_ROWS * SQS + g * SG;
    real* wsm = ring + S_NSTAGE * S_ROWS * SQS + (SG << qlog) + g;
    real* xb = x + b;

    real c[B2];  // w_{t-1} forward, x_{t+1} backward, in every lane
#pragma unroll
    for (int k = 0; k < B2; ++k) c[k] = real(0);
    solve_sweep<false, WSM>(s, stager, idle, valid, i, g, chol, gain, rhs,
                            ring, slot, wsm, xb, W, B, c);
    // The barrier ends the forward sweep's reads of the ring (and makes its
    // w writes visible).
    __syncthreads();
#pragma unroll
    for (int k = 0; k < B2; ++k) c[k] = real(0);
    solve_sweep<true, WSM>(s, stager, idle, valid, i, g, chol, gain, x, ring,
                           slot, wsm, xb, W, B, c);
}

// Dynamic shared memory of the factor: C_{t-1} and G_{t-1} beside its two
// stages.
constexpr int FACTOR_SMEM = 3 * STAGE * LANE_BLOCK * (int)sizeof(real);

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

// The solve's plan on the current device for W steps and a batch of B;
// budget <= 0: the shared memory a block may use (the host-emulation tests
// pass a small one to put w in x).
static int solve_plan(int W, int B, int budget, SolvePlan* p) {
    int dev_smem = 0, sms = 0;
    const int err = lane_device_limits(&dev_smem, &sms);
    if (err != 0) return err;
    *p = solve_plan_for(W, B, budget > 0 ? budget : dev_smem, sms);
    return p->smem > dev_smem ? -1 : 0;
}

// plan[0..8] = threads per problem, problems per block Q, stages, w kept
// on chip (0/1), shared bytes, blocks, threads per block, tile row stride,
// bytes per staging copy (for 16-byte aligned arrays): the plan
// tridiag_solve_launch makes.
extern "C" int tridiag_solve_plan(int W, int B, int budget, long long* plan) {
    SolvePlan p{};
    const int err = solve_plan(W, B, budget, &p);
    const long long v[9] = {SG,       p.Q,       S_NSTAGE, p.w_on_chip, p.smem,
                            p.blocks, p.threads, SQS,
                            group_tile_x4(p.qlog, B) ? 16 : 4};
    for (int k = 0; k < 9; ++k) plan[k] = v[k];
    return err;
}

extern "C" int tridiag_solve_launch(const void* chol, const void* gain,
                                    const void* rhs, void* x, int W, int B,
                                    int budget, void* stream) {
    SolvePlan p{};
    const int err = solve_plan(W, B, budget, &p);
    if (err != 0) return err;
    // 16-byte copies need every staged array 16-byte aligned.
    uintptr_t bits = 0;
    for (const void* ptr : {chol, gain, rhs, (const void*)x})
        bits |= (uintptr_t)ptr;
    const int x4 = group_tile_x4(p.qlog, B) && bits % 16 == 0;
#define LANE_SOLVE_ARGS                                                       \
    (const real*)chol, (const real*)gain, (const real*)rhs, (real*)x, W, B,  \
        p.qlog, x4
    if (p.w_on_chip)
        return lane_launch_coop(&tridiag_solve_kernel<true>, p.blocks,
                                p.threads, SG, p.smem, stream,
                                LANE_SOLVE_ARGS);
    return lane_launch_coop(&tridiag_solve_kernel<false>, p.blocks, p.threads,
                            SG, p.smem, stream, LANE_SOLVE_ARGS);
#undef LANE_SOLVE_ARGS
}
