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
// Factor (a group of threads per problem: kkt_factor.cu's step, fed as
// below), so that a problem's chain is ~B2 pivots and one substitution a
// step, not the ~2,000 dependent operations of a step on one thread:
//   - a group of SG threads (16 at B2 = 12) works on one problem; a block
//     holds Q adjacent problems, the problem index fastest among a warp's
//     lanes (lane l of problem q is thread l*Q + q), so that the Q problems'
//     values of one entry are adjacent in every load and store (Q = 8: one
//     32-byte sector); Q is 8 while the blocks still cover 7/8 of the SMs,
//     fewer for small batches (B = 1024: 128 blocks; B = 1: one group);
//   - D_t and L_t do not depend on the chain: each lane copies what it will
//     read itself (its Schur entries of D_t, lane i < B2 row i of L_t) with
//     4-byte cp.async two steps ahead into a ring of three stages, and waits
//     for its own copies only (no barrier for them; a producer warp, the
//     solve's form, must copy 4 bytes at a time here and was 2.5x slower).  A
//     problem's values in shared memory are contiguous and read with 16-byte
//     loads (4x fewer shared-memory instructions than one value a load);
//   - a step: each lane forms NE (5) of the entries of S_t = D_t -
//     G_{t-1} G_{t-1}' in place from G_{t-1} in shared memory; barrier;
//     every lane factors the whole S_t in registers with the branch-free
//     rounded sqrt_rn and rcp_rn; lane i < B2 forms row i of G_t = L_t
//     C_t^{-T} (an independent forward substitution) while C_t is in its
//     registers, and writes row i of C_t (its upper part zero) and of G_t out
//     and G_t into shared memory; barrier.  The lanes past B2 run the same
//     code on rows of their own, and the stores and copies are predicated
//     (store_if, cp_async4_if), so that the copies, the Cholesky, the
//     substitution and the stores are one block without a branch, which the
//     compiler interleaves (with a branch around each store, as it compiles
//     a plain if, the kernel took a third longer: PERF.md).
// Above B2 = 20 (LANE_ROWS) lane i owns row i of the step instead: the
// Cholesky goes by columns across the group, a block barrier a pivot, C_t
// overwriting S_t in the stage, and row i of G_t reads C_t from there
// (factor_rows_step).
// Every entry keeps the one-thread kernel's order of operations (Schur and
// substitution sums from D_t and L_t with k ascending, one reciprocal per
// pivot times the sum, multiply-adds as nvcc contracted them, written out
// with fma_rn/mul_rn), so chol and gain are bit for bit that kernel's.  A
// non-positive pivot turns the whole block C_t into NaN, as a failed dense
// Cholesky does in the reference (and so G_t and every later block of that
// problem): statuses depend on it, no error is raised.  Bound: each
// problem's chain of W steps, each B2 pivots (a square root and a
// reciprocal) and the substitution behind them.
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
//   - every lane then solves the whole triangular system in registers
//     (above B2 = 16 reading C_t from the stage: L_IN_STAGE), row by row
//     with j ascending, as the one-thread kernel did, each division
//     rounded as the division rounds it but without its branch to a slow
//     path (div_rn: the pivots' reciprocals are taken off the chain), so
//     the rows' multiply-adds interleave: x is bit for bit that kernel's;
//   - above B2 = 20 (LANE_ROWS) lane i owns row i instead: the step's dot
//     product and triangular solve go by columns across the group, a
//     shuffle a column (solve_rows_across), and nothing of B2 values stays
//     in a lane's registers;
//   - the forward sweep keeps w_t on chip (W B2 values a problem) for the
//     backward sweep, or, where the launch plan finds no room, writes it into
//     x, from where the producer stages it back.  Nothing on a step's chain
//     reads device memory.
// Bound: bytes on paper (each step's blocks read once a sweep); in practice
// each problem's chain of 2W steps, each B2 divisions and the multiply-adds
// between them.
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "lane_platform.cuh"

#ifndef B2
#error "compile with -DB2=<block size>"
#endif

constexpr int NT = B2 * (B2 + 1) / 2;  // packed lower triangle
constexpr int NF = B2 * B2;            // full block

__host__ __device__ constexpr int TRI(int i, int j) {
    return i * (i + 1) / 2 + j;
}

// A group of SG threads (the smallest power of two >= B2, at least 4) works
// on one problem in both kernels.
constexpr int SG = pow2_at_least(B2) < 4 ? 4 : pow2_at_least(B2);
static_assert(SG <= 32, "a group is at most one warp (B2 <= 32)");

// Above B2 = 20 both kernels split a step's rows among the group's lanes
// (lane i owns row i) instead of working the whole B2 x B2 system in every
// lane, and the solve's producer issues its copies in a loop
// (solve_copies): neither kernel spills there.  Up to B2 = 20 the forms
// below are unchanged, bit for bit.  (With the copies unrolled, the solve
// built at B2 = 24 spilled and its results changed from run to run, with
// the consumer's earlier form and with this one alike: PERF.md.)
constexpr bool LANE_ROWS = B2 > 20;

// ---- the factor.
// Problems per block at most (log2), stages of the ring, Schur entries per
// lane, and a row of a block padded to whole 16-byte loads.
constexpr int F_QLOG_MAX = 3;
constexpr int F_NSTAGE = 3;
constexpr int NE = (NT + SG - 1) / SG;
constexpr int B2P = (B2 + 3) / 4 * 4;
// A problem's shared values, each read with 16-byte loads: in a stage of
// the ring, the packed lower triangle of D_t, which the Schur update turns
// into S_t in place (NE * SG values: those past NT take the last lanes'
// spare entries), then row i of L_t for lane i at F_L + i * B2P (lane i <
// B2 copies and reads it; the rows of the lanes past B2 are never copied);
// G_{t-1} as [lane][B2P].  Each stride is an odd number of 16-byte pieces,
// so that the Q problems' loads of one lane fall in distinct banks.
__host__ __device__ constexpr int odd_quads(int n) {
    return n % 8 == 0 ? n + 4 : n;
}
constexpr int F_L = NE * SG;
// LANE_ROWS: the first spare entry past the triangle (F_L > NT at every
// B2 above 20) holds the step's "some pivot not positive" flag.
constexpr int F_BAD = NT;
static_assert(!LANE_ROWS || F_L > NT, "a spare entry for the pivot flag");
constexpr int F_FR = odd_quads(F_L + SG * B2P);
constexpr int F_GS = odd_quads(SG * B2P);
// A lane's table of Schur entries packs four offsets into one word: a byte
// each while every offset is below 256 (B2 <= 16), else 16 bits each.
constexpr bool ENT_WIDE = !(F_L <= 256 && NF <= 256 && (B2 - 1) * B2P < 256);
using ent_t = std::conditional_t<ENT_WIDE, unsigned long long, unsigned>;
constexpr int ENT_BITS = ENT_WIDE ? 16 : 8;
constexpr ent_t ENT_MASK = (ent_t(1) << ENT_BITS) - 1;
static_assert(F_L <= 65536 && NF <= 65536, "entries fit 16 bits each");
// Field k of an entry: 0 and 1 the offsets of rows i and j of G, 2 the
// entry's offset (i, j) in a full block, 3 its place e in the triangle.
__host__ __device__ constexpr int ent_field(ent_t e, int k) {
    return (int)(e >> (k * ENT_BITS) & ENT_MASK);
}

__host__ __device__ constexpr long long factor_smem_bytes(int qlog) {
    return ((long long)F_NSTAGE * F_FR + F_GS) * (1 << qlog) *
           (long long)sizeof(real);
}

struct FactorPlan {
    int qlog, Q, smem, blocks, threads;
};

// Problems per block as the chunk kernel plans them.
static FactorPlan factor_plan_for(int B, int sms) {
    const int qlog = group_qlog(B, sms, F_QLOG_MAX), Q = 1 << qlog;
    return FactorPlan{qlog, Q, (int)factor_smem_bytes(qlog), (B + Q - 1) / Q,
                      SG << qlog};
}

// One step of the factor above B2 = 20, after the Schur update left S_t in
// the stage (sg: this problem's values) and the block's barrier: lane l < B2
// owns row l.  Cholesky by columns (a block barrier per pivot): lane j
// forms its pivot from its row, then every lane below forms its entry of
// column j from its row and row j in shared memory; C_t overwrites S_t in
// place.  Then row l of G_t = L_t C_t^{-T} from C_t in shared memory, into
// gq (G_{t-1}'s place, read by this step's Schur update before the last
// barrier) and out, and row l of C_t out.  Every entry keeps the one-thread
// kernel's order of operations, as the forms below B2 = 20 do.  Lanes past
// B2 (lr = 0) compute on row 0 and write nothing but their unread rows of
// gq.
__device__ __forceinline__ void factor_rows_step(
    real* sg, real* gq, real* co, real* go, int t, int W, size_t Bs, int l,
    int lr, bool row, bool valid) {
    real a[B2];  // row lr of S_t, then of C_t
#pragma unroll
    for (int k = 0; k < B2; ++k) a[k] = k <= lr ? sg[TRI(lr, k)] : real(0);
    if (l == 0) sg[F_BAD] = real(0);
#pragma unroll
    for (int j = 0; j < B2; ++j) {
        if (l == j) {
            real s = a[j];
#pragma unroll
            for (int k = 0; k < j; ++k) s = fma_rn(-a[k], a[k], s);
            if (!(s > real(0))) sg[F_BAD] = real(1);
            a[j] = sqrt_rn(s);
            sg[TRI(j, j)] = a[j];
        }
        __syncthreads();  // pivot j and row j whole
        if (row && l > j) {
            real v = a[j];
#pragma unroll
            for (int k = 0; k < j; ++k) v = fma_rn(-a[k], sg[TRI(j, k)], v);
            a[j] = mul_rn(v, rcp_rn(sg[TRI(j, j)]));
            sg[TRI(l, j)] = a[j];
        }
    }
    __syncthreads();  // C_t whole
    // A non-positive pivot: every value of C_t and G_t NaN.
    const real poison = sg[F_BAD] != real(0) ? real(NAN) : real(0);
    const bool gout = row && valid && t < W - 1;
    real g[B2P];
#pragma unroll
    for (int j = 0; j < B2P; ++j) {
        if (j < B2) {
            real s = sg[F_L + l * B2P + j];
#pragma unroll
            for (int k = 0; k < j; ++k) s = fma_rn(-g[k], sg[TRI(j, k)], s);
            g[j] = mul_rn(s, rcp_rn(sg[TRI(j, j)])) - poison;
            store_if(go + (size_t)t * NF * Bs + j * Bs, g[j], gout);
        } else {
            g[j] = real(0);
        }
    }
#pragma unroll
    for (int k = 0; k < B2P; k += 4) store4(gq + l * B2P + k, g + k);
#pragma unroll
    for (int j = 0; j < B2; ++j)
        store_if(co + (size_t)t * NF * Bs + j * Bs,
                 l >= j ? a[j] - poison : real(0), row && valid);
}

__global__ void __launch_bounds__(SG << F_QLOG_MAX, 1)
    tridiag_factor_kernel(const real* __restrict__ diag,
                          const real* __restrict__ lower,
                          real* __restrict__ chol, real* __restrict__ gain,
                          int W, int B, int qlog) {
    LANE_SMEM_DECL();
    const int Q = 1 << qlog, tid = threadIdx.x;
    const int q = tid & (Q - 1), l = tid >> qlog;
    const int b = (blockIdx.x << qlog) + q;
    const bool valid = b < B, row = l < B2;
    const size_t Bs = (size_t)B;
    // Past the batch (the last block): read the last problem, write nothing.
    const size_t bl = valid ? b : B - 1;
    real* ring = lane_smem + q * F_FR;                        // [stage][q][F_FR]
    real* gq = lane_smem + F_NSTAGE * F_FR * Q + q * F_GS;   // G_{t-1}
    const real nan = real(NAN);

    // This lane's Schur entries e = l, l + SG, ... of the packed triangle,
    // each its four fields of ent_field (the entries past NT update spare
    // values with row B2-1's terms, so that every lane runs NE entries
    // without a branch).
    ent_t ent[NE];
#pragma unroll
    for (int m = 0; m < NE; ++m) {
        const int e = l + m * SG;
        int i = 0;
        while (i + 1 < B2 && TRI(i + 1, 0) <= e) ++i;
        const int j = e < NT ? e - TRI(i, 0) : i;
        ent[m] = (ent_t)(i * B2P) | (ent_t)(j * B2P) << ENT_BITS |
                 (ent_t)(i * B2 + j) << 2 * ENT_BITS |
                 (ent_t)e << 3 * ENT_BITS;
    }
    // Where lane l < B2 writes row l of C_t and of G_t.
    const int lr = row ? l : 0;
    real* co = chol + (size_t)lr * B2 * Bs + b;
    real* go = gain + (size_t)lr * B2 * Bs + b;
    // This lane's copies of step u into stage u % F_NSTAGE, one commit
    // group: its entries of D_u and, lane i < B2 below the last step, row i
    // of L_u.  Past the horizon it copies the last step's entries into a
    // stage nobody reads, so that the copies need no branch.
    const auto issue = [&](int u) {
        real* sg = ring + (u % F_NSTAGE) * F_FR * Q;
        const int uc = u < W ? u : W - 1;
        const real* d = diag + (size_t)uc * NF * Bs + bl;
#pragma unroll
        for (int m = 0; m < NE; ++m)
            cp_async4_if(sg + ent_field(ent[m], 3),
                         d + ent_field(ent[m], 2) * Bs, l + m * SG < NT);
        const real* lo = lower + ((size_t)uc * NF + lr * B2) * Bs + bl;
#pragma unroll
        for (int j = 0; j < B2; ++j)
            cp_async4_if(sg + F_L + l * B2P + j, lo + j * Bs,
                         row && uc < W - 1);
        cp_async_commit();
    };
    for (int u = 0; u < F_NSTAGE - 1; ++u) issue(u);

    for (int t = 0; t < W; ++t) {
        real* sg = ring + (t % F_NSTAGE) * F_FR * Q;
        // Into the stage of step t-1, which nobody reads after the last
        // barrier.
        issue(t + F_NSTAGE - 1);
        cp_async_wait<F_NSTAGE - 1>();  // this lane's copies of step t
        if (t > 0) {
            // S_t = D_t - G_{t-1} G_{t-1}', this lane's entries, k ascending.
            real acc[NE];
#pragma unroll
            for (int m = 0; m < NE; ++m) {
                real gi[B2P], gj[B2P];
#pragma unroll
                for (int k = 0; k < B2P; k += 4) {
                    load4(gq + ent_field(ent[m], 0) + k, gi + k);
                    load4(gq + ent_field(ent[m], 1) + k, gj + k);
                }
                real a = sg[ent_field(ent[m], 3)];
#pragma unroll
                for (int k = 0; k < B2; ++k) a = fma_rn(-gi[k], gj[k], a);
                acc[m] = a;
            }
#pragma unroll
            for (int m = 0; m < NE; ++m) sg[ent_field(ent[m], 3)] = acc[m];
        }
        __syncthreads();  // S_t whole

        if constexpr (LANE_ROWS) {
            factor_rows_step(sg, gq, co, go, t, W, Bs, l, lr, row, valid);
        } else {
            // Cholesky of the whole S_t in this lane's registers, column by
            // column, one reciprocal per pivot.
            real S[(NT + 3) / 4 * 4], rl[B2];
#pragma unroll
            for (int k = 0; k < NT; k += 4) load4(sg + k, S + k);
            bool bad = false;
#pragma unroll
            for (int j = 0; j < B2; ++j) {
                real s = S[TRI(j, j)];
#pragma unroll
                for (int k = 0; k < j; ++k)
                    s = fma_rn(-S[TRI(j, k)], S[TRI(j, k)], s);
                bad = bad || !(s > real(0));
                const real d = sqrt_rn(s);
                rl[j] = rcp_rn(d);
                S[TRI(j, j)] = d;
#pragma unroll
                for (int i = j + 1; i < B2; ++i) {
                    real v = S[TRI(i, j)];
#pragma unroll
                    for (int k = 0; k < j; ++k)
                        v = fma_rn(-S[TRI(i, k)], S[TRI(j, k)], v);
                    S[TRI(i, j)] = mul_rn(v, rl[j]);
                }
            }
            // A non-positive pivot: every value of C_t and G_t NaN (x - poison
            // is x, -0 included, or NaN).
            const real poison = bad ? nan : real(0);
            // Row l of G_t = L_t C_t^{-T}: G[l][j] = (L[l][j] - sum_{k<j}
            // G[l][k] C[j][k]) / C[j][j]; into shared memory for the next step
            // (the lanes past B2 into rows nobody reads) and out.
            const bool gout = row && valid && t < W - 1;
            real Lr[B2P], g[B2P];
#pragma unroll
            for (int k = 0; k < B2P; k += 4)
                load4(sg + F_L + l * B2P + k, Lr + k);
#pragma unroll
            for (int j = 0; j < B2P; ++j) {
                real s = j < B2 ? Lr[j] : real(0);
#pragma unroll
                for (int k = 0; k < j && j < B2; ++k)
                    s = fma_rn(-g[k], S[TRI(j, k)], s);
                g[j] = j < B2 ? mul_rn(s, rl[j]) - poison : real(0);
                if (j < B2)
                    store_if(go + (size_t)t * NF * Bs + j * Bs, g[j], gout);
            }
#pragma unroll
            for (int k = 0; k < B2P; k += 4) store4(gq + l * B2P + k, g + k);
            // Row l of C_t, picked out of the registers, its upper part zero.
#pragma unroll
            for (int j = 0; j < B2; ++j) {
                real v = real(0);
#pragma unroll
                for (int i = j; i < B2; ++i) v = l == i ? S[TRI(i, j)] : v;
                v = l >= j ? v - poison : real(0);
                store_if(co + (size_t)t * NF * Bs + j * Bs, v, row && valid);
            }
        }
        __syncthreads();  // G_t whole
    }
}

// ---- the solve: a group of SG threads per problem.
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
// Above B2 = 20 (LANE_ROWS) the copies go in a loop (stage_tile_copies_
// rolled): unrolled, the producer's addresses of a stage's ~1,600 rows
// took the kernel's registers and it spilled.
template <int CNT, class DstRow>
__device__ __forceinline__ void solve_copies(const Stager& s, const real* src,
                                             real* dst, DstRow dst_row) {
    if constexpr (LANE_ROWS)
        stage_tile_copies_rolled<SQS, S_PRODUCERS, CNT>(s, src, dst, dst_row);
    else
        stage_tile_copies<SQS, S_PRODUCERS, CNT>(s, src, dst, dst_row);
}

template <bool BWD, bool WSM>
__device__ __forceinline__ void solve_issue(const Stager& s, const real* chol,
                                            const real* gain, const real* v,
                                            real* ring, int t, int W) {
    real* sg = ring + (t % S_NSTAGE) * S_ROWS * SQS;
    const size_t blk = (size_t)NF * s.B, vec = (size_t)B2 * s.B;
    solve_copies<NF>(s, chol + t * blk + s.b0, sg + S_C * SQS, [](int k) {
        const int i = k / B2, j = k % B2;
        return j <= i ? TRI(i, j) : -1;
    });
    if (!BWD && t > 0)
        solve_copies<NF>(s, gain + (t - 1) * blk + s.b0, sg + S_G * SQS,
                         [](int k) { return (k % B2) * B2 + k / B2; });
    if (BWD && t < W - 1)
        solve_copies<NF>(s, gain + t * blk + s.b0, sg + S_G * SQS,
                         [](int k) { return k; });
    if (!BWD || !WSM)
        solve_copies<B2>(s, v + t * vec + s.b0, sg + S_V * SQS,
                         [](int k) { return k; });
    cp_async_commit();
}

// Above B2 = 16 a lane cannot hold the step's triangle (NT values) in
// registers beside the rest: the solve then reads it from the stage at the
// point of use.  Held in registers at B2 = 18 and 20, the kernel spilled
// and its results on the card changed from run to run; read from the
// stage it does not spill there and is right in every case checked.  At
// B2 = 24 this form spilled again and failed: above B2 = 20 the solve
// takes the LANE_ROWS form.
constexpr bool L_IN_STAGE = B2 > 16;

// The step's triangular solve in every lane: y from the group's right-hand
// side r[] (in the slot) and the lower triangle L[] of C_t (in registers,
// or the stage's column above B2 = 16),
// row by row with j ascending and a division per row rounded as the
// division rounds it (div_rn, from the pivots' reciprocals rl[] taken as
// soon as L is loaded), as the one-thread kernel formed them: forward
// C y = r, backward C' y = r.
template <bool BWD, class Tri>
__device__ __forceinline__ void solve_rows(const Tri& L, const real* rl,
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
    real L[L_IN_STAGE ? 1 : NT], rl[B2], gr[B2], v;
};

template <bool BWD, bool WSM>
__device__ __forceinline__ void load_step(const real* sg, const real* wsm_t,
                                          int i, StepOperands& o) {
    const STile C{sg + S_C * SQS}, Gt{sg + S_G * SQS}, V{sg + S_V * SQS};
    if constexpr (L_IN_STAGE) {
#pragma unroll
        for (int k = 0; k < B2; ++k) o.rl[k] = rcp_rn(C[TRI(k, k)]);
    } else {
#pragma unroll
        for (int k = 0; k < NT; ++k) o.L[k] = C[k];
#pragma unroll
        for (int k = 0; k < B2; ++k) o.rl[k] = rcp_rn(o.L[TRI(k, k)]);
    }
    const int r = i < B2 ? i : 0;  // lanes past B2: a row of the tile, unused
#pragma unroll
    for (int j = 0; j < B2; ++j) o.gr[j] = Gt[j * B2 + r];
    o.v = BWD && WSM ? wsm_t[r * SQS] : V[r];
}

// A step of a sweep above B2 = 20 (LANE_ROWS), lane i owning row i: its
// element of the right-hand side (the dot product with the previous step's
// vector, whose elements the lanes own, through shuffles), then the
// triangular solve by columns across the group, a shuffle a column: lane j
// divides and passes its element, the lanes below (forward) or above
// (backward) take its term off.  Forward this is the row form's order of
// operations; backward each row takes its terms in decreasing j.  c is this
// lane's element of the previous step's vector on entry and of this step's
// on return.
template <bool BWD, bool WSM>
__device__ __forceinline__ real solve_rows_across(const real* sg,
                                                  const real* wsm_t, int i,
                                                  int g, bool first, real c) {
    const STile C{sg + S_C * SQS}, Gt{sg + S_G * SQS}, V{sg + S_V * SQS};
    const int r = i < B2 ? i : 0;  // lanes past B2: row 0's values, unused
    const real cii = C[TRI(r, r)], rli = rcp_rn(cii);
    real acc = real(0);
    if (!first) {
#pragma unroll
        for (int j = 0; j < B2; ++j)
            acc = fma_rn(Gt[j * B2 + r], lane_shfl(c, j, g, SG), acc);
    }
    real v = (BWD && WSM ? wsm_t[r * SQS] : V[r]) - acc, y = real(0);
#pragma unroll
    for (int u = 0; u < B2; ++u) {
        const int j = BWD ? B2 - 1 - u : u;
        const real yj = lane_shfl(div_rn(v, cii, rli), j, g, SG);
        y = i == j ? yj : y;
        if (!BWD && i > j && i < B2) v = fma_rn(-C[TRI(i, j)], yj, v);
        if (BWD && i < j) v = fma_rn(-C[TRI(j, i)], yj, v);
    }
    return y;
}

// One sweep, step u = 0..W-1 on t = u (forward) or W-1-u (backward):
// forward w_t = C_t^{-1} (rhs_t - G_{t-1} w_{t-1}), into wsm (w on chip)
// or x; backward x_t = C_t^{-T} (w_t - G_t' x_{t+1}), into x.  c[] holds
// the previous step's vector in every lane, zero at the first step (above
// B2 = 20 c[0] holds this lane's element of it).  vec is
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
        const real* sg = ring + (t % S_NSTAGE) * S_ROWS * SQS + g;
        if constexpr (LANE_ROWS) {
            c[0] = solve_rows_across<BWD, WSM>(sg, wsm + t * B2 * SQS, i, g,
                                                u == 0, c[0]);
            if (i < B2) {
                if (!BWD && WSM)
                    wsm[(t * B2 + i) * SQS] = c[0];
                else if (valid)
                    xb[(size_t)(t * B2 + i) * B] = c[0];
            }
        } else {
            load_step<BWD, WSM>(sg, wsm + t * B2 * SQS, i, o);
            if (i < B2) {
                real acc = real(0);
                if (u > 0) {
#pragma unroll
                    for (int j = 0; j < B2; ++j)
                        acc = fma_rn(o.gr[j], c[j], acc);
                }
                slot[i] = o.v - acc;
            }
            lane_group_sync(g, SG);
            if constexpr (L_IN_STAGE)
                solve_rows<BWD>(STile{sg + S_C * SQS}, o.rl, slot, c);
            else
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

    // w_{t-1} forward, x_{t+1} backward, in every lane (above B2 = 20 this
    // lane's element).
    constexpr int NC = LANE_ROWS ? 1 : B2;
    real c[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) c[k] = real(0);
    solve_sweep<false, WSM>(s, stager, idle, valid, i, g, chol, gain, rhs,
                            ring, slot, wsm, xb, W, B, c);
    // The barrier ends the forward sweep's reads of the ring (and makes its
    // w writes visible).
    __syncthreads();
#pragma unroll
    for (int k = 0; k < NC; ++k) c[k] = real(0);
    solve_sweep<true, WSM>(s, stager, idle, valid, i, g, chol, gain, x, ring,
                           slot, wsm, xb, W, B, c);
}

// The factor's plan on the current device for a batch of B.
static int factor_plan(int B, FactorPlan* p) {
    int dev_smem = 0, sms = 0;
    const int err = lane_device_limits(&dev_smem, &sms);
    if (err != 0) return err;
    *p = factor_plan_for(B, sms);
    return p->smem > dev_smem ? -1 : 0;
}

// plan[0..6] = threads per problem, problems per block Q, stages, shared
// bytes, blocks, threads per block, bytes per staging copy: the plan
// tridiag_factor_launch makes.
extern "C" int tridiag_factor_plan(int B, long long* plan) {
    FactorPlan p{};
    const int err = factor_plan(B, &p);
    const long long v[7] = {SG,       p.Q,       F_NSTAGE, p.smem,
                            p.blocks, p.threads, (long long)sizeof(real)};
    for (int k = 0; k < 7; ++k) plan[k] = v[k];
    return err;
}

extern "C" int tridiag_factor_launch(const void* diag, const void* lower,
                                     void* chol, void* gain, int W, int B,
                                     void* stream) {
    FactorPlan p{};
    const int err = factor_plan(B, &p);
    if (err != 0) return err;
    return lane_launch_coop(&tridiag_factor_kernel, p.blocks, p.threads,
                            p.threads, p.smem, stream, (const real*)diag,
                            (const real*)lower, (real*)chol, (real*)gain, W,
                            B, p.qlog);
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
