// KKT assemble + block-Cholesky + pack: a group of threads per problem, the
// assembly off the step chain.
//
// Replaces the Pallas kernel of osqp_solver_tpu/ops/kkt_factor_pallas.py
// (factor_packed_lane, body _make_kernel) in both forms: emit_gain=False
// (gainp null) and emit_gain=True.
//
// Per waypoint t: the lower half M_t of the 2N x 2N diagonal block of
// P + sigma*I + A' diag(rho) A and the coupling block Ml_t (three diagonals:
// (j, j) = qq, (j, N+j) = qv, (N+j, N+j) = vv; the formulas of ml_at() of the
// chunk kernel) from the stencil coefficients (vel-diag P); the Schur step
// S = M_t - G_{t-1} G_{t-1}'; S = C C'; the packed lower triangle of C to
// cholp row t; G_t = Ml_t C_t^{-T} (packed upper triangle), and with a gain
// pack (emit_gain) G_t to gainp row t, the row of the last waypoint zero
// (ops/admm_fused.py pack_factor).  Divisions go through one exact
// reciprocal per pivot, as in the reference kernel.
//
// Design (Hopper).  One thread per problem did all of it, on 32 single-warp
// blocks at B = 1024.  Here a group of G threads (the smallest power of two
// >= 2N: 16 at N = 6) works on each problem and a block holds Q adjacent
// problems, the problem index fastest among a warp's lanes (lane l of problem
// q is thread l*Q + q), so a row's loads and stores of the Q problems are
// adjacent values.  The chain over t is real (S_t needs G_{t-1}), but:
//   - the assembly of M_t and Ml_t does not depend on t-1: a prologue
//     assembles a window of TW waypoints of all Q problems at once (one
//     thread per (waypoint, problem) pair) into shared memory, before the
//     chain walks them; the window is planned so that the blocks of one wave
//     fit on the SMs (W = 100 at B = 1024: 8 problems a block, two windows);
//   - a step: each lane forms a few entries of the Schur update (G_{t-1} in
//     shared memory), barrier; every lane factors the whole 2N x 2N S in its
//     registers (no exchange), with the branch-free rounded sqrt_rn and
//     rcp_rn of lane_platform.cuh; lane i < 2N forms row i of G_t (an
//     independent forward substitution) into shared memory for the next
//     step and, with emit_gain, to gainp; barrier; C_t goes to its slot and
//     out to cholp during the next step, a few entries a lane.
// Above N = 10 (LANE_ROWS) the whole S no longer fits a lane's registers:
// the prologue assembles each waypoint in its slot, and lane i owns row i
// of the step (factor_rows_step: the Cholesky by columns across the group,
// a barrier a pivot, in place in the slot; row i of G_t from there).
// Above N = 16 (WIDE: 2N > 32) the group spans several warps (64 threads at
// N = 17-32, at most 512), and a block holds one problem: the blocked step
// of wide_chol.cuh (kkt_factor_wide_kernel).  Each step stages the
// waypoint's coefficients that the assembly reads, assembles M_t's lower
// triangle in C's place of the working matrix [G | C] (every thread a few
// entries), factors it panel by panel (G_{t-1} upper triangular: the sums
// over G start at the panel), and forms G_t = Ml_t C_t^{-T} panel by panel
// in G_{t-1}'s place (upper triangular: panel J's rows below it are zero
// and skipped).  Where the matrix does not fit in shared memory it and the
// staged coefficients live in a device-memory workspace that the wrapper
// allocates (DEV); the arithmetic is the same in both placements.
// Two other designs were timed on the card and were no faster (PERF.md): the
// Cholesky by columns across the group (lane i owning row i, a barrier a
// pivot), and the whole Schur update in every lane's registers with one
// barrier a step.
// Bound: each problem's chain of W dependent steps (a square root and an
// exact reciprocal per pivot), not bytes or operations.
#include <type_traits>

#include "lane_common.cuh"
#include "wide_chol.cuh"

// Threads per problem (at most LANE_GROUP_MAX), problems per block at most
// (log2), threads per block.  WIDE: a group of several warps, one problem
// a block.
constexpr int G = group_size(B2);
constexpr bool WIDE = B2 > 32;
constexpr int QLOG_MAX = WIDE ? 0 : 3;
constexpr int MAX_THREADS = G << QLOG_MAX;
// Schur entries per lane.
constexpr int NE = (T + G - 1) / G;
// One waypoint's slot of the window: M_t (then S_t, then C_t, packed lower)
// and Ml_t (qq, qv, vv); an odd count, so that the prologue's stores of
// several waypoints land in distinct banks.  G_{t-1} of a problem: GS values
// (odd, so that the problems of a warp read distinct banks).
constexpr int SL_ML = T;
constexpr int SLOT = (T + 3 * N + 1) | 1;
constexpr int GS = T | 1;
// The slot row that the Schur entries past T (NE * G > T) update: a spare.
constexpr int SL_SPARE = SLOT - 1;
// A lane's table of Schur entries packs four fields into one word: a byte
// each while every field is below 256 (N <= 10), else 16 bits each.
// (The wide form keeps no table.)
constexpr bool ENT_WIDE = !(SLOT <= 256 && GS <= 256);
using ent_t = std::conditional_t<ENT_WIDE, unsigned long long, unsigned>;
constexpr int ENT_BITS = ENT_WIDE ? 16 : 8;
static_assert(WIDE || (SLOT <= 65536 && GS <= 65536),
              "entries fit 16 bits each");
// Field k of an entry: 0 its row i, 1 and 2 the offsets of rows i and j of
// the packed upper G (G[UP(i, k)] at gq[ui + k] for k >= i), 3 its slot row.
__host__ __device__ constexpr int ent_field(ent_t e, int k) {
    return (int)(e >> (k * ENT_BITS) & ((ent_t(1) << ENT_BITS) - 1));
}
// Above 2N = 20 (N > 10) the step's rows are split among the group's lanes
// (the header's LANE_ROWS form): no array of T values stays in a lane's
// registers.
constexpr bool LANE_ROWS = B2 > 20;

// ---------------------------------------------------------------- the plan

struct FactorPlan {
    int Q, qlog, TW, windows, smem, blocks, threads;
    long long work;  // DEV: values of the device-memory workspace
    int cl = 1;      // WIDE: blocks a problem (above 1: the split form)
};

// The wide form (WIDE): rows of the working matrix (2N in whole panels),
// panels, a row of [G | C] (whole 16-byte pieces, rows 1 apart in distinct
// banks) and the matrix's values; the staged coefficients of a waypoint:
// the dense rows' N coefficients each and their rho, the diagonal terms
// of the q and v blocks and the q-v coupling, and Ml's three diagonals;
// the head of the shared memory: the diagonal block's pivot reciprocals.
constexpr int WP = wc_pad(B2);
constexpr int WNP = WP / WC_NB;
constexpr int WLD = 2 * WP + 4;
constexpr long long W_M = (long long)WP * WLD;
constexpr int WS_F = 0, WS_RX = NX * N, WS_DQ = WS_RX + NX, WS_CQ = WS_DQ + N,
              WS_DV = WS_CQ + N, WS_MQ = WS_DV + N, WS_MQV = WS_MQ + N,
              WS_MV = WS_MQV + N;
constexpr int W_ST = (WS_MV + N + 3) / 4 * 4;
constexpr int W_HEAD = 64;
// The split form's copy of a diagonal block (in shared memory, and in the
// workspace past the stage as the product left it).
constexpr int W_TLD = WC_NB + 4;
constexpr int W_TS = WC_NB * W_TLD;
// The products read all their initial values before their first store in
// groups of 256 threads or more: on an H100 16.3 ms against 17.0 at N=256
// (W=20, B=8) so, and at N=40 (W=100, B=256) 6.3 against 6.1.
constexpr bool W_INIT_FIRST = G >= 256;

static FactorPlan factor_plan_for(int W, int B, int budget, int sms) {
    if (WIDE) {
        // One problem a block, each step assembling its own waypoint; the
        // matrix and the stage in shared memory where they fit in budget,
        // else in device memory; where the batch leaves SMs idle, 4 of
        // them or more a problem, the split form: cl blocks a problem (up
        // to one a panel of rows), one launch a phase.  (On an H100 at
        // N=100, W=50: 2 blocks a problem 20.7 ms against 17.1 for one at
        // B=64, 4 blocks 13.5 against 16.2 at B=32.)
        int cl = B > 0 ? sms / B : 1;
        if (cl > WNP) cl = WNP;
        const int sz = (int)sizeof(real);
        if (cl >= 4 && (W_HEAD + W_TS) * sz <= budget)
            return FactorPlan{1, 0, 1, W, (W_HEAD + W_TS) * sz, B * cl, G,
                              W_M + W_ST + W_TS, cl};
        const long long chip = (W_HEAD + W_M + W_ST) * (long long)sz;
        if (chip <= budget)
            return FactorPlan{1, 0, 1, W, (int)chip, B, G, 0};
        return FactorPlan{1, 0, 1, W, W_HEAD * sz, B, G, W_M + W_ST};
    }
    int qlog = QLOG_MAX;
    // Q problems a block while the blocks still cover 7/8 of the SMs.
    while (qlog > 0 && 8LL * ((B + (1 << qlog) - 1) >> qlog) < 7LL * sms)
        --qlog;
    const int Q = 1 << qlog;
    const int blocks = (B + Q - 1) / Q;
    // Shared memory of a block such that the blocks of one wave (up to two a
    // SM) fit; a block reserves 1 KB of the SM's shared memory.
    const int per_sm = sms > 0 ? (blocks + sms - 1) / sms : 1;
    const int k = per_sm < 2 ? 1 : 2;
    long long per_block = ((long long)budget + 1024) / k - 1024;
    if (per_block > budget) per_block = budget;
    const long long fixed = (long long)GS * Q;
    long long tw = (per_block / (long long)sizeof(real) - fixed) /
                   ((long long)SLOT * Q);
    if (tw > W) tw = W;
    FactorPlan p{};
    if (tw < 1) return p;
    const int windows = (int)((W + tw - 1) / tw);
    const int TW = (W + windows - 1) / windows;
    const long long bytes =
        ((long long)TW * SLOT * Q + fixed) * (long long)sizeof(real);
    p = FactorPlan{Q, qlog, TW, windows, (int)bytes, blocks, G * Q, 0};
    return p;
}

// --------------------------------------------------------------- the kernel

// One step above N = 10 (LANE_ROWS), after the Schur update left S_t in its
// slot (stride Q) and the block's barrier: lane l < 2N owns row l.  Cholesky
// by columns (a block barrier per pivot): lane j forms its pivot from its
// row, then every lane below forms its entry of column j from its row and
// row j in the slot; C_t overwrites S_t in place, where the next step stores
// it out.  Then row l of G_t = Ml_t C_t^{-T} from C_t in the slot, into
// G_{t-1}'s place (read by this step's Schur update before the last
// barrier) and with emit_gain to gainp row t.  Every entry keeps the order
// of operations of the form in registers.
template <bool GAIN>
__device__ __forceinline__ void factor_rows_step(real* slot, real* gq,
                                                 real* gainp, int t, int W,
                                                 size_t Bs, int b, int Q,
                                                 int l, bool valid) {
    const bool row = l < B2;
    const int lr = row ? l : 0;
    const auto C = [&](int i, int j) -> real& { return slot[LOW(i, j) * Q]; };
    real a[B2];  // row lr of S_t, then of C_t
#pragma unroll
    for (int k = 0; k < B2; ++k) a[k] = k <= lr ? C(lr, k) : real(0);
#pragma unroll
    for (int jj = 0; jj < B2; ++jj) {
        if (l == jj) {
            real sdd = a[jj];
#pragma unroll
            for (int k = 0; k < jj; ++k) sdd -= a[k] * a[k];
            a[jj] = sqrt_rn(sdd);
            C(jj, jj) = a[jj];
        }
        __syncthreads();  // pivot jj and row jj whole
        if (row && l > jj) {
            real sij = a[jj];
#pragma unroll
            for (int k = 0; k < jj; ++k) sij -= a[k] * C(jj, k);
            a[jj] = sij * rcp_rn(C(jj, jj));
            C(l, jj) = a[jj];
        }
    }
    __syncthreads();  // C_t whole
    if (!row) return;
    const real diag =
        l < N ? slot[(SL_ML + l) * Q] : slot[(SL_ML + N + l) * Q];
    const real qv = l < N ? slot[(SL_ML + N + l) * Q] : real(0);
    real grow[B2];
#pragma unroll
    for (int j = 0; j < B2; ++j) {
        real sij = j == l ? diag : (j == l + N ? qv : real(0));
#pragma unroll
        for (int k = 0; k < j; ++k)
            if (k >= l) sij -= grow[k] * C(j, k);
        grow[j] = j >= l ? sij * rcp_rn(C(j, j)) : real(0);
    }
    real* grow_out = gq + (UP(l, l) - l);
#pragma unroll
    for (int j = 0; j < B2; ++j)
        if (j >= l) grow_out[j] = grow[j];
    if (GAIN && valid) {
        real* gout = gainp + ((size_t)t * Tp + UP(l, l) - l) * Bs + b;
#pragma unroll
        for (int j = 0; j < B2; ++j)
            if (j >= l) gout[(size_t)j * Bs] = t < W - 1 ? grow[j] : real(0);
    }
}

// DEV: never (the narrow forms' window is on chip; the parameter and work
// keep the kernel's signature).
template <bool GAIN, bool DEV = false>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    kkt_factor_kernel(const real* __restrict__ coef_,
                      const real* __restrict__ rho_,
                      const real* __restrict__ pd_,
                      const real* __restrict__ pl_, real* __restrict__ cholp,
                      real* __restrict__ gainp, int W, int B, real sigma,
                      int qlog, int TW, real* work) {
    LANE_SMEM_DECL();
    const int Q = 1 << qlog;
    const int tid = threadIdx.x, nthreads = G << qlog;
    const int q = tid & (Q - 1), l = tid >> qlog;
    const int b0 = blockIdx.x << qlog, b = b0 + q;
    const bool valid = b < B;
    const size_t Bs = (size_t)B;
    // [t][SLOT][Q]
    real* win = DEV ? work + (size_t)blockIdx.x * ((size_t)TW * SLOT + GS) * Q
                    : lane_smem;
    real* gq = win + (size_t)TW * SLOT * Q + q * GS;  // G_{t-1}: [Q][GS]

    // This lane's Schur entries (i, j) of the packed lower triangle, NE of
    // them; those past T update the spare slot row with row 2N-1's single
    // term, so that every lane runs NE entries without a branch.  Fields
    // (ent_field): i, the offsets of rows i and j of the packed upper G and
    // the slot row.
    ent_t ent[NE];
#pragma unroll
    for (int m = 0; m < NE; ++m) {
        const int e = l + m * G;
        int i = 0;
        while (i + 1 < B2 && LOW(i + 1, 0) <= e) ++i;
        const int j = e < T ? e - LOW(i, 0) : i;
        ent[m] = (ent_t)i | (ent_t)(UP(i, i) - i) << ENT_BITS |
                 (ent_t)(UP(j, j) - j) << 2 * ENT_BITS |
                 (ent_t)(e < T ? e : SL_SPARE) << 3 * ENT_BITS;
    }
    for (int e = l; e < T; e += G) gq[e] = real(0);  // G_{-1} = 0
    // Packed C of waypoint t from its slot to cholp row t: entries l, l + G,
    // ... of this lane (the Q problems of a warp's store are adjacent).
    const auto store_chol = [&](const real* cslot, int t) {
        real* out = cholp + (size_t)t * Tp * Bs + b;
#pragma unroll
        for (int m = 0; m < (Tp + G - 1) / G; ++m) {
            const int e = l + m * G;
            if (e < Tp) out[(size_t)e * Bs] = e < T ? cslot[e * Q] : real(0);
        }
    };

    for (int t0 = 0; t0 < W; t0 += TW) {
        const int tn = W - t0 < TW ? W - t0 : TW;
        // ---- prologue: M_t and Ml_t of the window, one thread a pair
        for (int pr = tid; pr < tn * Q; pr += nthreads) {
            const int tl = pr >> qlog, t = t0 + tl;
            const int bb = b0 + (pr & (Q - 1));
            if (bb >= B) continue;
            const Pack coef{coef_, Bs, bb}, rho{rho_, Bs, bb}, pd{pd_, Bs, bb},
                pl{pl_, Bs, bb};
            real* slot = win + (size_t)tl * SLOT * Q + (pr & (Q - 1));
            // M_t in registers, or (LANE_ROWS) in its slot.
            real Sr[LANE_ROWS ? 1 : T];
            const auto S = [&](int k) -> real& {
                if constexpr (LANE_ROWS) return slot[k * Q];
                else return Sr[k];
            };
#pragma unroll
            for (int k = 0; k < T; ++k) S(k) = real(0);
            // Dense q-block J' rho J of the workspace / obstacle rows.
#pragma unroll
            for (int k = 0; k < NX; ++k) {
                const real rr = rho(t, Rp, R_X + k);
                real f[N];
#pragma unroll
                for (int j = 0; j < N; ++j) f[j] = coef(t, CRp, C_X + k * N + j);
#pragma unroll
                for (int i = 0; i < N; ++i) {
                    const real fi = f[i] * rr;
#pragma unroll
                    for (int j = 0; j <= i; ++j) S(LOW(i, j)) += fi * f[j];
                }
            }
#pragma unroll
            for (int j = 0; j < N; ++j) {
                const real rd = rho(t, Rp, R_DYN + j);
                const real ra = rho(t, Rp, R_ACC + j);
                const real c0 = coef(t, CRp, C_C0 + j);
                const real c1 = coef(t, CRp, C_C1 + j);
                const real c2 = coef(t, CRp, C_C2 + j);
                const real a0 = coef(t, CRp, C_A0 + j);
                const real a1 = coef(t, CRp, C_A1 + j);
                const real po = coef(t, CRp, C_POS + j);
                const real ve = coef(t, CRp, C_VEL + j);
                // The coupling rows of waypoint t-1 (zero at t = 0; loaded
                // from waypoint 0 there, so that no load waits on a branch).
                const int tp = t > 0 ? t - 1 : 0;
                const real c1p = coef(tp, CRp, C_C1 + j);
                const real a0p = coef(tp, CRp, C_A0 + j);
                const real rdp = rho(tp, Rp, R_DYN + j);
                const real rap = rho(tp, Rp, R_ACC + j);
                const real c1sq = t > 0 ? rdp * c1p * c1p : real(0);
                const real a0sq = t > 0 ? rap * a0p * a0p : real(0);
                const real d_qq =
                    rho(t, Rp, R_POS + j) * po * po + rd * c2 * c2 + c1sq;
                const real d_vv = rd * c0 * c0 +
                                  rho(t, Rp, R_VEL + j) * ve * ve + a0sq +
                                  ra * a1 * a1;
                S(LOW(j, j)) = S(LOW(j, j)) + d_qq + sigma;
                S(LOW(N + j, j)) = rd * c2 * c0;
                S(LOW(N + j, N + j)) = d_vv + pd(t, PNp, j) + sigma;
                slot[(SL_ML + j) * Q] = rd * c1 * c2;
                slot[(SL_ML + N + j) * Q] = rd * c1 * c0;
                slot[(SL_ML + 2 * N + j) * Q] = ra * a0 * a1 + pl(t, PNp, j);
            }
            if constexpr (!LANE_ROWS) {
#pragma unroll
                for (int k = 0; k < T; ++k) slot[k * Q] = Sr[k];
            }
        }
        __syncthreads();

        // ---- the chain over the window
        for (int tl = 0; tl < tn; ++tl) {
            const int t = t0 + tl;
            real* slot = win + (size_t)tl * SLOT * Q + q;
            // S = M_t - G_{t-1} G_{t-1}', NE entries a lane.  Every k is
            // loaded (k < i reads other entries of G) and the slot written
            // after all the sums, so that no load waits behind a predicate
            // or a store; each sum takes k >= i.
            real acc[NE];
#pragma unroll
            for (int m = 0; m < NE; ++m) {
                const int i = ent_field(ent[m], 0);
                const real* gi = gq + ent_field(ent[m], 1);
                const real* gj = gq + ent_field(ent[m], 2);
                real a[B2], c[B2];
#pragma unroll
                for (int k = 0; k < B2; ++k) {
                    a[k] = gi[k];
                    c[k] = gj[k];
                }
                acc[m] = real(0);
#pragma unroll
                for (int k = 0; k < B2; ++k)
                    acc[m] = k >= i ? acc[m] + a[k] * c[k] : acc[m];
            }
#pragma unroll
            for (int m = 0; m < NE; ++m) {
                real* e = slot + ent_field(ent[m], 3) * Q;
                *e = *e - acc[m];
            }
            __syncthreads();
            // C_{t-1} out of its slot (written there after the last barrier),
            // a few entries a lane, the pad entries zero.
            if (tl > 0 && valid) store_chol(slot - SLOT * Q, t - 1);

            if constexpr (LANE_ROWS) {
                factor_rows_step<GAIN>(slot, gq, gainp, t, W, Bs, b, Q, l,
                                       valid);
                if (GAIN && valid) {
                    for (int e = T + l; e < Tp; e += G)
                        gainp[((size_t)t * Tp + e) * Bs + b] = real(0);
                }
                __syncthreads();
            } else {
                // Cholesky of the whole S in this lane's registers.
                real S[T], idia[B2];
#pragma unroll
                for (int k = 0; k < T; ++k) S[k] = slot[k * Q];
#pragma unroll
                for (int jj = 0; jj < B2; ++jj) {
                    real sdd = S[LOW(jj, jj)];
#pragma unroll
                    for (int k = 0; k < jj; ++k)
                        sdd -= S[LOW(jj, k)] * S[LOW(jj, k)];
                    const real d = sqrt_rn(sdd);
                    S[LOW(jj, jj)] = d;
                    idia[jj] = rcp_rn(d);
#pragma unroll
                    for (int i = jj + 1; i < B2; ++i) {
                        real sij = S[LOW(i, jj)];
#pragma unroll
                        for (int k = 0; k < jj; ++k)
                            sij -= S[LOW(i, k)] * S[LOW(jj, k)];
                        S[LOW(i, jj)] = sij * idia[jj];
                    }
                }

                // Row i = l of G_t = Ml_t C_t^{-T} (upper triangular: Ml has
                // the diagonals qq, vv and qv at (j, N+j)): into G_{t-1}'s
                // place for the next step, and with emit_gain to gainp row t.
                if (l < B2) {
                    const real diag = l < N ? slot[(SL_ML + l) * Q]
                                            : slot[(SL_ML + N + l) * Q];
                    const real qv =
                        l < N ? slot[(SL_ML + N + l) * Q] : real(0);
                    real grow[B2];
#pragma unroll
                    for (int j = 0; j < B2; ++j) {
                        real sij =
                            j == l ? diag : (j == l + N ? qv : real(0));
#pragma unroll
                        for (int k = 0; k < j; ++k)
                            if (k >= l) sij -= grow[k] * S[LOW(j, k)];
                        grow[j] = j >= l ? sij * idia[j] : real(0);
                    }
                    real* grow_out = gq + (UP(l, l) - l);
#pragma unroll
                    for (int j = 0; j < B2; ++j)
                        if (j >= l) grow_out[j] = grow[j];
                    if (GAIN && valid) {
                        real* gout =
                            gainp + ((size_t)t * Tp + UP(l, l) - l) * Bs + b;
#pragma unroll
                        for (int j = 0; j < B2; ++j)
                            if (j >= l)
                                gout[(size_t)j * Bs] =
                                    t < W - 1 ? grow[j] : real(0);
                    }
                }
                if (GAIN && valid) {
                    for (int e = T + l; e < Tp; e += G)
                        gainp[((size_t)t * Tp + e) * Bs + b] = real(0);
                }
                __syncthreads();
                // C_t into the slot of S_t (read by every lane before the
                // barrier), by the lanes of the first warp.
                if (l * Q < LANE_WARP) {
#pragma unroll
                    for (int k = 0; k < T; ++k) slot[k * Q] = S[k];
                }
            }
        }
        __syncthreads();
        // C of the window's last step out before the next window's prologue.
        if (valid) store_chol(win + (size_t)(tn - 1) * SLOT * Q + q, t0 + tn - 1);
        __syncthreads();
    }
}

// The wide form (WIDE): M = [G | C], rows of WLD values (wide_chol.cuh),
// and the stage of the waypoint's coefficients, a problem's values in
// shared memory or (DEV) in the workspace.  A step in phases: the stage,
// M_t's lower triangle in C's place, C_t panel by panel (the panel's
// product, its diagonal block factored, the rows below solved against it
// and C_t's panel out to cholp row t), then G_t = Ml_t C_t^{-T} panel by
// panel in G_{t-1}'s place, out to gainp row t as it is formed
// (emit_gain; the last waypoint's row zero).  Where G_{t-1}'s entries in
// a product are zero (G upper triangular) its sums skip them: over G from
// the panel's first column, and panel J of G_t only for the rows above the
// panel's end (those below zero).  One block a problem runs every phase in
// one launch (kkt_factor_wide_kernel); the split form
// (kkt_factor_split_kernel) runs each phase as a launch of cl blocks a
// problem, each its chunk of the rows, every block factoring the diagonal
// block in a copy of its own (Ts, from the product's tb; the first writes
// it into M).
template <bool GAIN>
struct KktWide {
    Pack coef, rho, pd, pl;
    real* cholp;
    real* gainp;
    real* M;     // the working matrix
    real* st;    // the stage
    real* head;  // the diagonal block's pivot reciprocals, a spare flag
    real* Ts;    // the split form's copy of the diagonal block (else null)
    real* tb;    // the split form's diagonal block as the product left it
    int W, b, tid;
    size_t Bs;
    real sigma;

    // The coefficients of waypoint t that the assembly and Ml_t read.
    __device__ void stage(int t) const {
#pragma unroll 1
        for (int e = tid; e < NX * N; e += G)
            st[WS_F + e] = coef(t, CRp, C_X + e);
        for (int k = tid; k < NX; k += G) st[WS_RX + k] = rho(t, Rp, R_X + k);
#pragma unroll 1
        for (int j = tid; j < N; j += G) {
            const real rd = rho(t, Rp, R_DYN + j);
            const real ra = rho(t, Rp, R_ACC + j);
            const real c0 = coef(t, CRp, C_C0 + j);
            const real c1 = coef(t, CRp, C_C1 + j);
            const real c2 = coef(t, CRp, C_C2 + j);
            const real a0 = coef(t, CRp, C_A0 + j);
            const real a1 = coef(t, CRp, C_A1 + j);
            const real po = coef(t, CRp, C_POS + j);
            const real ve = coef(t, CRp, C_VEL + j);
            // The coupling rows of waypoint t-1 (zero at t = 0).
            const int tp = t > 0 ? t - 1 : 0;
            const real c1p = coef(tp, CRp, C_C1 + j);
            const real a0p = coef(tp, CRp, C_A0 + j);
            const real rdp = rho(tp, Rp, R_DYN + j);
            const real rap = rho(tp, Rp, R_ACC + j);
            const real c1sq = t > 0 ? rdp * c1p * c1p : real(0);
            const real a0sq = t > 0 ? rap * a0p * a0p : real(0);
            st[WS_DQ + j] =
                rho(t, Rp, R_POS + j) * po * po + rd * c2 * c2 + c1sq;
            st[WS_CQ + j] = rd * c2 * c0;
            st[WS_DV + j] = rd * c0 * c0 + rho(t, Rp, R_VEL + j) * ve * ve +
                            a0sq + ra * a1 * a1 + pd(t, PNp, j) + sigma;
            st[WS_MQ + j] = rd * c1 * c2;
            st[WS_MQV + j] = rd * c1 * c0;
            st[WS_MV + j] = ra * a0 * a1 + pl(t, PNp, j);
        }
    }
    // Entry (r, c <= r) of M_t (the identity past 2N): the dense rows'
    // J' rho J on the q block, the stencil's diagonals, the q-v coupling.
    __device__ real m_at(int r, int c) const {
        if (r >= B2) return r == c ? real(1) : real(0);
        if (r < N) {
            real s = real(0);
#pragma unroll
            for (int k = 0; k < NX; ++k)
                s = fma_rn(mul_rn(st[WS_F + k * N + r], st[WS_RX + k]),
                           st[WS_F + k * N + c], s);
            return c == r ? s + st[WS_DQ + r] + sigma : s;
        }
        return c == r - N ? st[WS_CQ + r - N]
               : c == r   ? st[WS_DV + r - N]
                          : real(0);
    }
    // Entry (r, c) of Ml_t: (j, j) qq, (j, N + j) qv, (N + j, N + j) vv.
    __device__ real ml_at(int r, int c) const {
        if (r >= B2 || c >= B2) return real(0);
        if (r == c) return r < N ? st[WS_MQ + r] : st[WS_MV + r - N];
        return r < N && c == r + N ? st[WS_MQV + r] : real(0);
    }
    // M_t's lower triangle in C's place, chunk c of its rows.
    __device__ void assemble(int c, int cl) const {
        int a, e;
        wc_chunk(0, WP, c, cl, a, e);
#pragma unroll 1
        for (int k = a * WP + tid; k < e * WP; k += G) {
            const int r = k / WP, cc = k % WP;
            if (cc <= r) M[r * WLD + WP + cc] = m_at(r, cc);
        }
    }
    // Panel p of C_t, chunk c of its rows: M_t's less [G_{t-1} from column
    // p0 | C_t so far] of the rows times the panel rows', in place.
    __device__ void product(int p, int c, int cl) const {
        const int p0 = p * WC_NB;
        int a, e;
        wc_chunk(p0, WP, c, cl, a, e);
        real* Cp = M + WP + p0;
        // The split form's diagonal block apart, so that no block's
        // write-back of it races another's read.
        const int split = Ts != nullptr ? p0 + WC_NB : 0;
        wc_panel_product<G, WLD, WP, W_INIT_FIRST>(
            M, p0, p0, p0, a, e, WP, tid,
            [&](int r, int k) { return Cp[r * WLD + k]; },
            [&](int r, int k, real v) {
                if (r < split)
                    tb[(r - p0) * W_TLD + k] = v;
                else
                    Cp[r * WLD + k] = v;
            });
    }
    // Panel p's diagonal block factored by the first warp: in place, or
    // (split) from tb into Ts, the first block writing it into M.
    __device__ void tile(int p, int c) const {
        const int p0 = p * WC_NB;
        const int npiv = B2 - p0 < WC_NB ? B2 - p0 : WC_NB;
        wc_block_factor<WLD, W_TLD>(M + p0 * WLD + WP + p0, Ts, tb, tid,
                                    head, head + WC_NB, head + WC_NB, npiv,
                                    c == 0);
    }
    // Chunk c of panel p's rows below its diagonal block solved against
    // it, and their entries of the panel out to cholp row t; the first
    // chunk also the block's rows (their lower part), and at the last
    // panel the pad entries.
    template <int TLD>
    __device__ void solve_on(const real* Tb, int t, int p, int c,
                             int cl) const {
        const int p0 = p * WC_NB;
        real* co = cholp + (size_t)t * Tp * Bs + b;
        int a, e;
        wc_chunk(p0 + WC_NB, WP, c, cl, a, e);
        wc_row_solve<G, WLD, TLD>(
            M, a, e, WP + p0, Tb, head, real(0), B2 - p0, tid,
            [&](int r, int j, real v) {
                if (r < B2 && p0 + j < B2)
                    co[(size_t)LOW(r, p0 + j) * Bs] = v;
            });
        if (c != 0) return;
        for (int k = tid; k < WC_NB * WC_NB; k += G) {
            const int i = k / WC_NB, j = k % WC_NB;
            if (j <= i && p0 + i < B2)
                co[(size_t)LOW(p0 + i, p0 + j) * Bs] = Tb[i * TLD + j];
        }
        if (p == WNP - 1)
            for (int k = T + tid; k < Tp; k += G) co[(size_t)k * Bs] = real(0);
    }
    __device__ void solve(int t, int p, int c, int cl) const {
        if (Ts != nullptr)
            solve_on<W_TLD>(Ts, t, p, c, cl);
        else
            solve_on<WLD>(M + p * WC_NB * WLD + WP + p * WC_NB, t, p, c,
                          cl);
    }
    // The gain pack's row t zero (the last waypoint), chunk c of it; and
    // any row's pad entries.
    __device__ void gain_zeros(int t, int c, int cl) const {
        if (!GAIN) return;
        real* go = gainp + (size_t)t * Tp * Bs + b;
        int a, e;
        wc_chunk(t == W - 1 ? 0 : T, Tp, c, cl, a, e);
        for (int k = a + tid; k < e; k += G) go[(size_t)k * Bs] = real(0);
    }
    // Panel J of G_t, chunk c of the rows (the same chunk at every J, so
    // that a block's rows of G_t so far are its own): those above the
    // panel's end are Ml_t's less G_t so far times C_t's panel rows, then
    // each solved against C_t's diagonal block, out as formed; those below
    // it, zero.
    __device__ void gain_panel(int t, int J, int c, int cl) const {
        const int j0 = J * WC_NB, rend = j0 + WC_NB;
        const real* blk = M + j0 * WLD + WP + j0;
        if (tid < WC_NB) head[tid] = rcp_rn(blk[tid * WLD + tid]);
        if (Ts != nullptr)
            for (int k = 4 * tid; k < WC_NB * WC_NB; k += 4 * G)
                copy4(Ts + (k / WC_NB) * W_TLD + k % WC_NB,
                      blk + (k / WC_NB) * WLD + k % WC_NB);
        real* Gp = M + j0;
        int a, e;
        wc_chunk(0, WP, c, cl, a, e);
        const int mid = e < rend ? e : a > rend ? a : rend;
#pragma unroll 1
        for (int k = mid * WC_NB + tid; k < e * WC_NB; k += G)
            Gp[(k / WC_NB) * WLD + k % WC_NB] = real(0);
        e = mid;
        wc_panel_product<G, WLD, WP, W_INIT_FIRST>(
            M, 0, j0, WP, a, e, j0, tid,
            [&](int r, int k) { return ml_at(r, j0 + k); },
            [&](int r, int k, real v) { Gp[r * WLD + k] = v; });
        __syncthreads();
        real* go = gainp + (size_t)t * Tp * Bs + b;
        const auto out = [&](int r, int j, real v) {
            const int cc = j0 + j;
            if (GAIN && cc >= r && cc < B2)
                go[(size_t)(UP(r, r) - r + cc) * Bs] = v;
        };
        if (Ts != nullptr)
            wc_row_solve<G, WLD, W_TLD>(M, a, e, j0, Ts, head, real(0),
                                        B2 - j0, tid, out);
        else
            wc_row_solve<G, WLD, WLD>(M, a, e, j0, blk, head, real(0),
                                      B2 - j0, tid, out);
    }
};

// One block a problem: every phase of every step in one launch.  DEV: M
// and the stage in the workspace work.
template <bool GAIN, bool DEV = false>
__global__ void __launch_bounds__(G, 1)
    kkt_factor_wide_kernel(const real* __restrict__ coef_,
                           const real* __restrict__ rho_,
                           const real* __restrict__ pd_,
                           const real* __restrict__ pl_,
                           real* __restrict__ cholp, real* __restrict__ gainp,
                           int W, int B, real sigma, int qlog, int TW,
                           real* work) {
    LANE_SMEM_DECL();
    (void)qlog;
    (void)TW;
    const int tid = threadIdx.x, b = blockIdx.x;
    const size_t Bs = (size_t)B;
    real* M = DEV ? work + (size_t)b * (W_M + W_ST) : lane_smem + W_HEAD;
    const KktWide<GAIN> f{{coef_, Bs, b}, {rho_, Bs, b}, {pd_, Bs, b},
                          {pl_, Bs, b},   cholp,         gainp,
                          M,              M + W_M,       lane_smem,
                          nullptr,        nullptr,       W,
                          b,              tid,           Bs,
                          sigma};
#pragma unroll 1
    for (int e = tid; e < WP * WP; e += G)
        M[(e / WP) * WLD + e % WP] = real(0);  // G_{-1} = 0
    for (int t = 0; t < W; ++t) {
        f.stage(t);
        __syncthreads();  // the stage whole; G_{t-1} whole
        f.assemble(0, 1);
        __syncthreads();
#pragma unroll 1
        for (int p = 0; p < WNP; ++p) {
            f.product(p, 0, 1);
            __syncthreads();
            if (tid < 32) f.tile(p, 0);
            __syncthreads();
            f.solve(t, p, 0, 1);
            __syncthreads();
        }
        f.gain_zeros(t, 0, 1);
        if (t == W - 1) break;
#pragma unroll 1
        for (int J = 0; J < WNP; ++J) {
            f.gain_panel(t, J, 0, 1);
            __syncthreads();
        }
    }
}

// The split form's phases, one a launch of cl blocks a problem (block
// b * cl + c takes chunk c of problem b's rows; a kernel a phase, so that
// each takes the registers of its own work); M and the stage in the
// workspace work.  KW_GAIN forms every panel of G_t for the block's rows
// (they depend on those rows and C_t alone), after the gain pack's zeros
// (the first block; at the last step only those).
enum { KW_INIT, KW_STAGE, KW_ASSEMBLE, KW_PRODUCT, KW_TILE_SOLVE, KW_GAIN };

template <bool GAIN, int PHASE>
__global__ void __launch_bounds__(G, 1)
    kkt_factor_split_kernel(const real* __restrict__ coef_,
                            const real* __restrict__ rho_,
                            const real* __restrict__ pd_,
                            const real* __restrict__ pl_,
                            real* __restrict__ cholp,
                            real* __restrict__ gainp, int W, int B,
                            real sigma, real* work, int cl, int t, int p) {
    LANE_SMEM_DECL();
    const int tid = threadIdx.x, b = blockIdx.x / cl, c = blockIdx.x % cl;
    const size_t Bs = (size_t)B;
    real* M = work + (size_t)b * (W_M + W_ST + W_TS);
    const KktWide<GAIN> f{{coef_, Bs, b},     {rho_, Bs, b},
                          {pd_, Bs, b},       {pl_, Bs, b},
                          cholp,              gainp,
                          M,                  M + W_M,
                          lane_smem,          lane_smem + W_HEAD,
                          M + W_M + W_ST,     W,
                          b,                  tid,
                          Bs,                 sigma};
    if constexpr (PHASE == KW_INIT) {  // G_{-1} = 0
        int a, e;
        wc_chunk(0, WP, c, cl, a, e);
#pragma unroll 1
        for (int k = a * WP + tid; k < e * WP; k += G)
            M[(k / WP) * WLD + k % WP] = real(0);
    } else if constexpr (PHASE == KW_STAGE) {
        f.stage(t);
    } else if constexpr (PHASE == KW_ASSEMBLE) {
        f.assemble(c, cl);
    } else if constexpr (PHASE == KW_PRODUCT) {
        f.product(p, c, cl);
    } else if constexpr (PHASE == KW_TILE_SOLVE) {
        if (tid < 32) f.tile(p, c);
        __syncthreads();
        f.solve(t, p, c, cl);
    } else {
        if (c == 0) f.gain_zeros(t, 0, 1);
        if (t == W - 1) return;
#pragma unroll 1
        for (int J = 0; J < WNP; ++J) {
            f.gain_panel(t, J, c, cl);
            __syncthreads();
        }
    }
}

// The launch in either form (gain), DEV: the wide form's matrix in the
// workspace (a template, so that a build compiles its own form's kernels
// only).
// The split form (WIDE, p.cl blocks a problem): each phase of each step a
// launch (the stage, the assembly, the product and the diagonal block's
// phase of every panel of C_t, then every panel of G_t in one), a phase's
// blocks a problem fewer where its rows are fewer (one for every panel of
// them, at least one).
template <bool GAIN>
static int launch_split(const FactorPlan& p, void* stream, const real* coef,
                        const real* rho, const real* pd, const real* pl,
                        real* cholp, real* gainp, int W, int B, real sigma,
                        real* work) {
    if constexpr (WIDE) {
        const auto run = [&](auto kernel, int t, int q, int rows) {
            int cl = rows / WC_NB;
            cl = cl < 1 ? 1 : cl > p.cl ? p.cl : cl;
            return lane_launch_coop(kernel, B * cl, p.threads, p.threads,
                                    p.smem, stream, coef, rho, pd, pl, cholp,
                                    gainp, W, B, sigma, work, cl, t, q);
        };
        int err = run(&kkt_factor_split_kernel<GAIN, KW_INIT>, 0, 0, WP);
        for (int t = 0; t < W && err == 0; ++t) {
            err = run(&kkt_factor_split_kernel<GAIN, KW_STAGE>, t, 0, 0);
            if (err == 0)
                err = run(&kkt_factor_split_kernel<GAIN, KW_ASSEMBLE>, t, 0,
                          WP);
            for (int q = 0; q < WNP && err == 0; ++q) {
                err = run(&kkt_factor_split_kernel<GAIN, KW_PRODUCT>, t, q,
                          WP - q * WC_NB);
                if (err == 0)
                    err = run(&kkt_factor_split_kernel<GAIN, KW_TILE_SOLVE>,
                              t, q, WP - (q + 1) * WC_NB);
            }
            if (err == 0)
                err = run(&kkt_factor_split_kernel<GAIN, KW_GAIN>, t, 0, WP);
        }
        return err;
    } else {
        (void)p, (void)stream, (void)coef, (void)rho, (void)pd, (void)pl;
        (void)cholp, (void)gainp, (void)W, (void)B, (void)sigma, (void)work;
        return -1;
    }
}

template <bool DEV, class... A>
static int launch_form(bool gain, const FactorPlan& p, void* stream,
                       A... args) {
    const int smem = DEV && !WIDE ? 0 : p.smem;
    if constexpr (WIDE) {
        if (gain)
            return lane_launch_coop(&kkt_factor_wide_kernel<true, DEV>,
                                    p.blocks, p.threads, p.threads, smem,
                                    stream, args...);
        return lane_launch_coop(&kkt_factor_wide_kernel<false, DEV>, p.blocks,
                                p.threads, p.threads, smem, stream, args...);
    } else {
        if (gain)
            return lane_launch_coop(&kkt_factor_kernel<true, DEV>, p.blocks,
                                    p.threads, p.threads, smem, stream,
                                    args...);
        return lane_launch_coop(&kkt_factor_kernel<false, DEV>, p.blocks,
                                p.threads, p.threads, smem, stream, args...);
    }
}

// plan[0..10] = threads per problem G, problems per block Q, waypoints per
// window TW, windows, shared bytes, blocks, threads per block, the shared
// bytes planned for, the bytes of the device-memory workspace the launch
// needs (0: none; the wide form where no waypoint fits on chip), blocks a
// problem (above 1: the wide form split, one launch a phase), and the
// split form's launches a step (launch_split: a call makes 1 + W times as
// many; 0: one launch a call): the plan kkt_factor_launch makes on the
// current device.  budget <= 0: the
// device's (the host-emulation tests pass a small budget to reach several
// windows, or the workspace).  Returns -1 where not one waypoint fits the
// shared memory of the budget or the device (kkt_factor_launch refuses it
// too).
extern "C" int kkt_factor_plan(int W, int B, int budget, long long* plan) {
    int dev_smem = 0, sms = 0;
    const int err = lane_device_limits(&dev_smem, &sms);
    if (err != 0) return err;
    if (budget <= 0) budget = dev_smem;
    const FactorPlan p = factor_plan_for(W, B, budget, sms);
    const long long v[11] = {G,        p.Q,      p.TW,      p.windows,
                             p.smem,   p.blocks, p.threads, budget,
                             p.work * (p.blocks / p.cl) *
                                 (long long)sizeof(real),
                             p.cl,     p.cl > 1 ? 3 + 2 * WNP : 0};
    for (int k = 0; k < 11; ++k) plan[k] = v[k];
    return p.TW == 0 || p.smem > dev_smem ? -1 : 0;
}

// gainp: null for the chol-only form (emit_gain=False).  budget: as
// kkt_factor_plan; work: its workspace (null where the plan needs none;
// the last argument, so that a caller of the earlier signature still
// works where none is needed).
extern "C" int kkt_factor_launch(const void* coef, const void* rho,
                                 const void* pd, const void* pl, void* cholp,
                                 void* gainp, int W, int B, double sigma,
                                 int budget, void* stream, void* work) {
    int dev_smem = 0, sms = 0;
    const int err = lane_device_limits(&dev_smem, &sms);
    if (err != 0) return err;
    if (budget <= 0) budget = dev_smem;
    const FactorPlan p = factor_plan_for(W, B, budget, sms);
    if (p.TW == 0 || p.smem > dev_smem || (p.work > 0 && work == nullptr))
        return -1;
#define LANE_FACTOR_ARGS                                                      \
    (const real*)coef, (const real*)rho, (const real*)pd, (const real*)pl,    \
        (real*)cholp, (real*)gainp, W, B, (real)sigma, p.qlog, p.TW,          \
        (real*)work
    if (p.cl > 1) {
        const auto split = gainp != nullptr ? &launch_split<true>
                                            : &launch_split<false>;
        return split(p, stream, (const real*)coef, (const real*)rho,
                     (const real*)pd, (const real*)pl, (real*)cholp,
                     (real*)gainp, W, B, (real)sigma, (real*)work);
    }
    if (p.work > 0)
        return launch_form<WIDE>(gainp != nullptr, p, stream,
                                 LANE_FACTOR_ARGS);
    return launch_form<false>(gainp != nullptr, p, stream, LANE_FACTOR_ARGS);
#undef LANE_FACTOR_ARGS
}
