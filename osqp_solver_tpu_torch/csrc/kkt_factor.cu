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
// Two other designs were timed on the card and were no faster (PERF.md): the
// Cholesky by columns across the group (lane i owning row i, a barrier a
// pivot), and the whole Schur update in every lane's registers with one
// barrier a step.
// Bound: each problem's chain of W dependent steps (a square root and an
// exact reciprocal per pivot), not bytes or operations.
#include <type_traits>

#include "lane_common.cuh"

// Threads per problem, problems per block at most (log2), threads per block.
constexpr int G = pow2_at_least(B2);
static_assert(G <= 32, "a group is at most one warp (2N <= 32)");
constexpr int QLOG_MAX = 3;
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
constexpr bool ENT_WIDE = !(SLOT <= 256 && GS <= 256);
using ent_t = std::conditional_t<ENT_WIDE, unsigned long long, unsigned>;
constexpr int ENT_BITS = ENT_WIDE ? 16 : 8;
static_assert(SLOT <= 65536 && GS <= 65536, "entries fit 16 bits each");
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
};

static FactorPlan factor_plan_for(int W, int B, int budget, int sms) {
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
    p = FactorPlan{Q, qlog, TW, windows, (int)bytes, blocks, G * Q};
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

template <bool GAIN>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    kkt_factor_kernel(const real* __restrict__ coef_,
                      const real* __restrict__ rho_,
                      const real* __restrict__ pd_,
                      const real* __restrict__ pl_, real* __restrict__ cholp,
                      real* __restrict__ gainp, int W, int B, real sigma,
                      int qlog, int TW) {
    LANE_SMEM_DECL();
    const int Q = 1 << qlog;
    const int tid = threadIdx.x, nthreads = G << qlog;
    const int q = tid & (Q - 1), l = tid >> qlog;
    const int b0 = blockIdx.x << qlog, b = b0 + q;
    const bool valid = b < B;
    const size_t Bs = (size_t)B;
    real* win = lane_smem;                         // [t][SLOT][Q]
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

// plan[0..7] = threads per problem G, problems per block Q, waypoints per
// window TW, windows, shared bytes, blocks, threads per block, and the
// shared bytes planned for: the plan kkt_factor_launch makes on the current
// device.  budget <= 0: the device's (the host-emulation tests pass a small
// budget to reach several windows).
extern "C" int kkt_factor_plan(int W, int B, int budget, long long* plan) {
    int dev_smem = 0, sms = 0;
    const int err = lane_device_limits(&dev_smem, &sms);
    if (err != 0) return err;
    if (budget <= 0) budget = dev_smem;
    const FactorPlan p = factor_plan_for(W, B, budget, sms);
    const long long v[8] = {G,        p.Q,      p.TW,      p.windows,
                            p.smem,   p.blocks, p.threads, budget};
    for (int k = 0; k < 8; ++k) plan[k] = v[k];
    return 0;
}

// gainp: null for the chol-only form (emit_gain=False).  budget: as
// kkt_factor_plan.
extern "C" int kkt_factor_launch(const void* coef, const void* rho,
                                 const void* pd, const void* pl, void* cholp,
                                 void* gainp, int W, int B, double sigma,
                                 int budget, void* stream) {
    int dev_smem = 0, sms = 0;
    const int err = lane_device_limits(&dev_smem, &sms);
    if (err != 0) return err;
    if (budget <= 0) budget = dev_smem;
    const FactorPlan p = factor_plan_for(W, B, budget, sms);
    if (p.TW == 0 || p.smem > dev_smem) return -1;
#define LANE_FACTOR_ARGS                                                      \
    (const real*)coef, (const real*)rho, (const real*)pd, (const real*)pl,    \
        (real*)cholp, (real*)gainp, W, B, (real)sigma, p.qlog, p.TW
    if (gainp == nullptr)
        return lane_launch_coop(&kkt_factor_kernel<false>, p.blocks,
                                p.threads, p.threads, p.smem, stream,
                                LANE_FACTOR_ARGS);
    return lane_launch_coop(&kkt_factor_kernel<true>, p.blocks, p.threads,
                            p.threads, p.smem, stream, LANE_FACTOR_ARGS);
#undef LANE_FACTOR_ARGS
}
