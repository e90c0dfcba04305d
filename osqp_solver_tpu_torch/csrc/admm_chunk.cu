// Fused ADMM chunk, a group of threads per problem: n_iter OSQP iterations
// per launch on the packed state, and in the last backward pass either the
// termination / certificate accumulators (MODE_TERM) or the last iteration's
// packed deltas dx, dy (MODE_DXDY), or neither (MODE_PLAIN).  Each mode exists
// in both factor forms: gain-free ("hrec", GAIN = false) and with the packed
// gain G_t streamed beside the packed chol (GAIN = true).
//
// Replaces the Pallas kernel of osqp_solver_tpu/ops/admm_fused.py
// (fused_admm_chunk, body _make_kernel): with emit_term, in the
// accumulator-free form the warm-up chunk uses, and in the no-emit_term form
// that writes the (W, DRp, B) delta pack for the separate residual kernel
// (csrc/residuals.cu), each in the hrec and in the gain form.
//
// Per iteration:
//   forward  (t = 0..W-1):  rhs_t = sigma x_t - q_t + [A'(rho z - y)]_t, built
//            from the stencil (the A' gather touches rows of waypoints t-1, t);
//            hrec: h_t = C_t^{-T} C_t^{-1} (rhs_t - Ml_{t-1} h_{t-1});
//            gain: w_t = C_t^{-1} (rhs_t - G_{t-1} w_{t-1});
//            h_t / w_t goes to a (W, 2N, B) global scratch (L2-resident).
//   backward (t = W-1..0):  hrec: x~_t = h_t - C_t^{-T} C_t^{-1} (Ml_t' x~_{t+1});
//            gain: x~_t = C_t^{-T} (w_t - G_t' x~_{t+1});
//            A rows of waypoint t from (x~_t, x~_{t+1}), relaxation, box
//            projection, dual update; state tile t rewritten IN PLACE.
// Ml_t is the sparse KKT coupling block rebuilt from rho and the stencil
// (same formulas as the factor kernel); G_t is the packed upper triangle the
// factor kernel writes with emit_gain (row t; the last row zero).  Frozen
// problems (done) keep their state and emit zero deltas.
//
// MODE_DXDY, last backward pass: as x_t, y_t of waypoint t are rewritten, the
// deltas against the state BEFORE this iteration (read from the staged copy of
// the tile, so before the in-place write) go to dxdy[t] = [dx (2N); dy (Rp);
// pad]; frozen problems emit exact zeros.
//
// MODE_TERM, last backward pass: the accumulators of the separate residual
// kernel (ops/residuals.py _ACC), equal to it bit for bit on the same state
// and deltas: both reduce through lane_common.cuh's termination functions
// (reduce_row, at_gather, reduce_var, waypoint_sum, term_finish) in the same
// backward walk, the per-waypoint sums parked in the h scratch of their
// (already consumed) waypoint.
//
// Design (Hopper).  The work of a waypoint step is a chain: two (gain: one)
// 2N x 2N triangular solves per pass.  One thread per problem left B = 1024 at
// 32 single-warp blocks (100 of 132 SMs idle) with every staged row and every
// multiply-add of a step on one thread.  Here:
//   - a group of G threads (the smallest power of two >= 2N: 16 at N = 6)
//     works on one problem; a block holds Q adjacent problems (planned at each
//     launch: 4 while the blocks still cover 7/8 of the SMs, fewer for small
//     batches), so B = 1024 is 256 blocks of 64 such threads;
//   - a producer warp per block stages waypoint t+2's rows of its Q problems
//     (t-2 backward) with cp.async into a ring of NSTAGE = 3 tiles while the
//     groups compute waypoint t, one __syncthreads per step; the copies'
//     instructions are then off the groups' chain.  A tile is [row][QS = 12]
//     (one column per problem), 16-byte copies of four problems each;
//   - each lane of a group solves the whole 2N x 2N systems in registers
//     from the group's vector (left in shared memory, one __syncwarp): the
//     two problems of a warp share one instruction stream, and the solve
//     needs no exchange (column sweeps across the group were slower: a
//     shuffle per pivot on the chain).  Above N = 10 (LANE_SOLVE) the
//     factor does not fit a lane's registers, and the solves go by columns
//     across the group, the factor read from the stage;
//   - constraint rows r = lane, lane + G, ... stay on one lane each, from the
//     A-row apply to the state and delta writes; the vectors a row reads
//     (x~_t, x~_{t+1}, and in MODE_TERM x_sel, dx of t and t+1) sit in a
//     small shared-memory slot per group, double-buffered by waypoint parity.
// Bound: on paper bytes (each pack read once per pass); in practice each
// problem's chain of dependent steps (the solves' 2N true divisions each, the
// rows), with one or two blocks of 3 warps per SM: eight problems take about
// as long as 1024.  PERF.md records the variants timed on the card.
#include <cstdint>
#include <initializer_list>

#include "lane_common.cuh"

// Threads per problem, and problems per block at most.
constexpr int G = pow2_at_least(B2) < 4 ? 4 : pow2_at_least(B2);
static_assert(G <= 32, "a group is at most one warp (2N <= 32)");
// Problems per block at most (log2) and stages of the ring, as tuned on an
// H100 (PERF.md records the other values timed).
constexpr int QLOG_MAX = 2;
constexpr int Q_MAX = 1 << QLOG_MAX;
constexpr int NSTAGE = 3;
// The producer threads of a block, which issue all the staging copies.
constexpr int PRODUCERS = group_producers(G);

// One stage of the ring: rows of QS values (one column per problem).
constexpr int O_CH = 0;            // packed chol, T rows
constexpr int O_CF = O_CH + T;     // stencil coefficients, CR rows
constexpr int O_RH = O_CF + CR;    // rho, Rp rows
constexpr int O_PL = O_RH + Rp;    // P-lower velocity diagonal, N rows
constexpr int O_ST = O_PL + N;     // state tile x, z, y: SR rows
constexpr int O_QW = O_ST + SR;    // q (forward) or the h scratch (backward)
constexpr int O_LU = O_QW + B2;    // bounds, 2 Rp rows (backward only)
constexpr int STAGE_ROWS = O_LU + 2 * Rp;
// The last backward pass of a MODE_TERM launch also stages:
constexpr int O_EE = STAGE_ROWS;        // E then Einv, 2 Rp rows
constexpr int O_VC = O_EE + 2 * Rp;     // q, D, Dinv: 3 * 2N rows
constexpr int O_PD = O_VC + 3 * B2;     // P-diag velocity diagonal, N rows
constexpr int STAGE_ROWS_TERM = O_PD + N;
// The gain form stages the packed G (T rows) after the rows above: G_{t-1}
// in the forward pass, G_t in the backward pass.
__host__ __device__ constexpr int o_gain(bool term) {
    return term ? STAGE_ROWS_TERM : STAGE_ROWS;
}
__host__ __device__ constexpr int stage_rows(bool term, bool gain) {
    return o_gain(term) + (gain ? T : 0);
}

// The slot of a group (shared memory after the ring): vectors of G values
// and rows of a waypoint, two of each (waypoint parity), the support terms
// of a waypoint's rows, the accumulators, and the right-hand side of a
// solve.
constexpr int SL_X = 0;             // fwd: h_t / w_t; bwd: x~_t
constexpr int SL_XS = SL_X + 2 * G;   // x_sel_t (MODE_TERM)
constexpr int SL_DX = SL_XS + 2 * G;  // dx_t (MODE_TERM)
constexpr int SL_Y = SL_DX + 2 * G;   // y_sel of the Rp rows (MODE_TERM), 2x
constexpr int SL_DY = SL_Y + 2 * Rp;  // dy of the Rp rows (MODE_TERM), 2x
constexpr int SL_SUP = SL_DY + 2 * Rp;  // support terms (MODE_TERM)
constexpr int SL_ACC = SL_SUP + 2 * Rp;  // the accumulators (MODE_TERM)
constexpr int SL_R = SL_ACC + NACC;   // the right-hand side of a solve
constexpr int SLOT = SL_R + G;
static_assert(A_COUNT <= NACC && 4 <= G, "");

enum { MODE_PLAIN = 0, MODE_TERM = 1, MODE_DXDY = 2 };

// The tile: rows of QS = 12 values, Q <= 4 of them used (one column per
// problem).  A compile-time stride makes every staged read an immediate
// offset; the G lanes of a problem, reading G rows of one column, meet at
// most 2-way bank conflicts.  16-byte copies when a block's columns are
// whole 16-byte pieces of every row (group_tile_x4) and every pack is
// 16-byte aligned, else 4-byte copies.  Where three stages of the largest
// form (the gain form with the accumulators) would not leave a block's
// shared memory 32 KB of the 227 KB it may use at 12 values a row (above
// N = 12), the rows take QS = 4, one value per problem.
__host__ __device__ constexpr int qs_for(int rows) {
    return NSTAGE * rows * 12 * 4 <= 195 * 1024 ? 12 : 4;
}
constexpr int QS = qs_for(stage_rows(true, true));
static_assert(Q_MAX <= QS && QS % 4 == 0, "");

__host__ __device__ constexpr int producer_base(int qlog) {
    return group_producer_base(G << qlog);
}
__host__ __device__ constexpr int block_threads(int qlog) {
    return producer_base(qlog) + PRODUCERS;
}

// The shared-memory bytes of a launch.
__host__ __device__ constexpr int chunk_smem_bytes(int qlog, bool term,
                                                   bool gain) {
    return (NSTAGE * stage_rows(term, gain) * QS + (1 << qlog) * SLOT) *
           (int)sizeof(real);
}

using Tile = TileCol<QS>;

struct Args {
    const real *chol, *gain, *coef, *q, *lu, *rho, *plf, *ee, *varc, *pd;
    real* state;
    real* w;
    real* acc;
    real* dxdy;
    int W, B;
    real sigma, alpha;
    // This thread: block's first problem, problems per block (log2), group
    // (= problem in the block), lane, its problem; below, whether the batch
    // holds its problem and whether that is frozen.
    int b0, qlog, g, lane, b;
    bool x4;        // stage with 16-byte copies (four problems each)
    bool stager;    // this thread is a producer: it issues staging copies
    bool idle;      // this thread computes nothing (a producer, or a pad
                    // thread before the producers' warp)
    int ptid;       // its index among the PRODUCERS
    bool valid;
    bool frozen;
    real* ring;  // stage 0 of the ring
    real* slot;  // this group's slot
};

// Copy the first CNT rows of waypoint t of a (W, ROWS, B) pack into rows
// DST.. of stage sg, the block's Q columns (this producer's share).
template <int ROWS, int CNT, int DST>
__device__ __forceinline__ void stage_rows_of(const Args& a, const real* pack,
                                              int t, real* sg) {
    stage_pack_rows<QS, PRODUCERS, ROWS, CNT, DST>(
        make_stager(a.B, a.b0, a.qlog, a.ptid, a.x4), pack, t, sg);
}

// Start the block's copies of waypoint t's rows into stage t % NSTAGE and
// commit them as one group.
template <bool BWD, bool GAIN, bool TERM = false>
__device__ __forceinline__ void stage_issue(const Args& a, int t) {
    real* sg = a.ring + (t % NSTAGE) * stage_rows(TERM, GAIN) * QS;
    stage_rows_of<Tp, T, O_CH>(a, a.chol, t, sg);
    if (GAIN)
        stage_rows_of<Tp, T, o_gain(TERM)>(
            a, a.gain, BWD ? t : (t > 0 ? t - 1 : 0), sg);
    stage_rows_of<CRp, CR, O_CF>(a, a.coef, t, sg);
    stage_rows_of<Rp, Rp, O_RH>(a, a.rho, t, sg);
    stage_rows_of<PNp, N, O_PL>(a, a.plf, t, sg);
    stage_rows_of<SRp, SR, O_ST>(a, a.state, t, sg);
    if (BWD) {
        stage_rows_of<B2, B2, O_QW>(a, a.w, t, sg);
        stage_rows_of<2 * Rp, 2 * Rp, O_LU>(a, a.lu, t, sg);
        if (TERM) {
            stage_rows_of<2 * Rp, 2 * Rp, O_EE>(a, a.ee, t, sg);
            stage_rows_of<VCp, 3 * B2, O_VC>(a, a.varc, t, sg);
            stage_rows_of<PNp, N, O_PD>(a, a.pd, t, sg);
        }
    } else {
        stage_rows_of<B2, B2, O_QW>(a, a.q, t, sg);
    }
    cp_async_commit();
}

// Top of a step: this thread's copies of waypoint t have landed (every step
// commits one group, empty past the horizon, so NSTAGE - 2 later groups are
// in flight), the whole block's with the barrier, and nobody reads the
// stage the next issue overwrites any more.  Returns this problem's column
// of stage t.
template <bool TERM, bool GAIN>
__device__ __forceinline__ const real* stage_wait(const Args& a, int t) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    return a.ring + (t % NSTAGE) * stage_rows(TERM, GAIN) * QS + a.g;
}

// L y = v in place, L the packed lower triangle c[] (true divisions), by
// columns: y_j = v_j / L_jj, then v_i -= L_ij y_j below it, so each row
// subtracts in increasing j as a row-by-row substitution does, and the
// chain is one division and one multiply-add per column.
__device__ __forceinline__ void lower_solve(const real* c, real* v) {
#pragma unroll
    for (int j = 0; j < B2; ++j) {
        v[j] = v[j] / c[LOW(j, j)];
#pragma unroll
        for (int i = j + 1; i < B2; ++i) v[i] = v[i] - c[LOW(i, j)] * v[j];
    }
}

// L' x = v in place, by columns of L' from the last: x_k = v_k / L_kk, then
// v_i -= L_ki x_k above it (each row subtracts in decreasing k).
__device__ __forceinline__ void upper_solve(const real* c, real* v) {
#pragma unroll
    for (int k = B2 - 1; k >= 0; --k) {
        v[k] = v[k] / c[LOW(k, k)];
#pragma unroll
        for (int i = 0; i < k; ++i) v[i] = v[i] - c[LOW(k, i)] * v[k];
    }
}

// A solve with the staged factor C of the group's 2N-vector, lane i < 2N
// holding v_i: LOWER C y = v, then UPPER C' x = y.  Returns this lane's
// element of the result.  The lanes leave v in the slot and each solves the
// whole system in registers: the two problems of a warp issue one
// instruction stream, and nothing is exchanged inside the solve (column
// sweeps across the group, a shuffle per pivot on the chain, were slower:
// PERF.md).
//
// Above 2N = 20 (N > 10) the factor (T values) does not fit beside the rest
// in a lane's registers: the solve then runs by columns ACROSS the group,
// lane i owning element i, the factor read from the stage at the point of
// use, a shuffle a column (lane j divides and passes its element, the lanes
// below, or above for C', take its term off), in the same order of
// operations as lower_solve and upper_solve.
constexpr bool LANE_SOLVE = B2 > 20;

template <bool LOWER, bool UPPER>
__device__ __forceinline__ real group_solve(const Tile& ch, real v,
                                            const Args& a) {
    if constexpr (LANE_SOLVE) {
        const int i = a.lane;
        const real cii = ch[LOW(i < B2 ? i : 0, i < B2 ? i : 0)];
        if (LOWER) {
#pragma unroll
            for (int j = 0; j < B2; ++j) {
                const real yj = lane_shfl(v / cii, j, a.g, G);
                if (i == j) v = yj;
                else if (i > j && i < B2) v = v - ch[LOW(i, j)] * yj;
            }
        }
        if (UPPER) {
#pragma unroll
            for (int k = B2 - 1; k >= 0; --k) {
                const real xk = lane_shfl(v / cii, k, a.g, G);
                if (i == k) v = xk;
                else if (i < k) v = v - ch[LOW(k, i)] * xk;
            }
        }
        return v;
    } else {
        real* r = a.slot + SL_R;
        if (a.lane < B2) r[a.lane] = v;
        lane_group_sync(a.g, G);
        // The factor in registers first: every load in flight at once, and
        // the substitutions' chain is then divisions and multiply-adds only.
        real L[T], y[B2];
#pragma unroll
        for (int k = 0; k < T; ++k) L[k] = ch[k];
#pragma unroll
        for (int k = 0; k < B2; ++k) y[k] = r[k];
        if (LOWER) lower_solve(L, y);
        if (UPPER) upper_solve(L, y);
        real out = y[0];
#pragma unroll
        for (int k = 1; k < B2; ++k)
            if (a.lane == k) out = y[k];
        return out;
    }
}

template <bool GAIN>
__device__ __forceinline__ void forward_pass(const Args& a) {
    const int i = a.lane;
    const int j = i < N ? i : i - N;  // joint of this lane's variable
    // Carried from waypoint t-1: lane j < N: c1_{t-1}[j], (rho z - y) of
    // dyn row j, and Ml's (j,j), (j,N+j); lane N+j: a0_{t-1}[j], (rho z - y)
    // of acc row j, and Ml's (N+j,N+j).
    real cc = real(0), vc = real(0), m0 = real(0), m1 = real(0);
    __syncthreads();  // the previous pass's state and slot writes
    if (a.stager)
        for (int t = 0; t < NSTAGE - 1; ++t) {
            if (t < a.W) stage_issue<false, GAIN>(a, t);
            else cp_async_commit();
        }
    for (int t = 0; t < a.W; ++t) {
        const real* sg = stage_wait<false, GAIN>(a, t);
        if (a.stager) {
            if (t + NSTAGE - 1 < a.W)
                stage_issue<false, GAIN>(a, t + NSTAGE - 1);
            else
                cp_async_commit();
        }
        if (a.idle) continue;
        const Tile cf{sg + O_CF * QS}, rh{sg + O_RH * QS},
            pl{sg + O_PL * QS}, ch{sg + O_CH * QS};
        const Tile st{sg + O_ST * QS};
        // v_r = rho_r z_r - y_r of row r.
        auto vr = [&](int r) { return rh[r] * st[S_Z + r] - st[S_Y + r]; };
        const real* hp = a.slot + SL_X + ((t + 1) & 1) * G;  // h_{t-1}
        real v = real(0);
        real cc_n = real(0), vc_n = real(0);
        if (i < N) {  // q row j of the A' gather
            const real vd = vr(R_DYN + j);
            real g = cf[C_C2 + j] * vd;
            g = g + cc * vc;
            g = g + cf[C_POS + j] * vr(R_POS + j);
#pragma unroll
            for (int k = 0; k < NX; ++k)
                g = g + cf[C_X + k * N + j] * vr(R_X + k);
            v = a.sigma * st[S_X + j] - sg[(O_QW + j) * QS] + g;
            cc_n = cf[C_C1 + j];
            vc_n = vd;
        } else if (i < B2) {  // v row j
            const real va = vr(R_ACC + j);
            real g = cf[C_C0 + j] * vr(R_DYN + j);
            g = g + cf[C_VEL + j] * vr(R_VEL + j);
            g = g + cf[C_A1 + j] * va;
            g = g + cc * vc;
            v = a.sigma * st[S_X + N + j] - sg[(O_QW + N + j) * QS] + g;
            cc_n = cf[C_A0 + j];
            vc_n = va;
        }
        if (GAIN) {
            // rhs_t - G_{t-1} w_{t-1}, G upper-triangular.
            if (t > 0 && i < B2) {
                const Tile gn{sg + o_gain(false) * QS};
                real acc = real(0);
#pragma unroll
                for (int c = 0; c < B2; ++c)
                    if (c >= i) acc = acc + gn[UP(i, c)] * hp[c];
                v = v - acc;
            }
            v = group_solve<true, false>(ch, v, a);  // w_t
        } else {
            // rhs_t - Ml_{t-1} h_{t-1}   (all-zero carry at t = 0).
            if (t > 0) {
                if (i < N)
                    v = v - (m0 * hp[j] + m1 * hp[N + j]);
                else if (i < B2)
                    v = v - m0 * hp[N + j];
            }
            v = group_solve<true, true>(ch, v, a);  // h_t
        }
        if (i < B2) {
            if (a.valid) a.w[((size_t)t * B2 + i) * a.B + a.b] = v;
            a.slot[SL_X + (t & 1) * G + i] = v;
        }
        cc = cc_n;
        vc = vc_n;
        if (!GAIN) {  // Ml_t: (j,j) = qq, (j,N+j) = qv, (N+j,N+j) = vv
            if (i < N) {
                const real rd = rh[R_DYN + j];
                m0 = rd * cf[C_C1 + j] * cf[C_C2 + j];
                m1 = rd * cf[C_C1 + j] * cf[C_C0 + j];
            } else if (i < B2) {
                m0 = rh[R_ACC + j] * cf[C_A0 + j] * cf[C_A1 + j] + pl[j];
            }
        }
    }
}

template <int MODE, bool GAIN>
__device__ __forceinline__ void backward_pass(const Args& a) {
    constexpr bool TERM = MODE == MODE_TERM;
    constexpr bool DXDY = MODE == MODE_DXDY;
    const int i = a.lane;
    const int j = i < N ? i : i - N;
    const real alpha = a.alpha;
    real* sl = a.slot;

    // TERM carries of this lane's variable (unused otherwise): the partials
    // of waypoint t+1 and its q and Dinv rows.
    real px_p = real(0), pdx_p = real(0), cw[NCW];
    real q_n = real(0), dinv_n = real(0);
    Maxima m = maxima_start();

    __syncthreads();  // the forward pass is done with the slot
    // No waypoint W: x~, x_sel and dx of "t+1" are zero at t = W-1.
    if (!a.idle) {
        sl[SL_X + (a.W & 1) * G + i] = real(0);
        sl[SL_XS + (a.W & 1) * G + i] = real(0);
        sl[SL_DX + (a.W & 1) * G + i] = real(0);
    }
    if (a.stager)
        for (int t = a.W - 1; t > a.W - NSTAGE; --t) {
            if (t >= 0) stage_issue<true, GAIN, TERM>(a, t);
            else cp_async_commit();
        }
    for (int t = a.W - 1; t >= 0; --t) {
        const real* sg = stage_wait<TERM, GAIN>(a, t);
        if (a.stager) {
            if (t - NSTAGE + 1 >= 0)
                stage_issue<true, GAIN, TERM>(a, t - NSTAGE + 1);
            else
                cp_async_commit();
        }
        if (a.idle) continue;
        const Tile cf{sg + O_CF * QS}, rh{sg + O_RH * QS},
            pl{sg + O_PL * QS}, ch{sg + O_CH * QS};
        const Tile stg{sg + O_ST * QS};
        const int cur = t & 1, nxt = (t + 1) & 1;
        const real* xn = sl + SL_X + nxt * G;  // x~_{t+1}
        real* st = a.state + ((size_t)t * SRp) * a.B + a.b;  // written here
        real* dd = DXDY ? a.dxdy + ((size_t)t * DRp) * a.B + a.b : nullptr;

        const real h = i < B2 ? sg[(O_QW + i) * QS] : real(0);
        real xt;
        if (GAIN) {
            // x~_t = C^{-T} (w_t - G_t' x~_{t+1});  (G'x)_i = sum_{c<=i} G[c][i] x_c.
            real v = real(0);
            if (i < B2) {
                const Tile gn{sg + o_gain(TERM) * QS};
                real gx = real(0);
#pragma unroll
                for (int c = 0; c < B2; ++c)
                    if (c <= i) gx = gx + gn[UP(c, i)] * xn[c];
                v = (t < a.W - 1) ? h - gx : h;
            }
            xt = group_solve<false, true>(ch, v, a);
        } else {
            // x~_t = h_t - C^{-T} C^{-1} (Ml_t' x~_{t+1}).
            real u = real(0);
            if (i < N) {
                const real rd = rh[R_DYN + j];
                u = rd * cf[C_C1 + j] * cf[C_C2 + j] * xn[j];
            } else if (i < B2) {
                const real rd = rh[R_DYN + j];
                const real qv = rd * cf[C_C1 + j] * cf[C_C0 + j];
                const real vv =
                    rh[R_ACC + j] * cf[C_A0 + j] * cf[C_A1 + j] + pl[j];
                u = qv * xn[j] + vv * xn[N + j];
            }
            u = group_solve<true, true>(ch, u, a);
            xt = (t < a.W - 1) ? h - u : h;
        }

        real x_sel = real(0), dx = real(0);
        if (i < B2) {
            const real x_old = stg[S_X + i];
            const real x_new = alpha * xt + (real(1) - alpha) * x_old;
            x_sel = a.frozen ? x_old : x_new;
            dx = a.frozen ? real(0) : x_new - x_old;
            if (a.valid) {
                st[(size_t)(S_X + i) * a.B] = x_sel;
                if (DXDY) dd[(size_t)i * a.B] = dx;
            }
            sl[SL_X + cur * G + i] = xt;
            if (TERM) {
                sl[SL_XS + cur * G + i] = x_sel;
                sl[SL_DX + cur * G + i] = dx;
            }
        }
        lane_group_sync(a.g, G);

        const real* xc = sl + SL_X + cur * G;
        // Rows i, i + G, ... (unrolled: the rows of a lane overlap).
#pragma unroll
        for (int rr = 0; rr < (Rp + G - 1) / G; ++rr) {
            const int r = i + rr * G;
            if (r >= Rp) break;
            // Pad rows (r >= R): zero coefficients, (-INF, INF) bounds.
            const real ztr = a_row(r, cf, xc, xn);
            const real rho_r = rh[r];
            const real z_old = stg[S_Z + r];
            const real y_old = stg[S_Y + r];
            const real lo = sg[(O_LU + r) * QS];
            const real hi = sg[(O_LU + Rp + r) * QS];
            const real z_tmp = alpha * ztr + (real(1) - alpha) * z_old;
            const real z_new = rmin(rmax(z_tmp + y_old / rho_r, lo), hi);
            const real y_new = y_old + rho_r * (z_tmp - z_new);
            const real z_s = a.frozen ? z_old : z_new;
            const real y_s = a.frozen ? y_old : y_new;
            const real dy_r = a.frozen ? real(0) : y_new - y_old;
            if (a.valid) {
                st[(size_t)(S_Z + r) * a.B] = z_s;
                st[(size_t)(S_Y + r) * a.B] = y_s;
                if (DXDY) dd[(size_t)(B2 + r) * a.B] = dy_r;
            }
            if (TERM) {
                sl[SL_Y + cur * Rp + r] = y_s;
                sl[SL_DY + cur * Rp + r] = dy_r;
                // A x_sel and A dx by the same A-row apply as the residual
                // kernel, and the same expressions after it.
                const real ax_sel = a_row(r, cf, sl + SL_XS + cur * G,
                                          sl + SL_XS + nxt * G);
                const real adx = a_row(r, cf, sl + SL_DX + cur * G,
                                       sl + SL_DX + nxt * G);
                reduce_row(ax_sel, adx, z_s, dy_r, sg[(O_EE + r) * QS],
                           sg[(O_EE + Rp + r) * QS], lo, hi, m,
                           sl + SL_SUP + 2 * r);
            }
        }
        if (a.valid) {
            for (int r = SR + i; r < SRp; r += G) st[(size_t)r * a.B] = real(0);
            if (DXDY)
                for (int r = DR + i; r < DRp; r += G)
                    dd[(size_t)r * a.B] = real(0);
        }

        if (TERM) {
            lane_group_sync(a.g, G);  // y_sel, dy of every row
            const real* ys = sl + SL_Y + cur * Rp;
            const real* dys = sl + SL_DY + cur * Rp;
            const real* xs = sl + SL_XS + cur * G;
            const real* dxs = sl + SL_DX + cur * G;
            // The sums of waypoint t, each on one lane, parked in the
            // consumed h scratch of waypoint t.
            if (i < 4) {
                const real s = waypoint_sum(i, sl + SL_SUP, ys,
                                            Tile{sg + O_VC * QS}, xs, dxs);
                if (a.valid) a.w[((size_t)t * B2 + i) * a.B + a.b] = s;
            }
            if (i < B2) {
                // Variable space, waypoint t+1: its own-row gathers (its
                // rows and coefficients kept from step t+1) and this
                // waypoint's cross terms (c1/a0 rows, P-lower), formed in
                // one expression each, as the residual kernel forms them.
                if (t < a.W - 1) {
                    const real* ysn = sl + SL_Y + nxt * Rp;
                    const real* dysn = sl + SL_DY + nxt * Rp;
                    const bool q = i < N;
                    const real c = q ? cf[C_C1 + j] : cf[C_A0 + j];
                    const int r = q ? R_DYN + j : R_ACC + j;
                    const real aty = at_gather(i, cw, ysn, c, ys[r]);
                    const real atdy = at_gather(i, cw, dysn, c, dys[r]);
                    real px = real(0), pdx = real(0);
                    if (!q) {
                        px = fma_rn(pl[j], x_sel, px_p);
                        pdx = fma_rn(pl[j], dx, pdx_p);
                    }
                    reduce_var(q_n, dinv_n, aty, atdy, px, pdx, m);
                }
                // Own values of waypoint t.
                q_n = sg[(O_VC + i) * QS];
                dinv_n = sg[(O_VC + 2 * B2 + i) * QS];
                m.ndx = rmax(m.ndx, rabs(sg[(O_VC + B2 + i) * QS] * dx));
                // Partials of waypoint t: its own-row coefficients, P terms.
                own_coefs(i, cf, cw);
                if (i >= N) {
                    const real pdj = sg[(O_PD + j) * QS];
                    px_p = fma_rn(pdj, x_sel,
                                  mul_rn(pl[j], sl[SL_XS + nxt * G + i]));
                    pdx_p = fma_rn(pdj, dx,
                                   mul_rn(pl[j], sl[SL_DX + nxt * G + i]));
                }
            }
        }
    }
    if (a.idle) return;

    if (TERM) {
        // Epilogue: waypoint 0 has no t-1 cross terms.
        if (i < B2)
            reduce_var(q_n, dinv_n,
                       at_gather(i, cw, sl + SL_Y, real(0), real(0)),
                       at_gather(i, cw, sl + SL_DY, real(0), real(0)), px_p,
                       pdx_p, m);
        term_finish<G>(i, a.g, a.valid, a.W, m, a.w + (size_t)i * a.B + a.b,
                       (size_t)B2 * a.B, sl + SL_ACC, a.acc + a.b, a.B);
    }
}

template <int MODE, bool GAIN>
__global__ void __launch_bounds__(block_threads(QLOG_MAX), 1)
    admm_chunk_kernel(
    const real* __restrict__ chol, const real* __restrict__ gain,
    const real* __restrict__ coef,
    const real* __restrict__ q, const real* __restrict__ lu,
    const real* __restrict__ rho, const real* __restrict__ plf,
    const real* __restrict__ ee, const real* __restrict__ varc,
    const real* __restrict__ pd, const real* __restrict__ done, real* state,
    real* w, real* acc, real* dxdy, int W, int B, int n_iter, real sigma,
    real alpha, int qlog, int x4) {
    LANE_SMEM_DECL();
    const int consumers = G << qlog, tid = threadIdx.x;
    const int pbase = producer_base(qlog);
    const bool idle = tid >= consumers;
    const int g = threadIdx.x / G;
    const int b0 = blockIdx.x << qlog;
    const int b = b0 + g;
    const bool valid = !idle && b < B;
    real* ring = lane_smem;
    real* slot = ring + NSTAGE * stage_rows(MODE == MODE_TERM, GAIN) * QS +
                 g * SLOT;
    const Args a{chol,  gain,  coef,  q,     lu,     rho,
                 plf,   ee,    varc,  pd,    state,  w,
                 acc,   dxdy,  W,     B,     sigma,  alpha,
                 b0,    qlog,  g,     (int)(threadIdx.x % G), b,
                 x4 != 0, tid >= pbase, idle, tid - pbase, valid, valid && done[b] != real(0), ring, slot};
    for (int it = 0; it < n_iter; ++it) {
        forward_pass<GAIN>(a);
        if (MODE != MODE_PLAIN && it == n_iter - 1)
            backward_pass<MODE, GAIN>(a);
        else
            backward_pass<MODE_PLAIN, GAIN>(a);
    }
}

static int chunk_qlog(int B, int sms) { return group_qlog(B, sms, QLOG_MAX); }

// plan[0..8] = threads per problem G, problems per block Q, stages, shared
// bytes, blocks, threads per block, slot values per problem, tile row
// stride, bytes per staging copy (for 16-byte aligned packs).
extern "C" void admm_chunk_plan(int B, int sms, int mode, int gain,
                                long long* plan) {
    const int qlog = chunk_qlog(B, sms), Q = 1 << qlog;
    const long long p[9] = {G, Q, NSTAGE,
                            chunk_smem_bytes(qlog, mode == MODE_TERM,
                                             gain != 0),
                            (B + Q - 1) / Q, block_threads(qlog), SLOT, QS,
                            group_tile_x4(qlog, B) ? 16 : 4};
    for (int k = 0; k < 9; ++k) plan[k] = p[k];
}

template <int MODE, bool GAIN>
static int launch_mode(const void* chol, const void* gain, const void* coef,
                       const void* q, const void* lu, const void* rho,
                       const void* plf, const void* ee, const void* varc,
                       const void* pd, const void* done, void* state, void* w,
                       void* acc, void* dxdy, int W, int B, int n_iter,
                       double sigma, double alpha, void* stream) {
    int dev_smem = 0, sms = 0;
    const int err = lane_device_limits(&dev_smem, &sms);
    if (err != 0) return err;
    const int qlog = chunk_qlog(B, sms), Q = 1 << qlog;
    // 16-byte copies need every staged pack 16-byte aligned.
    uintptr_t bits = 0;
    for (const void* p : {chol, gain, coef, q, lu, rho, plf, ee, varc, pd,
                          (const void*)state, (const void*)w})
        bits |= (uintptr_t)p;
    const int x4 = group_tile_x4(qlog, B) && bits % 16 == 0;
    return lane_launch_coop(
        &admm_chunk_kernel<MODE, GAIN>, (B + Q - 1) / Q, block_threads(qlog), G,
        chunk_smem_bytes(qlog, MODE == MODE_TERM, GAIN), stream,
        (const real*)chol, (const real*)gain, (const real*)coef,
        (const real*)q, (const real*)lu, (const real*)rho, (const real*)plf,
        (const real*)ee, (const real*)varc, (const real*)pd,
        (const real*)done, (real*)state, (real*)w, (real*)acc, (real*)dxdy,
        W, B, n_iter, (real)sigma, (real)alpha, qlog, x4);
}

// mode: 0 = state only, 1 = also the accumulators (acc), 2 = also the deltas
// of the last iteration (dxdy).  gain: null for the hrec form, else the
// packed gain (W, Tp, B).
extern "C" int admm_chunk_launch(const void* chol, const void* gain,
                                 const void* coef, const void* q,
                                 const void* lu, const void* rho,
                                 const void* plf, const void* ee,
                                 const void* varc, const void* pd,
                                 const void* done, void* state, void* w,
                                 void* acc, void* dxdy, int W, int B,
                                 int n_iter, int mode, double sigma,
                                 double alpha, void* stream) {
#define LANE_CHUNK_ARGS                                                       \
    chol, gain, coef, q, lu, rho, plf, ee, varc, pd, done, state, w, acc,    \
        dxdy, W, B, n_iter, sigma, alpha, stream
    if (gain == nullptr) {
        if (mode == MODE_PLAIN) return launch_mode<MODE_PLAIN, false>(LANE_CHUNK_ARGS);
        if (mode == MODE_TERM) return launch_mode<MODE_TERM, false>(LANE_CHUNK_ARGS);
        if (mode == MODE_DXDY) return launch_mode<MODE_DXDY, false>(LANE_CHUNK_ARGS);
    } else {
        if (mode == MODE_PLAIN) return launch_mode<MODE_PLAIN, true>(LANE_CHUNK_ARGS);
        if (mode == MODE_TERM) return launch_mode<MODE_TERM, true>(LANE_CHUNK_ARGS);
        if (mode == MODE_DXDY) return launch_mode<MODE_DXDY, true>(LANE_CHUNK_ARGS);
    }
#undef LANE_CHUNK_ARGS
    return -1;
}
