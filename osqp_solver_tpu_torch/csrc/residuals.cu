// Streaming termination quantities, a group of threads per problem: every
// per-problem reduction of the OSQP termination check and of the
// infeasibility certificates in ONE walk over the horizon, from the packed
// state and the packed deltas of the last iteration.
//
// Replaces the Pallas kernel of osqp_solver_tpu/ops/residuals_pallas.py
// (termination_quantities_kernel, body _make_kernel): vel-diag P, or with
// -DBLOCK_P=1 generic dense 2N x 2N blocks of P (the reference's block
// branch, residuals_pallas.py:296-310).
//
// All six matvecs are waypoint-local stencils.  At waypoint u:
//   A x, A dx     rows of u from the variables of u and u+1;
//   A'y, A'dy     own rows of u plus the c1 / a0 cross terms of rows u-1;
//   P x, P dx     Pd_u v_u + Pl_{u-1} v_{u-1} + Pl_u v_{u+1} (velocity half);
//                 BLOCK_P: Pd_u x_u + Pl_{u-1} x_{u-1} + Pl_u' x_{u+1} on all
//                 2N rows, Pd_u from its packed lower triangle.
// The certificate matvecs use the scaled-operator identities
//   A_base dx_u = Einv (A_s dx),  A'_base dy_u = cinv Dinv (A'_s dy),
//   P_base dx_u = cinv Dinv (P_s dx)
// so only the scaled problem streams; the cinv factors are applied by the
// caller (ops/residuals.py assemble_term_quantities).
//
// Design (Hopper): the MODE_TERM tail of csrc/admm_chunk.cu without the ADMM
// update, through the same functions (lane_common.cuh: reduce_row,
// at_gather, reduce_var, waypoint_sum, term_finish), so the fused and the
// unfused termination decide from the same float values.  One thread per
// problem left B = 1024 at 32 single-warp blocks (100 of 132 SMs idle), each
// thread walking W steps of every row and variable.  Here:
//   - a group of G threads (the smallest power of two >= 2N: 16 at N = 6)
//     works on one problem; a block holds Q adjacent problems (4 while the
//     blocks still cover 7/8 of the SMs, fewer for small batches);
//   - a producer warp stages waypoint t-2's rows while the groups work on
//     waypoint t (the walk goes backward) into a ring of NSTAGE = 3
//     [row][QS] tiles, 16-byte copies of four problems where the packs allow,
//     one __syncthreads a step (368 rows a stage, 578 with BLOCK_P: 5.9 and
//     9.2 KB at QS = 4);
//   - lane i owns variable i and rows i, i + G, ...: x, dx of waypoint t and
//     its y, dy rows go to the group's slot (double-buffered by parity),
//     from which waypoint t's A rows read x, dx of t and t+1 and, at step
//     t-1, its own-row A' gather reads the rows; waypoint t+1's variables
//     are finished at step t with the cross terms of the rows of t and the
//     P partials carried in registers;
//   - per waypoint, lanes 0-3 each add one of the four sums over the rows
//     (variables) in increasing order, in one loop in step (the rows' support
//     terms formed by their lanes), and park it in a (W, 4, B) scratch in
//     device memory; after the walk they add them in increasing waypoint
//     order and the group reduces its maxima by xor shuffles.
// BLOCK_P: lane i forms row i of Pd_u x_u and of Pl_u' x_{u+1} (j ascending,
// from zero) at step u and carries them; at step u-1, row i of
// Pl_{u-1} x_{u-1} completes P x of waypoint u as (Pd x + Pl x) + Pl' x.
// Above N = 16 (WIDE: 2N > 32) the group spans several warps and a block
// holds one problem, as the chunk kernel's wide form: one value a tile row,
// the copies in a loop, the maxima through the group's exchange in shared
// memory, and the ring in a device-memory workspace where it does not fit
// on chip (DEV).  Above N = 256 the group stays at 512 threads and each
// owns the variables lane, lane + 512, ... (COLS of them), as the chunk's
// (residuals_kernel_cols; with one variable a thread, residuals_kernel).
// Bound: every pack read once and 24 values a problem written (bytes); in
// practice each problem's chain of W steps.  PERF.md records the times.
#include <cstdint>
#include <initializer_list>

#include "lane_common.cuh"

#ifndef BLOCK_P
#define BLOCK_P 0
#endif

// Threads per problem (at most LANE_GROUP_MAX), the variables a thread owns
// (i = lane, lane + G, ...: one up to 2N = 512) and the length of a vector
// in the slot, problems per block at most (log2), stages of the ring,
// producer threads, and the tile's row stride (one column a problem).
// WIDE: a group of several warps, one problem a block.
constexpr int G = group_size(B2, 4);
constexpr int COLS = group_cols(B2, G);
constexpr int GC = G * COLS;
constexpr bool WIDE = B2 > 32;
static_assert(COLS == 1 || WIDE, "several variables a thread: wide only");
constexpr int QLOG_MAX = WIDE ? 0 : 2;
constexpr int NSTAGE = 3;
constexpr int PRODUCERS = group_producers(G);
constexpr int QS = 1 << QLOG_MAX;
static_assert(WIDE || QS % 4 == 0, "");

// One stage of the ring: rows of QS values.
#if BLOCK_P
constexpr int PD_ROWS = T, PL_ROWS = B2 * B2;  // packed Pd_u, full Pl_u
#else
constexpr int PD_ROWS = N, PL_ROWS = N;  // velocity diagonals
#endif
constexpr int O_CF = 0;               // stencil coefficients, CR rows
constexpr int O_PD = O_CF + CR;       // P-diag: PD_ROWS rows
constexpr int O_PL = O_PD + PD_ROWS;  // P-lower: PL_ROWS rows
constexpr int O_ST = O_PL + PL_ROWS;  // state tile x, z, y: SR rows
constexpr int O_DD = O_ST + SR;       // delta tile dx, dy: DR rows
constexpr int O_RC = O_DD + DR;       // E, Einv, l, u: 4 Rp rows
constexpr int O_VC = O_RC + 4 * Rp;   // q, D, Dinv: 3 * 2N rows
constexpr int STAGE_ROWS = O_VC + 3 * B2;

// The slot of a group: x and dx (GC values), y and dy rows (Rp values), two
// of each (waypoint parity), the support terms of a waypoint's rows, and the
// accumulators.
constexpr int SL_XS = 0;
constexpr int SL_DX = SL_XS + 2 * GC;
constexpr int SL_Y = SL_DX + 2 * GC;
constexpr int SL_DY = SL_Y + 2 * Rp;
constexpr int SL_SUP = SL_DY + 2 * Rp;  // support terms, 2 a row
constexpr int SL_ACC = SL_SUP + 2 * Rp;
constexpr int SL_XCH = SL_ACC + NACC;  // WIDE: the group's exchange
constexpr int SLOT = SL_XCH + (WIDE ? G : 0);

// Sums parked per waypoint: support, sum y, q'dx, sum x.
constexpr int NSUM = 4;

__host__ __device__ constexpr int producer_base(int qlog) {
    return group_producer_base(G << qlog);
}
__host__ __device__ constexpr int block_threads(int qlog) {
    return producer_base(qlog) + PRODUCERS;
}
// DEV: the ring in device memory, the slots alone in shared memory.
constexpr int RING = NSTAGE * STAGE_ROWS * QS;
__host__ __device__ constexpr int resid_smem_bytes(int qlog,
                                                   bool dev = false) {
    return ((dev ? 0 : RING) + (1 << qlog) * SLOT) * (int)sizeof(real);
}

using Tile = TileCol<QS>;

struct Packs {
    const real *coef, *pd, *pl, *state, *dxdy, *rowc, *varc;
};

// Start this producer's copies of waypoint t's rows into stage t % NSTAGE
// and commit them as one group.
template <bool DEV = false>
__device__ __forceinline__ void stage_issue(const Packs& k, const Stager& s,
                                            real* ring, int t) {
    real* sg = ring + (t % NSTAGE) * STAGE_ROWS * QS;
    stage_pack_rows<QS, PRODUCERS, CRp, CR, O_CF, WIDE, DEV>(s, k.coef, t,
                                                            sg);
#if BLOCK_P
    stage_pack_rows<QS, PRODUCERS, Tp, T, O_PD, WIDE, DEV>(s, k.pd, t, sg);
    stage_pack_rows<QS, PRODUCERS, B2 * B2, B2 * B2, O_PL, WIDE, DEV>(
        s, k.pl, t, sg);
#else
    stage_pack_rows<QS, PRODUCERS, PNp, N, O_PD, WIDE, DEV>(s, k.pd, t, sg);
    stage_pack_rows<QS, PRODUCERS, PNp, N, O_PL, WIDE, DEV>(s, k.pl, t, sg);
#endif
    stage_pack_rows<QS, PRODUCERS, SRp, SR, O_ST, WIDE, DEV>(s, k.state, t,
                                                            sg);
    stage_pack_rows<QS, PRODUCERS, DRp, DR, O_DD, WIDE, DEV>(s, k.dxdy, t,
                                                            sg);
    stage_pack_rows<QS, PRODUCERS, 4 * Rp, 4 * Rp, O_RC, WIDE, DEV>(
        s, k.rowc, t, sg);
    stage_pack_rows<QS, PRODUCERS, VCp, 3 * B2, O_VC, WIDE, DEV>(
        s, k.varc, t, sg);
    cp_async_commit();
}

// DEV (WIDE only): the ring in the workspace work, each block its part.
template <bool DEV = false>
__global__ void __launch_bounds__(block_threads(QLOG_MAX), 1)
    residuals_kernel(const real* __restrict__ coef,
                     const real* __restrict__ pd, const real* __restrict__ pl,
                     const real* __restrict__ state,
                     const real* __restrict__ dxdy,
                     const real* __restrict__ rowc,
                     const real* __restrict__ varc, real* sums, real* acc_out,
                     int W, int B, int qlog, int x4, real* work) {
    LANE_SMEM_DECL();
    const int tid = threadIdx.x, pbase = producer_base(qlog);
    const bool idle = tid >= (G << qlog), stager = tid >= pbase;
    const int g = tid / G, i = tid % G;
    const int j = i < N ? i : i - N;  // joint of this lane's variable
    const int b0 = blockIdx.x << qlog, b = b0 + g;
    const bool valid = !idle && b < B;
    const Packs packs{coef, pd, pl, state, dxdy, rowc, varc};
    const Stager s = make_stager(B, b0, qlog, tid - pbase, x4);
    real* ring = DEV ? work + (size_t)blockIdx.x * RING : lane_smem;
    real* sl = (DEV ? lane_smem : ring + RING) + g * SLOT;

    // Carried from waypoint t+1: its maxima inputs q, Dinv, own-row A'
    // coefficients, and its P partials (vel-diag: Pd v + Pl v_{+1} of a v
    // row; BLOCK_P: rows of Pd x and Pl' x_{+1}, for x and dx).
    Maxima m = maxima_start();
    real cw[NCW], q_n = real(0), dinv_n = real(0);
#pragma unroll
    for (int c = 0; c < NCW; ++c) cw[c] = real(0);
#if BLOCK_P
    real dg_x = real(0), dg_dx = real(0), up_x = real(0), up_dx = real(0);
#else
    real px_p = real(0), pdx_p = real(0);
#endif

    // No waypoint W: x and dx of "t+1" are zero at t = W-1.
    if (!idle) {
        sl[SL_XS + (W & 1) * G + i] = real(0);
        sl[SL_DX + (W & 1) * G + i] = real(0);
    }
    if (stager)
        for (int t = W - 1; t > W - NSTAGE; --t) {
            if (t >= 0) stage_issue<DEV>(packs, s, ring, t);
            else cp_async_commit();
        }
    for (int t = W - 1; t >= 0; --t) {
        // Waypoint t has landed (every step commits one group, empty past
        // the horizon), the whole block's with the barrier, and nobody reads
        // the stage the next issue overwrites any more.
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();
        const real* sg = ring + (t % NSTAGE) * STAGE_ROWS * QS + g;
        if (stager) {
            if (t - NSTAGE + 1 >= 0)
                stage_issue<DEV>(packs, s, ring, t - NSTAGE + 1);
            else cp_async_commit();
        }
        if (idle) continue;
        const Tile cf{sg + O_CF * QS}, pdr{sg + O_PD * QS},
            plr{sg + O_PL * QS}, st{sg + O_ST * QS}, dd{sg + O_DD * QS},
            rc{sg + O_RC * QS}, vc{sg + O_VC * QS};
        const int cur = t & 1, nxt = (t + 1) & 1;
        const real* xs = sl + SL_XS + cur * G;
        const real* dxs = sl + SL_DX + cur * G;
        const real* xn = sl + SL_XS + nxt * G;
        const real* dxn = sl + SL_DX + nxt * G;
        const real* ys = sl + SL_Y + cur * Rp;
        const real* dys = sl + SL_DY + cur * Rp;

        real x = real(0), dx = real(0);
        if (i < B2) {
            x = st[S_X + i];
            dx = dd[i];
            sl[SL_XS + cur * G + i] = x;
            sl[SL_DX + cur * G + i] = dx;
        }
        lane_group_sync(g, G);

        // Rows i, i + G, ... (pad rows r >= R: zero coefficients, (-INF,
        // INF) bounds).
#pragma unroll
        for (int rr = 0; rr < (Rp + G - 1) / G; ++rr) {
            const int r = i + rr * G;
            if (r >= Rp) break;
            const real dy_r = dd[B2 + r];
            sl[SL_Y + cur * Rp + r] = st[S_Y + r];
            sl[SL_DY + cur * Rp + r] = dy_r;
            reduce_row(a_row(r, cf, xs, xn), a_row(r, cf, dxs, dxn),
                       st[S_Z + r], dy_r, rc[r], rc[Rp + r], rc[2 * Rp + r],
                       rc[3 * Rp + r], m, sl + SL_SUP + 2 * r);
        }
        lane_group_sync(g, G);  // y, dy of every row

        if (i < 4) {
            const real sum = waypoint_sum(i, sl + SL_SUP, ys, vc, xs, dxs);
            if (valid) sums[((size_t)t * NSUM + i) * B + b] = sum;
        }
        if (i < B2) {
            // Variable i of waypoint t+1: its own-row gathers (its rows and
            // coefficients kept from step t+1), the cross terms of the rows
            // of t, and P.
            if (t < W - 1) {
                const bool q = i < N;
                const real c = q ? cf[C_C1 + j] : cf[C_A0 + j];
                const int r = q ? R_DYN + j : R_ACC + j;
                const real aty =
                    at_gather(i, cw, sl + SL_Y + nxt * Rp, c, ys[r]);
                const real atdy =
                    at_gather(i, cw, sl + SL_DY + nxt * Rp, c, dys[r]);
#if BLOCK_P
                real sx = real(0), sdx = real(0);  // row i of Pl_t x_t, dx_t
#pragma unroll
                for (int k = 0; k < B2; ++k) {
                    const real p = plr[i * B2 + k];
                    sx = fma_rn(p, xs[k], sx);
                    sdx = fma_rn(p, dxs[k], sdx);
                }
                const real px = (dg_x + sx) + up_x;
                const real pdx = (dg_dx + sdx) + up_dx;
#else
                real px = real(0), pdx = real(0);
                if (!q) {
                    px = fma_rn(plr[j], x, px_p);
                    pdx = fma_rn(plr[j], dx, pdx_p);
                }
#endif
                reduce_var(q_n, dinv_n, aty, atdy, px, pdx, m);
            }
            // Own values and partials of waypoint t.
            q_n = vc[i];
            dinv_n = vc[2 * B2 + i];
            m.ndx = rmax(m.ndx, rabs(vc[B2 + i] * dx));
            own_coefs(i, cf, cw);
#if BLOCK_P
            dg_x = dg_dx = up_x = up_dx = real(0);
#pragma unroll
            for (int k = 0; k < B2; ++k) {
                const real p = pdr[k <= i ? LOW(i, k) : LOW(k, i)];
                dg_x = fma_rn(p, xs[k], dg_x);
                dg_dx = fma_rn(p, dxs[k], dg_dx);
            }
#pragma unroll
            for (int k = 0; k < B2; ++k) {  // zero pad block at t = W-1
                const real p = plr[k * B2 + i];
                up_x = fma_rn(p, xn[k], up_x);
                up_dx = fma_rn(p, dxn[k], up_dx);
            }
#else
            if (i >= N) {  // Pl is 0 at t = W-1
                px_p = fma_rn(pdr[j], x, mul_rn(plr[j], xn[i]));
                pdx_p = fma_rn(pdr[j], dx, mul_rn(plr[j], dxn[i]));
            }
#endif
        }
    }
    if (idle) return;

    // Waypoint 0 has no t-1 cross terms.
    if (i < B2) {
#if BLOCK_P
        const real px = (dg_x + real(0)) + up_x;
        const real pdx = (dg_dx + real(0)) + up_dx;
#else
        const real px = px_p, pdx = pdx_p;
#endif
        reduce_var(q_n, dinv_n, at_gather(i, cw, sl + SL_Y, real(0), real(0)),
                   at_gather(i, cw, sl + SL_DY, real(0), real(0)), px, pdx,
                   m);
    }
    term_finish<G, WIDE>(i, g, valid, W, m, sums + (size_t)i * B + b,
                         (size_t)NSUM * B, sl + SL_ACC, acc_out + b, B,
                         sl + SL_XCH);
}

// residuals_kernel with several variables a thread (COLS > 1): each
// per-variable quantity and carry held for every variable this thread owns
// (i = lane + c G), the rows and the reductions as there.
template <bool DEV = false>
__global__ void __launch_bounds__(block_threads(QLOG_MAX), 1)
    residuals_kernel_cols(const real* __restrict__ coef,
                     const real* __restrict__ pd, const real* __restrict__ pl,
                     const real* __restrict__ state,
                     const real* __restrict__ dxdy,
                     const real* __restrict__ rowc,
                     const real* __restrict__ varc, real* sums, real* acc_out,
                     int W, int B, int qlog, int x4, real* work) {
    LANE_SMEM_DECL();
    const int tid = threadIdx.x, pbase = producer_base(qlog);
    const bool idle = tid >= (G << qlog), stager = tid >= pbase;
    const int g = tid / G, lane = tid % G;
    const int b0 = blockIdx.x << qlog, b = b0 + g;
    const bool valid = !idle && b < B;
    const Packs packs{coef, pd, pl, state, dxdy, rowc, varc};
    const Stager s = make_stager(B, b0, qlog, tid - pbase, x4);
    real* ring = DEV ? work + (size_t)blockIdx.x * RING : lane_smem;
    real* sl = (DEV ? lane_smem : ring + RING) + g * SLOT;

    // Carried from waypoint t+1, for each of this thread's variables: its
    // maxima inputs q, Dinv, own-row A' coefficients, and its P partials
    // (vel-diag: Pd v + Pl v_{+1} of a v row; BLOCK_P: rows of Pd x and
    // Pl' x_{+1}, for x and dx).
    Maxima m = maxima_start();
    real cw[COLS][NCW], q_n[COLS], dinv_n[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
#pragma unroll
        for (int k = 0; k < NCW; ++k) cw[c][k] = real(0);
        q_n[c] = dinv_n[c] = real(0);
    }
#if BLOCK_P
    real dg_x[COLS], dg_dx[COLS], up_x[COLS], up_dx[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c)
        dg_x[c] = dg_dx[c] = up_x[c] = up_dx[c] = real(0);
#else
    real px_p[COLS], pdx_p[COLS];
#pragma unroll
    for (int c = 0; c < COLS; ++c) px_p[c] = pdx_p[c] = real(0);
#endif

    // No waypoint W: x and dx of "t+1" are zero at t = W-1.
    if (!idle) {
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
            sl[SL_XS + (W & 1) * GC + lane + c * G] = real(0);
            sl[SL_DX + (W & 1) * GC + lane + c * G] = real(0);
        }
    }
    if (stager)
        for (int t = W - 1; t > W - NSTAGE; --t) {
            if (t >= 0) stage_issue<DEV>(packs, s, ring, t);
            else cp_async_commit();
        }
    for (int t = W - 1; t >= 0; --t) {
        // Waypoint t has landed (every step commits one group, empty past
        // the horizon), the whole block's with the barrier, and nobody reads
        // the stage the next issue overwrites any more.
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();
        const real* sg = ring + (t % NSTAGE) * STAGE_ROWS * QS + g;
        if (stager) {
            if (t - NSTAGE + 1 >= 0)
                stage_issue<DEV>(packs, s, ring, t - NSTAGE + 1);
            else cp_async_commit();
        }
        if (idle) continue;
        const Tile cf{sg + O_CF * QS}, pdr{sg + O_PD * QS},
            plr{sg + O_PL * QS}, st{sg + O_ST * QS}, dd{sg + O_DD * QS},
            rc{sg + O_RC * QS}, vc{sg + O_VC * QS};
        const int cur = t & 1, nxt = (t + 1) & 1;
        const real* xs = sl + SL_XS + cur * GC;
        const real* dxs = sl + SL_DX + cur * GC;
        const real* xn = sl + SL_XS + nxt * GC;
        const real* dxn = sl + SL_DX + nxt * GC;
        const real* ys = sl + SL_Y + cur * Rp;
        const real* dys = sl + SL_DY + cur * Rp;

        real x[COLS], dx[COLS];
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
            const int i = lane + c * G;
            x[c] = real(0);
            dx[c] = real(0);
            if (i < B2) {
                x[c] = st[S_X + i];
                dx[c] = dd[i];
                sl[SL_XS + cur * GC + i] = x[c];
                sl[SL_DX + cur * GC + i] = dx[c];
            }
        }
        lane_group_sync(g, G);

        // Rows lane, lane + G, ... (pad rows r >= R: zero coefficients,
        // (-INF, INF) bounds).
#pragma unroll
        for (int rr = 0; rr < (Rp + G - 1) / G; ++rr) {
            const int r = lane + rr * G;
            if (r >= Rp) break;
            const real dy_r = dd[B2 + r];
            sl[SL_Y + cur * Rp + r] = st[S_Y + r];
            sl[SL_DY + cur * Rp + r] = dy_r;
            reduce_row(a_row(r, cf, xs, xn), a_row(r, cf, dxs, dxn),
                       st[S_Z + r], dy_r, rc[r], rc[Rp + r], rc[2 * Rp + r],
                       rc[3 * Rp + r], m, sl + SL_SUP + 2 * r);
        }
        lane_group_sync(g, G);  // y, dy of every row

        if (lane < 4) {
            const real sum = waypoint_sum(lane, sl + SL_SUP, ys, vc, xs, dxs);
            if (valid) sums[((size_t)t * NSUM + lane) * B + b] = sum;
        }
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
            const int i = lane + c * G;
            const int j = i < N ? i : i - N;  // joint of the variable
            if (i >= B2) continue;
            // Variable i of waypoint t+1: its own-row gathers (its rows and
            // coefficients kept from step t+1), the cross terms of the rows
            // of t, and P.
            if (t < W - 1) {
                const bool q = i < N;
                const real cq = q ? cf[C_C1 + j] : cf[C_A0 + j];
                const int r = q ? R_DYN + j : R_ACC + j;
                const real aty =
                    at_gather(i, cw[c], sl + SL_Y + nxt * Rp, cq, ys[r]);
                const real atdy =
                    at_gather(i, cw[c], sl + SL_DY + nxt * Rp, cq, dys[r]);
#if BLOCK_P
                real sx = real(0), sdx = real(0);  // row i of Pl_t x_t, dx_t
#pragma unroll
                for (int k = 0; k < B2; ++k) {
                    const real p = plr[i * B2 + k];
                    sx = fma_rn(p, xs[k], sx);
                    sdx = fma_rn(p, dxs[k], sdx);
                }
                const real px = (dg_x[c] + sx) + up_x[c];
                const real pdx = (dg_dx[c] + sdx) + up_dx[c];
#else
                real px = real(0), pdx = real(0);
                if (!q) {
                    px = fma_rn(plr[j], x[c], px_p[c]);
                    pdx = fma_rn(plr[j], dx[c], pdx_p[c]);
                }
#endif
                reduce_var(q_n[c], dinv_n[c], aty, atdy, px, pdx, m);
            }
            // Own values and partials of waypoint t.
            q_n[c] = vc[i];
            dinv_n[c] = vc[2 * B2 + i];
            m.ndx = rmax(m.ndx, rabs(vc[B2 + i] * dx[c]));
            own_coefs(i, cf, cw[c]);
#if BLOCK_P
            dg_x[c] = dg_dx[c] = up_x[c] = up_dx[c] = real(0);
#pragma unroll
            for (int k = 0; k < B2; ++k) {
                const real p = pdr[k <= i ? LOW(i, k) : LOW(k, i)];
                dg_x[c] = fma_rn(p, xs[k], dg_x[c]);
                dg_dx[c] = fma_rn(p, dxs[k], dg_dx[c]);
            }
#pragma unroll
            for (int k = 0; k < B2; ++k) {  // zero pad block at t = W-1
                const real p = plr[k * B2 + i];
                up_x[c] = fma_rn(p, xn[k], up_x[c]);
                up_dx[c] = fma_rn(p, dxn[k], up_dx[c]);
            }
#else
            if (i >= N) {  // Pl is 0 at t = W-1
                px_p[c] = fma_rn(pdr[j], x[c], mul_rn(plr[j], xn[i]));
                pdx_p[c] = fma_rn(pdr[j], dx[c], mul_rn(plr[j], dxn[i]));
            }
#endif
        }
    }
    if (idle) return;

    // Waypoint 0 has no t-1 cross terms.
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
        const int i = lane + c * G;
        if (i >= B2) continue;
#if BLOCK_P
        const real px = (dg_x[c] + real(0)) + up_x[c];
        const real pdx = (dg_dx[c] + real(0)) + up_dx[c];
#else
        const real px = px_p[c], pdx = pdx_p[c];
#endif
        reduce_var(q_n[c], dinv_n[c],
                   at_gather(i, cw[c], sl + SL_Y, real(0), real(0)),
                   at_gather(i, cw[c], sl + SL_DY, real(0), real(0)), px, pdx,
                   m);
    }
    term_finish<G, WIDE>(lane, g, valid, W, m, sums + (size_t)lane * B + b,
                         (size_t)NSUM * B, sl + SL_ACC, acc_out + b, B,
                         sl + SL_XCH);
}

struct ResidPlan {
    int qlog, Q, smem, blocks, threads;
    long long work;  // DEV: values of the device-memory workspace
};

// budget <= 0: the shared memory a block may use (the host-emulation tests
// and the card's checks pass a small one to put the ring in device memory).
static int resid_plan_for(int B, int budget, ResidPlan* p) {
    int dev_smem = 0, sms = 0;
    const int err = lane_device_limits(&dev_smem, &sms);
    if (err != 0) return err;
    const int room = budget > 0 && budget < dev_smem ? budget : dev_smem;
    const int qlog = group_qlog(B, sms, QLOG_MAX), Q = 1 << qlog;
    const int blocks = (B + Q - 1) / Q;
    // WIDE: the ring in device memory where it does not fit on chip.
    const bool dev = WIDE && resid_smem_bytes(qlog) > room;
    *p = ResidPlan{qlog, Q, resid_smem_bytes(qlog, dev), blocks,
                   block_threads(qlog), dev ? (long long)RING * blocks : 0};
    return p->smem > dev_smem ? -1 : 0;
}

// plan[0..8] = threads per problem G, problems per block Q, stages, shared
// bytes, blocks, threads per block, tile row stride, bytes per staging copy
// (for 16-byte aligned packs), and the bytes of the device-memory workspace
// (0: the ring on chip): the plan residuals_launch makes on the current
// device.
extern "C" int residuals_plan(int B, long long* plan, int budget) {
    ResidPlan p{};
    const int err = resid_plan_for(B, budget, &p);
    const long long v[9] = {G,        p.Q,       NSTAGE, p.smem,
                            p.blocks, p.threads, QS,
                            group_tile_x4(p.qlog, B) ? 16 : 4,
                            p.work * (long long)sizeof(real)};
    for (int k = 0; k < 9; ++k) plan[k] = v[k];
    return err;
}

// The launch, DEV: the ring in the workspace (a template, so that only the
// wide builds compile that kernel).
template <bool DEV, class... A>
static int launch_resid(const ResidPlan& p, void* stream, A... args) {
    if constexpr (COLS > 1)
        return lane_launch_coop(&residuals_kernel_cols<DEV>, p.blocks,
                                p.threads, G, p.smem, stream, args...);
    else
        return lane_launch_coop(&residuals_kernel<DEV>, p.blocks, p.threads,
                                G, p.smem, stream, args...);
}

// sums: a (W, 4, B) scratch, written and read back by the kernel.  work:
// the plan's workspace for the same budget (residuals_plan), null where it
// needs none (the last arguments, so that a caller of the earlier
// signature still works there).
extern "C" int residuals_launch(const void* coef, const void* pd,
                                const void* pl, const void* state,
                                const void* dxdy, const void* rowc,
                                const void* varc, void* sums, void* acc, int W,
                                int B, void* stream, void* work,
                                int budget) {
    ResidPlan p{};
    const int err = resid_plan_for(B, budget, &p);
    if (err != 0) return err;
    if (p.work > 0 && work == nullptr) return -1;
    // 16-byte copies need every staged pack 16-byte aligned.
    uintptr_t bits = 0;
    for (const void* ptr : {coef, pd, pl, state, dxdy, rowc, varc})
        bits |= (uintptr_t)ptr;
    const int x4 = group_tile_x4(p.qlog, B) && bits % 16 == 0;
#define LANE_RESID_ARGS                                                       \
    (const real*)coef, (const real*)pd, (const real*)pl, (const real*)state,  \
        (const real*)dxdy, (const real*)rowc, (const real*)varc, (real*)sums, \
        (real*)acc, W, B, p.qlog, x4, (real*)work
    if (p.work > 0) return launch_resid<WIDE>(p, stream, LANE_RESID_ARGS);
    return launch_resid<false>(p, stream, LANE_RESID_ARGS);
#undef LANE_RESID_ARGS
}
