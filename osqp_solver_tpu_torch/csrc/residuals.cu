// Streaming termination quantities, one thread per problem: every per-problem
// reduction of the OSQP termination check and of the infeasibility
// certificates in ONE forward walk over the horizon, from the packed state and
// the packed deltas of the last iteration.
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
// What waypoint u needs of u-1 (c1, a0, the dyn and acc rows of y and dy, Pl,
// v, dv: 9N values) is carried in registers; the variables of u+1 are read
// from the NEXT stage of a three-stage shared-memory ring, which each thread
// fills for its own column with cp.async two waypoints ahead (no block
// barrier).  The certificate matvecs use the scaled-operator identities
//   A_base dx_u = Einv (A_s dx),  A'_base dy_u = cinv Dinv (A'_s dy),
//   P_base dx_u = cinv Dinv (P_s dx)
// so only the scaled problem streams; the cinv factors are applied by the
// caller (ops/residuals.py assemble_term_quantities).
//
// Sums (support, q'dx, sum x, sum y) are taken per waypoint and added in
// waypoint order; maxima start from 0, Adx_max from -inf, Adx_min from +inf.
//
// Bound: each pack is read once (about 1.5 KB per waypoint and problem) and 24
// values are written, so bytes over the memory rate; in practice the walk is
// one dependent chain of W steps per thread and B = 1024 is 32 warps on 132
// SMs, so latency decides, as for the other lane kernels.
//
// BLOCK_P: the stage also holds Pd_u (T packed rows) and Pl_u (4N^2 rows),
// 578 rows in all at N=6, NX=5: three stages are 222 KB of the 227 KB a block
// may opt into.  Pl_{u-1} is not kept: at step u-1, while its stage is live,
// the products Pl_{u-1} x_{u-1} and Pl_{u-1} dx_{u-1} that waypoint u needs
// are formed and carried (4N values).
#include "lane_common.cuh"

#ifndef BLOCK_P
#define BLOCK_P 0
#endif

// One stage of the ring: rows of LANE_BLOCK values.
#if BLOCK_P
constexpr int PD_ROWS = T, PL_ROWS = B2 * B2;  // packed Pd_u, full Pl_u
#else
constexpr int PD_ROWS = N, PL_ROWS = N;  // velocity diagonals
#endif
constexpr int O_CF = 0;             // stencil coefficients, CR rows
constexpr int O_PD = O_CF + CR;     // P-diag: PD_ROWS rows
constexpr int O_PL = O_PD + PD_ROWS;  // P-lower: PL_ROWS rows
constexpr int O_ST = O_PL + PL_ROWS;  // state tile x, z, y: SR rows
constexpr int O_DD = O_ST + SR;     // delta tile dx, dy: DR rows
constexpr int O_RC = O_DD + DR;     // E, Einv, l, u: 4 Rp rows
constexpr int O_VC = O_RC + 4 * Rp; // q, D, Dinv: 3 * 2N rows
constexpr int STAGE_ROWS = O_VC + 3 * B2;
constexpr int NSTAGE = 3;
constexpr int STAGE_ELEMS = STAGE_ROWS * LANE_BLOCK;

struct Args {
    Pack coef, pd, pl, state, dxdy, rowc, varc;
    real* smem;  // this thread's column of stage 0
};

__device__ __forceinline__ void stage_issue(const Args& a, int t) {
    real* sg = a.smem + (t % NSTAGE) * STAGE_ELEMS;
    stage_pack<CRp, CR, O_CF>(a.coef, t, sg);
#if BLOCK_P
    stage_pack<Tp, T, O_PD>(a.pd, t, sg);
    stage_pack<B2 * B2, B2 * B2, O_PL>(a.pl, t, sg);
#else
    stage_pack<PNp, N, O_PD>(a.pd, t, sg);
    stage_pack<PNp, N, O_PL>(a.pl, t, sg);
#endif
    stage_pack<SRp, SR, O_ST>(a.state, t, sg);
    stage_pack<DRp, DR, O_DD>(a.dxdy, t, sg);
    stage_pack<4 * Rp, 4 * Rp, O_RC>(a.rowc, t, sg);
    stage_pack<VCp, 3 * B2, O_VC>(a.varc, t, sg);
    cp_async_commit();
}

__global__ void residuals_kernel(
    const real* __restrict__ coef, const real* __restrict__ pd,
    const real* __restrict__ pl, const real* __restrict__ state,
    const real* __restrict__ dxdy, const real* __restrict__ rowc,
    const real* __restrict__ varc, real* acc_out, int W, int B) {
    LANE_SMEM_DECL();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t Bs = (size_t)B;
    const Args a{{coef, Bs, b},  {pd, Bs, b},   {pl, Bs, b},  {state, Bs, b},
                 {dxdy, Bs, b},  {rowc, Bs, b}, {varc, Bs, b},
                 lane_smem + threadIdx.x};

    real acc[A_COUNT];
#pragma unroll
    for (int k = 0; k < A_COUNT; ++k) acc[k] = real(0);
    acc[A_ADX_MAX] = -INFINITY;
    acc[A_ADX_MIN] = INFINITY;

    // What waypoint u needs of waypoint u-1 (all zero at u = 0).
    real c1_p[N], a0_p[N], ydyn_p[N], yacc_p[N], dydyn_p[N], dyacc_p[N];
#if BLOCK_P
    real spx[B2], spdx[B2];  // Pl_{u-1} x_{u-1}, Pl_{u-1} dx_{u-1}
#pragma unroll
    for (int i = 0; i < B2; ++i) spx[i] = spdx[i] = real(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
        c1_p[j] = a0_p[j] = ydyn_p[j] = yacc_p[j] = real(0);
        dydyn_p[j] = dyacc_p[j] = real(0);
    }
#else
    real pl_p[N], v_p[N], dv_p[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
        c1_p[j] = a0_p[j] = ydyn_p[j] = yacc_p[j] = real(0);
        dydyn_p[j] = dyacc_p[j] = pl_p[j] = v_p[j] = dv_p[j] = real(0);
    }
#endif

    stage_issue(a, 0);
    if (W > 1) stage_issue(a, 1);
    for (int u = 0; u < W; ++u) {
        // Waypoints u and u+1 must have landed; u+2 may be in flight.
        if (u + 2 < W) {
            stage_issue(a, u + 2);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        const bool have_next = u + 1 < W;
        const real* sg = a.smem + (u % NSTAGE) * STAGE_ELEMS;
        const real* sn = a.smem + ((u + 1) % NSTAGE) * STAGE_ELEMS;
        const Rows cf{sg + O_CF * LANE_BLOCK};

        real x[B2], dx[B2], xn[B2], dxn[B2];
#pragma unroll
        for (int i = 0; i < B2; ++i) {
            x[i] = sg[(O_ST + S_X + i) * LANE_BLOCK];
            dx[i] = sg[(O_DD + i) * LANE_BLOCK];
            // No waypoint W: its stage holds stale values, never read.
            xn[i] = have_next ? sn[(O_ST + S_X + i) * LANE_BLOCK] : real(0);
            dxn[i] = have_next ? sn[(O_DD + i) * LANE_BLOCK] : real(0);
        }

        // ---- row space at waypoint u.
        real y[R], dy[R];
        real pr_c = real(0), nax_c = real(0), nz_c = real(0), nedy_c = real(0);
        real sup_c = real(0), lpos_c = real(0), lneg_c = real(0), ys_c = real(0);
        real adxmx_c = -INFINITY, adxmn_c = INFINITY;
#pragma unroll
        for (int r = 0; r < Rp; ++r) {
            // Pad rows (r >= R): zero coefficients, (-INF, INF) bounds.
            const real ax = a_row(r, cf, x, xn);
            const real adx = a_row(r, cf, dx, dxn);
            const real E_r = sg[(O_RC + r) * LANE_BLOCK];
            const real Einv_r = sg[(O_RC + Rp + r) * LANE_BLOCK];
            const real lo = sg[(O_RC + 2 * Rp + r) * LANE_BLOCK];
            const real hi = sg[(O_RC + 3 * Rp + r) * LANE_BLOCK];
            const real z_r = sg[(O_ST + S_Z + r) * LANE_BLOCK];
            const real y_r = sg[(O_ST + S_Y + r) * LANE_BLOCK];
            const real dy_r = sg[(O_DD + B2 + r) * LANE_BLOCK];
            if (r < R) {
                y[r < R ? r : 0] = y_r;
                dy[r < R ? r : 0] = dy_r;
            }
            pr_c = rmax(pr_c, rabs(Einv_r * (ax - z_r)));
            nax_c = rmax(nax_c, rabs(Einv_r * ax));
            nz_c = rmax(nz_c, rabs(Einv_r * z_r));
            const real edy = E_r * dy_r;
            nedy_c = rmax(nedy_c, rabs(edy));
            const real edy_pos = rmax(edy, real(0));
            const real edy_neg = rmin(edy, real(0));
            const real u_b = Einv_r * hi;
            const real l_b = Einv_r * lo;
            const bool loose_u = u_b >= INF_THRESHOLD;
            const bool loose_l = l_b <= -INF_THRESHOLD;
            sup_c = sup_c + (loose_u ? real(0) : u_b * edy_pos) +
                    (loose_l ? real(0) : l_b * edy_neg);
            lpos_c = rmax(lpos_c, loose_u ? edy_pos : real(0));
            lneg_c = rmax(lneg_c, loose_l ? -edy_neg : real(0));
            const real eadx = Einv_r * adx;
            if (!loose_u) adxmx_c = rmax(adxmx_c, eadx);
            if (!loose_l) adxmn_c = rmin(adxmn_c, eadx);
            ys_c = ys_c + y_r;
        }

        // ---- variable space at waypoint u: A'y, A'dy (own rows + the cross
        // terms of rows u-1), P x, P dx.
        real aty[B2], atdy[B2];
        at_own(cf, y, aty);
        at_own(cf, dy, atdy);
#pragma unroll
        for (int j = 0; j < N; ++j) {
            aty[j] = aty[j] + c1_p[j] * ydyn_p[j];
            aty[N + j] = aty[N + j] + a0_p[j] * yacc_p[j];
            atdy[j] = atdy[j] + c1_p[j] * dydyn_p[j];
            atdy[N + j] = atdy[N + j] + a0_p[j] * dyacc_p[j];
        }
#if BLOCK_P
        // P x, P dx on all 2N rows, summed as the reference: the diagonal
        // block from zero, then the carried Pl_{u-1} term, then Pl_u' of the
        // next waypoint (zero pad block at u = W-1).
        real px_b[B2], pdx_b[B2];
        {
            const Rows pdr{sg + O_PD * LANE_BLOCK}, plr{sg + O_PL * LANE_BLOCK};
#pragma unroll
            for (int i = 0; i < B2; ++i) {
                real dg = real(0), dgd = real(0), up = real(0), upd = real(0);
#pragma unroll
                for (int j = 0; j < B2; ++j) {
                    const real p = pdr[j <= i ? LOW(i, j) : LOW(j, i)];
                    dg = dg + p * x[j];
                    dgd = dgd + p * dx[j];
                }
#pragma unroll
                for (int j = 0; j < B2; ++j) {
                    const real p = plr[j * B2 + i];
                    up = up + p * xn[j];
                    upd = upd + p * dxn[j];
                }
                px_b[i] = (dg + spx[i]) + up;
                pdx_b[i] = (dgd + spdx[i]) + upd;
            }
            // What waypoint u+1 needs of Pl_u: Pl_u x_u and Pl_u dx_u.
#pragma unroll
            for (int i = 0; i < B2; ++i) {
                real lx = real(0), ldx = real(0);
#pragma unroll
                for (int j = 0; j < B2; ++j) {
                    const real p = plr[i * B2 + j];
                    lx = lx + p * x[j];
                    ldx = ldx + p * dx[j];
                }
                spx[i] = lx;
                spdx[i] = ldx;
            }
        }
#endif
        real draw = real(0), ndpx = real(0), ndaty = real(0), ndx = real(0);
        real npdx = real(0), natdy = real(0), qdot = real(0), xs = real(0);
#pragma unroll
        for (int i = 0; i < B2; ++i) {
            const real q_i = sg[(O_VC + i) * LANE_BLOCK];
            const real D_i = sg[(O_VC + B2 + i) * LANE_BLOCK];
            const real Dinv_i = sg[(O_VC + 2 * B2 + i) * LANE_BLOCK];
#if BLOCK_P
            const real px = px_b[i], pdx = pdx_b[i];
#else
            real px = real(0), pdx = real(0);
            if (i >= N) {
                const int j = i >= N ? i - N : 0;
                const real pd_j = sg[(O_PD + j) * LANE_BLOCK];
                const real pl_j = sg[(O_PL + j) * LANE_BLOCK];  // 0 at u = W-1
                // Same association as the chunk kernel's fused reductions.
                px = (pd_j * x[i] + pl_j * xn[i]) + pl_p[j] * v_p[j];
                pdx = (pd_j * dx[i] + pl_j * dxn[i]) + pl_p[j] * dv_p[j];
            }
#endif
            draw = rmax(draw, rabs(Dinv_i * (px + q_i + aty[i])));
            ndpx = rmax(ndpx, rabs(Dinv_i * px));
            ndaty = rmax(ndaty, rabs(Dinv_i * aty[i]));
            ndx = rmax(ndx, rabs(D_i * dx[i]));
            npdx = rmax(npdx, rabs(Dinv_i * pdx));
            natdy = rmax(natdy, rabs(Dinv_i * atdy[i]));
            qdot = qdot + q_i * dx[i];
            xs = xs + x[i];
        }

        acc[A_PRIM_RES] = rmax(acc[A_PRIM_RES], pr_c);
        acc[A_NORM_EAX] = rmax(acc[A_NORM_EAX], nax_c);
        acc[A_NORM_EZ] = rmax(acc[A_NORM_EZ], nz_c);
        acc[A_DUAL_RAW] = rmax(acc[A_DUAL_RAW], draw);
        acc[A_NORM_DPX] = rmax(acc[A_NORM_DPX], ndpx);
        acc[A_NORM_DATY] = rmax(acc[A_NORM_DATY], ndaty);
        acc[A_NORM_EDY] = rmax(acc[A_NORM_EDY], nedy_c);
        acc[A_NORM_DX] = rmax(acc[A_NORM_DX], ndx);
        acc[A_AT_DY] = rmax(acc[A_AT_DY], natdy);
        acc[A_SUPPORT] = acc[A_SUPPORT] + sup_c;
        acc[A_LOOSE_POS] = rmax(acc[A_LOOSE_POS], lpos_c);
        acc[A_LOOSE_NEG] = rmax(acc[A_LOOSE_NEG], lneg_c);
        acc[A_PDX_MAX] = rmax(acc[A_PDX_MAX], npdx);
        acc[A_ADX_MAX] = rmax(acc[A_ADX_MAX], adxmx_c);
        acc[A_ADX_MIN] = rmin(acc[A_ADX_MIN], adxmn_c);
        acc[A_Q_DOT] = acc[A_Q_DOT] + qdot;
        acc[A_XSUM] = acc[A_XSUM] + xs;
        acc[A_YSUM] = acc[A_YSUM] + ys_c;

        // ---- what waypoint u+1 needs of this one.
#pragma unroll
        for (int j = 0; j < N; ++j) {
            c1_p[j] = cf[C_C1 + j];
            a0_p[j] = cf[C_A0 + j];
            ydyn_p[j] = y[R_DYN + j];
            yacc_p[j] = y[R_ACC + j];
            dydyn_p[j] = dy[R_DYN + j];
            dyacc_p[j] = dy[R_ACC + j];
#if !BLOCK_P
            pl_p[j] = sg[(O_PL + j) * LANE_BLOCK];
            v_p[j] = x[N + j];
            dv_p[j] = dx[N + j];
#endif
        }
    }

#pragma unroll
    for (int k = 0; k < A_COUNT; ++k) acc_out[(size_t)k * Bs + b] = acc[k];
#pragma unroll
    for (int k = A_COUNT; k < NACC; ++k) acc_out[(size_t)k * Bs + b] = real(0);
}

extern "C" int residuals_launch(const void* coef, const void* pd,
                                const void* pl, const void* state,
                                const void* dxdy, const void* rowc,
                                const void* varc, void* acc, int W, int B,
                                void* stream) {
    const int grid = (B + LANE_BLOCK - 1) / LANE_BLOCK;
    const int smem_bytes = NSTAGE * STAGE_ELEMS * (int)sizeof(real);
#ifndef LANE_HOST_EMULATION
    // More than the 48 KB a kernel gets without asking.
    const cudaError_t attr = cudaFuncSetAttribute(
        residuals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (attr != cudaSuccess) return (int)attr;
#endif
    LANE_LAUNCH_SMEM(residuals_kernel, grid, LANE_BLOCK, smem_bytes, stream,
                     (const real*)coef, (const real*)pd, (const real*)pl,
                     (const real*)state, (const real*)dxdy, (const real*)rowc,
                     (const real*)varc, (real*)acc, W, B);
    return LANE_LAST_ERROR();
}
