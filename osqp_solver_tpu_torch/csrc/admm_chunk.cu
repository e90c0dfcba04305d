// Fused ADMM chunk, one thread per problem: n_iter OSQP iterations per launch
// on the packed state, and in the last backward pass either the termination /
// certificate accumulators (MODE_TERM) or the last iteration's packed deltas
// dx, dy (MODE_DXDY), or neither (MODE_PLAIN).  Each mode exists in both
// factor forms: gain-free ("hrec", GAIN = false) and with the packed gain
// G_t streamed beside the packed chol (GAIN = true).
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
// MODE_TERM, last backward pass: row-space reductions at waypoint t; the
// variable-space quantities of waypoint t+1 (A'y, Px, A'dy, P dx) need rows of
// waypoint t, so they are carried as one-step-delayed partials and reduced at
// step t; waypoint 0 is finished in an epilogue.  Same accumulators and
// semantics as the reference's residual kernel (ops/residuals.py _ACC).
//
// Bound: two chains of W dependent 12x12 triangular-solve pairs per
// iteration; latency-bound (B = 1024 is 32 warps on 132 SMs).  With one warp
// per SM nothing hides the latency of the ~340 rows a waypoint step reads, so
// each thread stages the NEXT waypoint's rows into shared memory with
// cp.async (two stages, its own column only: no block barrier) while it
// computes the current one (the termination packs too, in the last backward
// pass).  That pass holds far more than 255 values and spills; accepted.
#include "lane_common.cuh"

// One stage of the shared-memory pipeline: rows of LANE_BLOCK values.
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
__host__ __device__ constexpr int stage_elems(bool term, bool gain) {
    return (o_gain(term) + (gain ? T : 0)) * LANE_BLOCK;
}

enum { MODE_PLAIN = 0, MODE_TERM = 1, MODE_DXDY = 2 };

struct Args {
    Pack chol, gain, coef, q, lu, rho, plf, ee, varc, pd;
    real* state;
    real* w;
    real* acc;
    real* dxdy;
    int W, B, b;
    real sigma, alpha, keep;
    real* smem;  // this thread's column of stage 0
    int stage;   // elements per stage
};

// Start the copies of waypoint t's rows into stage t & 1 and commit them as
// one group.
template <bool BWD, bool GAIN, bool TERM = false>
__device__ __forceinline__ void stage_issue(const Args& a, int t) {
    real* sg = a.smem + (t & 1) * a.stage;
    stage_pack<Tp, T, O_CH>(a.chol, t, sg);
    if (GAIN) {
        constexpr int OG = o_gain(TERM);
        stage_pack<Tp, T, OG>(a.gain, BWD ? t : (t > 0 ? t - 1 : 0), sg);
    }
    stage_pack<CRp, CR, O_CF>(a.coef, t, sg);
    stage_pack<Rp, Rp, O_RH>(a.rho, t, sg);
    stage_pack<PNp, N, O_PL>(a.plf, t, sg);
    const Pack st{a.state, (size_t)a.B, a.b};
    stage_pack<SRp, SR, O_ST>(st, t, sg);
    if (BWD) {
        const Pack w{a.w, (size_t)a.B, a.b};
        stage_pack<B2, B2, O_QW>(w, t, sg);
        stage_pack<2 * Rp, 2 * Rp, O_LU>(a.lu, t, sg);
        if (TERM) {
            stage_pack<2 * Rp, 2 * Rp, O_EE>(a.ee, t, sg);
            stage_pack<VCp, 3 * B2, O_VC>(a.varc, t, sg);
            stage_pack<PNp, N, O_PD>(a.pd, t, sg);
        }
    } else {
        stage_pack<B2, B2, O_QW>(a.q, t, sg);
    }
    cp_async_commit();
}



// Sparse coupling block Ml_t: (j,j) = qq, (j,N+j) = qv, (N+j,N+j) = vv.
__device__ __forceinline__ void ml_at(const Rows& cf, const Rows& rh,
                                      const Rows& pl, real* qq, real* qv,
                                      real* vv) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
        const real rd = rh[R_DYN + j];
        qq[j] = rd * cf[C_C1 + j] * cf[C_C2 + j];
        qv[j] = rd * cf[C_C1 + j] * cf[C_C0 + j];
        vv[j] = rh[R_ACC + j] * cf[C_A0 + j] * cf[C_A1 + j] + pl[j];
    }
}

template <bool GAIN>
__device__ __forceinline__ void forward_pass(const Args& a) {
    real h_p[B2], vdyn_p[N], vacc_p[N], c1_p[N], a0_p[N];
    real qq_p[N], qv_p[N], vv_p[N];
#pragma unroll
    for (int i = 0; i < B2; ++i) h_p[i] = real(0);
#pragma unroll
    for (int j = 0; j < N; ++j) {
        vdyn_p[j] = vacc_p[j] = c1_p[j] = a0_p[j] = real(0);
        qq_p[j] = qv_p[j] = vv_p[j] = real(0);
    }
    stage_issue<false, GAIN>(a, 0);
    for (int t = 0; t < a.W; ++t) {
        if (t + 1 < a.W) {
            stage_issue<false, GAIN>(a, t + 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        const real* sg = a.smem + (t & 1) * a.stage;
        const Rows cf{sg + O_CF * LANE_BLOCK}, rh{sg + O_RH * LANE_BLOCK},
            pl{sg + O_PL * LANE_BLOCK}, ch{sg + O_CH * LANE_BLOCK};
        // v_r = rho_r z_r - y_r for the real rows.
        real vr[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
            vr[r] = rh[r] * sg[(O_ST + S_Z + r) * LANE_BLOCK] -
                    sg[(O_ST + S_Y + r) * LANE_BLOCK];

        real rhs[B2];
#pragma unroll
        for (int j = 0; j < N; ++j) {  // q rows of the A' gather
            real g = cf[C_C2 + j] * vr[R_DYN + j];
            g = g + c1_p[j] * vdyn_p[j];
            g = g + cf[C_POS + j] * vr[R_POS + j];
#pragma unroll
            for (int k = 0; k < NX; ++k)
                g = g + cf[C_X + k * N + j] * vr[R_X + k];
            rhs[j] = a.sigma * sg[(O_ST + S_X + j) * LANE_BLOCK] -
                     sg[(O_QW + j) * LANE_BLOCK] + g;
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {  // v rows
            real g = cf[C_C0 + j] * vr[R_DYN + j];
            g = g + cf[C_VEL + j] * vr[R_VEL + j];
            g = g + cf[C_A1 + j] * vr[R_ACC + j];
            g = g + a0_p[j] * vacc_p[j];
            rhs[N + j] = a.sigma * sg[(O_ST + S_X + N + j) * LANE_BLOCK] -
                         sg[(O_QW + N + j) * LANE_BLOCK] + g;
        }
        if (GAIN) {
            // rhs_t - G_{t-1} w_{t-1}, G upper-triangular (h_p holds w_{t-1}).
            if (t > 0) {
                const Rows gn{sg + o_gain(false) * LANE_BLOCK};
#pragma unroll
                for (int i = 0; i < B2; ++i) {
                    real acc = real(0);
#pragma unroll
                    for (int j = i; j < B2; ++j)
                        acc = acc + gn[UP(i, j)] * h_p[j];
                    rhs[i] = rhs[i] - acc;
                }
            }
            lower_solve(ch, rhs);  // w_t
        } else {
            // rhs_t - Ml_{t-1} h_{t-1}   (all-zero carry at t = 0).
            if (t > 0) {
#pragma unroll
                for (int j = 0; j < N; ++j) {
                    rhs[j] = rhs[j] - (qq_p[j] * h_p[j] + qv_p[j] * h_p[N + j]);
                    rhs[N + j] = rhs[N + j] - vv_p[j] * h_p[N + j];
                }
            }
            lower_solve(ch, rhs);
            upper_solve(ch, rhs);  // h_t
        }
#pragma unroll
        for (int i = 0; i < B2; ++i) {
            a.w[((size_t)t * B2 + i) * a.B + a.b] = rhs[i];
            h_p[i] = rhs[i];
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
            vdyn_p[j] = vr[R_DYN + j];
            vacc_p[j] = vr[R_ACC + j];
            c1_p[j] = cf[C_C1 + j];
            a0_p[j] = cf[C_A0 + j];
        }
        if (!GAIN) ml_at(cf, rh, pl, qq_p, qv_p, vv_p);
    }
}

// max-reduce the variable-space quantities of one waypoint, given its q and
// Dinv rows, into the accumulators.
__device__ __forceinline__ void reduce_var_space(const real* qv_,
                                                 const real* dinv,
                                                 const real* aty,
                                                 const real* atdy,
                                                 const real* px,
                                                 const real* pdx, real* acc) {
    real draw = real(0), ndpx = real(0), ndaty = real(0), natdy = real(0),
         npdx = real(0);
#pragma unroll
    for (int i = 0; i < B2; ++i) {
        const real Dinv = dinv[i];
        const real qi = qv_[i];
        const real Px = i < N ? real(0) : px[i < N ? 0 : i - N];
        const real Pdx = i < N ? real(0) : pdx[i < N ? 0 : i - N];
        draw = rmax(draw, rabs(Dinv * (Px + qi + aty[i])));
        ndpx = rmax(ndpx, rabs(Dinv * Px));
        ndaty = rmax(ndaty, rabs(Dinv * aty[i]));
        natdy = rmax(natdy, rabs(Dinv * atdy[i]));
        npdx = rmax(npdx, rabs(Dinv * Pdx));
    }
    acc[A_DUAL_RAW] = rmax(acc[A_DUAL_RAW], draw);
    acc[A_NORM_DPX] = rmax(acc[A_NORM_DPX], ndpx);
    acc[A_NORM_DATY] = rmax(acc[A_NORM_DATY], ndaty);
    acc[A_AT_DY] = rmax(acc[A_AT_DY], natdy);
    acc[A_PDX_MAX] = rmax(acc[A_PDX_MAX], npdx);
}

template <int MODE, bool GAIN>
__device__ __forceinline__ void backward_pass(const Args& a) {
    constexpr bool TERM = MODE == MODE_TERM;
    constexpr bool DXDY = MODE == MODE_DXDY;
    const bool frozen = a.keep != real(0);
    const real alpha = a.alpha;
    real xt_n[B2];  // x~_{t+1}
#pragma unroll
    for (int i = 0; i < B2; ++i) xt_n[i] = real(0);

    // TERM carries (unused and removed by the compiler otherwise).
    real xsel_n[B2], dx_n[B2];
    real aty_p[B2], atdy_p[B2], px_p[N], pdx_p[N];
    real q_n[B2], dinv_n[B2];  // q and Dinv rows of waypoint t+1
    real acc[A_COUNT];
    if (TERM) {
#pragma unroll
        for (int i = 0; i < B2; ++i) q_n[i] = dinv_n[i] = real(0);
#pragma unroll
        for (int i = 0; i < B2; ++i)
            xsel_n[i] = dx_n[i] = aty_p[i] = atdy_p[i] = real(0);
#pragma unroll
        for (int j = 0; j < N; ++j) px_p[j] = pdx_p[j] = real(0);
#pragma unroll
        for (int k = 0; k < A_COUNT; ++k) acc[k] = real(0);
        acc[A_ADX_MAX] = -INFINITY;
        acc[A_ADX_MIN] = INFINITY;
    }

    stage_issue<true, GAIN, TERM>(a, a.W - 1);
    for (int t = a.W - 1; t >= 0; --t) {
        if (t > 0) {
            stage_issue<true, GAIN, TERM>(a, t - 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        const real* sg = a.smem + (t & 1) * a.stage;
        const Rows cf{sg + O_CF * LANE_BLOCK}, rh{sg + O_RH * LANE_BLOCK},
            pl{sg + O_PL * LANE_BLOCK}, ch{sg + O_CH * LANE_BLOCK};
        real* st = a.state + ((size_t)t * SRp) * a.B + a.b;  // written here
        real* dd = DXDY ? a.dxdy + ((size_t)t * DRp) * a.B + a.b : nullptr;

        real xt[B2];
        if (GAIN) {
            // x~_t = C^{-T} (w_t - G_t' x~_{t+1});  (G'x)_i = sum_{j<=i} G[j][i] x_j.
            const Rows gn{sg + o_gain(TERM) * LANE_BLOCK};
#pragma unroll
            for (int i = 0; i < B2; ++i) {
                real gx = real(0);
#pragma unroll
                for (int j = 0; j <= i; ++j) gx = gx + gn[UP(j, i)] * xt_n[j];
                const real w = sg[(O_QW + i) * LANE_BLOCK];
                xt[i] = (t < a.W - 1) ? w - gx : w;
            }
            upper_solve(ch, xt);
        } else {
            // x~_t = h_t - C^{-T} C^{-1} (Ml_t' x~_{t+1}).
            real qq[N], qv[N], vv[N], u[B2];
            ml_at(cf, rh, pl, qq, qv, vv);
#pragma unroll
            for (int j = 0; j < N; ++j) {
                u[j] = qq[j] * xt_n[j];
                u[N + j] = qv[j] * xt_n[j] + vv[j] * xt_n[N + j];
            }
            lower_solve(ch, u);
            upper_solve(ch, u);
#pragma unroll
            for (int i = 0; i < B2; ++i) {
                const real h = sg[(O_QW + i) * LANE_BLOCK];
                xt[i] = (t < a.W - 1) ? h - u[i] : h;
            }
        }

        real x_old[B2], x_sel[B2], dx[B2];
#pragma unroll
        for (int i = 0; i < B2; ++i) {
            x_old[i] = sg[(O_ST + S_X + i) * LANE_BLOCK];
            const real x_new = alpha * xt[i] + (real(1) - alpha) * x_old[i];
            x_sel[i] = frozen ? x_old[i] : x_new;
            dx[i] = frozen ? real(0) : x_new - x_old[i];
            st[(size_t)(S_X + i) * a.B] = x_sel[i];
            if (DXDY) dd[(size_t)i * a.B] = dx[i];
        }

        real y_sel[R], dy[R];  // kept for the A' gathers (TERM only)
        real pr_c = real(0), nax_c = real(0), nz_c = real(0), nedy_c = real(0);
        real sup_c = real(0), lpos_c = real(0), lneg_c = real(0), ys_c = real(0);
        real adxmx_c = -INFINITY, adxmn_c = INFINITY;
#pragma unroll
        for (int r = 0; r < Rp; ++r) {
            // Pad rows (r >= R): zero coefficients, (-INF, INF) bounds.
            const real ztr = a_row(r, cf, xt, xt_n);
            const real rho_r = sg[(O_RH + r) * LANE_BLOCK];
            const real z_old = sg[(O_ST + S_Z + r) * LANE_BLOCK];
            const real y_old = sg[(O_ST + S_Y + r) * LANE_BLOCK];
            const real lo = sg[(O_LU + r) * LANE_BLOCK];
            const real hi = sg[(O_LU + Rp + r) * LANE_BLOCK];
            const real z_tmp = alpha * ztr + (real(1) - alpha) * z_old;
            const real z_new = rmin(rmax(z_tmp + y_old / rho_r, lo), hi);
            const real y_new = y_old + rho_r * (z_tmp - z_new);
            const real z_s = frozen ? z_old : z_new;
            const real y_s = frozen ? y_old : y_new;
            const real dy_r = frozen ? real(0) : y_new - y_old;
            st[(size_t)(S_Z + r) * a.B] = z_s;
            st[(size_t)(S_Y + r) * a.B] = y_s;
            if (DXDY) dd[(size_t)(B2 + r) * a.B] = dy_r;
            if (TERM) {
                if (r < R) {
                    y_sel[r < R ? r : 0] = y_s;
                    dy[r < R ? r : 0] = dy_r;
                }
                // Row space at waypoint t: A x_sel and A dx by the same
                // A-row apply, in the same order of operations, as the
                // separate residual kernel (csrc/residuals.cu), so that the
                // two termination paths decide from the same float32 values.
                const real ax_sel = a_row(r, cf, x_sel, xsel_n);
                const real adx = a_row(r, cf, dx, dx_n);
                const real E_r = sg[(O_EE + r) * LANE_BLOCK];
                const real Einv_r = sg[(O_EE + Rp + r) * LANE_BLOCK];
                pr_c = rmax(pr_c, rabs(Einv_r * (ax_sel - z_s)));
                nax_c = rmax(nax_c, rabs(Einv_r * ax_sel));
                nz_c = rmax(nz_c, rabs(Einv_r * z_s));
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
                ys_c = ys_c + y_s;
            }
        }
#pragma unroll
        for (int r = SR; r < SRp; ++r) st[(size_t)r * a.B] = real(0);
        if (DXDY) {
#pragma unroll
            for (int r = DR; r < DRp; ++r) dd[(size_t)r * a.B] = real(0);
        }

        if (TERM) {
            acc[A_PRIM_RES] = rmax(acc[A_PRIM_RES], pr_c);
            acc[A_NORM_EAX] = rmax(acc[A_NORM_EAX], nax_c);
            acc[A_NORM_EZ] = rmax(acc[A_NORM_EZ], nz_c);
            acc[A_NORM_EDY] = rmax(acc[A_NORM_EDY], nedy_c);
            acc[A_SUPPORT] = acc[A_SUPPORT] + sup_c;
            acc[A_LOOSE_POS] = rmax(acc[A_LOOSE_POS], lpos_c);
            acc[A_LOOSE_NEG] = rmax(acc[A_LOOSE_NEG], lneg_c);
            acc[A_ADX_MAX] = rmax(acc[A_ADX_MAX], adxmx_c);
            acc[A_ADX_MIN] = rmin(acc[A_ADX_MIN], adxmn_c);
            acc[A_YSUM] = acc[A_YSUM] + ys_c;

            // Variable space, waypoint t+1: finish the carried partials with
            // this waypoint's cross terms (c1/a0 rows, P-lower).
            if (t < a.W - 1) {
                real cross_y[B2], cross_dy[B2], px_f[N], pdx_f[N];
                at_prev(cf, y_sel, cross_y);
                at_prev(cf, dy, cross_dy);
#pragma unroll
                for (int i = 0; i < B2; ++i) {
                    cross_y[i] = aty_p[i] + cross_y[i];
                    cross_dy[i] = atdy_p[i] + cross_dy[i];
                }
#pragma unroll
                for (int j = 0; j < N; ++j) {
                    px_f[j] = px_p[j] + pl[j] * x_sel[N + j];
                    pdx_f[j] = pdx_p[j] + pl[j] * dx[N + j];
                }
                reduce_var_space(q_n, dinv_n, cross_y, cross_dy, px_f, pdx_f,
                                 acc);
            }

            // Own-value variable reductions at waypoint t.
            real ndx_c = real(0), qdot_c = real(0), xs_c = real(0);
#pragma unroll
            for (int i = 0; i < B2; ++i) {
                q_n[i] = sg[(O_VC + i) * LANE_BLOCK];
                dinv_n[i] = sg[(O_VC + 2 * B2 + i) * LANE_BLOCK];
                ndx_c = rmax(ndx_c, rabs(sg[(O_VC + B2 + i) * LANE_BLOCK] * dx[i]));
                qdot_c = qdot_c + q_n[i] * dx[i];
                xs_c = xs_c + x_sel[i];
            }
            acc[A_NORM_DX] = rmax(acc[A_NORM_DX], ndx_c);
            acc[A_Q_DOT] = acc[A_Q_DOT] + qdot_c;
            acc[A_XSUM] = acc[A_XSUM] + xs_c;

            // Fresh partials for waypoint t (own-row terms).
            at_own(cf, y_sel, aty_p);
            at_own(cf, dy, atdy_p);
#pragma unroll
            for (int j = 0; j < N; ++j) {
                const real pdj = sg[(O_PD + j) * LANE_BLOCK];
                px_p[j] = pdj * x_sel[N + j] + pl[j] * xsel_n[N + j];
                pdx_p[j] = pdj * dx[N + j] + pl[j] * dx_n[N + j];
            }
#pragma unroll
            for (int i = 0; i < B2; ++i) {
                xsel_n[i] = x_sel[i];
                dx_n[i] = dx[i];
            }
        }
#pragma unroll
        for (int i = 0; i < B2; ++i) xt_n[i] = xt[i];
    }

    if (TERM) {
        // Epilogue: waypoint 0 has no t-1 cross terms.
        reduce_var_space(q_n, dinv_n, aty_p, atdy_p, px_p, pdx_p, acc);
#pragma unroll
        for (int k = 0; k < A_COUNT; ++k) a.acc[(size_t)k * a.B + a.b] = acc[k];
#pragma unroll
        for (int k = A_COUNT; k < NACC; ++k)
            a.acc[(size_t)k * a.B + a.b] = real(0);
    }
}

template <int MODE, bool GAIN>
__global__ void admm_chunk_kernel(
    const real* __restrict__ chol, const real* __restrict__ gain,
    const real* __restrict__ coef,
    const real* __restrict__ q, const real* __restrict__ lu,
    const real* __restrict__ rho, const real* __restrict__ plf,
    const real* __restrict__ ee, const real* __restrict__ varc,
    const real* __restrict__ pd, const real* __restrict__ done, real* state,
    real* w, real* acc, real* dxdy, int W, int B, int n_iter, real sigma,
    real alpha) {
    LANE_SMEM_DECL();
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t Bs = (size_t)B;
    Args a{{chol, Bs, b}, {gain, Bs, b}, {coef, Bs, b}, {q, Bs, b}, {lu, Bs, b},
           {rho, Bs, b},  {plf, Bs, b},  {ee, Bs, b},   {varc, Bs, b},
           {pd, Bs, b},   state,         w,             acc,
           dxdy,          W,             B,             b,
           sigma,         alpha,         done[b],       lane_smem + threadIdx.x,
           stage_elems(MODE == MODE_TERM, GAIN)};
    for (int it = 0; it < n_iter; ++it) {
        forward_pass<GAIN>(a);
        if (MODE != MODE_PLAIN && it == n_iter - 1)
            backward_pass<MODE, GAIN>(a);
        else
            backward_pass<MODE_PLAIN, GAIN>(a);
    }
}

template <int MODE, bool GAIN>
static int launch_mode(const void* chol, const void* gain, const void* coef,
                       const void* q, const void* lu, const void* rho,
                       const void* plf, const void* ee, const void* varc,
                       const void* pd, const void* done, void* state, void* w,
                       void* acc, void* dxdy, int W, int B, int n_iter,
                       double sigma, double alpha, void* stream) {
    const int grid = (B + LANE_BLOCK - 1) / LANE_BLOCK;
    const int smem_bytes =
        2 * stage_elems(MODE == MODE_TERM, GAIN) * (int)sizeof(real);
#ifndef LANE_HOST_EMULATION
    // More than the 48 KB a kernel gets without asking.
    const cudaError_t attr = cudaFuncSetAttribute(
        (const void*)admm_chunk_kernel<MODE, GAIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (attr != cudaSuccess) return (int)attr;
#endif
    auto* kernel = admm_chunk_kernel<MODE, GAIN>;
    LANE_LAUNCH_SMEM(kernel, grid, LANE_BLOCK,
                     smem_bytes, stream, (const real*)chol, (const real*)gain,
                     (const real*)coef, (const real*)q, (const real*)lu,
                     (const real*)rho, (const real*)plf, (const real*)ee,
                     (const real*)varc, (const real*)pd, (const real*)done,
                     (real*)state, (real*)w, (real*)acc, (real*)dxdy, W, B,
                     n_iter, (real)sigma, (real)alpha);
    return LANE_LAST_ERROR();
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
