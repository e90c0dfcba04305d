// Modified Ruiz equilibration, all passes in one launch, one thread per
// problem.
//
// Replaces the Pallas kernel of osqp_solver_tpu/ops/ruiz_pallas.py
// (ruiz_equilibrate_lane_kernel, body _make_kernel), vel-diag P.
//
// Inputs are absolute values: |coef| (W, CRp, B), |Pd|, |Pl| (W, PNp, B; last
// |Pl| row zero), |q| (W, 2N, B).  D (2, W, 2N, B) and E (2, W, Rp, B) are
// ping-pong buffers, slot 0 initialised to ones by the caller: pass k reads
// slot k%2 and writes slot (k+1)%2, so every row and column maximum of a pass
// sees the OLD D/E of all neighbouring waypoints (a Jacobi sweep, as the
// reference computes it).  Only the cost normalisation uses the NEW D, carried
// one waypoint back in registers, with the old c.  Scaled magnitudes keep the
// grouping (|a| * e) * d of scale_data.  c (B,) is written at the end.
//
// Bound: each thread walks W waypoints serially per pass; the streamed bytes
// are small, so the kernel is bound by that walk's latency.  Every load of a
// step is issued at its top (the u-1 values are carried in registers, the u+1
// index is clamped), so a step waits for memory once and not once per branch.
#include "lane_common.cuh"

constexpr real MIN_SCALING = real(1e-4);
constexpr real MAX_SCALING = real(1e4);

__device__ __forceinline__ real limit_scaling(real x) {
    x = x < MIN_SCALING ? real(1) : x;
    return rmin(x, MAX_SCALING);
}

__device__ __forceinline__ real inv_sqrt_limit(real x) {
    return real(1) / sqrt(limit_scaling(x));
}

__global__ void ruiz_kernel(const real* __restrict__ ac_,
                            const real* __restrict__ apd_,
                            const real* __restrict__ apl_,
                            const real* __restrict__ aq_, real* Dbuf,
                            real* Ebuf, real* c_out, int W, int B, int iters) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const size_t Bs = (size_t)B;
    const Pack ac{ac_, Bs, b}, apd{apd_, Bs, b}, apl{apl_, Bs, b},
        aq{aq_, Bs, b};
    const size_t dslot = (size_t)W * B2 * Bs, eslot = (size_t)W * Rp * Bs;
    real c = real(1);

    for (int it = 0; it < iters; ++it) {
        const Pack Do{Dbuf + (it % 2) * dslot, Bs, b};
        const Pack Eo{Ebuf + (it % 2) * eslot, Bs, b};
        real* Dn_out = Dbuf + ((it + 1) % 2) * dslot;
        real* En_out = Ebuf + ((it + 1) % 2) * eslot;

        real gsum = real(0), gqmax = real(0);
        real Dn_prev[N], gpart[N];  // new Dv and P partial of waypoint u-1
        // Old (this pass's input) values of waypoint u-1, carried in registers
        // so that no load sits behind a branch: |c1|, |a0|, their E rows, |Pl|
        // and the old Dv.  Zero at u = 0, where they multiply into a max
        // with non-negative terms and so drop out.
        real c1_p[N], a0_p[N], edyn_p[N], eacc_p[N], apl_p[N], dv_p[N];
#pragma unroll
        for (int j = 0; j < N; ++j) {
            Dn_prev[j] = gpart[j] = real(0);
            c1_p[j] = a0_p[j] = edyn_p[j] = eacc_p[j] = apl_p[j] = dv_p[j] =
                real(0);
        }

        for (int u = 0; u < W; ++u) {
            const bool have_next = u + 1 < W;
            const int un = have_next ? u + 1 : u;  // clamped: loaded always
            // Every load of the step is issued here, up front.
            real Du[B2], Dnx[B2], Eu[R], a[CR], pdu[N], plu[N], aqu[B2];
#pragma unroll
            for (int i = 0; i < B2; ++i) {
                Du[i] = Do(u, B2, i);
                Dnx[i] = Do(un, B2, i);
                aqu[i] = aq(u, B2, i);
            }
#pragma unroll
            for (int r = 0; r < R; ++r) Eu[r] = Eo(u, Rp, r);
#pragma unroll
            for (int k = 0; k < CR; ++k) a[k] = ac(u, CRp, k);
#pragma unroll
            for (int j = 0; j < N; ++j) {
                pdu[j] = apd(u, PNp, j);
                plu[j] = apl(u, PNp, j);
            }

            real Dn[B2];
            real rowmax[R];
#pragma unroll
            for (int j = 0; j < N; ++j) {
                const real dq = Du[j], dv = Du[N + j];
                // Scaled magnitudes of this waypoint's stencil rows.
                const real s_pos = a[C_POS + j] * Eu[R_POS + j] * dq;
                const real s_c2 = a[C_C2 + j] * Eu[R_DYN + j] * dq;
                const real s_c0 = a[C_C0 + j] * Eu[R_DYN + j] * dv;
                const real s_vel = a[C_VEL + j] * Eu[R_VEL + j] * dv;
                const real s_a1 = a[C_A1 + j] * Eu[R_ACC + j] * dv;

                // ---- column maxima of waypoint u (A + P, old D / c); the
                // u-1 terms are zero at u = 0.
                real cq = rmax(s_pos, s_c2);
                real cv = rmax(rmax(s_vel, s_c0), s_a1);
                cq = rmax(cq, c1_p[j] * edyn_p[j] * dq);
                cv = rmax(cv, a0_p[j] * eacc_p[j] * dv);
#pragma unroll
                for (int k = 0; k < NX; ++k)
                    cq = rmax(cq, a[C_X + k * N + j] * Eu[R_X + k] * dq);
                real pcol = ((c * dv) * pdu[j]) * dv;
                pcol = rmax(pcol, (apl_p[j] * dv_p[j]) * (c * dv));
                if (have_next)
                    pcol = rmax(pcol, ((c * Dnx[N + j]) * plu[j]) * dv);
                cv = rmax(cv, pcol);
                Dn[j] = dq * inv_sqrt_limit(cq);
                Dn[N + j] = dv * inv_sqrt_limit(cv);

                // ---- row maxima of waypoint u (old D / E)
                real rd = rmax(s_c0, s_c2);
                real ra = s_a1;
                if (have_next) {
                    rd = rmax(rd, a[C_C1 + j] * Eu[R_DYN + j] * Dnx[j]);
                    ra = rmax(ra, a[C_A0 + j] * Eu[R_ACC + j] * Dnx[N + j]);
                }
                rowmax[R_DYN + j] = rd;
                rowmax[R_POS + j] = s_pos;
                rowmax[R_VEL + j] = s_vel;
                rowmax[R_ACC + j] = ra;
            }
#pragma unroll
            for (int k = 0; k < NX; ++k) {
                real m = real(0);
#pragma unroll
                for (int j = 0; j < N; ++j)
                    m = rmax(m, a[C_X + k * N + j] * Eu[R_X + k] * Du[j]);
                rowmax[R_X + k] = m;
            }

            // ---- new D / E of waypoint u into the other slot
#pragma unroll
            for (int i = 0; i < B2; ++i)
                Dn_out[((size_t)u * B2 + i) * Bs + b] = Dn[i];
#pragma unroll
            for (int r = 0; r < R; ++r)
                En_out[((size_t)u * Rp + r) * Bs + b] =
                    Eu[r] * inv_sqrt_limit(rowmax[r]);
#pragma unroll
            for (int r = R; r < Rp; ++r)  // pad rows: zero row, E stays 1
                En_out[((size_t)u * Rp + r) * Bs + b] = real(1);

            // ---- cost normalisation (new D, old c), one waypoint delayed:
            // the P column of u-1 needs the new Dv of u.  q columns carry no
            // P entry and add limit(0) = 1 each to the mean.
            if (u >= 1) {
                real add = real(N);
#pragma unroll
                for (int j = 0; j < N; ++j) {
                    const real lowcol =
                        ((c * Dn[N + j]) * apl_p[j]) * Dn_prev[j];
                    add = add + limit_scaling(rmax(gpart[j], lowcol));
                }
                gsum = gsum + add;
            }
            real qadd = real(0);
#pragma unroll
            for (int i = 0; i < B2; ++i)
                qadd = rmax(qadd, (c * Dn[i]) * aqu[i]);
            gqmax = rmax(gqmax, qadd);
#pragma unroll
            for (int j = 0; j < N; ++j) {
                real g = ((c * Dn[N + j]) * pdu[j]) * Dn[N + j];
                // zero at u = 0 (apl_p = 0)
                g = rmax(g, (apl_p[j] * Dn_prev[j]) * (c * Dn[N + j]));
                gpart[j] = g;
                Dn_prev[j] = Dn[N + j];
                c1_p[j] = a[C_C1 + j];
                a0_p[j] = a[C_A0 + j];
                edyn_p[j] = Eu[R_DYN + j];
                eacc_p[j] = Eu[R_ACC + j];
                apl_p[j] = plu[j];
                dv_p[j] = Du[N + j];
            }
        }
        {   // finish the last waypoint: no lower-column term
            real add = real(N);
#pragma unroll
            for (int j = 0; j < N; ++j) add = add + limit_scaling(gpart[j]);
            gsum = gsum + add;
        }
        const real gamma =
            real(1) / limit_scaling(rmax(gsum / real(W * B2), gqmax));
        c = c * gamma;
    }
    c_out[b] = c;
}

extern "C" int ruiz_launch(const void* ac, const void* apd, const void* apl,
                           const void* aq, void* Dbuf, void* Ebuf, void* c_out,
                           int W, int B, int iters, void* stream) {
    const int grid = (B + LANE_BLOCK - 1) / LANE_BLOCK;
    LANE_LAUNCH(ruiz_kernel, grid, LANE_BLOCK, stream, (const real*)ac,
                (const real*)apd, (const real*)apl, (const real*)aq,
                (real*)Dbuf, (real*)Ebuf, (real*)c_out, W, B, iters);
    return LANE_LAST_ERROR();
}
