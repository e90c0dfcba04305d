// Modified Ruiz equilibration, all passes in one launch, one thread per
// problem.
//
// Replaces the Pallas kernel of osqp_solver_tpu/ops/ruiz_pallas.py
// (ruiz_equilibrate_lane_kernel, body _make_kernel): vel-diag P, or with
// -DBLOCK_P=1 generic dense 2N x 2N blocks of P (the reference's block
// branches, ruiz_pallas.py:175-200 and :284-300).
//
// Inputs are absolute values: |coef| (W, CRp, B), |Pd|, |Pl| (W, PNp, B; last
// |Pl| row zero; BLOCK_P: full blocks (W, 2N, 2N, B), the last |Pl| block
// zero), |q| (W, 2N, B).  D (2, W, 2N, B) and E (2, W, Rp, B) are
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
//
// BLOCK_P: the P blocks are 4 x 144 values a step (|Pd_u| twice, |Pl_u|,
// |Pl_{u-1}|), too many for registers, so they are read at the point of use
// (the second reads of a step hit L1).  What waypoint u needs of |Pl_{u-1}|
// under the OLD D — its row maxima weighted by D_{u-1} — is formed at step u-1
// while |Pl_{u-1}| is read for the lower-column term, and carried (2N values);
// the cost normalisation, which needs the NEW D of u, reads |Pl_{u-1}| again.
// The block packs are ~30x the vel-diag bytes (2 x 59 MB at W=100, N=6,
// B=1024) and are streamed every pass.
#include "lane_common.cuh"

#ifndef BLOCK_P
#define BLOCK_P 0
#endif
constexpr int PB = B2 * B2;  // entries of one full P block (BLOCK_P packs)

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
#if BLOCK_P
        // New D, P partial (diagonal + lower-row terms) and old-D lower-row
        // maxima of waypoint u-1 (the last for waypoint u), and its old |c1|,
        // |a0| and their E rows: zero at u = 0, where they multiply into a
        // max with non-negative terms and so drop out.
        real Dn_prev[B2], gpart[B2], prow[B2];
        real c1_p[N], a0_p[N], edyn_p[N], eacc_p[N];
#pragma unroll
        for (int i = 0; i < B2; ++i) Dn_prev[i] = gpart[i] = prow[i] = real(0);
#pragma unroll
        for (int j = 0; j < N; ++j)
            c1_p[j] = a0_p[j] = edyn_p[j] = eacc_p[j] = real(0);
#else
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
#endif

        for (int u = 0; u < W; ++u) {
            const bool have_next = u + 1 < W;
            const int un = have_next ? u + 1 : u;  // clamped: loaded always
            // Every load of the step is issued here, up front.
            real Du[B2], Dnx[B2], Eu[R], a[CR], aqu[B2];
#if !BLOCK_P
            real pdu[N], plu[N];
#endif
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
#if !BLOCK_P
#pragma unroll
            for (int j = 0; j < N; ++j) {
                pdu[j] = apd(u, PNp, j);
                plu[j] = apl(u, PNp, j);
            }
#else
            // P column maxima of waypoint u (old D / c): the diagonal block,
            // the carried lower-row term of |Pl_{u-1}|, the lower-column term
            // of |Pl_u| with the old D of u+1 (the pad block is zero at
            // u = W-1).  Grouping as the reference: (c d_i |P_ij|) d_j.
            real pcb[B2], prow_n[B2];
            {
                real cd[B2], cdn[B2];
#pragma unroll
                for (int i = 0; i < B2; ++i) {
                    cd[i] = c * Du[i];
                    cdn[i] = c * Dnx[i];
                }
#pragma unroll
                for (int jj = 0; jj < B2; ++jj) {
                    real acc = real(0), accc = real(0);
#pragma unroll
                    for (int ii = 0; ii < B2; ++ii) {
                        acc = rmax(acc, cd[ii] * apd(u, PB, ii * B2 + jj));
                        accc = rmax(accc, cdn[ii] * apl(u, PB, ii * B2 + jj));
                    }
                    real pc = acc * Du[jj];
                    pc = rmax(pc, prow[jj] * (c * Du[jj]));
                    pcb[jj] = rmax(pc, accc * Du[jj]);
                }
                // Row maxima of |Pl_u| under the old D of u: waypoint u+1's
                // lower-row term, carried.
#pragma unroll
                for (int ii = 0; ii < B2; ++ii) {
                    real r = real(0);
#pragma unroll
                    for (int jx = 0; jx < B2; ++jx)
                        r = rmax(r, apl(u, PB, ii * B2 + jx) * Du[jx]);
                    prow_n[ii] = r;
                }
            }
#endif

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
#if BLOCK_P
                cq = rmax(cq, pcb[j]);
                cv = rmax(cv, pcb[N + j]);
#else
                real pcol = ((c * dv) * pdu[j]) * dv;
                pcol = rmax(pcol, (apl_p[j] * dv_p[j]) * (c * dv));
                if (have_next)
                    pcol = rmax(pcol, ((c * Dnx[N + j]) * plu[j]) * dv);
                cv = rmax(cv, pcol);
#endif
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
            // the P column of u-1 needs the new D of u.
#if BLOCK_P
            real cdn_new[B2];
#pragma unroll
            for (int i = 0; i < B2; ++i) cdn_new[i] = c * Dn[i];
            real growp[B2];  // lower-row maxima of |Pl_{u-1}| under new D
#pragma unroll
            for (int i = 0; i < B2; ++i) growp[i] = real(0);
            if (u >= 1) {
                real add = real(0);
#pragma unroll
                for (int jj = 0; jj < B2; ++jj) {
                    real accc = real(0);
#pragma unroll
                    for (int ii = 0; ii < B2; ++ii)
                        accc = rmax(accc,
                                    cdn_new[ii] * apl(u - 1, PB, ii * B2 + jj));
                    add = add + limit_scaling(
                                    rmax(gpart[jj], accc * Dn_prev[jj]));
                }
                gsum = gsum + add;
#pragma unroll
                for (int jj = 0; jj < B2; ++jj) {
                    real r = real(0);
#pragma unroll
                    for (int jx = 0; jx < B2; ++jx)
                        r = rmax(r, apl(u - 1, PB, jj * B2 + jx) * Dn_prev[jx]);
                    growp[jj] = r;
                }
            }
            real qadd = real(0);
#pragma unroll
            for (int i = 0; i < B2; ++i) qadd = rmax(qadd, cdn_new[i] * aqu[i]);
            gqmax = rmax(gqmax, qadd);
#pragma unroll
            for (int jj = 0; jj < B2; ++jj) {
                real acc = real(0);
#pragma unroll
                for (int ii = 0; ii < B2; ++ii)
                    acc = rmax(acc, cdn_new[ii] * apd(u, PB, ii * B2 + jj));
                // zero at u = 0 (growp = 0)
                gpart[jj] = rmax(acc * Dn[jj], growp[jj] * (c * Dn[jj]));
            }
#pragma unroll
            for (int i = 0; i < B2; ++i) {
                Dn_prev[i] = Dn[i];
                prow[i] = prow_n[i];
            }
#pragma unroll
            for (int j = 0; j < N; ++j) {
                c1_p[j] = a[C_C1 + j];
                a0_p[j] = a[C_A0 + j];
                edyn_p[j] = Eu[R_DYN + j];
                eacc_p[j] = Eu[R_ACC + j];
            }
#else
            // q columns carry no P entry and add limit(0) = 1 each to the mean.
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
#endif
        }
        {   // finish the last waypoint: no lower-column term
#if BLOCK_P
            real add = real(0);
#pragma unroll
            for (int j = 0; j < B2; ++j) add = add + limit_scaling(gpart[j]);
#else
            real add = real(N);
#pragma unroll
            for (int j = 0; j < N; ++j) add = add + limit_scaling(gpart[j]);
#endif
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
