// KKT assemble + block-Cholesky + pack, one thread per problem.
//
// Replaces the Pallas kernel of osqp_solver_tpu/ops/kkt_factor_pallas.py
// (factor_packed_lane, body _make_kernel) in both forms: emit_gain=False
// (gainp null) and emit_gain=True.
//
// Per waypoint t the thread assembles the lower half of the 2N x 2N block of
// P + sigma*I + A' diag(rho) A from the stencil coefficients (vel-diag P),
// applies the Schur step S = M_t - G_{t-1} G_{t-1}', factors S = C C' in
// place, writes the packed lower triangle of C, and forms the packed upper
// triangle G_t = Ml_t C_t^{-T} that the next step needs (Ml_t is the sparse
// coupling block, the same formulas as ml_at() of the chunk kernel).  G is
// carried in registers; with a gain pack (emit_gain) it is also written as
// the packed upper triangle G_t at row t, the row of the last waypoint zero
// (ops/admm_fused.py pack_factor).  Divisions go through one exact reciprocal
// per pivot, as in the reference kernel.
//
// Bound: a chain of W dependent Cholesky steps per thread; latency, not
// bandwidth or FLOP rate.  C (78 values at N=6) and G (78) are live together,
// so the kernel spills; see the ptxas figures printed by chip_smoke.py.
#include "lane_common.cuh"

__global__ void kkt_factor_kernel(const real* __restrict__ coef_,
                                  const real* __restrict__ rho_,
                                  const real* __restrict__ pd_,
                                  const real* __restrict__ pl_,
                                  real* __restrict__ cholp,
                                  real* __restrict__ gainp, int W, int B,
                                  real sigma) {
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const Pack coef{coef_, (size_t)B, b}, rho{rho_, (size_t)B, b},
        pd{pd_, (size_t)B, b}, pl{pl_, (size_t)B, b};

    real G[T];          // packed upper G_{t-1}
    real c1sq_p[N], a0sq_p[N];
#pragma unroll
    for (int k = 0; k < T; ++k) G[k] = real(0);
#pragma unroll
    for (int j = 0; j < N; ++j) { c1sq_p[j] = real(0); a0sq_p[j] = real(0); }

    for (int t = 0; t < W; ++t) {
        real S[T];  // packed lower: M_diag, then S, then C (in place)
#pragma unroll
        for (int k = 0; k < T; ++k) S[k] = real(0);

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
                for (int j = 0; j <= i; ++j) S[LOW(i, j)] += fi * f[j];
            }
        }

        real ml_qq[N], ml_qv[N], ml_vv[N];
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
            const real d_qq =
                rho(t, Rp, R_POS + j) * po * po + rd * c2 * c2 + c1sq_p[j];
            const real d_vv = rd * c0 * c0 + rho(t, Rp, R_VEL + j) * ve * ve +
                              a0sq_p[j] + ra * a1 * a1;
            S[LOW(j, j)] = S[LOW(j, j)] + d_qq + sigma;
            S[LOW(N + j, j)] = rd * c2 * c0;
            S[LOW(N + j, N + j)] = d_vv + pd(t, PNp, j) + sigma;
            c1sq_p[j] = rd * c1 * c1;
            a0sq_p[j] = ra * a0 * a0;
            ml_qq[j] = rd * c1 * c2;
            ml_qv[j] = rd * c1 * c0;
            ml_vv[j] = ra * a0 * a1 + pl(t, PNp, j);
        }

        // S = M_diag - G_{t-1} G_{t-1}'   (G = 0 at t = 0).
#pragma unroll
        for (int i = 0; i < B2; ++i) {
#pragma unroll
            for (int j = 0; j <= i; ++j) {
                real acc = real(0);
#pragma unroll
                for (int k = i; k < B2; ++k) acc += G[UP(i, k)] * G[UP(j, k)];
                S[LOW(i, j)] = S[LOW(i, j)] - acc;
            }
        }

        // In-place Cholesky, column by column, reciprocal pivots.
        real idia[B2];
#pragma unroll
        for (int jj = 0; jj < B2; ++jj) {
            real sdd = S[LOW(jj, jj)];
#pragma unroll
            for (int k = 0; k < jj; ++k) sdd -= S[LOW(jj, k)] * S[LOW(jj, k)];
            const real d = sqrt(sdd);
            S[LOW(jj, jj)] = d;
            idia[jj] = real(1) / d;
#pragma unroll
            for (int i = jj + 1; i < B2; ++i) {
                real sij = S[LOW(i, jj)];
#pragma unroll
                for (int k = 0; k < jj; ++k) sij -= S[LOW(i, k)] * S[LOW(jj, k)];
                S[LOW(i, jj)] = sij * idia[jj];
            }
        }

#pragma unroll
        for (int k = 0; k < T; ++k) cholp[((size_t)t * Tp + k) * B + b] = S[k];
#pragma unroll
        for (int k = T; k < Tp; ++k) cholp[((size_t)t * Tp + k) * B + b] = real(0);

        // G_t = Ml_t C_t^{-T}, upper triangular; Ml has three diagonals:
        // (j, j) = qq, (j, N+j) = qv, (N+j, N+j) = vv.
#pragma unroll
        for (int i = 0; i < B2; ++i) {
#pragma unroll
            for (int j = i; j < B2; ++j) {
                real sij = real(0);
                if (j == i) sij = (i < N) ? ml_qq[i] : ml_vv[i - N];
                if (i < N && j == i + N) sij = ml_qv[i];
#pragma unroll
                for (int k = i; k < j; ++k) sij -= G[UP(i, k)] * S[LOW(j, k)];
                G[UP(i, j)] = sij * idia[j];
            }
        }
        if (gainp != nullptr) {
            real* gout = gainp + ((size_t)t * Tp) * B + b;
#pragma unroll
            for (int k = 0; k < T; ++k)
                gout[(size_t)k * B] = t < W - 1 ? G[k] : real(0);
#pragma unroll
            for (int k = T; k < Tp; ++k) gout[(size_t)k * B] = real(0);
        }
    }
}

// gainp: null for the chol-only form (emit_gain=False).
extern "C" int kkt_factor_launch(const void* coef, const void* rho,
                                 const void* pd, const void* pl, void* cholp,
                                 void* gainp, int W, int B, double sigma,
                                 void* stream) {
    const int grid = (B + LANE_BLOCK - 1) / LANE_BLOCK;
    LANE_LAUNCH(kkt_factor_kernel, grid, LANE_BLOCK, stream,
                (const real*)coef, (const real*)rho, (const real*)pd,
                (const real*)pl, (real*)cholp, (real*)gainp, W, B,
                (real)sigma);
    return LANE_LAST_ERROR();
}
