// Modified Ruiz equilibration, all passes in one launch: a group of threads
// per problem, the waypoints of a pass in parallel.
//
// Replaces the Pallas kernel of osqp_solver_tpu/ops/ruiz_pallas.py
// (ruiz_equilibrate_lane_kernel, body _make_kernel): vel-diag P, or with
// -DBLOCK_P=1 generic dense 2N x 2N blocks of P (the reference's block
// branches, ruiz_pallas.py:175-200 and :284-300).
//
// Inputs are absolute values: |coef| (W, CRp, B), |Pd|, |Pl| (W, PNp, B; last
// |Pl| row zero; BLOCK_P: full blocks (W, 2N, 2N, B), the last |Pl| block
// zero), |q| (W, 2N, B).  Outputs: D (W, 2N, B), E (W, Rp, B) (pad rows 1)
// and c (B,), written once at the end.
//
// Each pass is a Jacobi sweep, as the reference computes it: every row and
// column maximum reads the OLD D/E of the neighbouring waypoints, so the new
// D/E of waypoint u depend only on the old D/E of u-1, u and u+1, and all W
// waypoints of a pass are independent.  Only the cost normalisation reduces
// over W: the mean of the limited P column maxima under the NEW D (which
// need the new D of u-1, u and u+1) and the max of |c D q|, with the old c.
// Scaled magnitudes keep the grouping (|a| * e) * d of scale_data and
// ((c d_i) |P_ij|) d_j of the reference.
//
// Design (Hopper).  One thread per problem walked W waypoints per pass, W
// dependent steps, on 32 single-warp blocks (100 of 132 SMs idle at
// B = 1024).  Here:
//   - a group of G threads works on each problem and deals its waypoints out
//     in contiguous runs of rpt (the last run may be shorter); a block holds
//     Q adjacent problems with the problem index fastest among a warp's
//     lanes, so a row's loads and stores of Q problems are adjacent values
//     (16-byte copies of 4 problems where Q >= 4 and the packs allow);
//   - the constant rows (|coef|, |Pd|, |Pl|, |q|) of every waypoint are
//     copied into shared memory once (cp.async) and read from there in every
//     pass; D and E live in shared memory too, [row][waypoint][problem];
//   - a pass: each thread reads the old values it needs of the waypoints
//     just outside its run (D of both neighbours, E of the one before; the
//     D after it into a shared slot of its own), barrier; it rewrites its
//     run's D/E in place, waypoint by waypoint, carrying the old values of
//     the waypoint before in registers; barrier; each thread forms the cost
//     normalisation's terms over its run from the new D; the group sums them
//     (butterfly shuffles within a warp, then one value per warp through
//     shared memory, added in a fixed order by every thread, so all threads
//     of a problem hold the same c); barrier;
//   - neighbour terms that do not exist (u = 0, u = W-1) are zeros that drop
//     out of the maxima, not branches, and the square roots and reciprocals
//     are lane_platform.cuh's branch-free rounded ones (limit_scaling keeps
//     their operands in [1e-4, 1e4]), so a waypoint's loads issue together;
//   - Q, G, rpt and where the rows live are planned at each launch from W,
//     B, the shared memory a block may use and the SM count (ruiz_plan):
//     constants and D/E in shared memory while they fit, else both read and
//     written in device memory (the constants from their packs, D/E in the
//     output arrays), so every W >= 4 runs; on chip, the most problems per
//     block that fit (longer pieces of each row to copy beat shorter runs
//     on the card; PERF.md).
// BLOCK_P: the four 12 x 12 |P| blocks of a waypoint cannot stay on chip, so
// they are read from the packs at the point of use (2 x 59 MB at W=100, N=6,
// B=1024, read several times a pass through L2).
// Above N = 16 (WIDE: 2N > 32) a thread's values of a waypoint (D, E and
// the neighbours' of 2N, R and N rows, and in the block build the 2N x 2N
// blocks' columns) no longer fit in its registers: every loop over them is
// rolled (RUIZ_UNROLL), the arrays live in local memory, and the plan takes
// fewer threads where even the per-thread slots do not fit on chip.
// Bound: the vel-diag build by reading its packs once and writing D/E (the
// passes run on chip); the block build by the |P| block reads.  PERF.md
// records the times.
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "lane_common.cuh"

#ifndef BLOCK_P
#define BLOCK_P 0
#endif

constexpr bool WIDE = B2 > 32;
#if 2 * NDIM > 32
#define RUIZ_UNROLL _Pragma("unroll 1")
#else
#define RUIZ_UNROLL _Pragma("unroll")
#endif

constexpr int PB = B2 * B2;  // entries of one full P block (BLOCK_P packs)

constexpr real MIN_SCALING = real(1e-4);
constexpr real MAX_SCALING = real(1e4);

// Threads per block at most (255 registers a thread), and problems per
// block at most (log2).
constexpr int MAX_THREADS = 256;
constexpr int QLOG_MAX = 3;

// Rows of the state: D (2N) then E (the R real rows; the pad rows are 1).
constexpr int S_D = 0, S_E = B2, SROWS = B2 + R;
// Constant rows kept on chip: |coef| (the CR real rows), the velocity
// diagonals of |Pd| and |Pl| (vel-diag), |q|.
#if BLOCK_P
constexpr int K_CF = 0, K_Q = CR, KROWS = CR + B2;
#else
constexpr int K_CF = 0, K_PD = CR, K_PL = CR + N, K_Q = CR + 2 * N,
              KROWS = CR + 2 * N + B2;
#endif

__host__ __device__ __forceinline__ real limit_scaling(real x) {
    x = x < MIN_SCALING ? real(1) : x;
    return x < MAX_SCALING ? x : MAX_SCALING;
}

// A compiler barrier at the top of a loop's iteration (FENCE): its loads
// are not hoisted above it.  Where they come from device memory (the block
// build's P blocks, the placement without the rows on chip) the
// compiler otherwise issues every iteration's loads at once, each with its
// own address, and runs out of registers.
template <bool FENCE>
__device__ __forceinline__ void hold_loads() {
#ifndef LANE_HOST_EMULATION
    if (FENCE) asm volatile("" ::: "memory");
#endif
}

// The maxima of the scaled magnitudes (non-negative and finite): one
// instruction, where rmax's comparison and select are two.
__device__ __forceinline__ real vmax(real a, real b) { return fmax(a, b); }

// 1 / sqrt(limit(x)), each operation rounded as sqrt() and the division
// round it (limit_scaling keeps x within [1e-4, 1e4]).
__device__ __forceinline__ real inv_sqrt_limit(real x) {
    return rcp_rn(sqrt_rn(limit_scaling(x)));
}

// Row r of waypoint u of one problem: in shared memory ([row][u][Q], I =
// int) or in a (W, rows, B) pack in device memory (I = long long: the
// offset in 64 bits, the strides in 32).
template <class I>
struct View {
    real* p;
    int su, sr;
    __device__ __forceinline__ real& operator()(int u, int r) const {
        return p[(I)u * su + (I)r * sr];
    }
};

// ---------------------------------------------------------------- the plan

struct RuizPlan {
    int G, Q, qlog, rpt, sm, smem, blocks, threads, np;
};

// The plan for at most `threads` a block: the constant rows and D/E in
// shared memory if they fit, else both in device memory; in that placement
// the most problems per block (their rows are adjacent: longer pieces of
// each row to copy); then as many threads as the waypoints need.  WIDE:
// none where even the per-thread slots do not fit in budget.
static RuizPlan ruiz_plan_threads(int W, int B, int budget, int threads,
                                  int sms) {
    for (int sm = 1; sm >= 0; --sm) {
        for (int qlog = QLOG_MAX; qlog >= 0; --qlog) {
            const int Q = 1 << qlog;
            const long long blocks = (B + Q - 1) / Q;
            // A small batch spreads over the SMs.
            if (qlog > 0 && 8 * blocks < 7LL * sms) continue;
            const int L = LANE_WARP / Q > 1 ? LANE_WARP / Q : 1;
            const int gmax = threads / Q / L * L;
            if (gmax < L) continue;
            const int rpt = (W + gmax - 1) / gmax;
            const int runs = (W + rpt - 1) / rpt;
            const int G = (runs + L - 1) / L * L;
            // + the group sums, and the old D of the waypoint after each
            // thread's run.
            const long long vals = (long long)W * Q * (sm ? KROWS + SROWS : 0) +
                                   2LL * (G / L) * Q + (long long)B2 * G * Q;
            const long long bytes = vals * (long long)sizeof(real);
            if (bytes > budget && (sm || WIDE)) continue;
            return RuizPlan{G, Q, qlog, rpt, sm, (int)bytes, (int)blocks,
                            G * Q, G / L};
        }
    }
    return RuizPlan{};
}

// The plan at the build's thread cap (or max_thr); WIDE: fewer threads a
// block until the slots fit.
static RuizPlan ruiz_plan_for(int W, int B, int budget, int max_thr,
                              int sms) {
    int threads =
        max_thr > 0 && max_thr < MAX_THREADS ? max_thr : MAX_THREADS;
    RuizPlan p = ruiz_plan_threads(W, B, budget, threads, sms);
    while (WIDE && p.G == 0 && threads > LANE_WARP)
        p = ruiz_plan_threads(W, B, budget, threads /= 2, sms);
    return p;
}

// --------------------------------------------------------------- the kernel

// SM: the constant rows and D/E in shared memory (else the packs and the
// outputs in device memory).
template <bool SM>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    ruiz_kernel(const real* __restrict__ ac_, const real* __restrict__ apd_,
                const real* __restrict__ apl_, const real* __restrict__ aq_,
                real* Dout, real* Eout, real* c_out, int W, int B, int iters,
                int qlog, int G, int rpt, int x4) {
    using I = typename std::conditional<SM, int, long long>::type;
    LANE_SMEM_DECL();
    const int Q = 1 << qlog, WQ = W * Q;
    const int tid = threadIdx.x, nthreads = G << qlog;
    const int q = tid & (Q - 1), g = tid >> qlog;
    const int b0 = blockIdx.x << qlog, b = b0 + q;
    const bool valid = b < B;
    const size_t Bs = (size_t)B;
    // A warp holds 2^llog lanes of each of its problems.
    int llog = 0;
    while ((1 << (llog + 1)) * Q <= LANE_WARP) ++llog;
    const int np = G >> llog;
    // This thread's run of waypoints (empty for the problems past B).
    const int u0 = g * rpt;
    const int u1 = valid ? (u0 + rpt < W ? u0 + rpt : W) : u0;

    real* ks = lane_smem;
    real* ss = ks + (SM ? KROWS * WQ : 0);
    real* red = ss + (SM ? SROWS * WQ : 0);
    // The old D of the waypoint after this thread's run ([i][thread]): kept
    // here rather than in registers across the run.
    real* nxt = red + 2 * np * Q + tid;

    // ---- the views of this problem's rows
    View<I> cf, aq, D, E;
#if !BLOCK_P
    View<I> pd, pl;
#endif
    if constexpr (SM) {
        cf = {ks + K_CF * WQ + q, Q, WQ};
        aq = {ks + K_Q * WQ + q, Q, WQ};
#if !BLOCK_P
        pd = {ks + K_PD * WQ + q, Q, WQ};
        pl = {ks + K_PL * WQ + q, Q, WQ};
#endif
        D = {ss + S_D * WQ + q, Q, WQ};
        E = {ss + S_E * WQ + q, Q, WQ};
    } else {
        cf = {const_cast<real*>(ac_) + b, CRp * B, B};
        aq = {const_cast<real*>(aq_) + b, B2 * B, B};
#if !BLOCK_P
        pd = {const_cast<real*>(apd_) + b, PNp * B, B};
        pl = {const_cast<real*>(apl_) + b, PNp * B, B};
#endif
        D = {Dout + b, B2 * B, B};
        E = {Eout + b, Rp * B, B};
    }
#if BLOCK_P
    const Pack pdb{apd_, Bs, b}, plb{apl_, Bs, b};
#endif

    // ---- stage the constant rows (row by row: the source is uniform across
    // the block; 16-byte copies of 4 problems where x4); D = E = 1
    const int q4s = x4 ? qlog - 2 : 0;  // log2 of the 4-problem pieces
    if constexpr (SM) {
        for (int row = 0; row < KROWS; ++row) {
            const real* src;
            size_t us;  // waypoint stride of the source pack
            if (row < K_CF + CR) {
                src = ac_ + (size_t)(row - K_CF) * Bs;
                us = (size_t)CRp * Bs;
#if !BLOCK_P
            } else if (row < K_PD + N) {
                src = apd_ + (size_t)(row - K_PD) * Bs;
                us = (size_t)PNp * Bs;
            } else if (row < K_PL + N) {
                src = apl_ + (size_t)(row - K_PL) * Bs;
                us = (size_t)PNp * Bs;
#endif
            } else {
                src = aq_ + (size_t)(row - K_Q) * Bs;
                us = (size_t)B2 * Bs;
            }
            if (x4) {
                for (int k = tid; k < W << q4s; k += nthreads) {
                    const int u = k >> q4s, qq = (k & ((1 << q4s) - 1)) << 2;
                    real* dst = ks + (row * W + u) * Q + qq;
                    if (b0 + qq < B)
                        cp_async_x4(dst, src + u * us + b0 + qq);
                    else
                        dst[0] = dst[1] = dst[2] = dst[3] = real(0);
                }
            } else {
                for (int u = g; u < W; u += G) {
                    real* dst = ks + (row * W + u) * Q + q;
                    if (valid)
                        cp_async4(dst, src + u * us + b);
                    else
                        *dst = real(0);
                }
            }
        }
        cp_async_commit();
        for (int i = tid; i < SROWS * WQ; i += nthreads) ss[i] = real(1);
        cp_async_wait<0>();
    } else if (valid) {
        for (int i = g; i < W * B2; i += G) Dout[(size_t)i * Bs + b] = real(1);
        for (int i = g; i < W * Rp; i += G) Eout[(size_t)i * Bs + b] = real(1);
    }
    __syncthreads();

    real c = real(1);
    for (int it = 0; it < iters; ++it) {
        // ---- 1. the old values this run needs from its neighbours' runs:
        // D (Dv alone for vel-diag P) and the dyn/acc E rows of the waypoint
        // before it, D of the waypoint after it (zero where there is none).
        real pD[B2], pedyn[N], peacc[N];
RUIZ_UNROLL
        for (int i = 0; i < B2; ++i) pD[i] = real(0);
RUIZ_UNROLL
        for (int j = 0; j < N; ++j) pedyn[j] = peacc[j] = real(0);
        if (u0 < u1) {
            if (u0 > 0) {
RUIZ_UNROLL
                for (int i = BLOCK_P ? 0 : N; i < B2; ++i)
                    pD[i] = D(u0 - 1, i);
RUIZ_UNROLL
                for (int j = 0; j < N; ++j) {
                    pedyn[j] = E(u0 - 1, R_DYN + j);
                    peacc[j] = E(u0 - 1, R_ACC + j);
                }
            }
RUIZ_UNROLL
            for (int i = 0; i < B2; ++i)
                nxt[i * nthreads] = u1 < W ? D(u1 < W ? u1 : u0, i) : real(0);
        }
        __syncthreads();

        // ---- 2. new D and E of the run, in place, waypoint by waypoint; the
        // old values of the waypoint before are carried in registers.
        for (int u = u0; u < u1; ++u) {
            // The waypoint before (0 at u = 0, where the carried old values
            // are zero, so that its terms drop out of the maxima without a
            // branch); Dx is zero past the last waypoint.
            const int up = u > 0 ? u - 1 : 0;
            real Du[B2], Dx[B2], ex[NX > 0 ? NX : 1];
RUIZ_UNROLL
            for (int i = 0; i < B2; ++i) {
                Du[i] = D(u, i);
                Dx[i] = u + 1 < u1 ? D(u + 1, i) : nxt[i * nthreads];
            }
RUIZ_UNROLL
            for (int k = 0; k < NX; ++k) ex[k] = E(u, R_X + k);
#if BLOCK_P
            // P column maximum jj of waypoint u (old D / c): the diagonal
            // block, the row maxima of |Pl_{u-1}| under the old D of u-1,
            // and the lower-column term of |Pl_u| with the old D of u+1;
            // formed where it is used, so that no block of them stays live.
            const auto p_colmax = [&](int jj) {
                hold_loads<true>();
                // (Without the constants on chip, each of the three sweeps
                // has its loads to itself.)
                real acc = real(0), accc = real(0), prow = real(0);
RUIZ_UNROLL
                for (int ii = 0; ii < B2; ++ii)
                    acc = vmax(acc, (c * Du[ii]) * pdb(u, PB, ii * B2 + jj));
                hold_loads<!SM>();
RUIZ_UNROLL
                for (int ii = 0; ii < B2; ++ii)
                    accc = vmax(accc, (c * Dx[ii]) * plb(u, PB, ii * B2 + jj));
                hold_loads<!SM>();
RUIZ_UNROLL
                for (int ii = 0; ii < B2; ++ii)
                    prow = vmax(prow, plb(up, PB, jj * B2 + ii) * pD[ii]);
                real pc = acc * Du[jj];
                pc = vmax(pc, prow * (c * Du[jj]));
                return vmax(pc, accc * Du[jj]);
            };
#endif
            // The new D and E of u, written after all of u's reads (a store
            // between them would keep the later loads behind it); the block
            // build, bound by its P reads, writes them as they come and
            // keeps the registers.
            real Dnew[B2], Enew[R];
            const auto put_d = [&](int i, real v) {
                if (BLOCK_P) D(u, i) = v;
                else Dnew[i] = v;
            };
            const auto put_e = [&](int r, real v) {
                if (BLOCK_P) E(u, r) = v;
                else Enew[r] = v;
            };
RUIZ_UNROLL
            for (int j = 0; j < N; ++j) {
                hold_loads<!SM || BLOCK_P>();
                const real dq = Du[j], dv = Du[N + j];
                const real edyn = E(u, R_DYN + j), epos = E(u, R_POS + j);
                const real evel = E(u, R_VEL + j), eacc = E(u, R_ACC + j);
                // Scaled magnitudes of this waypoint's stencil rows.
                const real s_pos = cf(u, C_POS + j) * epos * dq;
                const real s_c2 = cf(u, C_C2 + j) * edyn * dq;
                const real s_c0 = cf(u, C_C0 + j) * edyn * dv;
                const real s_vel = cf(u, C_VEL + j) * evel * dv;
                const real s_a1 = cf(u, C_A1 + j) * eacc * dv;

                // column maxima of waypoint u (A + P, old D / c)
                real cq = vmax(s_pos, s_c2);
                real cv = vmax(vmax(s_vel, s_c0), s_a1);
                cq = vmax(cq, cf(up, C_C1 + j) * pedyn[j] * dq);
                cv = vmax(cv, cf(up, C_A0 + j) * peacc[j] * dv);
RUIZ_UNROLL
                for (int k = 0; k < NX; ++k)
                    cq = vmax(cq, cf(u, C_X + k * N + j) * ex[k] * dq);
#if BLOCK_P
                cq = vmax(cq, p_colmax(j));
                cv = vmax(cv, p_colmax(N + j));
#else
                real pcol = ((c * dv) * pd(u, j)) * dv;
                pcol = vmax(pcol, (pl(up, j) * pD[N + j]) * (c * dv));
                pcol = vmax(pcol, ((c * Dx[N + j]) * pl(u, j)) * dv);
                cv = vmax(cv, pcol);
#endif
                put_d(j, dq * inv_sqrt_limit(cq));
                put_d(N + j, dv * inv_sqrt_limit(cv));

                // row maxima of waypoint u (old D / E)
                real rd = vmax(s_c0, s_c2);
                real ra = s_a1;
                rd = vmax(rd, cf(u, C_C1 + j) * edyn * Dx[j]);
                ra = vmax(ra, cf(u, C_A0 + j) * eacc * Dx[N + j]);
                put_e(R_DYN + j, edyn * inv_sqrt_limit(rd));
                put_e(R_POS + j, epos * inv_sqrt_limit(s_pos));
                put_e(R_VEL + j, evel * inv_sqrt_limit(s_vel));
                put_e(R_ACC + j, eacc * inv_sqrt_limit(ra));
                pedyn[j] = edyn;
                peacc[j] = eacc;
            }
RUIZ_UNROLL
            for (int k = 0; k < NX; ++k) {
                hold_loads<!SM || BLOCK_P>();
                real m = real(0);
RUIZ_UNROLL
                for (int j = 0; j < N; ++j)
                    m = vmax(m, cf(u, C_X + k * N + j) * ex[k] * Du[j]);
                put_e(R_X + k, ex[k] * inv_sqrt_limit(m));
            }
            if (!BLOCK_P) {
RUIZ_UNROLL
                for (int i = 0; i < B2; ++i) D(u, i) = Dnew[i];
RUIZ_UNROLL
                for (int r = 0; r < R; ++r) E(u, r) = Enew[r];
            }
RUIZ_UNROLL
            for (int i = 0; i < B2; ++i) pD[i] = Du[i];
        }
        __syncthreads();

        // ---- 3. cost normalisation terms of the run (new D, old c)
        real gsum = real(0), gqmax = real(0);
        for (int u = u0; u < u1; ++u) {
            // The new D of the waypoints before and after (zero where there
            // is none: their terms drop out of the maxima).
            const bool has_prev = u > 0, has_next = u + 1 < W;
            const int up = has_prev ? u - 1 : u, un = has_next ? u + 1 : u;
            real Dn[B2], Dp[B2], Dx[B2];
RUIZ_UNROLL
            for (int i = 0; i < B2; ++i) {
                Dn[i] = D(u, i);
                const real vp = D(up, i), vn = D(un, i);
                Dp[i] = has_prev ? vp : real(0);
                Dx[i] = has_next ? vn : real(0);
            }
#if BLOCK_P
            real add = real(0);
RUIZ_UNROLL
            for (int jj = 0; jj < B2; ++jj) {
                hold_loads<true>();
                real acc = real(0);
RUIZ_UNROLL
                for (int ii = 0; ii < B2; ++ii)
                    acc = vmax(acc, (c * Dn[ii]) * pdb(u, PB, ii * B2 + jj));
                real pc = acc * Dn[jj];
                real r = real(0), accc = real(0);
                hold_loads<!SM>();
RUIZ_UNROLL
                for (int jx = 0; jx < B2; ++jx)
                    r = vmax(r, plb(up, PB, jj * B2 + jx) * Dp[jx]);
                pc = vmax(pc, r * (c * Dn[jj]));
                hold_loads<!SM>();
RUIZ_UNROLL
                for (int ii = 0; ii < B2; ++ii)
                    accc = vmax(accc, (c * Dx[ii]) * plb(u, PB, ii * B2 + jj));
                pc = vmax(pc, accc * Dn[jj]);
                add = add + limit_scaling(pc);
            }
#else
            // q columns carry no P entry and add limit(0) = 1 each.
            real add = real(N);
RUIZ_UNROLL
            for (int j = 0; j < N; ++j) {
                hold_loads<!SM>();
                const real dv = Dn[N + j];
                real pc = ((c * dv) * pd(u, j)) * dv;
                pc = vmax(pc, (pl(up, j) * Dp[N + j]) * (c * dv));
                pc = vmax(pc, ((c * Dx[N + j]) * pl(u, j)) * dv);
                add = add + limit_scaling(pc);
            }
#endif
            gsum = gsum + add;
            real qadd = real(0);
RUIZ_UNROLL
            for (int i = 0; i < B2; ++i) qadd = vmax(qadd, (c * Dn[i]) * aq(u, i));
            gqmax = vmax(gqmax, qadd);
        }

        // ---- 4. the group's sum and max: within the warp (lanes of one
        // problem are Q apart), then one value per warp, every thread adding
        // them in the same order.
        for (int m = Q; m < LANE_WARP; m <<= 1) {
            gsum = gsum + lane_shfl_xor(gsum, m, tid / LANE_WARP, LANE_WARP);
            gqmax = vmax(gqmax,
                         lane_shfl_xor(gqmax, m, tid / LANE_WARP, LANE_WARP));
        }
        if ((g & ((1 << llog) - 1)) == 0) {
            red[(g >> llog) * Q + q] = gsum;
            red[(np + (g >> llog)) * Q + q] = gqmax;
        }
        __syncthreads();
        real s = real(0), mx = real(0);
        for (int k = 0; k < np; ++k) {
            s = s + red[k * Q + q];
            mx = vmax(mx, red[(np + k) * Q + q]);
        }
        c = c * (real(1) / limit_scaling(vmax(s / real(W * B2), mx)));
    }

    // ---- D, E (pad rows 1) and c out
    if constexpr (SM) {
        if (x4) {
            for (int row = 0; row < B2 + Rp; ++row) {
                real* dst = row < B2 ? Dout + (size_t)row * Bs
                                     : Eout + (size_t)(row - B2) * Bs;
                const size_t us = (size_t)(row < B2 ? B2 : Rp) * Bs;
                const real* src = ss + (row < B2 ? S_D + row : S_E + row - B2) * WQ;
                for (int k = tid; k < W << q4s; k += nthreads) {
                    const int u = k >> q4s, qq = (k & ((1 << q4s) - 1)) << 2;
                    if (b0 + qq >= B) continue;
                    if (row < B2 + R)
                        copy4(dst + u * us + b0 + qq, src + u * Q + qq);
                    else
                        fill4(dst + u * us + b0 + qq, real(1));
                }
            }
        } else if (valid) {
            for (int u = g; u < W; u += G) {
RUIZ_UNROLL
                for (int i = 0; i < B2; ++i)
                    Dout[((size_t)u * B2 + i) * Bs + b] = D(u, i);
RUIZ_UNROLL
                for (int r = 0; r < Rp; ++r)
                    Eout[((size_t)u * Rp + r) * Bs + b] =
                        r < R ? E(u, r) : real(1);
            }
        }
    }
    if (valid && g == 0) c_out[b] = c;
}

// plan[0..8] = threads per problem G, problems per block Q, waypoints per
// thread rpt, constants and D/E in shared memory (0/1), shared bytes,
// blocks, threads per block, partial sums per problem, and the shared bytes
// planned for: the plan ruiz_launch makes on the current device.  budget <=
// 0: the device's; threads <= 0: the build's own cap (the host-emulation
// tests pass fewer, and a small budget, to reach runs of several waypoints
// and the placement in device memory).  Returns -1 where no plan fits the
// device's shared memory (ruiz_launch refuses it too).
extern "C" int ruiz_plan(int W, int B, int budget, int threads,
                         long long* plan) {
    int dev_smem = 0, sms = 0;
    const int err = lane_device_limits(&dev_smem, &sms);
    if (err != 0) return err;
    if (budget <= 0) budget = dev_smem;
    const RuizPlan p = ruiz_plan_for(W, B, budget, threads, sms);
    const long long v[9] = {p.G,      p.Q,       p.rpt, p.sm,  p.smem,
                            p.blocks, p.threads, p.np,  budget};
    for (int k = 0; k < 9; ++k) plan[k] = v[k];
    return p.G == 0 || p.smem > dev_smem ? -1 : 0;
}

// D (W, 2N, B), E (W, Rp, B), c (B,) are written whole.  budget, threads:
// as ruiz_plan (<= 0: the device's, the build's own cap).
extern "C" int ruiz_launch(const void* ac, const void* apd, const void* apl,
                           const void* aq, void* D, void* E, void* c_out,
                           int W, int B, int iters, int budget, int threads,
                           void* stream) {
    int dev_smem = 0, sms = 0;
    const int err = lane_device_limits(&dev_smem, &sms);
    if (err != 0) return err;
    if (budget <= 0) budget = dev_smem;
    const RuizPlan p = ruiz_plan_for(W, B, budget, threads, sms);
    // A pack's waypoint stride (rows x B) is a 32-bit int in the kernel.
    const int rows = CRp > Rp ? CRp : Rp;
    if (p.G == 0 || p.smem > dev_smem || (long long)rows * B > 0x7fffffffLL)
        return -1;
    // 16-byte copies of 4 problems: whole pieces of every row (B a multiple
    // of 4, at least 4 problems a block) at 16-byte aligned addresses.
    uintptr_t bits = 0;
    for (const void* ptr : {ac, apd, apl, aq, (const void*)D, (const void*)E})
        bits |= (uintptr_t)ptr;
    const int x4 = p.Q >= 4 && B % 4 == 0 && bits % 16 == 0;
#define LANE_RUIZ_ARGS                                                        \
    (const real*)ac, (const real*)apd, (const real*)apl, (const real*)aq,     \
        (real*)D, (real*)E, (real*)c_out, W, B, iters, p.qlog, p.G, p.rpt, x4
    if (p.sm)
        return lane_launch_coop(&ruiz_kernel<true>, p.blocks, p.threads,
                                LANE_WARP, p.smem, stream, LANE_RUIZ_ARGS);
    return lane_launch_coop(&ruiz_kernel<false>, p.blocks, p.threads,
                            LANE_WARP, p.smem, stream, LANE_RUIZ_ARGS);
#undef LANE_RUIZ_ARGS
}
