// The blocked block-Cholesky step of the wide forms (B2 > 32) of the two
// factors, csrc/tridiag.cu's and csrc/kkt_factor.cu's: one problem a block
// of NTH threads (a whole number of warps), its working matrix M in shared
// memory or, where it does not fit, in a device-memory workspace.
//
// A step factors S_t = D_t - G_{t-1} G_{t-1}' and forms the next gain
// G_t = L_t C_t^{-T} (the KKT factor: Ml_t C_t^{-T}).  Row r of M holds
// [G (P values) | C (P values)], P = B2 rounded up to whole panels of
// WC_NB = 32 columns (the pad rows and columns are the identity in S_t and
// zero in L_t, so they stay out of the real ones), so that both sums of a
// panel of C run over one contiguous stretch of a row:
//   - the Cholesky, left-looking by panels: panel p of C (columns
//     [32p, 32p+32), rows from 32p down) is D_t's minus the products of
//     the rows' [G | C so far] with the panel's own rows' (one register-
//     tiled product, wc_panel_product), then one warp factors the panel's
//     32 x 32 diagonal block in registers with shuffles (wc_tile_factor),
//     then the rows below are solved against it, a thread a row, all rows
//     at once (wc_row_solve): three block barriers a panel, no dependent
//     chain longer than a 32-wide block;
//   - G_t by column panels in place of G_{t-1}: panel J is L_t's minus the
//     rows' G_t so far times C_t's panel rows (the same product), then
//     every row solved against C_t's diagonal block J: two barriers a
//     panel.
// The product tiles a panel's rows x 32 columns as 4 x 8 values a thread
// (the 8 columns c, c + 4, ... so that the four column groups of a warp
// read rows in distinct banks), its sums over k ascending in each thread's
// stretch; where the rows are fewer than the block's threads, the stretch
// of k is split among 2-16 adjacent lanes (chosen pass by pass, for the
// rows left) and their sums added by xor shuffles (the same order on every
// lane, so every launch repeats bit for bit).  Trip counts of the loops
// inside a tile are compile-time; the loops over panels, rows and k are
// rolled, so a build stays quick.
//
// Where the batch leaves SMs idle, the split form puts several blocks on a
// problem, each a chunk of the rows (wc_chunk), one launch a phase of a
// step (the callers' *_split_kernel): a panel's product, its diagonal
// block with the rows below, then every panel of G_t, whose rows depend on
// themselves and C_t alone.  Every block factors the diagonal block in a
// copy of its own (wc_block_factor).
//
// Bound on an H100: operations on paper (~B2^3 multiply-adds a step; bytes
// well below); in practice the products' f32 multiply-adds on the SMs the
// plan gives a problem, the diagonal blocks' chains of 32 pivots (a square
// root, a reciprocal and two shuffles each), and in the split form a
// launch a phase.
#pragma once

#include "lane_platform.cuh"

// Panel width: a warp factors a diagonal block.  The host-emulation tests
// lower it at compile time (-DWC_NB=8), to reach several panels and a
// ragged last one at a few tens of rows.
#ifndef WC_NB
#define WC_NB 32
#endif
static_assert(WC_NB % 8 == 0 && WC_NB <= 32, "a panel: 8-32 columns");
constexpr int WC_NR = WC_NB / 4;  // a thread's columns of a panel
constexpr int WC_KS_MAX = 16;  // lanes that split one tile's sum at most

__host__ __device__ constexpr int wc_pad(int n) {
    return (n + WC_NB - 1) / WC_NB * WC_NB;
}

// rows r in [r0, r1) of a panel's WC_NB columns c: store(r, c, init(r, c)
// - sum_{0 <= k < K} A[r][k] B[c][k]), A[r][k] = m[r * LD + acol + k],
// B[c][k] = m[(brow + c) * LD + bcol + k]; rows at or past P are not read.
// K is a multiple of WC_NB (or 0); every thread of the block calls it.
// INIT_FIRST: a thread reads all its init values before its first store
// (else each value just before its store), the faster on an H100 in some
// builds and the slower in others (the callers say which).
template <int NTH, int LD, int P, bool INIT_FIRST, class Init, class Store>
__device__ __forceinline__ void wc_panel_product(const real* m, int acol,
                                                 int brow, int bcol, int r0,
                                                 int r1, int K, int tid,
                                                 Init init, Store store) {
#pragma unroll 1
    for (int rp = r0; rp < r1;) {
        // The lanes splitting a sum (2^ksl) for the rows left: as many as
        // leave every row of this pass a thread.
        int ksl = 0;
        while (K > 0 && (1 << ksl) < WC_KS_MAX &&
               (NTH >> (ksl + 1)) >= r1 - rp && ((K >> (ksl + 1)) & 3) == 0)
            ++ksl;
        const int KS = 1 << ksl, ks = tid & (KS - 1);
        const int cg = (tid >> ksl) & 3, rg = tid >> (ksl + 2);
        const int kc = K >> ksl, kb = ks * kc;
        const real* bp = m + (size_t)(brow + cg) * LD + bcol + kb;
        const int rb = rp + 4 * rg;
        int ao[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            ao[i] = (rb + i < P ? rb + i : P - 1) * LD + acol + kb;
        real acc[4][WC_NR];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < WC_NR; ++j) acc[i][j] = real(0);
#pragma unroll 1
        for (int k = 0; k < kc; k += 4) {
            real a[4][4], b[WC_NR][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) load4(m + ao[i] + k, a[i]);
#pragma unroll
            for (int j = 0; j < WC_NR; ++j) load4(bp + j * 4 * LD + k, b[j]);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < WC_NR; ++j)
                        acc[i][j] = fma_rn(a[i][kk], b[j][kk], acc[i][j]);
        }
#pragma unroll 1
        for (int s = 1; s < KS; s <<= 1)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < WC_NR; ++j)
                    acc[i][j] = acc[i][j] + lane_tile_shfl_xor(acc[i][j], s);
        if (ks == 0 && INIT_FIRST) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < WC_NR; ++j)
                    acc[i][j] = rb + i < r1 ? init(rb + i, cg + 4 * j) -
                                                  acc[i][j]
                                            : real(0);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = rb + i;
                if (r < r1) {
#pragma unroll
                    for (int j = 0; j < WC_NR; ++j)
                        store(r, cg + 4 * j, acc[i][j]);
                }
            }
        } else if (ks == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int r = rb + i;
                if (r < r1) {
#pragma unroll
                    for (int j = 0; j < WC_NR; ++j) {
                        const int c = cg + 4 * j;
                        store(r, c, init(r, c) - acc[i][j]);
                    }
                }
            }
        }
        rp += NTH >> ksl;
    }
}

// The WC_NB x WC_NB diagonal block at m[row0 * LD + col0], lower
// triangle, in place: C C' of it, the block's first warp calling (lane
// i < WC_NB holding row i in registers, the other lanes in the shuffles
// only), a pivot at a time: its square root broadcast, the column below
// scaled by its reciprocal, the trailing rows updated with the column's
// values from their lanes; rinv[i] = 1 / C[i][i].  A pivot that is not
// positive sets *bad.  The pivots from npiv on are the pad's (the
// identity: its pivots 1, the entries below them 0, exactly), skipped.
template <int LD>
__device__ __forceinline__ void wc_tile_factor(real* m, int row0, int col0,
                                               int lane, real* rinv,
                                               real* bad, int npiv) {
    const bool own = lane < WC_NB;
    real* row = m + (size_t)(row0 + (own ? lane : 0)) * LD + col0;
    real a[WC_NB];
#pragma unroll
    for (int k = 0; k < WC_NB; k += 4) load4(row + k, a + k);
    bool neg = false;
#pragma unroll
    for (int j = 0; j < WC_NB; ++j) {
        if (j >= npiv) {  // uniform across the warp
            if (lane == j) rinv[j] = real(1);
            continue;
        }
        const real s = lane_tile_shfl(a[j], j);
        neg = neg || !(s > real(0));
        const real d = sqrt_rn(s), rd = rcp_rn(d);
        const real l = mul_rn(a[j], rd);
        if (lane == j) rinv[j] = rd;
        a[j] = lane == j ? d : lane > j ? l : a[j];
#pragma unroll
        for (int k = j + 1; k < WC_NB; ++k) {
            const real lk = lane_tile_shfl(l, k);
            if (lane >= k) a[k] = fma_rn(-l, lk, a[k]);
        }
    }
    if (own) {
#pragma unroll
        for (int k = 0; k < WC_NB; k += 4) store4(row + k, a + k);
    }
    if (neg && lane == 0) *bad = real(1);
}

// The diagonal block at blk (rows LD apart) factored by the block's first
// warp: in place (Ts null: one block a problem), or (the split form) from
// tb, the block as its product left it, into this block's copy Ts (rows
// TLD apart), the first block of the problem writing it back into blk,
// its flag at `flag`, the others' at `spare`.
template <int LD, int TLD>
__device__ __forceinline__ void wc_block_factor(real* blk, real* Ts,
                                                const real* tb, int lane,
                                                real* rinv, real* flag,
                                                real* spare, int npiv,
                                                bool first) {
    if (Ts == nullptr) {
        wc_tile_factor<LD>(blk, 0, 0, lane, rinv, flag, npiv);
        return;
    }
    if (lane < WC_NB)
        for (int k = 0; k < WC_NB; k += 4)
            copy4(Ts + lane * TLD + k, tb + lane * TLD + k);
    lane_tile_sync<real>();
    wc_tile_factor<TLD>(Ts, 0, 0, lane, rinv, first ? flag : spare, npiv);
    lane_tile_sync<real>();
    if (first && lane < WC_NB)
        for (int k = 0; k < WC_NB; k += 4)
            copy4(blk + lane * LD + k, Ts + lane * TLD + k);
}

// Rows [r0, r1) cut into cl chunks of whole 4-row pieces: chunk c is
// [a, e).
__device__ __forceinline__ void wc_chunk(int r0, int r1, int c, int cl,
                                         int& a, int& e) {
    const int per = ((r1 - r0 + cl - 1) / cl + 3) / 4 * 4;
    a = r0 + c * per < r1 ? r0 + c * per : r1;
    e = a + per < r1 ? a + per : r1;
}

// Rows r in [r0, r1) (a thread a row): the WC_NB values x at m[r * LD +
// xcol] solved against the lower triangle of the block T (rows TLD apart;
// x T' = b, j ascending, each sum k ascending, then times rinv[j]),
// written back less `poison` and handed to out(r, j, value).  The columns
// from ncols on are the pad's (T the identity there), which would leave
// them as they are: not solved.
template <int NTH, int LD, int TLD, class Out>
__device__ __forceinline__ void wc_row_solve(real* m, int r0, int r1,
                                             int xcol, const real* T,
                                             const real* rinv, real poison,
                                             int ncols, int tid, Out out) {
#pragma unroll 1
    for (int r = r0 + tid; r < r1; r += NTH) {
        // T's loads stay in the row's loop: hoisted out of it (where the
        // compiler sees that no store here reaches T) its 528 values
        // spill.
        lane_compiler_fence();
        real* row = m + (size_t)r * LD + xcol;
        real x[WC_NB];
#pragma unroll
        for (int k = 0; k < WC_NB; k += 4) load4(row + k, x + k);
#pragma unroll
        for (int j = 0; j < WC_NB; ++j) {
            if (j >= ncols) break;  // uniform across the block
            real s = x[j];
#pragma unroll
            for (int k0 = 0; k0 < j; k0 += 4) {
                real tj[4];
                load4(T + j * TLD + k0, tj);
#pragma unroll
                for (int k = k0; k < k0 + 4 && k < j; ++k)
                    s = fma_rn(-x[k], tj[k - k0], s);
            }
            x[j] = mul_rn(s, rinv[j]) - poison;
        }
#pragma unroll
        for (int k = 0; k < WC_NB; k += 4) store4(row + k, x + k);
#pragma unroll
        for (int j = 0; j < WC_NB; ++j) out(r, j, x[j]);
    }
}
