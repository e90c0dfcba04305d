// Batched dense Cholesky factor and fused two-sweep solve, many threads per
// problem.
//
// Replaces the Pallas kernels of osqp_solver_tpu/ops/pallas_dense.py:
// factor_lane_major (body _factor_kernel) and solve_lane_major (body
// _solve_kernel).  M = L L' for the reduced KKT matrix P + sigma I + A' R A of
// each problem of a DenseQP batch.
//
// Layout (batch-trailing, "lane-major"): M and Lt are (n, n, B), rhs and x are
// (n, B); element [i, j, b] sits at (i*n + j)*B + b.  Lt[j] holds column j of
// L: Lt[j, i] = L[i, j] for i >= j, and zero above the diagonal.  n is a
// run-time argument: one build serves every problem size.
//
// Design.  A block takes G adjacent problems and a group of P threads (one or
// more warps) works on each.  One problem's entries lie 4*B bytes apart, so
// the block moves entry (i, j) of its G problems together (G adjacent values,
// one 32-byte sector at G = 8), four entries per thread in flight (cp.async
// into shared memory), and keeps each problem's lower triangle in shared
// memory, packed by columns (column j holds rows j..n-1), with a stride
// padded so that those copies hit distinct banks.  It writes Lt (and x) back
// the same way.  G and P are planned at each launch from n, B, the card's
// shared memory per block (a run-time argument: the host-emulation tests
// pass a small one to reach the other branches) and its SM count (see
// set_plan).  On an H100 (227 KB per block, 132 SMs): n=64, B=1024 runs
// G=8, P=32 in both kernels (128 blocks); n=160, B=256 G=2 with P=128
// (factor) and 32 (solve).
//
// Factor: blocked right-looking, panels of PW = 4 columns (factor_panels).
// The chain of a problem is what bounds it, not the card's rates: the pivots
// are sequential, each an exact sqrt and each column of L an exact divide,
// and a group of one warp sits at its barriers at every step.  A panel
// takes two barriers for four columns; each thread factors the 4 x 4
// diagonal block itself (no barrier for it) and owns rows round-robin, two
// at a time, for the panel solve and the rank-4 update, whose per-entry
// work is one broadcast vector load of the panel row, a load and a store
// for eight multiply-subtracts of a row pair.  The first versions of this
// redesign were a right-looking loop with the trailing triangle dealt out
// entry by entry (three loads and a store per multiply-subtract, and index
// arithmetic per entry) and a left-looking (Crout) loop with two barriers
// per column; both were bound by per-column latency (PERF.md).  A pivot
// that is not positive, or NaN, becomes NaN, so that its column and every
// later one of that problem come out NaN, as the reference's failing
// Cholesky does; no other problem is touched.  When one triangle and its
// panel rows do not fit (n(n+1)/2 + 4n values above the budget: n > 336 in
// float32 on an H100) the same code runs on a packed triangle per problem in
// a device-memory scratch buffer (problem-major, so a group's accesses stay
// contiguous), one block per problem.
//
// Solve: L z = b (forward, column form: the owner of row j divides, a group
// barrier publishes z_j, every thread updates its own rows i > j), then
// L' x = z (backward, column form on the rows of L: x_k published, own rows
// i < k updated).  Rows are owned round-robin (i mod P), so each sweep is one
// barrier per column and needs no reduction and no shuffle.  The group's
// triangle is staged in shared memory when it fits (read once per launch; at
// n=64, B=1024 all triangles, 8.5 MB, stay in the 50 MB L2 across the solves
// of a batch); otherwise L is read from Lt at the point of use.  The
// n-vector lives in shared memory while the group's vectors fit
// (n <= 58,112 at G = 1), else in x itself.
//
// Bound on an H100: bytes on paper (factor: read the lower triangle of M,
// write all of Lt; solve: read the lower triangle of Lt, rhs, write x); in
// practice each problem's chain of dependent steps (sqrt and divides,
// barriers) with only a few warps per SM.  Not used yet: tensor cores
// (mma/wgmma on blocked panels), TMA, and more than one block per problem
// for large n; a later redesign.
#include "lane_platform.cuh"

// Threads per block at most (the plans cap the caller's figure); the factor
// keeps a PW x PW block and two panel rows per thread in registers, within
// the 64 registers a thread has at 1024 threads.
constexpr int DENSE_MAX_THREADS = 1024;

// Offset of column j in a packed column-major lower triangle of order n.
template <class I>
__host__ __device__ __forceinline__ I col_off(int j, int n) {
    return (I)j * n - (I)j * (j - 1) / 2;
}

// Panel width of the factor: PW columns are factored together, then the
// trailing triangle takes one rank-PW update.
constexpr int PW = 4;

// The PanelRows of a problem follow its triangle, aligned for vector loads.
__host__ __device__ __forceinline__ long long panel_off(int n) {
    return ((long long)n * (n + 1) / 2 + PW - 1) / PW * PW;
}

template <bool SMEM> struct Index { typedef long long type; };
template <> struct Index<true> { typedef int type; };

// Entries f = e, e+E, ... of an n x n matrix in row order, (row, column)
// advanced by constant steps; four at a time so that their memory
// operations overlap.
struct FlatWalk {
    int r, c, dr, dc, n;
    __device__ __forceinline__ FlatWalk(int e, int E, int n_)
        : r(e / n_), c(e % n_), dr(E / n_), dc(E % n_), n(n_) {}
    __device__ __forceinline__ void next() {
        r += dr;
        c += dc;
        if (c >= n) { c -= n; ++r; }
    }
};

// Copy the lower triangle of a lane-major matrix (problem b; entry (i, j)
// at (i*si + j*sj)*B + b) into the packed triangle a (entry (i, j), i >= j,
// at col_off(j) + i - j), this thread's entries e, e+E, ... of the square.
// ASYNC: `a` is shared memory and the copies are cp.async, all in flight at
// once (the caller commits and waits); else plain loads and stores.
template <class I, bool ASYNC>
__device__ __forceinline__ void load_lower(const real* __restrict__ src,
                                           real* a, int n, int si, int sj,
                                           int B, int b, int e, int E) {
    FlatWalk f(e, E, n);  // r = j (column of L), c = i (row)
    while (f.r < n) {
        const real* from[4];
        I to[4];
        bool on[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int j = f.r, i = f.c;
            on[u] = j < n && i >= j;
            from[u] = src + ((size_t)i * si + (size_t)j * sj) * B + b;
            to[u] = col_off<I>(j, n) + (i - j);
            f.next();
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (on[u]) {
                if (ASYNC) cp_async4(a + to[u], from[u]);
                else a[to[u]] = *from[u];
            }
    }
}

// Write all of Lt for problem b from the packed triangle a (zeros above the
// diagonal), this thread's entries e, e+E, ... of Lt in row order.
template <class I>
__device__ __forceinline__ void store_lt(const real* a, real* __restrict__ Lt,
                                         int n, int B, int b, int e, int E) {
    FlatWalk f(e, E, n);  // r = j (row of Lt), c = i
    while (f.r < n) {
        real v[4];
        size_t to[4];
        bool on[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int j = f.r, i = f.c;
            on[u] = j < n;
            to[u] = ((size_t)j * n + i) * B + b;
            v[u] = on[u] && i >= j ? a[col_off<I>(j, n) + (i - j)] : real(0);
            f.next();
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (on[u]) Lt[to[u]] = v[u];
    }
}

// PW values of one row of the panel: vector loads.
struct alignas(16) PanelRow {
    real v[PW];
};

// Blocked right-looking Cholesky of one packed triangle `a` by the group g
// of P threads (this thread is q), rows owned round-robin (q, q + P, ...);
// `pb` holds one PanelRow per row.  For each panel of PW columns j0..:
//   A. every thread factors the PW x PW diagonal block itself, in registers
//      (left-looking within the block; an exact sqrt per pivot, a pivot
//      that is not positive or NaN becomes NaN, exact divides);
//   B. each thread solves its rows i below the block for their panel
//      entries u (exact divides), two rows at a time, and writes them to
//      the triangle and to pb[i];  barrier;
//   C. each thread subtracts u_i . u_k (in the order of the columns) from
//      the entries (i, k), k past the panel, of its rows, four columns at a
//      time, u_k read from pb[k] with one vector load; thread 0 writes the
//      block's factor (nobody reads the block now);  barrier.
// Two barriers per panel.  A row pair's update loads, per column, one
// PanelRow (a broadcast) and the two entries, and stores them: 2*PW
// multiply-subtracts for five shared-memory accesses.
template <class I>
__device__ __forceinline__ void factor_panels(real* a, PanelRow* pb, int n,
                                              int q, int P, int g) {
    I c0 = 0;       // col_off(j0)
    int first = q;  // this thread's first row past the panel
    for (int j0 = 0; j0 < n; j0 += PW) {
        const int w = n - j0 < PW ? n - j0 : PW;
        I cc[PW];  // col_off(j0 + c)
        cc[0] = c0;
#pragma unroll
        for (int c = 1; c < PW; ++c) cc[c] = cc[c - 1] + (n - j0 - c + 1);
        // A. The diagonal block (rows and columns j0..j0+w-1).
        real Ld[PW][PW];
#pragma unroll
        for (int r = 0; r < PW; ++r)
#pragma unroll
            for (int c = 0; c <= r; ++c)
                Ld[r][c] = r < w ? a[cc[c] + (r - c)] : real(1);
#pragma unroll
        for (int c = 0; c < PW; ++c) {
            real s = Ld[c][c];
#pragma unroll
            for (int p = 0; p < c; ++p) s = s - Ld[c][p] * Ld[c][p];
            const real d = s > real(0) ? sqrt(s) : real(NAN);
            Ld[c][c] = d;
#pragma unroll
            for (int r = c + 1; r < PW; ++r) {
                real t = Ld[r][c];
#pragma unroll
                for (int p = 0; p < c; ++p) t = t - Ld[r][p] * Ld[c][p];
                Ld[r][c] = t / d;
            }
        }
        // B. Own rows below the block, two at a time (i, i + P).
        while (first < j0 + w) first += P;
        for (int i = first; i < n; i += 2 * P) {
            const bool two = i + P < n;
            const int i1 = two ? i + P : i;
            PanelRow u, u1;
#pragma unroll
            for (int c = 0; c < PW; ++c) {
                real t = real(0), t1 = real(0);
                if (c < w) {
                    t = a[cc[c] + (i - j0 - c)];
                    t1 = a[cc[c] + (i1 - j0 - c)];
#pragma unroll
                    for (int p = 0; p < c; ++p) {
                        t = t - u.v[p] * Ld[c][p];
                        t1 = t1 - u1.v[p] * Ld[c][p];
                    }
                    t = t / Ld[c][c];
                    t1 = t1 / Ld[c][c];
                }
                u.v[c] = t;
                u1.v[c] = t1;
            }
#pragma unroll
            for (int c = 0; c < PW; ++c)
                if (c < w) {
                    a[cc[c] + (i - j0 - c)] = u.v[c];
                    if (two) a[cc[c] + (i1 - j0 - c)] = u1.v[c];
                }
            pb[i] = u;
            if (two) pb[i1] = u1;
        }
        lane_group_sync(g, P);
        // C. Rank-w update of the own rows' entries past the panel.
        if (q == 0) {
#pragma unroll
            for (int r = 0; r < PW; ++r)
#pragma unroll
                for (int c = 0; c <= r; ++c)
                    if (r < w) a[cc[c] + (r - c)] = Ld[r][c];
        }
        const int k0 = j0 + w;
        for (int i = first; i < n; i += 2 * P) {
            const bool two = i + P < n;
            const int i1 = two ? i + P : i;
            const PanelRow u = pb[i], u1 = pb[i1];
            // Columns k..k+3, all loads before the stores; a column past i1
            // is clamped to i1 for its (discarded) loads.
            for (int k = k0; k <= i1; k += 4) {
                int kc[4];
                I cx[4];
                PanelRow v[4];
                real x[4], y[4];
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    kc[e] = k + e <= i1 ? k + e : i1;
                    cx[e] = col_off<I>(kc[e], n) - kc[e];
                    v[e] = pb[kc[e]];
                    x[e] = a[cx[e] + i];
                    y[e] = a[cx[e] + i1];
                }
#pragma unroll
                for (int e = 0; e < 4; ++e) {
#pragma unroll
                    for (int c = 0; c < PW; ++c) {
                        x[e] = x[e] - u.v[c] * v[e].v[c];
                        y[e] = y[e] - u1.v[c] * v[e].v[c];
                    }
                    if (k + e <= i) a[cx[e] + i] = x[e];
                    if (two && k + e <= i1) a[cx[e] + i1] = y[e];
                }
            }
        }
        lane_group_sync(g, P);
        c0 = col_off<I>(k0, n);
    }
}

// SMEM: the triangles in shared memory (stride Tp); else in `scratch`
// (stride Tp = panel_off(n) + PW*n), one problem per block.  Each triangle
// is followed by factor_panels' PanelRow per row.
template <bool SMEM>
__global__ void __launch_bounds__(DENSE_MAX_THREADS)
    dense_factor_kernel(const real* __restrict__ M, real* __restrict__ Lt,
                        real* __restrict__ scratch, int n, int B, int G,
                        int P, long long Tp) {
    typedef typename Index<SMEM>::type I;
    LANE_SMEM_DECL();
    const int tid = threadIdx.x, step = blockDim.x / G;
    const int b0 = blockIdx.x * G;
    real* base = SMEM ? lane_smem : scratch + (size_t)b0 * Tp;
    {  // G adjacent problems per entry: coalesced
        const int g = tid % G, b = b0 + g;
        if (b < B) load_lower<I, SMEM>(M, base + (size_t)g * Tp, n, n, 1, B,
                                       b, tid / G, step);
        cp_async_commit();
        cp_async_wait<0>();
    }
    __syncthreads();
    {
        const int g = tid / P, b = b0 + g;
        if (b < B) {
            real* a = base + (size_t)g * Tp;
            factor_panels<I>(a, (PanelRow*)(a + panel_off(n)), n, tid % P,
                             P, g);
        }
    }
    __syncthreads();
    {
        const int g = tid % G, b = b0 + g;
        if (b < B) store_lt<I>(base + (size_t)g * Tp, Lt, n, B, b, tid / G,
                               step);
    }
}

// The factor of one problem seen by the solve: a packed triangle in shared
// memory, or Lt in device memory.
struct PackedTri {
    const real* a;
    int n;
    __device__ __forceinline__ real operator()(int i, int j) const {
        return a[col_off<int>(j, n) + (i - j)];
    }
};
struct LaneMajorTri {
    const real* Lt;
    int n;
    size_t B;
    int b;
    __device__ __forceinline__ real operator()(int i, int j) const {
        return Lt[((size_t)j * n + i) * B + b];
    }
};
// The vector of one problem in x (stride B).
struct StridedVec {
    real* p;
    size_t s;
    __device__ __forceinline__ real& operator[](int i) const {
        return p[(size_t)i * s];
    }
};

template <class Tri, class Vec>
__device__ __forceinline__ void solve_sweeps(const Tri& L, const Vec& v,
                                             int n, int q, int P, int g) {
    // Forward: z_j = v_j / L_jj by the owner of row j; v_i -= z_j L_ij.
    int own = 0, i0 = q > 0 ? q : P;  // own rows > 0: q, q + P, ...
    for (int j = 0; j < n; ++j) {
        if (own == q) v[j] = v[j] / L(j, j);
        lane_group_sync(g, P);
        const real z = v[j];
        for (int i = i0; i < n; i += P) v[i] = v[i] - z * L(i, j);
        if (++own == P) own = 0;
        if (i0 == j + 1) i0 += P;
    }
    lane_group_sync(g, P);
    // Backward: x_k = v_k / L_kk; v_i -= L_ki x_k for i < k.
    own = (n - 1) % P;
    for (int k = n - 1; k >= 0; --k) {
        if (own == q) v[k] = v[k] / L(k, k);
        lane_group_sync(g, P);
        const real xk = v[k];
        for (int i = q; i < k; i += P) v[i] = v[i] - L(k, i) * xk;
        if (--own < 0) own = P - 1;
    }
}

// STAGED: the triangles in shared memory (stride Tp), then the vectors
// (stride n); VSMEM: the vectors in shared memory, else in x.
template <bool STAGED, bool VSMEM>
__global__ void __launch_bounds__(DENSE_MAX_THREADS)
    dense_solve_kernel(const real* __restrict__ Lt,
                       const real* __restrict__ rhs, real* __restrict__ x,
                       int n, int B, int G, int P, int Tp) {
    LANE_SMEM_DECL();
    const int tid = threadIdx.x, step = blockDim.x / G;
    const int b0 = blockIdx.x * G;
    real* vs = lane_smem + (STAGED ? (size_t)G * Tp : 0);
    {  // G adjacent problems per entry: coalesced
        const int g = tid % G, b = b0 + g;
        if (b < B) {
            if (STAGED)  // L[i, j] = Lt[j, i]
                load_lower<int, true>(Lt, lane_smem + (size_t)g * Tp, n, 1, n,
                                      B, b, tid / G, step);
            for (int i = tid / G; i < n; i += step) {
                const real* from = rhs + (size_t)i * B + b;
                if (VSMEM) cp_async4(vs + (size_t)g * n + i, from);
                else x[(size_t)i * B + b] = *from;
            }
        }
        cp_async_commit();
        cp_async_wait<0>();
    }
    __syncthreads();
    {
        const int g = tid / P, b = b0 + g, q = tid % P;
        if (b < B) {
            if (STAGED)
                solve_sweeps(PackedTri{lane_smem + (size_t)g * Tp, n},
                             vs + (size_t)g * n, n, q, P, g);
            else if (VSMEM)
                solve_sweeps(LaneMajorTri{Lt, n, (size_t)B, b},
                             vs + (size_t)g * n, n, q, P, g);
            else
                solve_sweeps(LaneMajorTri{Lt, n, (size_t)B, b},
                             StridedVec{x + b, (size_t)B}, n, q, P, g);
        }
    }
    if (!VSMEM) return;
    __syncthreads();
    {
        const int g = tid % G, b = b0 + g;
        if (b < B)
            for (int i = tid / G; i < n; i += step)
                x[(size_t)i * B + b] = vs[(size_t)g * n + i];
    }
}

// ---------------------------------------------------------------- planning
static long long padded(long long T, int G) {
    // Stride = 32/G (mod 32): the G problems of a load hit distinct banks.
    return (T + 31) / 32 * 32 + (G > 1 ? 32 / G : 0);
}

static long long tri(int n) { return (long long)n * (n + 1) / 2; }

// Threads per problem: one warp, doubled while a thread would own more
// than `rows` rows (and the block allows).
static int group_threads(int n, int threads, int rows) {
    int P = LANE_WARP;
    while (2 * P <= threads && n > rows * P) P *= 2;
    return P;
}

// plan[0..5] = G, P, triangle stride, shared bytes, branch, blocks.  Factor
// branches: 0 triangles in shared memory, 1 in the scratch buffer.  Solve
// branches: 0 triangles and vectors in shared memory, 1 vectors only,
// 2 neither (the vector in x).  G is the largest <= 8 whose triangles fit
// the budget and whose groups fit the block, as long as the blocks still
// cover 7/8 of the SMs: more problems per block fill more of each 32-byte
// sector of the lane-major loads and stores, but an SM that holds more than
// one block's problems runs each of them slower (on an H100 the factor at
// n=160, B=256 is slower at G=4 than at G=2).
static void set_plan(long long* plan, long long G, long long P, long long Tp,
                     long long bytes, long long branch, long long blocks) {
    const long long p[6] = {G, P, Tp, bytes, branch, blocks};
    for (int k = 0; k < 6; ++k) plan[k] = p[k];
}

static bool spreads(int B, int G, int sms) {
    return G == 1 || 8LL * ((B + G - 1) / G) >= 7LL * sms;
}

static void factor_plan(int n, int B, int budget, int threads, int sms,
                        long long* plan) {
    if (threads > DENSE_MAX_THREADS) threads = DENSE_MAX_THREADS;
    const int P = group_threads(n, threads, 2);
    const long long per = panel_off(n) + (long long)PW * n;
    for (int G = 8; G >= 1; G /= 2) {
        if (G * P > threads || !spreads(B, G, sms)) continue;
        const long long Tp = padded(per, G);
        const long long bytes = G * Tp * (long long)sizeof(real);
        if (bytes > budget) continue;
        return set_plan(plan, G, P, Tp, bytes, 0, (B + G - 1) / G);
    }
    set_plan(plan, 1, P, per, 0, 1, B);
}

static void solve_plan(int n, int B, int budget, int threads, int sms,
                       long long* plan) {
    if (threads > DENSE_MAX_THREADS) threads = DENSE_MAX_THREADS;
    const int P = group_threads(n, threads, 8);
    for (int branch = 0; branch < 2; ++branch)
        for (int G = 8; G >= 1; G /= 2) {
            if (G * P > threads || !spreads(B, G, sms)) continue;
            const long long Tp = branch == 0 ? padded(tri(n), G) : 0;
            const long long bytes = G * (Tp + n) * (long long)sizeof(real);
            if (bytes > budget) continue;
            return set_plan(plan, G, P, Tp, bytes, branch, (B + G - 1) / G);
        }
    set_plan(plan, 1, P, 0, 0, 2, B);
}

// which = 0: factor, 1: solve.
extern "C" void dense_plan(int which, int n, int B, int budget, int threads,
                           int sms, long long* plan) {
    if (which == 0) factor_plan(n, B, budget, threads, sms, plan);
    else solve_plan(n, B, budget, threads, sms, plan);
}

// Shared memory a block may opt into, and the SM count, of `device`.
extern "C" int dense_device_limits(int device, int* out) {
#ifdef LANE_HOST_EMULATION
    (void)device;
    out[0] = LANE_SMEM_MAX_BYTES;
    out[1] = 1;
    return 0;
#else
    const int err = (int)cudaDeviceGetAttribute(
        &out[0], cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != 0) return err;
    return (int)cudaDeviceGetAttribute(&out[1],
                                       cudaDevAttrMultiProcessorCount, device);
#endif
}

// `scratch`: plan branch 1 only, stride * B values.
extern "C" int dense_factor_launch(const void* M, void* Lt, void* scratch,
                                   int n, int B, int budget, int threads,
                                   int sms, void* stream) {
    long long p[6];
    factor_plan(n, B, budget, threads, sms, p);
    const int G = (int)p[0], P = (int)p[1], smem = (int)p[3];
    if (p[4] == 0)
        return lane_launch_coop(&dense_factor_kernel<true>, (int)p[5], G * P,
                                P, smem, stream, (const real*)M, (real*)Lt,
                                (real*)nullptr, n, B, G, P, p[2]);
    if (scratch == nullptr) return -1;
    return lane_launch_coop(&dense_factor_kernel<false>, (int)p[5], P, P, 0,
                            stream, (const real*)M, (real*)Lt, (real*)scratch,
                            n, B, 1, P, p[2]);
}

extern "C" int dense_solve_launch(const void* Lt, const void* rhs, void* x,
                                  int n, int B, int budget, int threads,
                                  int sms, void* stream) {
    long long p[6];
    solve_plan(n, B, budget, threads, sms, p);
    const int G = (int)p[0], P = (int)p[1], Tp = (int)p[2], smem = (int)p[3];
    const int grid = (int)p[5], block = G * P;
    const real* L = (const real*)Lt;
    const real* b = (const real*)rhs;
    real* out = (real*)x;
    if (p[4] == 0)
        return lane_launch_coop(&dense_solve_kernel<true, true>, grid, block,
                                P, smem, stream, L, b, out, n, B, G, P, Tp);
    if (p[4] == 1)
        return lane_launch_coop(&dense_solve_kernel<false, true>, grid, block,
                                P, smem, stream, L, b, out, n, B, G, P, Tp);
    return lane_launch_coop(&dense_solve_kernel<false, false>, grid, block, P,
                            smem, stream, L, b, out, n, B, G, P, Tp);
}
