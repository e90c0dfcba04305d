// A check of lane_platform.cuh's sqrt_rn, rcp_rn and div_rn, the square
// root, reciprocal and division of the Ruiz, factor and tridiagonal-solve
// kernels, bit for bit against sqrtf, 1.0f / x and the division: every float
// x from 2^-100 to 2^100 (1.6e9 of them) for sqrt_rn and rcp_rn, and as a
// divisor for div_rn with DIVIDENDS dividends each (both signs, exponents
// from -24 to 23, mantissas from a hash of x), and the zeros.  Not part of
// the solver: chip_smoke.py calls it.
#include <initializer_list>

#include "lane_platform.cuh"

constexpr int DIVIDENDS = 8;

// A hash of an index (for the dividends' bits).
__device__ __forceinline__ unsigned mix(unsigned v) {
    v ^= v >> 16;
    v *= 0x7feb352du;
    v ^= v >> 15;
    v *= 0x846ca68bu;
    return v ^ (v >> 16);
}

__global__ void fast_math_check_kernel(unsigned lo, unsigned n,
                                       unsigned long long* bad) {
    unsigned long long mine = 0, mine_div = 0;
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        const float x = __uint_as_float(lo + i);
        mine += (sqrt_rn(x) != sqrtf(x)) + (rcp_rn(x) != 1.0f / x);
        const float rx = rcp_rn(x);
        for (int k = 0; k < DIVIDENDS; ++k) {
            const unsigned h = mix(i * DIVIDENDS + k);
            // sign, exponent 103..150 (2^-24..2^23), 23 mantissa bits
            const unsigned e = 103u + (h >> 23) % 48u;
            const float a = __uint_as_float((h & 0x80000000u) | (e << 23) |
                                            (h & 0x7fffffu));
            mine_div += div_rn(a, x, rx) != a / x;
        }
        for (const float a : {0.0f, -0.0f})  // bit for bit: the zero's sign
            mine_div += __float_as_uint(div_rn(a, x, rx)) !=
                        __float_as_uint(a / x);
    }
    if (mine) atomicAdd(bad, mine);
    if (mine_div) atomicAdd(bad + 1, mine_div);
}

// The mismatches of that check (out[0]: sqrt_rn and rcp_rn, out[1]: div_rn;
// on the host); returns the CUDA error.
extern "C" int fast_math_mismatches(unsigned long long* out) {
    const unsigned lo = 0x0d800000u, hi = 0x71800000u;  // 2^-100, 2^100
    unsigned long long* bad = nullptr;
    int err = (int)cudaMalloc(&bad, 2 * sizeof(*bad));
    if (err == 0) err = (int)cudaMemset(bad, 0, 2 * sizeof(*bad));
    if (err == 0) {
        fast_math_check_kernel<<<1024, 256>>>(lo, hi - lo + 1, bad);
        err = (int)cudaGetLastError();
    }
    if (err == 0)
        err = (int)cudaMemcpy(out, bad, 2 * sizeof(*bad),
                              cudaMemcpyDeviceToHost);
    if (bad != nullptr) cudaFree(bad);
    return err;
}
