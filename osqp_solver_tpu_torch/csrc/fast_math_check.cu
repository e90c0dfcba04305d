// A check of lane_common.cuh's sqrt_rn and rcp_rn, the square root and
// reciprocal of the Ruiz and factor kernels: every float x from 2^-100 to
// 2^100 (1.6e9 of them), sqrt_rn(x) against sqrtf(x) and rcp_rn(x) against
// 1.0f / x, bit for bit.  Not part of the solver: chip_smoke.py calls it.
//
// lane_common.cuh needs the layout macros; the helpers checked use none.
#define NDIM 1
#define NX 0
#include "lane_common.cuh"

__global__ void fast_math_check_kernel(unsigned lo, unsigned n,
                                       unsigned long long* bad) {
    unsigned long long mine = 0;
    for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        const float x = __uint_as_float(lo + i);
        mine += (sqrt_rn(x) != sqrtf(x)) + (rcp_rn(x) != 1.0f / x);
    }
    if (mine) atomicAdd(bad, mine);
}

// The mismatches of that check (into *out, on the host); returns the CUDA
// error.
extern "C" int fast_math_mismatches(unsigned long long* out) {
    const unsigned lo = 0x0d800000u, hi = 0x71800000u;  // 2^-100, 2^100
    unsigned long long* bad = nullptr;
    int err = (int)cudaMalloc(&bad, sizeof(*bad));
    if (err == 0) err = (int)cudaMemset(bad, 0, sizeof(*bad));
    if (err == 0) {
        fast_math_check_kernel<<<1024, 256>>>(lo, hi - lo + 1, bad);
        err = (int)cudaGetLastError();
    }
    if (err == 0)
        err = (int)cudaMemcpy(out, bad, sizeof(*bad), cudaMemcpyDeviceToHost);
    if (bad != nullptr) cudaFree(bad);
    return err;
}
