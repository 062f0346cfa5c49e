// K3: radix-2 DIF butterfly over BN254 Fr, one NTT stage per launch:
//     u[i] = lo[i] + hi[i],   v[i] = (lo[i] - hi[i]) * w[i]
//
// Replaces plonkit_tpu/tpu/pallas_kernels.py `butterfly_dif`
// (_butterfly_dif_body), which tpu/ntt.py runs once per stage of its
// constant-geometry (Pease) NTT.  There the three [16, N/2] inputs are
// 1024-lane VMEM tiles; here they are [N/2, 8] 32-bit-limb rows and one
// thread owns one butterfly.
//
// What bounds it on the H100: 160 bytes per butterfly (three rows in, two
// out) against one Montgomery product (264 32-bit multiply instructions),
// so at 2^20 points it sits near the memory bound.  The design keeps each
// butterfly in registers with coalesced 16-byte row loads and stores; the
// stage's twiddle row is read like any other input, as in the TPU kernel.
// Fusing several stages in shared memory is later work.
//
// C interface for ctypes, built like field.cu (gpu/build.py): launches on
// the given stream, allocates nothing, does not synchronise, returns
// cudaGetLastError().

#include "field.cuh"

using namespace plonkit;

namespace {

constexpr int kThreads = 256;

__global__ void butterfly_dif_kernel(const uint32_t* __restrict__ lo,
                                     const uint32_t* __restrict__ hi,
                                     const uint32_t* __restrict__ w,
                                     uint32_t* __restrict__ u,
                                     uint32_t* __restrict__ v,
                                     int64_t n, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Fe a = load_fe(lo, i);
    const Fe b = load_fe(hi, i);
    store_fe(u, i, fe_add(a, b, f));
    store_fe(v, i, fe_mont_mul(load_fe(w, i), fe_sub(a, b, f), f));
}

}  // namespace

extern "C" int plonkit_butterfly_dif(const void* lo, const void* hi, const void* w,
                                     void* u, void* v, long long n, int field,
                                     void* stream) {
    FieldParams f;
    if (!field_params(field, &f) || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    butterfly_dif_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)lo, (const uint32_t*)hi, (const uint32_t*)w,
        (uint32_t*)u, (uint32_t*)v, (int64_t)n, f);
    return (int)cudaGetLastError();
}
