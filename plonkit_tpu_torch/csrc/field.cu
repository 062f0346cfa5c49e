// Elementwise BN254 field kernels: K1 mul, K2a add, K2b sub, K4 mul_add.
//
// Replace plonkit_tpu/tpu/pallas_kernels.py `mul` (_mul_body), `add`
// (_add_body), `sub` (_sub_body) and `mul_add` (_mul_add_body, a * b + c):
// [16, N] 16-bit-limb tiles of 1024
// lanes held in VMEM there, [N, 8] 32-bit-limb rows here, one thread per
// element.
//
// What bounds them on the H100: add and sub move 96 bytes per element
// (two rows in, one out) for a few dozen integer instructions, so they are
// bound by device memory.  mul does 136 32 x 32 -> 64-bit products per
// element (264 32-bit multiply instructions counting low and high halves),
// which at 2^20 elements is near its memory time too.  mul_add moves 128
// bytes (three rows in, one out) for the same product: the pair mul, add
// moved 192 and took two launches.  The design keeps the whole element in
// registers, reads each row as two coalesced 16-byte loads and writes it
// the same way; nothing else touches memory.  Fusing longer chains of these
// launches is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC (gpu/build.py).  C interface for ctypes: every entry
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include "field.cuh"

using namespace plonkit;

namespace {

constexpr int kThreads = 256;

__global__ void mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                           uint32_t* __restrict__ out, int64_t n, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    store_fe(out, i, fe_mont_mul(load_fe(a, i), load_fe(b, i), f));
}

__global__ void add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                           uint32_t* __restrict__ out, int64_t n, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    store_fe(out, i, fe_add(load_fe(a, i), load_fe(b, i), f));
}

__global__ void sub_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                           uint32_t* __restrict__ out, int64_t n, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    store_fe(out, i, fe_sub(load_fe(a, i), load_fe(b, i), f));
}

__global__ void mul_add_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                               const uint32_t* __restrict__ c, uint32_t* __restrict__ out,
                               int64_t n, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    store_fe(out, i, fe_add(fe_mont_mul(load_fe(a, i), load_fe(b, i), f), load_fe(c, i), f));
}

template <typename Kernel>
int launch(Kernel kernel, const void* a, const void* b, void* out, long long n,
           int field, void* stream) {
    FieldParams f;
    if (!field_params(field, &f) || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (int64_t)n, f);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int plonkit_field_mul(const void* a, const void* b, void* out, long long n,
                                 int field, void* stream) {
    return launch(mul_kernel, a, b, out, n, field, stream);
}

extern "C" int plonkit_field_add(const void* a, const void* b, void* out, long long n,
                                 int field, void* stream) {
    return launch(add_kernel, a, b, out, n, field, stream);
}

extern "C" int plonkit_field_sub(const void* a, const void* b, void* out, long long n,
                                 int field, void* stream) {
    return launch(sub_kernel, a, b, out, n, field, stream);
}

extern "C" int plonkit_field_mul_add(const void* a, const void* b, const void* c, void* out,
                                     long long n, int field, void* stream) {
    FieldParams f;
    if (!field_params(field, &f) || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    mul_add_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (const uint32_t*)c, (uint32_t*)out,
        (int64_t)n, f);
    return (int)cudaGetLastError();
}
