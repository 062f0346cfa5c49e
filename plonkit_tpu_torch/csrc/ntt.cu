// K3: radix-2 DIF butterfly over BN254 Fr, one NTT stage per launch:
//     u[i] = lo[i] + hi[i],   v[i] = (lo[i] - hi[i]) * w[i]
// K5: radix-2 DIT butterfly, one inverse-NTT stage per launch (Fr or Fq):
//     t = w[i] * hi[i],   out_lo[i] = lo[i] + t,   out_hi[i] = lo[i] - t
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
// K5 replaces pallas_kernels.py `butterfly` (_butterfly_body), which no JAX
// path calls.  Here it carries every stage of gpu/ntt.py's inverse
// transform, the transpose of the Pease DIF: stage t reads the even rows
// of the buffer as lo and the odd rows as hi (`row_stride` 2: thread i reads
// rows 2i and 2i + 1, 64 contiguous bytes) and writes the two outputs as
// the two halves of the next buffer, so the deinterleave is folded into the
// loads and the stage copies nothing else.  Same bytes and product as K3:
// bound by memory at 2^20 points.  The batched transforms of the 4-step
// NTT (gpu/ntt.py ntt_batched, parallel/ntt.py) keep the transform axis
// outermost, [m, B] rows, so a stage's even and odd rows are blocks of B
// contiguous rows 2B apart: `batch` B makes thread i read row
// (i / B) * row_stride + i % B (B = 1 is the plain transform).
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

namespace {

__global__ void butterfly_dit_kernel(const uint32_t* __restrict__ lo,
                                     const uint32_t* __restrict__ hi,
                                     const uint32_t* __restrict__ w,
                                     uint32_t* __restrict__ out_lo,
                                     uint32_t* __restrict__ out_hi,
                                     int64_t n, int64_t row_stride, int64_t batch,
                                     FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t src = batch == 1 ? i * row_stride : (i / batch) * row_stride + i % batch;
    const Fe a = load_fe(lo, src);
    const Fe t = fe_mont_mul(load_fe(w, i), load_fe(hi, src), f);
    store_fe(out_lo, i, fe_add(a, t, f));
    store_fe(out_hi, i, fe_sub(a, t, f));
}

}  // namespace

// lo and hi: n rows each, in blocks of `batch` contiguous rows whose
// starts are `row_stride` rows apart (batch 1, row_stride 1 = contiguous);
// w, out_lo and out_hi: n contiguous rows.
extern "C" int plonkit_butterfly(const void* lo, const void* hi, const void* w,
                                 void* out_lo, void* out_hi, long long n,
                                 long long row_stride, long long batch, int field,
                                 void* stream) {
    FieldParams f;
    if (!field_params(field, &f) || n < 0 || row_stride < 1 || batch < 1 ||
        (batch > 1 && (n % batch || row_stride < batch)))
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    butterfly_dit_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)lo, (const uint32_t*)hi, (const uint32_t*)w,
        (uint32_t*)out_lo, (uint32_t*)out_hi, (int64_t)n, (int64_t)row_stride,
        (int64_t)batch, f);
    return (int)cudaGetLastError();
}
