// MSM kernels over BN254 G1 (Fq, Jacobian, ec.cuh): K6 bucket_sweep,
// K7 padd, K8 combine.  gpu/msm.py drives them; gpu/msm_kernels.py holds
// the wrappers and their plain PyTorch versions.
//
// K6 bucket_sweep replaces plonkit_tpu/tpu/msm_pallas.py `sweep_flat`
// (_sweep_flat_body): there one vector lane owns one bucket and walks a
// padded run of u16-packed 64 B rows with unchecked mixed adds, flagging
// degenerate adds and overflowing runs for a host fallback.  Here one
// thread owns one *segment*: at most S consecutive entries of the MSM's
// sorted (window, digit, index) array that lie in one bucket.  The thread
// gathers each entry's 64 B affine row (x || y, Montgomery Fq) by index and
// accumulates with the complete mixed add, then writes one Jacobian segment
// sum.  Segments bound the work per thread whatever the skew (a 0/1
// selector column puts ~n points in one bucket), and the complete add makes
// P + P (which such columns do meet) exact, so there is no flag and no
// fallback.  No atomics: every sum has a fixed order, and two runs give the
// same bytes.
// What bounds it on the H100: 11 Montgomery products per entry (264 32-bit
// multiply instructions each), about 2.3e7 entries at a 2^20 MSM with
// c = 12: integer multiplies, ~4 ms at peak.  Its bytes (the 64 B row plus
// a 4 B index per entry) are ~0.5 ms.  The design keeps the accumulator in
// registers for the whole segment; the gathers are random 64 B rows.
//
// K7 padd replaces msm_pallas.py `padd` (_padd_body, driven by fold_round):
// an elementwise complete Jacobian + Jacobian add, one thread per lane.  It
// serves the fold of segment sums into bucket sums and every round of the
// weighted reduction sum_k k * S_k.  A lane whose partner is infinity only
// copies, so masked rounds cost their bytes (288 B a lane); the ones that
// add cost 16 products.
//
// K8 combine replaces msm_pallas.py `combine` (_combine_body): the window
// totals sum_w 2^(c w) P_w, by Horner from the top window as
// tpu/msm.py:_combine_body (c doublings and one complete add per window).
// One thread: about 250 doublings in sequence, bound by latency.
//
// C interface for ctypes, built like field.cu (gpu/build.py): every entry
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include "ec.cuh"

using namespace plonkit;

namespace {

constexpr int kThreads = 128;

__global__ void bucket_sweep_kernel(const uint32_t* __restrict__ table,
                                    const int32_t* __restrict__ idx,
                                    const int64_t* __restrict__ seg_start,
                                    const int64_t* __restrict__ seg_len,
                                    uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                    uint32_t* __restrict__ oz, int64_t m, FieldParams f) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= m) return;
    const int64_t start = seg_start[t];
    const int64_t len = seg_len[t];
    Jac acc = jac_infinity();
    for (int64_t i = 0; i < len; i++) {
        const int64_t row = idx[start + i];
        // row `row` of the [n, 16] table: x is element 2*row, y 2*row + 1
        const Fe x = load_fe(table, 2 * row);
        const Fe y = load_fe(table, 2 * row + 1);
        acc = jac_add_mixed(acc, x, y, f);
    }
    store_jac(ox, oy, oz, t, acc);
}

__global__ void padd_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                            const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                            const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
                            uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                            uint32_t* __restrict__ oz, int64_t n, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    store_jac(ox, oy, oz, i, jac_add(load_jac(px, py, pz, i), load_jac(qx, qy, qz, i), f));
}

__global__ void combine_kernel(const uint32_t* __restrict__ wx, const uint32_t* __restrict__ wy,
                               const uint32_t* __restrict__ wz, int num_windows, int c,
                               uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                               uint32_t* __restrict__ oz, FieldParams f) {
    if (blockIdx.x != 0 || threadIdx.x != 0) return;
    Jac acc = load_jac(wx, wy, wz, num_windows - 1);
    for (int w = num_windows - 2; w >= 0; w--) {
        for (int k = 0; k < c; k++) acc = jac_double(acc, f);
        acc = jac_add(acc, load_jac(wx, wy, wz, w), f);
    }
    store_jac(ox, oy, oz, 0, acc);
}

bool fq_params(FieldParams* f) { return field_params(1, f); }

}  // namespace

extern "C" int plonkit_bucket_sweep(const void* table, const void* idx, const void* seg_start,
                                    const void* seg_len, void* ox, void* oy, void* oz,
                                    long long m, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || m < 0) return (int)cudaErrorInvalidValue;
    if (m == 0) return (int)cudaGetLastError();
    const long long blocks = (m + kThreads - 1) / kThreads;
    bucket_sweep_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)table, (const int32_t*)idx, (const int64_t*)seg_start,
        (const int64_t*)seg_len, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int64_t)m, f);
    return (int)cudaGetLastError();
}

extern "C" int plonkit_padd(const void* px, const void* py, const void* pz, const void* qx,
                            const void* qy, const void* qz, void* ox, void* oy, void* oz,
                            long long n, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    padd_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,
        (const uint32_t*)qy, (const uint32_t*)qz, (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz,
        (int64_t)n, f);
    return (int)cudaGetLastError();
}

extern "C" int plonkit_combine(const void* wx, const void* wy, const void* wz, int num_windows,
                               int c, void* ox, void* oy, void* oz, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || num_windows < 1 || c < 1) return (int)cudaErrorInvalidValue;
    combine_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)wx, (const uint32_t*)wy, (const uint32_t*)wz, num_windows, c,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, f);
    return (int)cudaGetLastError();
}
