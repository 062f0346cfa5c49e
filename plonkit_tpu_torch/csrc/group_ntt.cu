// The G1 group NTT's kernels over BN254 (Fq, Jacobian, ec.cuh): K14
// g1_butterfly and K15 g1_scale.  gpu/group_ntt.py drives them (the
// Lagrange form of an SRS, api.crs_lagrange_form) and holds their plain
// PyTorch versions.
//
// They replace no TPU kernel: the JAX package runs its group NTT in host
// python (plonkit_tpu/api.py:99 _group_ntt, one python g1_mul a
// butterfly).  K14 is one radix-2 DIT stage over G1 points: lane i takes
// lo, hi and the stage twiddle w (a canonical Fr value) and writes lo +
// [w]hi and lo - [w]hi.  K15 multiplies every lane by one scalar (the
// transform's 1/n).
//
// Both run one thread a lane and the same ladder: fixed 4-bit windows
// over the scalar's canonical bits, most significant first, over a table
// [d]P for d < 16 that the thread builds with 14 complete adds (T[2] =
// T[1] + P takes add's doubling fallback) and keeps in local memory.  The
// ladder starts at the top non-zero window with the table row of its
// digit, then takes four doublings and one add of T[digit] a window (no
// add for a zero digit).  A scalar of 1 (a twiddle of k = 0) returns P
// without a table.  gpu/group_ntt.py's plain versions run the same steps
// over all lanes at once, so every output limb is theirs.
// What bounds them on the H100: integer multiplies.  A lane is ~252
// doublings (2 products, 5 squarings) and ~74 adds (12 products, 4
// squarings, with the table's and the butterfly's), ~0.69 M multiply
// instructions (264 a product, 208 a squaring) against 416 bytes moved.
// The 4-bit window halves the adds of a 1-bit ladder, and since every
// lane adds in nearly every window, the warps do not diverge on the
// twiddles' bits as a 1-bit ladder's would.  The table (1.5 KB a thread;
// ptxas: 128 registers, a 2,096-byte stack frame, no spills) stays in
// L1/L2: ~8 KB a lane of local traffic.  Measured (chip_smoke.py, H100
// 80GB HBM3 at 700 W): K14 35.5 ms for one stage of 2^19 butterflies, 61 %
// of this ladder's multiply bound but 44 % of what [w]P needs, since
// BN254's endomorphism (GLV) halves the doublings; K15 67.0 ms for 2^20
// points, 64 % / 46 %; the whole 2^20-point transform 0.74 s of device
// time.  A faster group NTT (GLV, a table shared by the lanes of one
// twiddle, a stage per block in shared memory) is later work.
//
// C interface for ctypes, built like field.cu (gpu/build.py): every entry
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include "ec.cuh"

using namespace plonkit;

namespace {

constexpr int kThreads = 128;
constexpr int kWindows = 64;           // 4-bit windows of a 256-bit scalar

__device__ __forceinline__ int window_digit(const Fe& s, int w) {
    return (s.v[w >> 3] >> (4 * (w & 7))) & 15;
}

// [s] p, s canonical little-endian limbs
__device__ Jac scalar_mul(const Jac& p, const Fe& s, const FieldParams& f) {
    int top = kWindows - 1;
    while (top >= 0 && window_digit(s, top) == 0) top--;
    if (top < 0) return jac_infinity();
    if (top == 0 && window_digit(s, 0) == 1) return p;
    Jac table[16];
    table[1] = p;
    for (int d = 2; d < 16; d++) table[d] = jac_add(table[d - 1], p, f);
    Jac acc = table[window_digit(s, top)];
    for (int w = top - 1; w >= 0; w--) {
        for (int k = 0; k < 4; k++) acc = jac_double(acc, f);
        const int d = window_digit(s, w);
        if (d) acc = jac_add(acc, table[d], f);
    }
    return acc;
}

__global__ void g1_butterfly_kernel(const uint32_t* __restrict__ lx,
                                    const uint32_t* __restrict__ ly,
                                    const uint32_t* __restrict__ lz,
                                    const uint32_t* __restrict__ hx,
                                    const uint32_t* __restrict__ hy,
                                    const uint32_t* __restrict__ hz,
                                    const uint32_t* __restrict__ w, uint32_t* __restrict__ ax,
                                    uint32_t* __restrict__ ay, uint32_t* __restrict__ az,
                                    uint32_t* __restrict__ bx, uint32_t* __restrict__ by,
                                    uint32_t* __restrict__ bz, int64_t n, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Jac t = scalar_mul(load_jac(hx, hy, hz, i), load_fe(w, i), f);
    const Jac lo = load_jac(lx, ly, lz, i);
    Jac neg_t = t;
    neg_t.y = fe_sub(fe_zero(), t.y, f);
    store_jac(ax, ay, az, i, jac_add(lo, t, f));
    store_jac(bx, by, bz, i, jac_add(lo, neg_t, f));
}

__global__ void g1_scale_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                                const uint32_t* __restrict__ pz, const uint32_t* __restrict__ s,
                                uint32_t* __restrict__ ox, uint32_t* __restrict__ oy,
                                uint32_t* __restrict__ oz, int64_t n, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    store_jac(ox, oy, oz, i, scalar_mul(load_jac(px, py, pz, i), load_fe(s, 0), f));
}

bool fq_params(FieldParams* f) { return field_params(1, f); }

}  // namespace

extern "C" int plonkit_g1_butterfly(const void* lx, const void* ly, const void* lz,
                                    const void* hx, const void* hy, const void* hz, const void* w,
                                    void* ax, void* ay, void* az, void* bx, void* by, void* bz,
                                    long long n, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    g1_butterfly_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)lx, (const uint32_t*)ly, (const uint32_t*)lz, (const uint32_t*)hx,
        (const uint32_t*)hy, (const uint32_t*)hz, (const uint32_t*)w, (uint32_t*)ax,
        (uint32_t*)ay, (uint32_t*)az, (uint32_t*)bx, (uint32_t*)by, (uint32_t*)bz, (int64_t)n, f);
    return (int)cudaGetLastError();
}

extern "C" int plonkit_g1_scale(const void* px, const void* py, const void* pz, const void* s,
                                void* ox, void* oy, void* oz, long long n, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    g1_scale_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)s,
        (uint32_t*)ox, (uint32_t*)oy, (uint32_t*)oz, (int64_t)n, f);
    return (int)cudaGetLastError();
}
