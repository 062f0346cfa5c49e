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
// Both run one thread a lane and one ladder on BN254's endomorphism (GLV):
// phi(x, y) = (beta x, y) = [lambda](x, y), so [k]P = [k1]P + [k2]phi(P)
// for the split k = k1 + k2 lambda mod r of glv_split (Babai rounding on
// the short basis of curve.py), |k1|, |k2| < 2^126.2 (curve.GLV_BOUND),
// recoded for |k_i| < 2^128: E_i = floor(k_i / 2) + 2^127, whose 32
// nibbles e are the odd signed digits 2e - 15 of k_i + (k_i even).  The
// thread builds P, 3P, ..., 15P (one doubling, 7 complete adds; 768 bytes
// of shared memory), starts from the two top digits' entries, then takes a
// window at a time four doublings and one add for each half, and at the
// end subtracts P (phi(P)) from a half that was even.  The ladder is
// regular: every lane of a warp runs the same operations whatever its
// digits, and a negative digit negates y by a select.  K14 splits its
// twiddle on the card, a lane each; K15's scalar is split and recoded once
// on the host and passed as a kernel argument.  A scalar of 1 (a twiddle
// of k = 0) returns P without a table.  gpu/group_ntt.py's plain versions
// run the same point operations over all lanes at once, so every output
// limb is theirs.
//
// What bounds them on the H100: integer multiplies.  A lane is 125
// doublings (2 products, 5 squarings), 63 adds for the windows, 7 for the
// table and 0-2 for the even halves (12 products, 4 squarings each), 32
// products by beta, ~0.49 M multiply instructions against 416 bytes moved;
// against ~0.69 M for the 4-bit unsigned ladder it replaced.  The point
// formulas are inlined (ec.cuh's *_inline) and the table lives in shared
// memory (96 KB a block of 128 threads: two blocks an SM, as the 180
// registers allow anyway), laid out so that a warp's reads never conflict
// whatever its digits.  ptxas: K14 180 registers and a 328-byte stack
// frame, K15 166 and 232, no spills.  This form was the fastest of those
// timed on 2^19 butterflies (H100 80GB HBM3 at 700 W, PERF.md): 21.7 ms;
// a table of phi's x 22.1; the formulas out of line 22.6; the table in
// local memory 23.2, and 26.4 under a cap of 168 registers (three blocks an
// SM, not two); the unsigned ladder it replaced 35.7.  chip_smoke.py phase
// 3: K14 21.5 ms a stage, K15 40.4 ms for 2^20 points, 59 % and 60 % of the
// least work known for [w]P (GLV with each lane's width-5 NAFs of the
// halves, ~43 adds a lane against the ladder's 64: lanes of distinct
// twiddles cannot share a NAF's irregular adds, which the regular ladder
// pays for; K15's one scalar could take it).
//
// C interface for ctypes, built like field.cu (gpu/build.py): every entry
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include "ec.cuh"

using namespace plonkit;

namespace {

constexpr int kThreads = 128;
constexpr int kWindows = 32;    // 4-bit signed windows of a half, |k_i| < 2^128
constexpr int kTable = 8;       // P, 3P, ..., 15P

// A scalar in the ladder's form: per half E_i = floor(k_i / 2) + 2^127
// (little-endian words) and whether k_i is even; `one` when k = 1.
struct GlvScalar {
    uint32_t e[2][4];
    uint32_t even[2];
    uint32_t one;
};

// beta in Montgomery form over Fq
__device__ __forceinline__ Fe glv_beta() {
    Fe r;
    r.v[0] = 0xd782e155u; r.v[1] = 0x71930c11u; r.v[2] = 0xffbe3323u; r.v[3] = 0xa6bb947cu;
    r.v[4] = 0xd4741444u; r.v[5] = 0xaa303344u; r.v[6] = 0x26594943u; r.v[7] = 0x2c3b3f0du;
    return r;
}

// all NA + NB limbs of a * b
template <int NA, int NB>
__device__ __forceinline__ void mul_wide(const uint32_t (&a)[NA], const uint32_t (&b)[NB],
                                         uint32_t (&o)[NA + NB]) {
#pragma unroll
    for (int j = 0; j < NA + NB; j++) o[j] = 0;
#pragma unroll
    for (int i = 0; i < NA; i++) {
        uint64_t carry = 0;
#pragma unroll
        for (int j = 0; j < NB; j++) {
            const uint64_t t = (uint64_t)a[i] * b[j] + o[i + j] + carry;
            o[i + j] = (uint32_t)t;
            carry = t >> 32;
        }
        o[i + NB] = (uint32_t)carry;
    }
}

// x -= y mod 2^(32 N), y's limbs above N dropped
template <int N, int M>
__device__ __forceinline__ void sub_low(uint32_t (&x)[N], const uint32_t (&y)[M]) {
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
        const uint64_t t = (uint64_t)x[j] - (j < M ? y[j < M ? j : 0] : 0u) - borrow;
        x[j] = (uint32_t)t;
        borrow = (t >> 32) & 1;
    }
}

// round(prod / 2^256) for a product of 8 + NB limbs whose quotient fits NC
template <int NP, int NC>
__device__ __forceinline__ void round_high(const uint32_t (&prod)[NP], uint32_t (&c)[NC]) {
    uint64_t carry = prod[7] >> 31;
#pragma unroll
    for (int j = 0; j < NC; j++) {
        const uint64_t t = (uint64_t)prod[8 + j] + carry;
        c[j] = (uint32_t)t;
        carry = t >> 32;
    }
}

// E = floor(h / 2) + 2^127 and h even, for h in (-2^128, 2^128) as 160-bit
// two's complement
__device__ __forceinline__ void recode_half(const uint32_t (&h)[5], uint32_t (&e)[4],
                                            uint32_t& even) {
#pragma unroll
    for (int j = 0; j < 4; j++) e[j] = __funnelshift_r(h[j], h[j + 1], 1);
    e[3] ^= 0x80000000u;
    even = ~h[0] & 1u;
}

// curve.glv_split of a canonical k < r (the caller's contract: for r <= k <
// 2^256 a half overflows its 128 bits and the point is wrong), recoded: c1 = round(k G1 / 2^256)
// < 2^64, c2 = round(k G2 / 2^256) < 2^127, k1 = k - c1 a1 - c2 a2 and k2 =
// c1 |b1| - c2 b2 (mod 2^160; both halves are under 2^127 in magnitude)
__device__ __forceinline__ GlvScalar glv_split(const Fe& k) {
    const uint32_t g1[3] = {0xc7e0b3d7u, 0xd91d232eu, 0x00000002u};
    const uint32_t g2[5] = {0x391eb18eu, 0x7a7bd9d4u, 0xa773d2cfu, 0x4ccef014u, 0x00000002u};
    const uint32_t a1[2] = {0x94d213e3u, 0x89d32568u};                           // = b2
    const uint32_t a2[4] = {0x1221250bu, 0x0be4e154u, 0xeeb859fdu, 0x6f4d8248u};
    const uint32_t b1[4] = {0x7d4f1128u, 0x8211bbebu, 0xeeb859fcu, 0x6f4d8248u};   // |b1|
    uint32_t p1[11], p2[13], c1[2], c2[4];
    mul_wide(k.v, g1, p1);
    mul_wide(k.v, g2, p2);
    round_high(p1, c1);
    round_high(p2, c2);
    uint32_t h1[5] = {k.v[0], k.v[1], k.v[2], k.v[3], k.v[4]};
    uint32_t t4[4], t8[8], t6[6], u6[6];
    mul_wide(c1, a1, t4);
    mul_wide(c2, a2, t8);
    sub_low(h1, t4);
    sub_low(h1, t8);
    mul_wide(c1, b1, t6);
    mul_wide(c2, a1, u6);
    uint32_t h2[5] = {t6[0], t6[1], t6[2], t6[3], t6[4]};
    sub_low(h2, u6);
    GlvScalar s;
    recode_half(h1, s.e[0], s.even[0]);
    recode_half(h2, s.e[1], s.even[1]);
    s.one = 0;
    return s;
}

__device__ __forceinline__ bool fe_is_one_raw(const Fe& k) {
    uint32_t acc = k.v[0] ^ 1u;
#pragma unroll
    for (int j = 1; j < 8; j++) acc |= k.v[j];
    return acc == 0;
}

__device__ __forceinline__ Fe neg_if(const Fe& y, bool neg, const FieldParams& f) {
    const Fe n = fe_sub(fe_zero(), y, f);
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = neg ? n.v[j] : y.v[j];
    return r;
}

// The table in shared memory: word j of entry i of thread t at
// [(i * 24 + j) * kThreads + t], so the 32 lanes of a warp read 32 banks
// whichever entries they take.  Each thread reads only its own words: no
// barrier.
constexpr int kSmemBytes = kTable * 24 * kThreads * 4;

__device__ __forceinline__ void smem_put(uint32_t* s, int i, const Jac& q) {
    uint32_t* w = s + i * 24 * kThreads + threadIdx.x;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        w[j * kThreads] = q.x.v[j];
        w[(8 + j) * kThreads] = q.y.v[j];
        w[(16 + j) * kThreads] = q.z.v[j];
    }
}

__device__ __forceinline__ Jac smem_get(const uint32_t* s, uint32_t i) {
    const uint32_t* w = s + i * 24 * kThreads + threadIdx.x;
    Jac q;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        q.x.v[j] = w[j * kThreads];
        q.y.v[j] = w[(8 + j) * kThreads];
        q.z.v[j] = w[(16 + j) * kThreads];
    }
    return q;
}

// the next nibble of each half: shift E left by 4, its top nibble then
// window j's digit
__device__ __forceinline__ void next_window(uint32_t (&e)[4]) {
    e[3] = __funnelshift_l(e[2], e[3], 4);
    e[2] = __funnelshift_l(e[1], e[2], 4);
    e[1] = __funnelshift_l(e[0], e[1], 4);
    e[0] <<= 4;
}

// [k]p for a scalar k in the ladder's form (not one), the point formulas
// inlined, phi's x a product at each of the second half's entries
__device__ __forceinline__ Jac glv_mul(const Jac& p, GlvScalar s, const FieldParams& f) {
    extern __shared__ uint32_t table[];
    // the entry of nibble e, the digit 2e - 15: T[e - 8] for e >= 8, else
    // -T[7 - e]; its x times beta in the second half
    auto entry = [&](uint32_t e, bool phi) -> Jac {
        Jac q = smem_get(table, e >= 8 ? e - 8 : 7 - e);
        if (phi) q.x = fe_mont_mul(q.x, glv_beta(), f);
        q.y = neg_if(q.y, e < 8, f);
        return q;
    };
    const Jac d = jac_double_inline(p, f);
    Jac t = p;
    smem_put(table, 0, t);
#pragma unroll 1
    for (int i = 1; i < kTable; i++) {
        t = jac_add_inline(t, d, f);
        smem_put(table, i, t);
    }
    Jac acc = entry(s.e[0][3] >> 28, false);
    acc = jac_add_inline(acc, entry(s.e[1][3] >> 28, true), f);
#pragma unroll 1
    for (int w = kWindows - 2; w >= 0; w--) {
        next_window(s.e[0]);
        next_window(s.e[1]);
#pragma unroll 1
        for (int k = 0; k < 4; k++) acc = jac_double_inline(acc, f);
        acc = jac_add_inline(acc, entry(s.e[0][3] >> 28, false), f);
        acc = jac_add_inline(acc, entry(s.e[1][3] >> 28, true), f);
    }
    // the even halves ran k_i + 1: take off P and phi(P)
    if (s.even[0]) acc = jac_add_inline(acc, entry(7, false), f);
    if (s.even[1]) acc = jac_add_inline(acc, entry(7, true), f);
    return acc;
}

__global__ void __launch_bounds__(kThreads, 1)
g1_butterfly_kernel(const uint32_t* __restrict__ lx, const uint32_t* __restrict__ ly,
                    const uint32_t* __restrict__ lz, const uint32_t* __restrict__ hx,
                    const uint32_t* __restrict__ hy, const uint32_t* __restrict__ hz,
                    const uint32_t* __restrict__ w, uint32_t* __restrict__ ax,
                    uint32_t* __restrict__ ay, uint32_t* __restrict__ az,
                    uint32_t* __restrict__ bx, uint32_t* __restrict__ by,
                    uint32_t* __restrict__ bz, int64_t n, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Fe k = load_fe(w, i);
    Jac t = load_jac(hx, hy, hz, i);
    if (!fe_is_one_raw(k)) t = glv_mul(t, glv_split(k), f);
    const Jac lo = load_jac(lx, ly, lz, i);
    Jac neg_t = t;
    neg_t.y = fe_sub(fe_zero(), t.y, f);
    store_jac(ax, ay, az, i, jac_add_inline(lo, t, f));
    store_jac(bx, by, bz, i, jac_add_inline(lo, neg_t, f));
}

__global__ void __launch_bounds__(kThreads, 1)
g1_scale_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                const uint32_t* __restrict__ pz, uint32_t* __restrict__ ox,
                uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, GlvScalar s, int64_t n,
                FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Jac p = load_jac(px, py, pz, i);
    store_jac(ox, oy, oz, i, s.one ? p : glv_mul(p, s, f));
}

bool fq_params(FieldParams* f) { return field_params(1, f); }

}  // namespace

// w: canonical twiddles, each below r
extern "C" int plonkit_g1_butterfly(const void* lx, const void* ly, const void* lz,
                                    const void* hx, const void* hy, const void* hz, const void* w,
                                    void* ax, void* ay, void* az, void* bx, void* by, void* bz,
                                    long long n, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const long long blocks = (n + kThreads - 1) / kThreads;
    cudaFuncSetAttribute(g1_butterfly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    g1_butterfly_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const uint32_t*)lx, (const uint32_t*)ly, (const uint32_t*)lz, (const uint32_t*)hx,
        (const uint32_t*)hy, (const uint32_t*)hz, (const uint32_t*)w, (uint32_t*)ax,
        (uint32_t*)ay, (uint32_t*)az, (uint32_t*)bx, (uint32_t*)by, (uint32_t*)bz, (int64_t)n, f);
    return (int)cudaGetLastError();
}

// scalar: host words [E1 (4), E2 (4), even1, even2, one] (group_ntt.scale_args)
extern "C" int plonkit_g1_scale(const void* px, const void* py, const void* pz, void* ox,
                                void* oy, void* oz, const void* scalar, long long n,
                                void* stream) {
    FieldParams f;
    if (!fq_params(&f) || n < 0 || scalar == nullptr) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    const uint32_t* a = (const uint32_t*)scalar;
    GlvScalar s;
    for (int h = 0; h < 2; h++)
        for (int j = 0; j < 4; j++) s.e[h][j] = a[4 * h + j];
    s.even[0] = a[8];
    s.even[1] = a[9];
    s.one = a[10];
    const long long blocks = (n + kThreads - 1) / kThreads;
    cudaFuncSetAttribute(g1_scale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         kSmemBytes);
    g1_scale_kernel<<<(unsigned)blocks, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (uint32_t*)ox,
        (uint32_t*)oy, (uint32_t*)oz, s, (int64_t)n, f);
    return (int)cudaGetLastError();
}
