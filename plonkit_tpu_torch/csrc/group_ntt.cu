// The G1 group NTT's kernels over BN254 (Fq, Jacobian, ec.cuh): K14
// g1_butterfly, K15 g1_scale and K16 g1_points_in.  gpu/group_ntt.py
// drives them (the Lagrange form of an SRS, api.crs_lagrange_form) and
// holds their plain PyTorch versions.
//
// They replace no TPU kernel: the JAX package runs its group NTT in host
// python (plonkit_tpu/api.py:99 _group_ntt, one python g1_mul a
// butterfly).  K14 is one radix-2 DIT stage over G1 points: lane i takes
// lo, hi and the stage twiddle w (a canonical Fr value) and writes lo +
// [w]hi and lo - [w]hi.  Its lo and hi rows lie `stride` rows apart, so a
// stage reads the even and odd rows of one buffer in place (stride 2) and
// writes the two halves of another.  K15 multiplies every lane by one
// scalar (the transform's 1/n).
//
// Both run one thread a lane and one ladder on BN254's endomorphism (GLV):
// phi(x, y) = (beta x, y) = [lambda](x, y), so [k]P = [k1]P + [k2]phi(P)
// for the split k = k1 + k2 lambda mod r of glv_split (Babai rounding on
// the short basis of curve.py), |k1|, |k2| < 2^126.2 (curve.GLV_BOUND),
// recoded for |k_i| < 2^128: E_i = floor(k_i / 2) + 2^127, whose 32
// nibbles e are the odd signed digits 2e - 15 of k_i + (k_i even).  The
// lane builds P, 3P, ..., 15P (one doubling, 7 complete adds; 768 bytes
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
// A lane runs on g = 1, 2 or 4 sub-groups of S = 1 or 2 threads of one
// warp, which gpu/group_ntt.lane_group and product_split pick from the
// launch's lanes and the card's SMs.  One thread runs ec.cuh's formulas.
// In a group of more, every thread holds the lane's points and does its
// field adds, and each level of a formula's independent products is dealt
// out over the sub-groups, a product a sub-group (its operands picked by a
// tree of selects on its rank), the products brought back to the whole
// group by warp shuffles: add-2007-bl's 16 products (17 with phi's beta x)
// in 5 levels, dbl-2009-l's 7 in 3.  A lane's ladder is then ~740 rounds
// of one product where one thread runs ~2,075 products in turn.  A
// sub-group of two splits each of its products (split_mont_mul, below):
// each thread runs half of the product's 64-bit multiply-adds.  The
// group's threads hold the same values and take the same branches; a
// warp's lanes take one path (every shuffle names the whole warp, see
// Group), and a lane's table is written once, each thread a share of its
// words, with one __syncwarp before it is read.
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
// frame, K15 166 and 232, no spills (g = 1; at g = 4, 24 KB of table a
// block, 180 and 288, 148 and 192).  This form was the fastest of those
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
// At few lanes the bound is one lane's chain instead.  Below 32 lanes a
// warp scheduler (528 on the H100's 132 SMs: 16,896 lanes) a thread a lane
// leaves schedulers without a warp, and a stage lasts one lane's ladder:
// the 2^12 Lagrange key's 2^11-lane stages ran 16 blocks on 16 SMs, 1.05
// ms a stage.  On groups of 4 they run 256 warps, 0.46 ms a stage (K15 on
// the key's 2^12 points 1.04 -> 0.45 ms).  Where a thread a lane already
// gives every scheduler a warp the group's shuffles and selects only add
// instructions (2^16 lanes: 2.70 ms at g = 1, 4.18 at g = 2).  Below,
// lane_group takes the smallest group that gives every scheduler a warp,
// the fastest at every lane count timed (the crossover, PERF.md).
//
// At g = 4 a round is one Montgomery product on each thread, and one warp
// a scheduler runs it as one dependent chain: a product took 837 cycles
// there (two independent ones on one thread 1,672, in turn; two warps a
// scheduler 572 each), so a round waits on its chain, not on the card's
// multiply rate.  The split halves the chain each thread runs.  Forms timed (H100 80GB HBM3 at 700 W,
// PERF.md; cycles a product in chains at one warp a scheduler, then K14
// at 2^11 lanes in ms): one thread 837; two threads each moving a
// six-word window a limb a step 766 (ptxas spends ~100 moves a product
// re-pairing the multiply-adds' 64-bit registers); split_mont_mul's
// even/odd window 596 (a g = 4 round 995 -> 798).  K14 with shuffles of
// the group's mask (WARPSYNC.COLLECTIVE around each) 0.475 -> 0.431 ms;
// with whole-warp shuffles 0.449 (g = 4) -> 0.410 (split), against 0.469
// before both.  A thread's share of a split product is ~210 instructions
// in 9 steps, 72 of them 64-bit multiply-adds, against one thread's ~180
// and 136; the operand selects, shuffles and field adds that every thread
// of a lane repeats add ~150-200 a round.  Where the split's warps
// would double up on the schedulers it loses (2^12 lanes: 0.455 -> 0.582
// ms), so product_split splits only where 8 threads a lane still give
// each scheduler at most one warp.
// ptxas: at g = 4, S = 2 K14 186 registers and a 288-byte stack frame,
// K15 152 and 192, no spills, 12 KB of table a block of 128 threads.
//
// C interface for ctypes, built like field.cu (gpu/build.py): every entry
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError().

#include <type_traits>

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

__device__ __forceinline__ Fe fe_select(bool c, const Fe& a, const Fe& b) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = c ? a.v[j] : b.v[j];
    return r;
}

__device__ __forceinline__ Fe neg_if(const Fe& y, bool neg, const FieldParams& f) {
    return fe_select(neg, fe_sub(fe_zero(), y, f), y);
}

// A lane's ladder on a group of G S threads of one warp: G sub-groups (G =
// 1, 2 or 4) of S threads (S = 1 or 2), the wrapper's choice.  Every thread
// of the group holds the lane's points and does its adds and subtractions,
// and each level of a point formula's independent Montgomery products is
// dealt out over the sub-groups, a product a sub-group, its results brought
// back to every thread of the group by warp shuffles; a sub-group of two
// splits its product (split_mont_mul).  The group's threads take the same
// branches (they hold the same values).  Every shuffle names the whole warp
// (kWarp): with a mask of the group alone ptxas wraps each shuffle in a
// WARPSYNC.COLLECTIVE sequence, whose moves and barriers made a third of a
// group kernel's instructions.  So the group kernels keep each warp on one
// path: a branch that differs between lanes is taken by the whole warp
// when any lane needs it (__any_sync), its result kept by the lanes that
// do, and lanes past the launch's end run the last lane and store nothing.
constexpr uint32_t kWarp = 0xffffffffu;

template <int G, int S>
struct Group {
    uint32_t rank;     // this thread's sub-group
    uint32_t srank;    // this thread's place in its sub-group
    uint32_t p[4];     // with S = 2: the modulus' limbs 4 srank ... 4 srank + 3
};

template <int G, int S>
__device__ __forceinline__ Group<G, S> this_group(const FieldParams& f) {
    const uint32_t lane = threadIdx.x & 31u;
    const uint32_t at = lane & (G * S - 1);
    Group<G, S> g;
    g.rank = at / S;
    g.srank = at % S;
#pragma unroll
    for (int j = 0; j < 4; j++) g.p[j] = S == 2 && g.srank ? f.p[4 + j] : f.p[j];
    return g;
}

// a from thread src of the group's T = G S threads
template <int T>
__device__ __forceinline__ Fe shfl_fe(const Fe& a, uint32_t src) {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = __shfl_sync(kWarp, a.v[j], src, T);
    return r;
}

// The split product: a * b * 2^-256 mod p on a sub-group of two threads,
// fe_mont_mul's CIOS rows over b's limbs run as a two-stage pipeline.  The
// thread of srank r holds a's and p's limbs 4r ... 4r + 3 and a window of
// the running sum in fe_mont_mul's even/odd form (x, six words at the
// window's base, and y, six words one limb up, each shifted two limbs at a
// time so that ptxas keeps every carry chain in its 64-bit register
// pairs); it runs row i at step i + r, so a step's chains are 4 limbs long
// and no thread waits on a shuffle of the same step.  Thread 0 makes m_i
// from the window's lowest word and passes it up, and thread 1 uses it a
// step later; thread 1 hands the lowest word of its window down as it
// leaves it, and thread 0 adds it two limbs up a step later, before it is
// the lowest word there.  After nine steps thread 0's window is limbs 0-6
// of the sum and thread 1's limbs 3-9; both threads add the two and
// subtract p once, so each returns fe_mont_mul's value.  A step costs each
// thread four 64-bit multiply-adds with a's limbs and four with p's, where
// one thread's row takes eight of each, plus two shuffles and a few adds.

// x[0] += y[1]; y = (y >> 64) + (A1, A3) * b, its carry in y[4]
__device__ __forceinline__ void split_shift_odd(uint32_t (&x)[6], uint32_t (&y)[6], uint32_t a1,
                                                uint32_t a3, uint32_t b) {
    asm("add.cc.u32 %0, %0, %2;\n\t"
        "madc.lo.cc.u32 %1, %7, %9, %3;\n\t"
        "madc.hi.cc.u32 %2, %7, %9, %4;\n\t"
        "madc.lo.cc.u32 %3, %8, %9, %5;\n\t"
        "madc.hi.cc.u32 %4, %8, %9, %6;\n\t"
        "addc.u32 %5, 0, 0;"
        : "+r"(x[0]), "+r"(y[0]), "+r"(y[1]), "+r"(y[2]), "+r"(y[3]), "+r"(y[4]), "+r"(y[5])
        : "r"(a1), "r"(a3), "r"(b));
    y[5] = 0;
}

// x[0..4] += c0 * b + c2 * b * 2^64
__device__ __forceinline__ void split_mad(uint32_t (&x)[6], uint32_t c0, uint32_t c2, uint32_t b) {
    asm("mad.lo.cc.u32 %0, %5, %7, %0;\n\t"
        "madc.hi.cc.u32 %1, %5, %7, %1;\n\t"
        "madc.lo.cc.u32 %2, %6, %7, %2;\n\t"
        "madc.hi.cc.u32 %3, %6, %7, %3;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4])
        : "r"(c0), "r"(c2), "r"(b));
}

// x[2..4] += h
__device__ __forceinline__ void split_add2(uint32_t (&x)[6], uint32_t h) {
    asm("add.cc.u32 %0, %0, %3;\n\t"
        "addc.cc.u32 %1, %1, 0;\n\t"
        "addc.u32 %2, %2, 0;"
        : "+r"(x[2]), "+r"(x[3]), "+r"(x[4])
        : "r"(h));
}

// step T of the pipeline, x the even half of the window and y the odd one:
// thread 0 runs row T (none at T = 8), thread 1 row T - 1 (none at T = 0)
template <int T>
__device__ __forceinline__ void split_step(uint32_t (&x)[6], uint32_t (&y)[6],
                                           const uint32_t (&A)[4], const uint32_t (&P)[4],
                                           const Fe& b, uint32_t srank, uint32_t n0,
                                           uint32_t& m_in, uint32_t& h_in) {
    const uint32_t b0 = T < 8 ? b.v[T < 8 ? T : 0] : 0u;
    const uint32_t b1 = T > 0 ? b.v[T > 0 ? T - 1 : 0] : 0u;
    const uint32_t w = srank ? b1 : b0;
    split_shift_odd(x, y, A[1], A[3], w);
    split_mad(x, A[0], A[2], w);
    const uint32_t m = srank ? m_in : (T < 8 ? x[0] * n0 : 0u);
    split_mad(y, P[1], P[3], m);
    split_mad(x, P[0], P[2], m);
    split_add2(x, h_in);
    if (T < 8) {
        h_in = __shfl_xor_sync(kWarp, x[0], 1);    // thread 0's x[0] is 0 here
        m_in = __shfl_xor_sync(kWarp, m, 1);
    }
}

template <int T>
__device__ __forceinline__ void split_steps(uint32_t (&e)[6], uint32_t (&o)[6],
                                            const uint32_t (&A)[4], const uint32_t (&P)[4],
                                            const Fe& b, uint32_t srank, uint32_t n0,
                                            uint32_t& m_in, uint32_t& h_in) {
    if constexpr (T <= 8) {
        if constexpr (T % 2 == 0) split_step<T>(e, o, A, P, b, srank, n0, m_in, h_in);
        else split_step<T>(o, e, A, P, b, srank, n0, m_in, h_in);
        split_steps<T + 1>(e, o, A, P, b, srank, n0, m_in, h_in);
    }
}

template <int G, int S>
__device__ __forceinline__ Fe split_mont_mul(const Fe& a, const Fe& b, const Group<G, S>& g,
                                             const FieldParams& f) {
    uint32_t A[4];
#pragma unroll
    for (int j = 0; j < 4; j++) A[j] = g.srank ? a.v[4 + j] : a.v[j];
    uint32_t e[6] = {0, 0, 0, 0, 0, 0}, o[6] = {0, 0, 0, 0, 0, 0};
    uint32_t m_in = 0, h_in = 0;
    split_steps<0>(e, o, A, g.p, b, g.srank, f.n0, m_in, h_in);
    // w = e + o * 2^32: thread 0's is limbs 0-6 of the result, thread 1's 3-9
    uint32_t w[7];
    asm("add.cc.u32 %0, %6, %11;\n\t"
        "addc.cc.u32 %1, %7, %12;\n\t"
        "addc.cc.u32 %2, %8, %13;\n\t"
        "addc.cc.u32 %3, %9, %14;\n\t"
        "addc.cc.u32 %4, %10, %15;\n\t"
        "addc.u32 %5, 0, 0;"
        : "=r"(w[1]), "=r"(w[2]), "=r"(w[3]), "=r"(w[4]), "=r"(w[5]), "=r"(w[6])
        : "r"(e[1]), "r"(e[2]), "r"(e[3]), "r"(e[4]), "r"(e[5]), "r"(o[0]), "r"(o[1]),
          "r"(o[2]), "r"(o[3]), "r"(o[4]));
    w[0] = e[0];
    const uint32_t lane = threadIdx.x & 31u;
    uint32_t lo[7], hi[5];
#pragma unroll
    for (int j = 0; j < 7; j++) lo[j] = __shfl_sync(kWarp, w[j], lane & ~1u);
#pragma unroll
    for (int j = 0; j < 5; j++) hi[j] = __shfl_sync(kWarp, w[j], lane | 1u);
    Fe r;
    r.v[0] = lo[0];
    r.v[1] = lo[1];
    r.v[2] = lo[2];
    // the sum is below 2p < 2^255: nothing carries out of limb 7
    asm("add.cc.u32 %0, %5, %9;\n\t"
        "addc.cc.u32 %1, %6, %10;\n\t"
        "addc.cc.u32 %2, %7, %11;\n\t"
        "addc.cc.u32 %3, %8, %12;\n\t"
        "addc.u32 %4, %13, 0;"
        : "=r"(r.v[3]), "=r"(r.v[4]), "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7])
        : "r"(lo[3]), "r"(lo[4]), "r"(lo[5]), "r"(lo[6]), "r"(hi[0]), "r"(hi[1]), "r"(hi[2]),
          "r"(hi[3]), "r"(hi[4]));
    return reduce_once(r, f);
}

// a * b on a thread (S = 1) or a sub-group's pair (S = 2)
template <int G, int S>
__device__ __forceinline__ Fe group_mul(const Fe& a, const Fe& b, const Group<G, S>& g,
                                        const FieldParams& f) {
    if constexpr (S == 1) {
        return fe_mont_mul(a, b, f);
    } else {
        return split_mont_mul(a, b, g, f);
    }
}

// v[i + rank], this sub-group's operand of the round from i (v[i] past the
// level's end), by a tree of selects on the rank's bits (a chain of
// compares cost the 4-thread stage ~12 %)
template <int G, int K>
__device__ __forceinline__ Fe pick(const Fe (&v)[K], int i, uint32_t rank) {
    auto at = [&](int j) -> const Fe& { return v[i + j < K ? i + j : i]; };
    if constexpr (G == 1) {
        return at(0);
    } else if constexpr (G == 2) {
        return fe_select(rank & 1, at(1), at(0));
    } else {
        return fe_select(rank & 2, fe_select(rank & 1, at(3), at(2)),
                         fe_select(rank & 1, at(1), at(0)));
    }
}

// o[i] = a[i] b[i] for the K products of one level, in rounds of G: the
// sub-group of rank j takes product i + j of the round from i (rank 0's
// where there is none), and every thread gets the round's products by
// shuffles.  A round of one product is that product on every thread, with
// nothing to exchange.
template <int G, int S, int K>
__device__ __forceinline__ void products(const Fe (&a)[K], const Fe (&b)[K], Fe (&o)[K],
                                         const Group<G, S>& g, const FieldParams& f) {
#pragma unroll
    for (int i = 0; i < K; i += G) {
        const Fe m = group_mul(pick<G>(a, i, g.rank), pick<G>(b, i, g.rank), g, f);
        if (G == 1 || i + 1 == K) {
            o[i] = m;
        } else {
#pragma unroll
            for (int j = 0; j < G; j++)
                if (i + j < K) o[i + j < K ? i + j : i] = shfl_fe<G * S>(m, j * S);
        }
    }
}

// dbl-2009-l, jac_double_inline's field operations, its products in three
// levels: {A = X^2, B = Y^2, Y Z}, {C = B^2, (X + B)^2, F = E^2},
// {E (D - X3)}.  One thread takes jac_double_inline itself, whose order of
// products keeps fewer values live.
template <int G, int S>
__device__ __forceinline__ Jac group_double(const Jac& p, const Group<G, S>& g,
                                            const FieldParams& f) {
    if constexpr (G * S == 1) {
        return jac_double_inline(p, f);
    } else {
        Fe l1[3];
        products({p.x, p.y, p.y}, {p.x, p.y, p.z}, l1, g, f);
        const Fe A = l1[0], B = l1[1];
        const Fe xb = fe_add(p.x, B, f);
        const Fe E = fe_add(fe_add(A, A, f), A, f);
        Fe l2[3];
        products({B, xb, E}, {B, xb, E}, l2, g, f);
        const Fe C = l2[0];
        const Fe t = fe_sub(l2[1], fe_add(A, C, f), f);
        const Fe D = fe_add(t, t, f);
        Jac r;
        r.x = fe_sub(l2[2], fe_add(D, D, f), f);
        Fe c2 = fe_add(C, C, f);
        c2 = fe_add(c2, c2, f);
        const Fe eight_c = fe_add(c2, c2, f);
        Fe l3[1];
        products({E}, {fe_sub(D, r.x, f)}, l3, g, f);
        r.y = fe_sub(l3[0], eight_c, f);
        r.z = fe_add(l1[2], l1[2], f);
        return r;
    }
}

// the doubling an add falls back to (P + P), out of line: it is rare
template <int G, int S>
__device__ __noinline__ Jac group_double_call(const Jac& p, const Group<G, S> g,
                                              const FieldParams f) {
    return group_double(p, g, f);
}

// add-2007-bl with jac_add_inline's fallbacks, its products in five levels:
// {Z1Z1, Z2Z2, Z1 Z2}, {U1, U2, Z2 Z2Z2, Z1 Z1Z1}, {S1, S2, HH, Z3 = Z1 Z2
// H}, {r^2, HHH, V}, {r (V - X3), S1 HHH}.  With PHI the add takes phi(q):
// q's x times beta, a fourth product of the first level.  One thread takes
// jac_add_inline itself, as the doubling does (and phi as the entry is
// read, glv_mul).
template <bool PHI, int G, int S>
__device__ __forceinline__ Jac group_add(const Jac& p, Jac q, const Group<G, S>& g,
                                         const FieldParams& f) {
    if constexpr (G * S == 1) {
        static_assert(!PHI, "one thread takes phi as the entry is read");
        return jac_add_inline(p, q, f);
    } else {
        const bool q_inf = fe_is_zero(q.z);
        Fe l1[PHI ? 4 : 3];
        if constexpr (PHI) {
            products({p.z, q.z, p.z, q.x}, {p.z, q.z, q.z, glv_beta()}, l1, g, f);
            q.x = l1[3];
        } else {
            products({p.z, q.z, p.z}, {p.z, q.z, q.z}, l1, g, f);
        }
        const bool p_inf = fe_is_zero(p.z);
        Fe l2[4];
        products({p.x, q.x, q.z, p.z}, {l1[1], l1[0], l1[1], l1[0]}, l2, g, f);
        const Fe U1 = l2[0];
        const Fe H = fe_sub(l2[1], U1, f);
        Fe l3[4];
        products({p.y, q.y, H, l1[2]}, {l2[2], l2[3], H, H}, l3, g, f);
        const Fe S1 = l3[0];
        const Fe r = fe_sub(l3[1], S1, f);
        const bool h0 = fe_is_zero(H), r0 = fe_is_zero(r);
        Fe l4[3];
        products({r, H, U1}, {r, l3[2], l3[2]}, l4, g, f);
        const Fe HHH = l4[1], V = l4[2];
        Jac o;
        o.x = fe_sub(fe_sub(l4[0], HHH, f), fe_add(V, V, f), f);
        Fe l5[2];
        products({r, S1}, {fe_sub(V, o.x, f), HHH}, l5, g, f);
        o.y = fe_sub(l5[0], l5[1], f);
        o.z = l3[3];
        // jac_add_inline's early returns, in their order, for the lanes
        // that take them
        if (__any_sync(kWarp, q_inf || p_inf || h0)) {
            if (__any_sync(kWarp, h0 && r0 && !p_inf && !q_inf)) {
                const Jac d = group_double_call(p, g, f);
                if (h0 && r0) o = d;
            }
            if (h0 && !r0) o = jac_infinity();
            if (p_inf) o = q;
            if (q_inf) o = p;
        }
        return o;
    }
}

// The table in shared memory, a lane's entries once for its group: word j
// of entry i of the block's lane l at [(i * 24 + j) * L + l], L = kThreads /
// (G S) lanes a block, so the lanes of a warp read distinct banks whichever
// entries they take, and a group's threads one word together.  The thread
// of place t in its group writes the words j = t mod G S of each
// coordinate; after the table, one __syncwarp of the group, and no barrier
// besides.
constexpr int kSmemBytes = kTable * 24 * kThreads * 4;    // G S = 1; G S takes 1 / (G S) of it

template <int G, int S>
__device__ __forceinline__ void smem_put(uint32_t* s, int i, const Jac& q, const Group<G, S>& g) {
    constexpr int T = G * S, L = kThreads / T;
    uint32_t* w = s + i * 24 * L + threadIdx.x / T;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        if (T == 1 || j % T == (int)(g.rank * S + g.srank)) {
            w[j * L] = q.x.v[j];
            w[(8 + j) * L] = q.y.v[j];
            w[(16 + j) * L] = q.z.v[j];
        }
    }
}

template <int T>
__device__ __forceinline__ Jac smem_get(const uint32_t* s, uint32_t i) {
    constexpr int L = kThreads / T;
    const uint32_t* w = s + i * 24 * L + threadIdx.x / T;
    Jac q;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        q.x.v[j] = w[j * L];
        q.y.v[j] = w[(8 + j) * L];
        q.z.v[j] = w[(16 + j) * L];
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

// [k]p for a scalar k in the ladder's form (not one) on the lane's group,
// the point formulas inlined.  Phi's x of a second-half entry is a product
// of the add's first level on a group (PHI), and on one thread a product
// of its own as the entry is read, as ec.cuh's order had it (1 % faster
// at 2^19 lanes than in the add)
template <int G, int S>
__device__ __forceinline__ Jac glv_mul(const Jac& p, GlvScalar s, const Group<G, S>& g,
                                       const FieldParams& f) {
    extern __shared__ uint32_t table[];
    constexpr bool kPhiInAdd = G * S > 1;
    // the entry of nibble e, the digit 2e - 15: T[e - 8] for e >= 8, else
    // -T[7 - e]
    auto entry = [&](uint32_t e, bool phi) -> Jac {
        Jac q = smem_get<G * S>(table, e >= 8 ? e - 8 : 7 - e);
        if (phi && !kPhiInAdd) q.x = fe_mont_mul(q.x, glv_beta(), f);
        q.y = neg_if(q.y, e < 8, f);
        return q;
    };
    const Jac d = group_double(p, g, f);
    Jac t = p;
    smem_put(table, 0, t, g);
#pragma unroll 1
    for (int i = 1; i < kTable; i++) {
        t = group_add<false>(t, d, g, f);
        smem_put(table, i, t, g);
    }
    if (G * S > 1) __syncwarp();
    Jac acc = entry(s.e[0][3] >> 28, false);
    acc = group_add<kPhiInAdd>(acc, entry(s.e[1][3] >> 28, true), g, f);
#pragma unroll 1
    for (int w = kWindows - 2; w >= 0; w--) {
        next_window(s.e[0]);
        next_window(s.e[1]);
#pragma unroll 1
        for (int k = 0; k < 4; k++) acc = group_double(acc, g, f);
        acc = group_add<false>(acc, entry(s.e[0][3] >> 28, false), g, f);
        acc = group_add<kPhiInAdd>(acc, entry(s.e[1][3] >> 28, true), g, f);
    }
    // the even halves ran k_i + 1: take off P and phi(P)
    if constexpr (G * S == 1) {
        if (s.even[0]) acc = group_add<false>(acc, entry(7, false), g, f);
        if (s.even[1]) acc = group_add<kPhiInAdd>(acc, entry(7, true), g, f);
    } else {
        if (__any_sync(kWarp, s.even[0])) {
            const Jac t = group_add<false>(acc, entry(7, false), g, f);
            if (s.even[0]) acc = t;
        }
        if (__any_sync(kWarp, s.even[1])) {
            const Jac t = group_add<kPhiInAdd>(acc, entry(7, true), g, f);
            if (s.even[1]) acc = t;
        }
    }
    return acc;
}

// The lane of a thread of the launch, n - 1 for a thread past the end whose
// warp holds a lane below it (kWarp); false for a thread that has nothing
// to do
template <int G, int S>
__device__ __forceinline__ bool lane_of(int64_t n, int64_t& i, bool& live) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    i = t / (G * S);
    live = i < n;
    if (G * S == 1) return live;
    if ((t & ~31ll) / (G * S) >= n) return false;    // the whole warp is past the end
    if (!live) i = n - 1;
    return true;
}

// lane i on threads i G S ... i G S + G S - 1 of the launch; the group's
// first thread stores
template <int G, int S>
__global__ void __launch_bounds__(kThreads, 1)
g1_butterfly_kernel(const uint32_t* __restrict__ lx, const uint32_t* __restrict__ ly,
                    const uint32_t* __restrict__ lz, const uint32_t* __restrict__ hx,
                    const uint32_t* __restrict__ hy, const uint32_t* __restrict__ hz,
                    const uint32_t* __restrict__ w, uint32_t* __restrict__ ax,
                    uint32_t* __restrict__ ay, uint32_t* __restrict__ az,
                    uint32_t* __restrict__ bx, uint32_t* __restrict__ by,
                    uint32_t* __restrict__ bz, int64_t n, int64_t stride, FieldParams f) {
    int64_t i;
    bool live;
    if (!lane_of<G, S>(n, i, live)) return;
    const Group<G, S> g = this_group<G, S>(f);
    const Fe k = load_fe(w, i);
    const bool one = fe_is_one_raw(k);
    Jac t = load_jac(hx, hy, hz, i * stride);
    if constexpr (G * S == 1) {
        if (!one) t = glv_mul(t, glv_split(k), g, f);
    } else if (__any_sync(kWarp, !one)) {
        const Jac m = glv_mul(t, glv_split(k), g, f);
        if (!one) t = m;
    }
    const Jac lo = load_jac(lx, ly, lz, i * stride);
    Jac neg_t = t;
    neg_t.y = fe_sub(fe_zero(), t.y, f);
    const bool first = live && (threadIdx.x & (G * S - 1)) == 0;
    const Jac a = group_add<false>(lo, t, g, f);
    if (first) store_jac(ax, ay, az, i, a);
    const Jac b = group_add<false>(lo, neg_t, g, f);
    if (first) store_jac(bx, by, bz, i, b);
}

template <int G, int S>
__global__ void __launch_bounds__(kThreads, 1)
g1_scale_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                const uint32_t* __restrict__ pz, uint32_t* __restrict__ ox,
                uint32_t* __restrict__ oy, uint32_t* __restrict__ oz, GlvScalar s, int64_t n,
                FieldParams f) {
    int64_t i;
    bool live;
    if (!lane_of<G, S>(n, i, live)) return;
    const Group<G, S> g = this_group<G, S>(f);
    const Jac p = load_jac(px, py, pz, i);
    const Jac o = s.one ? p : glv_mul(p, s, g, f);
    if (live && (threadIdx.x & (G * S - 1)) == 0) store_jac(ox, oy, oz, i, o);
}

// out_i = a_i b_i 2^-256 mod q by split_mont_mul, lane i on threads 2i and
// 2i + 1: the split product alone, for the card's tests
__global__ void __launch_bounds__(kThreads)
split_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                 uint32_t* __restrict__ out, int64_t n, FieldParams f) {
    int64_t i;
    bool live;
    if (!lane_of<1, 2>(n, i, live)) return;
    const Group<1, 2> g = this_group<1, 2>(f);
    const Fe r = split_mont_mul(load_fe(a, i), load_fe(b, i), g, f);
    if (live && g.srank == 0) store_fe(out, i, r);
}

// K16: the inverse transform's input from the key's uploaded rows, one
// thread a point.  Point i, canonical x and y limbs and its byte of inf,
// becomes the Jacobian (x R, y R, R) mod q, or all zero where inf is set,
// at row rev(i) of each of X, Y and Z, n rows apart in `out` ([3, n, 8]),
// rev(i) being i with its log2(n) bits reversed: the bit-reversal gather
// that the transposed Pease form starts from.  x R is one Montgomery
// product by R^2, as K1's to_mont.  It replaces no TPU kernel: it is the
// port's own fusion of the chain of small launches that made the same
// buffer (to_mont's broadcast copy and K1, the Z fill, the mask, the
// gather), which left the card waiting on the host at the start of every
// key.  Bound by bytes: 65 read and 96 written a point, so at the 2^12
// key's size its time is launch latency and two products.
__global__ void __launch_bounds__(kThreads)
g1_points_in_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                    const uint8_t* __restrict__ inf, uint32_t* __restrict__ out, int64_t n,
                    int bits, Fe r2, Fe one, FieldParams f) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int64_t at = bits ? (int64_t)(__brev((uint32_t)i) >> (32 - bits)) : 0;
    Fe px = fe_zero(), py = fe_zero(), pz = fe_zero();
    if (!inf[i]) {
        px = fe_mont_mul(load_fe(x, i), r2, f);
        py = fe_mont_mul(load_fe(y, i), r2, f);
        pz = one;
    }
    store_fe(out, at, px);
    store_fe(out + 8 * n, at, py);
    store_fe(out + 16 * n, at, pz);
}

// launch(std::integral_constant<int, G>) for group = G in {1, 2, 4}
template <typename Launch>
int with_group(int group, Launch&& launch) {
    switch (group) {
        case 1: return launch(std::integral_constant<int, 1>{});
        case 2: return launch(std::integral_constant<int, 2>{});
        case 4: return launch(std::integral_constant<int, 4>{});
        default: return (int)cudaErrorInvalidValue;
    }
}

// launch(G, S), both std::integral_constants, for the pairs lane_group and
// product_split give: group = G in {1, 2, 4} with split = S = 1, and G = 4
// with S = 2
template <typename Launch>
int with_split(int group, int split, Launch&& launch) {
    if (split == 1)
        return with_group(group,
                          [&](auto gc) { return launch(gc, std::integral_constant<int, 1>{}); });
    if (group == 4 && split == 2)
        return launch(std::integral_constant<int, 4>{}, std::integral_constant<int, 2>{});
    return (int)cudaErrorInvalidValue;
}

unsigned blocks_of(long long n, int threads) {
    return (unsigned)((n * threads + kThreads - 1) / kThreads);
}

bool fq_params(FieldParams* f) { return field_params(1, f); }

}  // namespace

// w: canonical twiddles, each below r, one contiguous row a lane; lane i
// reads row i * stride of lo and of hi; group: sub-groups a lane, 1, 2 or
// 4; split: threads a sub-group, 1 or 2 (2 with group 4)
extern "C" int plonkit_g1_butterfly(const void* lx, const void* ly, const void* lz,
                                    const void* hx, const void* hy, const void* hz, const void* w,
                                    void* ax, void* ay, void* az, void* bx, void* by, void* bz,
                                    long long n, long long stride, int group, int split,
                                    void* stream) {
    FieldParams f;
    if (!fq_params(&f) || n < 0 || stride < 1) return (int)cudaErrorInvalidValue;
    return with_split(group, split, [&](auto gc, auto sc) {
        constexpr int G = decltype(gc)::value, S = decltype(sc)::value;
        if (n == 0) return (int)cudaGetLastError();
        cudaFuncSetAttribute(g1_butterfly_kernel<G, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes / (G * S));
        g1_butterfly_kernel<G, S><<<blocks_of(n, G * S), kThreads, kSmemBytes / (G * S),
                                    (cudaStream_t)stream>>>(
            (const uint32_t*)lx, (const uint32_t*)ly, (const uint32_t*)lz, (const uint32_t*)hx,
            (const uint32_t*)hy, (const uint32_t*)hz, (const uint32_t*)w, (uint32_t*)ax,
            (uint32_t*)ay, (uint32_t*)az, (uint32_t*)bx, (uint32_t*)by, (uint32_t*)bz,
            (int64_t)n, (int64_t)stride, f);
        return (int)cudaGetLastError();
    });
}

// scalar: host words [E1 (4), E2 (4), even1, even2, one] (group_ntt.scale_args)
extern "C" int plonkit_g1_scale(const void* px, const void* py, const void* pz, void* ox,
                                void* oy, void* oz, const void* scalar, long long n, int group,
                                int split, void* stream) {
    FieldParams f;
    if (!fq_params(&f) || n < 0 || scalar == nullptr) return (int)cudaErrorInvalidValue;
    const uint32_t* a = (const uint32_t*)scalar;
    GlvScalar s;
    for (int h = 0; h < 2; h++)
        for (int j = 0; j < 4; j++) s.e[h][j] = a[4 * h + j];
    s.even[0] = a[8];
    s.even[1] = a[9];
    s.one = a[10];
    return with_split(group, split, [&](auto gc, auto sc) {
        constexpr int G = decltype(gc)::value, S = decltype(sc)::value;
        if (n == 0) return (int)cudaGetLastError();
        cudaFuncSetAttribute(g1_scale_kernel<G, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes / (G * S));
        g1_scale_kernel<G, S><<<blocks_of(n, G * S), kThreads, kSmemBytes / (G * S),
                                (cudaStream_t)stream>>>(
            (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (uint32_t*)ox,
            (uint32_t*)oy, (uint32_t*)oz, s, (int64_t)n, f);
        return (int)cudaGetLastError();
    });
}

// out = a b 2^-256 mod q over n rows of Montgomery Fq limbs by the split
// product, a pair of threads a row (tests)
extern "C" int plonkit_fq_split_mul(const void* a, const void* b, void* out, long long n,
                                    void* stream) {
    FieldParams f;
    if (!fq_params(&f) || n < 0) return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    split_mul_kernel<<<blocks_of(n, 2), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, (int64_t)n, f);
    return (int)cudaGetLastError();
}

// K16: x, y: n canonical rows each; inf: n bytes; out: [3, n, 8]; n a power
// of two up to 2^32; r2, one: host words of R^2 mod q and R mod q
// (mont.FieldSpec.words)
extern "C" int plonkit_g1_points_in(const void* x, const void* y, const void* inf, void* out,
                                    long long n, const void* r2_words, const void* one_words,
                                    void* stream) {
    FieldParams f;
    if (!fq_params(&f) || n < 0 || n > (1ll << 32) || (n & (n - 1)) || r2_words == nullptr ||
        one_words == nullptr)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaGetLastError();
    int bits = 0;
    while ((1ll << bits) < n) bits++;
    Fe r2, one;
    for (int j = 0; j < 8; j++) {
        r2.v[j] = ((const uint32_t*)r2_words)[j];
        one.v[j] = ((const uint32_t*)one_words)[j];
    }
    g1_points_in_kernel<<<blocks_of(n, 1), kThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (const uint32_t*)y, (const uint8_t*)inf, (uint32_t*)out, (int64_t)n,
        bits, r2, one, f);
    return (int)cudaGetLastError();
}
