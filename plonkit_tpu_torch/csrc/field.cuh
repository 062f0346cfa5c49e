// BN254 field arithmetic on 8 x 32-bit limbs for the port's CUDA kernels.
//
// An element is one row of eight little-endian uint32 limbs (32 bytes), a
// vector of N elements an [N, 8] int32 tensor (gpu/mont.py).  Values are in
// Montgomery form with R = 2^256, the radix of the JAX package's 16-bit
// limbs, and every result is fully reduced into [0, p): the same bits the
// plain versions in gpu/mont.py produce.
//
// One thread owns one element.  Every kernel of the port (field.cu, ntt.cu,
// msm.cu) takes its arithmetic from here, so all of them share one
// Montgomery product: fe_mont_mul below.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace plonkit {

// modulus limbs and n0 = -p^-1 mod 2^32; passed by value as a kernel
// argument, so the limbs sit in the constant bank.
struct FieldParams {
    uint32_t p[8];
    uint32_t n0;
};

// field: 0 = Fr (scalar field r), 1 = Fq (base field q).  Returns false
// for any other value.
static inline bool field_params(int field, FieldParams* out) {
    static const FieldParams kFr = {
        {0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u,
         0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
        0xefffffffu};
    static const FieldParams kFq = {
        {0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u,
         0x8181585du, 0xb85045b6u, 0xe131a029u, 0x30644e72u},
        0xe4866389u};
    if (field == 0) { *out = kFr; return true; }
    if (field == 1) { *out = kFq; return true; }
    return false;
}

struct Fe {
    uint32_t v[8];
};

// rows are 32 bytes and the wrappers check 16-byte alignment, so each row
// is two 16-byte loads
__device__ __forceinline__ Fe load_fe(const uint32_t* base, int64_t i) {
    const uint4* q = reinterpret_cast<const uint4*>(base + 8 * i);
    const uint4 lo = q[0];
    const uint4 hi = q[1];
    Fe r;
    r.v[0] = lo.x; r.v[1] = lo.y; r.v[2] = lo.z; r.v[3] = lo.w;
    r.v[4] = hi.x; r.v[5] = hi.y; r.v[6] = hi.z; r.v[7] = hi.w;
    return r;
}

__device__ __forceinline__ void store_fe(uint32_t* base, int64_t i, const Fe& a) {
    uint4* q = reinterpret_cast<uint4*>(base + 8 * i);
    q[0] = make_uint4(a.v[0], a.v[1], a.v[2], a.v[3]);
    q[1] = make_uint4(a.v[4], a.v[5], a.v[6], a.v[7]);
}

// The arithmetic below is PTX with the carry flag (add.cc / addc, sub.cc /
// subc, mad.lo.cc / madc.hi): a chain of limb operations carries through
// the flag, so there is no 64-bit sum to split with shifts and moves.  The
// flag does not live from one asm statement to the next, so every chain is
// one statement.  Every input is in [0, p) and every output is fully
// reduced into [0, p): no value is lazy.

// a - p if a >= p, else a; for a < 2p
__device__ __forceinline__ Fe reduce_once(const Fe& a, const FieldParams& f) {
    Fe d;
    uint32_t borrow;
    asm("sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, %9, %9;"
        : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]),
          "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(borrow)
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
          "r"(a.v[6]), "r"(a.v[7]), "r"(f.p[0]), "r"(f.p[1]), "r"(f.p[2]), "r"(f.p[3]),
          "r"(f.p[4]), "r"(f.p[5]), "r"(f.p[6]), "r"(f.p[7]));
    // borrow is 0 - 0 - (a < p): all ones when a < p
    return borrow ? a : d;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const FieldParams& f) {
    Fe s;
    // a + b < 2p < 2^255: no carry out of the top limb
    asm("add.cc.u32 %0, %8, %16;\n\t"
        "addc.cc.u32 %1, %9, %17;\n\t"
        "addc.cc.u32 %2, %10, %18;\n\t"
        "addc.cc.u32 %3, %11, %19;\n\t"
        "addc.cc.u32 %4, %12, %20;\n\t"
        "addc.cc.u32 %5, %13, %21;\n\t"
        "addc.cc.u32 %6, %14, %22;\n\t"
        "addc.u32 %7, %15, %23;"
        : "=r"(s.v[0]), "=r"(s.v[1]), "=r"(s.v[2]), "=r"(s.v[3]), "=r"(s.v[4]),
          "=r"(s.v[5]), "=r"(s.v[6]), "=r"(s.v[7])
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
          "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
    return reduce_once(s, f);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const FieldParams& f) {
    Fe d;
    uint32_t mask;
    asm("sub.cc.u32 %0, %9, %17;\n\t"
        "subc.cc.u32 %1, %10, %18;\n\t"
        "subc.cc.u32 %2, %11, %19;\n\t"
        "subc.cc.u32 %3, %12, %20;\n\t"
        "subc.cc.u32 %4, %13, %21;\n\t"
        "subc.cc.u32 %5, %14, %22;\n\t"
        "subc.cc.u32 %6, %15, %23;\n\t"
        "subc.cc.u32 %7, %16, %24;\n\t"
        "subc.u32 %8, %9, %9;"
        : "=r"(d.v[0]), "=r"(d.v[1]), "=r"(d.v[2]), "=r"(d.v[3]), "=r"(d.v[4]),
          "=r"(d.v[5]), "=r"(d.v[6]), "=r"(d.v[7]), "=r"(mask)
        : "r"(a.v[0]), "r"(a.v[1]), "r"(a.v[2]), "r"(a.v[3]), "r"(a.v[4]), "r"(a.v[5]),
          "r"(a.v[6]), "r"(a.v[7]), "r"(b.v[0]), "r"(b.v[1]), "r"(b.v[2]), "r"(b.v[3]),
          "r"(b.v[4]), "r"(b.v[5]), "r"(b.v[6]), "r"(b.v[7]));
    // mask is all ones when a < b: add p back, with its carry out dropped
    uint32_t pm[8];
#pragma unroll
    for (int j = 0; j < 8; j++) pm[j] = f.p[j] & mask;
    asm("add.cc.u32 %0, %0, %8;\n\t"
        "addc.cc.u32 %1, %1, %9;\n\t"
        "addc.cc.u32 %2, %2, %10;\n\t"
        "addc.cc.u32 %3, %3, %11;\n\t"
        "addc.cc.u32 %4, %4, %12;\n\t"
        "addc.cc.u32 %5, %5, %13;\n\t"
        "addc.cc.u32 %6, %6, %14;\n\t"
        "addc.u32 %7, %7, %15;"
        : "+r"(d.v[0]), "+r"(d.v[1]), "+r"(d.v[2]), "+r"(d.v[3]), "+r"(d.v[4]),
          "+r"(d.v[5]), "+r"(d.v[6]), "+r"(d.v[7])
        : "r"(pm[0]), "r"(pm[1]), "r"(pm[2]), "r"(pm[3]), "r"(pm[4]), "r"(pm[5]),
          "r"(pm[6]), "r"(pm[7]));
    return d;
}

// The Montgomery product keeps its running sum V in two halves, V = e + o *
// 2^32: e takes the products of the even limbs of a (a[2j] * b at limbs 2j,
// 2j + 1) and o those of the odd limbs one limb up.  Each half is then one
// carry chain of mad.lo.cc / madc.hi.cc pairs on adjacent limbs, which
// ptxas fuses into one IMAD.WIDE.U32.X each, and the two chains do not
// wait on each other.  (One chain of all the low halves, then all the high
// halves, compiled its carries into separate IADD3.X adds; chip_smoke.py
// prints the instructions of K1 and K6 from cuobjdump.)  The layout follows
// the even/odd CIOS of production BN254 GPU provers.

// e = a[0,2,4,6] * b at limbs (0,1), (2,3), ...; o = a[1,3,5,7] * b likewise
__device__ __forceinline__ void eo_first(uint32_t e[8], uint32_t o[8], const uint32_t a[8],
                                         uint32_t b) {
    asm("mul.lo.u32 %0, %16, %24;\n\t"
        "mul.hi.u32 %1, %16, %24;\n\t"
        "mul.lo.u32 %2, %18, %24;\n\t"
        "mul.hi.u32 %3, %18, %24;\n\t"
        "mul.lo.u32 %4, %20, %24;\n\t"
        "mul.hi.u32 %5, %20, %24;\n\t"
        "mul.lo.u32 %6, %22, %24;\n\t"
        "mul.hi.u32 %7, %22, %24;\n\t"
        "mul.lo.u32 %8, %17, %24;\n\t"
        "mul.hi.u32 %9, %17, %24;\n\t"
        "mul.lo.u32 %10, %19, %24;\n\t"
        "mul.hi.u32 %11, %19, %24;\n\t"
        "mul.lo.u32 %12, %21, %24;\n\t"
        "mul.hi.u32 %13, %21, %24;\n\t"
        "mul.lo.u32 %14, %23, %24;\n\t"
        "mul.hi.u32 %15, %23, %24;"
        : "=r"(e[0]), "=r"(e[1]), "=r"(e[2]), "=r"(e[3]), "=r"(e[4]), "=r"(e[5]),
          "=r"(e[6]), "=r"(e[7]), "=r"(o[0]), "=r"(o[1]), "=r"(o[2]), "=r"(o[3]),
          "=r"(o[4]), "=r"(o[5]), "=r"(o[6]), "=r"(o[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
          "r"(a[7]), "r"(b));
}

// e[0] += o[1], then o = (o >> 64) + a[1,3,5,7] * b, one carry chain
__device__ __forceinline__ void eo_shift_odd(uint32_t e[8], uint32_t o[8], const uint32_t a[8],
                                             uint32_t b) {
    asm("add.cc.u32 %0, %0, %2;\n\t"
        "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
        "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
        "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
        "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
        "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
        "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
        "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
        "madc.hi.u32 %8, %12, %13, 0;"
        : "+r"(e[0]), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]),
          "+r"(o[5]), "+r"(o[6]), "+r"(o[7])
        : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// x += a[0,2,4,6] * b (pairs of limbs), one carry chain whose carry out is
// added to top
__device__ __forceinline__ void eo_mad_even(uint32_t x[8], const uint32_t a[8], uint32_t b,
                                            uint32_t& top) {
    asm("mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
        "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
        "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
        "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
        "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
        "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
        "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
        "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
        "addc.u32 %8, %8, 0;"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),
          "+r"(x[6]), "+r"(x[7]), "+r"(top)
        : "r"(a[0]), "r"(a[2]), "r"(a[4]), "r"(a[6]), "r"(b));
}

// x += a[1,3,5,7] * b, one carry chain; nothing carries out of x[7]
__device__ __forceinline__ void eo_mad_odd(uint32_t x[8], const uint32_t a[8], uint32_t b) {
    asm("mad.lo.cc.u32 %0, %8, %12, %0;\n\t"
        "madc.hi.cc.u32 %1, %8, %12, %1;\n\t"
        "madc.lo.cc.u32 %2, %9, %12, %2;\n\t"
        "madc.hi.cc.u32 %3, %9, %12, %3;\n\t"
        "madc.lo.cc.u32 %4, %10, %12, %4;\n\t"
        "madc.hi.cc.u32 %5, %10, %12, %5;\n\t"
        "madc.lo.cc.u32 %6, %11, %12, %6;\n\t"
        "madc.hi.u32 %7, %11, %12, %7;"
        : "+r"(x[0]), "+r"(x[1]), "+r"(x[2]), "+r"(x[3]), "+r"(x[4]), "+r"(x[5]),
          "+r"(x[6]), "+r"(x[7])
        : "r"(a[1]), "r"(a[3]), "r"(a[5]), "r"(a[7]), "r"(b));
}

// one CIOS row: V += a * b, then V += m * p with m = V * n0 mod 2^32,
// which clears e[0]; V / 2^32 is then o + (e >> 32), so the next row
// takes o as its even half and e, moved down two limbs (eo_shift_odd,
// with e[1] added to o[0]), as its odd half
__device__ __forceinline__ void eo_row(uint32_t e[8], uint32_t o[8], const uint32_t a[8],
                                       uint32_t b, const FieldParams& f, bool first) {
    if (first) {
        eo_first(e, o, a, b);
    } else {
        eo_shift_odd(e, o, a, b);
        eo_mad_even(e, a, b, o[7]);
    }
    const uint32_t m = e[0] * f.n0;
    eo_mad_odd(o, f.p, m);
    eo_mad_even(e, f.p, m, o[7]);
}

// a * b * 2^-256 mod p: eight CIOS rows, the halves trading roles from row
// to row, then one add of the halves and one conditional subtraction.  With
// a, b < p < 2^254 the sum stays below 2p after each row and no carry
// leaves the top limb of either half: tests/test_torch_ptx.py runs this
// PTX instruction by instruction against big-integer arithmetic and checks
// that every chain end that drops a carry drops 0.
__device__ __forceinline__ Fe fe_mont_mul(const Fe& a, const Fe& b, const FieldParams& f) {
    uint32_t e[8], o[8];
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
        eo_row(e, o, a.v, b.v[i], f, i == 0);
        eo_row(o, e, a.v, b.v[i + 1], f, false);
    }
    // V = e + (o >> 32), o[0] = 0
    Fe r;
    asm("add.cc.u32 %0, %8, %16;\n\t"
        "addc.cc.u32 %1, %9, %17;\n\t"
        "addc.cc.u32 %2, %10, %18;\n\t"
        "addc.cc.u32 %3, %11, %19;\n\t"
        "addc.cc.u32 %4, %12, %20;\n\t"
        "addc.cc.u32 %5, %13, %21;\n\t"
        "addc.cc.u32 %6, %14, %22;\n\t"
        "addc.u32 %7, %15, 0;"
        : "=r"(r.v[0]), "=r"(r.v[1]), "=r"(r.v[2]), "=r"(r.v[3]), "=r"(r.v[4]),
          "=r"(r.v[5]), "=r"(r.v[6]), "=r"(r.v[7])
        : "r"(e[0]), "r"(e[1]), "r"(e[2]), "r"(e[3]), "r"(e[4]), "r"(e[5]), "r"(e[6]),
          "r"(e[7]), "r"(o[1]), "r"(o[2]), "r"(o[3]), "r"(o[4]), "r"(o[5]), "r"(o[6]),
          "r"(o[7]));
    return reduce_once(r, f);
}

}  // namespace plonkit
