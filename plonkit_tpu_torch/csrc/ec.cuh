// BN254 G1 in Jacobian coordinates over Fq, for the MSM kernels (msm.cu).
//
// The formulas of plonkit_tpu/tpu/ec.py (and of its plain PyTorch copy,
// plonkit_tpu_torch/gpu/ec.py) over field.cuh's 8 x 32-bit Fq elements:
// dbl-2009-l, add-2007-bl and madd-2007-bl, with the complete forms'
// fallbacks.  Every field result is fully reduced, so each output limb
// equals the plain version's, degenerate cases included:
//   - Q infinite -> P; P infinite -> Q (lifted to Z = 1 in the mixed add);
//   - H = 0 and r = 0 (P + P) -> double(P);
//   - H = 0 and r != 0 (P + (-P)) -> all zeros.
// Infinity is Z == 0.  The H = 0 branch is almost never taken, so it costs
// the warp nearly nothing.
#pragma once

#include "field.cuh"

namespace plonkit {

struct Jac {
    Fe x, y, z;
};

// 2^256 mod q: one in Montgomery form over Fq
__device__ __forceinline__ Fe fq_one_mont() {
    Fe r;
    r.v[0] = 0xc58f0d9du; r.v[1] = 0xd35d438du; r.v[2] = 0xf5c70b3du; r.v[3] = 0x0a78eb28u;
    r.v[4] = 0x7879462cu; r.v[5] = 0x666ea36fu; r.v[6] = 0x9a07df2fu; r.v[7] = 0x0e0a77c1u;
    return r;
}

__device__ __forceinline__ Fe fe_zero() {
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = 0;
    return r;
}

__device__ __forceinline__ bool fe_is_zero(const Fe& a) {
    uint32_t acc = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) acc |= a.v[j];
    return acc == 0;
}

__device__ __forceinline__ Jac jac_infinity() {
    Jac r;
    r.x = fe_zero(); r.y = fe_zero(); r.z = fe_zero();
    return r;
}

__device__ __forceinline__ Jac load_jac(const uint32_t* x, const uint32_t* y,
                                        const uint32_t* z, int64_t i) {
    Jac r;
    r.x = load_fe(x, i); r.y = load_fe(y, i); r.z = load_fe(z, i);
    return r;
}

__device__ __forceinline__ void store_jac(uint32_t* x, uint32_t* y, uint32_t* z, int64_t i,
                                          const Jac& p) {
    store_fe(x, i, p.x); store_fe(y, i, p.y); store_fe(z, i, p.z);
}

// dbl-2009-l, 2M + 5S (a = 0); infinity (Z = 0) stays Z = 0
__device__ __forceinline__ Jac jac_double_inline(const Jac& p, const FieldParams& f) {
    const Fe A = fe_mont_mul(p.x, p.x, f);
    const Fe B = fe_mont_mul(p.y, p.y, f);
    const Fe C = fe_mont_mul(B, B, f);
    const Fe xb = fe_add(p.x, B, f);
    const Fe t = fe_sub(fe_mont_mul(xb, xb, f), fe_add(A, C, f), f);
    const Fe D = fe_add(t, t, f);
    const Fe E = fe_add(fe_add(A, A, f), A, f);
    const Fe F = fe_mont_mul(E, E, f);
    Jac r;
    r.x = fe_sub(F, fe_add(D, D, f), f);
    Fe c2 = fe_add(C, C, f);
    c2 = fe_add(c2, c2, f);
    const Fe eight_c = fe_add(c2, c2, f);
    r.y = fe_sub(fe_mont_mul(E, fe_sub(D, r.x, f), f), eight_c, f);
    const Fe yz = fe_mont_mul(p.y, p.z, f);
    r.z = fe_add(yz, yz, f);
    return r;
}

// The MSM kernels call the point formulas out of line (one copy of their
// code a kernel); group_ntt.cu's ladder inlines them.
__device__ __noinline__ Jac jac_double(const Jac& p, const FieldParams& f) {
    return jac_double_inline(p, f);
}

// complete Jacobian + Jacobian: add-2007-bl with the fallbacks above (the
// doubling out of line: P + P is rare)
__device__ __forceinline__ Jac jac_add_inline(const Jac& p, const Jac& q, const FieldParams& f) {
    if (fe_is_zero(q.z)) return p;
    if (fe_is_zero(p.z)) return q;
    const Fe Z1Z1 = fe_mont_mul(p.z, p.z, f);
    const Fe Z2Z2 = fe_mont_mul(q.z, q.z, f);
    const Fe U1 = fe_mont_mul(p.x, Z2Z2, f);
    const Fe U2 = fe_mont_mul(q.x, Z1Z1, f);
    const Fe S1 = fe_mont_mul(p.y, fe_mont_mul(q.z, Z2Z2, f), f);
    const Fe S2 = fe_mont_mul(q.y, fe_mont_mul(p.z, Z1Z1, f), f);
    const Fe H = fe_sub(U2, U1, f);
    const Fe r = fe_sub(S2, S1, f);
    if (fe_is_zero(H)) return fe_is_zero(r) ? jac_double(p, f) : jac_infinity();
    const Fe HH = fe_mont_mul(H, H, f);
    const Fe HHH = fe_mont_mul(H, HH, f);
    const Fe V = fe_mont_mul(U1, HH, f);
    Jac o;
    o.x = fe_sub(fe_sub(fe_mont_mul(r, r, f), HHH, f), fe_add(V, V, f), f);
    o.y = fe_sub(fe_mont_mul(r, fe_sub(V, o.x, f), f), fe_mont_mul(S1, HHH, f), f);
    o.z = fe_mont_mul(fe_mont_mul(p.z, q.z, f), H, f);
    return o;
}

__device__ __noinline__ Jac jac_add(const Jac& p, const Jac& q, const FieldParams& f) {
    return jac_add_inline(p, q, f);
}

// complete Jacobian + finite affine (x2, y2): madd-2007-bl with the
// fallbacks above
__device__ __forceinline__ Jac jac_add_mixed(const Jac& p, const Fe& x2, const Fe& y2,
                                             const FieldParams& f) {
    if (fe_is_zero(p.z)) {
        Jac o;
        o.x = x2; o.y = y2; o.z = fq_one_mont();
        return o;
    }
    const Fe Z1Z1 = fe_mont_mul(p.z, p.z, f);
    const Fe U2 = fe_mont_mul(x2, Z1Z1, f);
    const Fe S2 = fe_mont_mul(y2, fe_mont_mul(p.z, Z1Z1, f), f);
    const Fe H = fe_sub(U2, p.x, f);
    const Fe r = fe_sub(S2, p.y, f);
    if (fe_is_zero(H)) return fe_is_zero(r) ? jac_double(p, f) : jac_infinity();
    const Fe HH = fe_mont_mul(H, H, f);
    const Fe HHH = fe_mont_mul(H, HH, f);
    const Fe V = fe_mont_mul(p.x, HH, f);
    Jac o;
    o.x = fe_sub(fe_sub(fe_mont_mul(r, r, f), HHH, f), fe_add(V, V, f), f);
    o.y = fe_sub(fe_mont_mul(r, fe_sub(V, o.x, f), f), fe_mont_mul(p.y, HHH, f), f);
    o.z = fe_mont_mul(p.z, H, f);
    return o;
}

}  // namespace plonkit
