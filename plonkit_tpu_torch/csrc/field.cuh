// BN254 field arithmetic on 8 x 32-bit limbs for the port's CUDA kernels.
//
// An element is one row of eight little-endian uint32 limbs (32 bytes), a
// vector of N elements an [N, 8] int32 tensor (gpu/mont.py).  Values are in
// Montgomery form with R = 2^256, the radix of the JAX package's 16-bit
// limbs, and every result is fully reduced into [0, p): the same bits the
// plain versions in gpu/mont.py produce.
//
// One thread owns one element.  Products are 32 x 32 -> 64-bit; the CIOS
// loop keeps its running sum in a uint64 whose bound is
// (2^32 - 1) + (2^32 - 1)^2 + (2^32 - 1) = 2^64 - 1, so it never overflows.
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

// a - p where a >= p; a < 2p
__device__ __forceinline__ Fe reduce_once(const Fe& a, const FieldParams& f) {
    Fe d;
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        const uint64_t t = (uint64_t)a.v[j] - f.p[j] - borrow;
        d.v[j] = (uint32_t)t;
        borrow = t >> 63;
    }
    return borrow ? a : d;
}

__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b, const FieldParams& f) {
    Fe s;
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        c += (uint64_t)a.v[j] + b.v[j];
        s.v[j] = (uint32_t)c;
        c >>= 32;
    }
    // a + b < 2p < 2^255: no carry out of the top limb
    return reduce_once(s, f);
}

__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b, const FieldParams& f) {
    Fe d;
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        const uint64_t t = (uint64_t)a.v[j] - b.v[j] - borrow;
        d.v[j] = (uint32_t)t;
        borrow = t >> 63;
    }
    if (borrow) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            c += (uint64_t)d.v[j] + f.p[j];
            d.v[j] = (uint32_t)c;
            c >>= 32;
        }
    }
    return d;
}

// a * b * 2^-256 mod p (CIOS, 8 x 32-bit limbs)
__device__ __forceinline__ Fe fe_mont_mul(const Fe& a, const Fe& b, const FieldParams& f) {
    uint32_t t[10];
#pragma unroll
    for (int j = 0; j < 10; j++) t[j] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < 8; j++) {
            c += (uint64_t)a.v[j] * b.v[i] + t[j];
            t[j] = (uint32_t)c;
            c >>= 32;
        }
        c += t[8];
        t[8] = (uint32_t)c;
        t[9] = (uint32_t)(c >> 32);
        const uint32_t m = t[0] * f.n0;
        c = ((uint64_t)m * f.p[0] + t[0]) >> 32;
#pragma unroll
        for (int j = 1; j < 8; j++) {
            c += (uint64_t)m * f.p[j] + t[j];
            t[j - 1] = (uint32_t)c;
            c >>= 32;
        }
        c += t[8];
        t[7] = (uint32_t)c;
        t[8] = t[9] + (uint32_t)(c >> 32);
    }
    // t < 2p < 2^256, so t[8] is 0 here
    Fe r;
#pragma unroll
    for (int j = 0; j < 8; j++) r.v[j] = t[j];
    return reduce_once(r, f);
}

}  // namespace plonkit
