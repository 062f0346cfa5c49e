"""The PTX of the port's field arithmetic (plonkit_tpu_torch/csrc/field.cuh,
the carry chains of K13 field_inverse in csrc/scan.cu, and K14 / K15's
product split over two threads in csrc/group_ntt.cu) run here,
without a card, by a small emulator of the carry-flag
instructions it uses (add/addc, sub/subc, mul, mad/madc with .lo/.hi and
.cc): each asm statement's template is read from the header, its operands
bound in the order of its constraint list, and the C++ around the
statements (which statement runs when, with which limbs) is mirrored here.
The Montgomery product, add and sub are held against big-integer
arithmetic for Fr and Fq on edge and seeded random values, so is the split
product (its two threads' steps and shuffles mirrored here), K13's almost
Montgomery inverse (its loop mirrored here over the emulated chains)
against pow(a, -1, p), and every
chain that ends without .cc must drop a carry of 0 (but the add of p
after a borrow in fe_sub, which wraps mod 2^256 by design).  The kernels
themselves run only on the card (tests/test_torch_cuda.py)."""

import re
from pathlib import Path

import numpy as np
import pytest

from plonkit_tpu_torch.fields import FQ_MODULUS, FR_MODULUS

CSRC = Path(__file__).parents[1] / "plonkit_tpu_torch" / "csrc"
SRC = (CSRC / "field.cuh").read_text()
SCAN_SRC = (CSRC / "scan.cu").read_text()
GROUP_SRC = (CSRC / "group_ntt.cu").read_text()
MASK = (1 << 32) - 1


def _asm_blocks(signature: str, src: str = SRC) -> list:
    """The instruction lists of the asm statements in the function whose
    definition starts with `signature`, in source order."""
    body = src[src.index(signature):]
    body = body[:body.index("\n}\n")]
    out = []
    for m in re.finditer(r"asm\((.*?)\);", body, re.S):
        template = "".join(re.findall(r'"((?:[^"\\]|\\.)*)"', m.group(1).split(":")[0]))
        text = template.replace("\\n", "\n").replace("\\t", "")
        out.append([ln.strip() for ln in text.split(";") if ln.strip()])
    return out


def _run(lines, ops, wraps=False):
    """Execute one asm statement on operand values (outputs first, as in
    its constraint list); returns the operands after it.  Unless the
    statement wraps mod 2^256 by design (wraps), a chain end without .cc
    must not drop a carry."""
    ops, cf = list(ops), 0
    for ln in lines:
        op, args = ln.split(None, 1)
        regs = [a.strip() for a in args.split(",")]
        src = [ops[int(r[1:])] if r.startswith("%") else int(r, 0) for r in regs[1:]]
        parts = op.split(".")
        base, cc = parts[0], "cc" in parts
        if base in ("add", "addc"):
            r = src[0] + src[1] + (cf if base == "addc" else 0)
            carry = r >> 32
        elif base in ("sub", "subc"):
            r = src[0] - src[1] - (cf if base == "subc" else 0)
            carry = int(r < 0)
        elif base in ("mad", "madc"):
            prod = src[0] * src[1]
            r = (prod & MASK if "lo" in parts else prod >> 32) + src[2] + \
                (cf if base == "madc" else 0)
            carry = r >> 32
        elif base == "mul" and not cc:
            prod = src[0] * src[1]
            r, carry = (prod & MASK if "lo" in parts else prod >> 32), 0
        else:
            raise AssertionError(f"instruction not emulated: {op}")
        if not cc and not wraps and base in ("add", "addc", "mad", "madc"):
            assert carry == 0, f"{ln} drops a carry"
        ops[int(regs[0][1:])] = r & MASK
        if cc:
            cf = carry
    return ops


REDUCE = _asm_blocks("__device__ __forceinline__ Fe reduce_once")
ADD = _asm_blocks("__device__ __forceinline__ Fe fe_add")
SUB = _asm_blocks("__device__ __forceinline__ Fe fe_sub")
FIRST = _asm_blocks("__device__ __forceinline__ void eo_first")
SHIFT_ODD = _asm_blocks("__device__ __forceinline__ void eo_shift_odd")
MAD_EVEN = _asm_blocks("__device__ __forceinline__ void eo_mad_even")
MAD_ODD = _asm_blocks("__device__ __forceinline__ void eo_mad_odd")
MONT = _asm_blocks("__device__ __forceinline__ Fe fe_mont_mul")


def limbs(x):
    return [(x >> (32 * j)) & MASK for j in range(8)]


def value(ls):
    return sum(v << (32 * j) for j, v in enumerate(ls))


def reduce_once(a, p):
    out = _run(REDUCE[0], [0] * 9 + a + p)
    return a if out[8] else out[:8]


def fe_add(a, b, p):
    return reduce_once(_run(ADD[0], [0] * 8 + a + b)[:8], p)


def fe_sub(a, b, p):
    out = _run(SUB[0], [0] * 9 + a + b)
    pm = [x & out[8] for x in p]
    return _run(SUB[1], out[:8] + pm, wraps=True)[:8]      # a - b + 2^256 + p


def eo_row(e, o, a, b, p, n0, first):
    odd, even = [a[1], a[3], a[5], a[7]], [a[0], a[2], a[4], a[6]]
    if first:
        out = _run(FIRST[0], [0] * 16 + a + [b])
        e, o = out[:8], out[8:16]
    else:
        out = _run(SHIFT_ODD[0], [e[0]] + o + odd + [b])
        e, o = [out[0]] + e[1:], out[1:9]
        out = _run(MAD_EVEN[0], e + [o[7]] + even + [b])
        e, o = out[:8], o[:7] + [out[8]]
    m = e[0] * n0 & MASK
    o = _run(MAD_ODD[0], o + [p[1], p[3], p[5], p[7], m])[:8]
    out = _run(MAD_EVEN[0], e + [o[7]] + [p[0], p[2], p[4], p[6], m])
    e, o = out[:8], o[:7] + [out[8]]
    assert e[0] == 0
    return e, o


def fe_mont_mul(a, b, p, n0):
    e, o = [0] * 8, [0] * 8
    for i in range(0, 8, 2):
        e, o = eo_row(e, o, a, b[i], p, n0, i == 0)
        o, e = eo_row(o, e, a, b[i + 1], p, n0, False)
    return reduce_once(_run(MONT[0], [0] * 8 + e + o[1:])[:8], p)


FIELDS = {"fr": FR_MODULUS, "fq": FQ_MODULUS}


def _pairs(p, seed):
    edge = [0, 1, 2, p - 1, p - 2, p // 2, p // 2 + 1, (1 << 253) % p, (1 << 256) % p]
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(400)]
    return [(x, y) for x in edge for y in edge] + list(zip(rand, rand[1:] + rand[:1]))


@pytest.mark.parametrize("field", sorted(FIELDS))
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_ptx_matches_big_integers(field, op):
    p = FIELDS[field]
    n0 = -pow(p, -1, 1 << 32) % (1 << 32)
    r_inv = pow(1 << 256, -1, p)
    for x, y in _pairs(p, seed=len(field) + len(op)):
        a, b = limbs(x), limbs(y)
        if op == "mul":
            assert value(fe_mont_mul(a, b, limbs(p), n0)) == x * y * r_inv % p, (x, y)
        elif op == "add":
            assert value(fe_add(a, b, limbs(p))) == (x + y) % p, (x, y)
        else:
            assert value(fe_sub(a, b, limbs(p))) == (x - y) % p, (x, y)


def test_field_ptx_uses_only_emulated_instructions():
    """Every asm statement of field.cuh is one this file runs."""
    seen = {id(b) for blocks in (REDUCE, ADD, SUB, FIRST, SHIFT_ODD, MAD_EVEN, MAD_ODD, MONT)
            for b in blocks}
    assert len(seen) == SRC.count("asm(") == 9


ADD_RAW = _asm_blocks("__device__ __forceinline__ Fe add_raw", SCAN_SRC)
SUB_RAW = _asm_blocks("__device__ __forceinline__ Fe sub_raw", SCAN_SRC)
DIV_POW2 = _asm_blocks("__device__ __forceinline__ Fe div_pow2", SCAN_SRC)


def k13_inverse(x, p, n0):
    """csrc/scan.cu almost_inverse, step by step over the emulated chains:
    (x^-1 mod p, steps, k)."""
    pl = limbs(p)

    def add_raw(a, b):
        return _run(ADD_RAW[0], [0] * 8 + a + b)[:8]

    def sub_raw(a, b):
        assert value(a) >= value(b)
        return _run(SUB_RAW[0], [0] * 8 + a + b)[:8]

    def div_pow2(a, k):
        m = (a[0] * n0 & MASK) & ((1 << k) - 1)
        t = _run(DIV_POW2[0], [0] * 9 + [m] + a + pl)[:9]
        return reduce_once(limbs(value(t) >> k), pl)

    def even_shift(a):
        return (a[0] & -a[0]).bit_length() - 1 if a[0] else 31

    u, v, r, s, k, steps = pl, limbs(x), limbs(0), limbs(1), 0, 0
    while value(v):
        if not u[0] & 1:
            t = even_shift(u)
            u, s, k = limbs(value(u) >> t), limbs(value(s) << t), k + t
        elif not v[0] & 1:
            t = even_shift(v)
            v, r, k = limbs(value(v) >> t), limbs(value(r) << t), k + t
        elif value(u) > value(v):
            u, r = sub_raw(u, v), add_raw(r, s)
        else:
            v, s = sub_raw(v, u), add_raw(r, s)
        assert max(value(r), value(s)) < 2 * p      # the shifts drop no bit
        steps += 1
        assert steps <= 4096
    out = sub_raw(pl, reduce_once(r, pl))
    for shift in [31] * (k // 31) + ([k % 31] if k % 31 else []):
        out = div_pow2(out, shift)
    return value(out), steps, k


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_field_inverse_ptx_matches_big_integers(field):
    """K13: x^-1 mod p, then one Montgomery product by R^3 mod p takes the
    Montgomery form aR to a^-1 R."""
    p = FIELDS[field]
    n0 = -pow(p, -1, 1 << 32) % (1 << 32)
    rng = np.random.default_rng(len(field))
    xs = [1, 2, 3, p - 1, p - 2, p // 2, 1 << 253, (1 << 256) % p] + \
        [int.from_bytes(rng.bytes(32), "little") % p for _ in range(24)]
    r3 = limbs(pow(1 << 256, 3, p))
    for x in xs:
        inv, steps, k = k13_inverse(x, p, n0)
        assert inv == pow(x, -1, p) and steps < 1024 and k < 1 << 16, x
        a = x * (1 << 256) % p                       # Montgomery form in
        got = value(fe_mont_mul(limbs(k13_inverse(a, p, n0)[0]), r3, limbs(p), n0))
        assert got == pow(x, -1, p) * (1 << 256) % p, x


def test_scan_ptx_uses_only_emulated_instructions():
    """K13's carry chains are the only plain asm statements of scan.cu (its
    others are the look-back's release stores and acquire loads and the
    staging copies)."""
    assert SCAN_SRC.count("asm(") == 3 and len(ADD_RAW) == len(SUB_RAW) == len(DIV_POW2) == 1


SPLIT_SHIFT = _asm_blocks("__device__ __forceinline__ void split_shift_odd", GROUP_SRC)
SPLIT_MAD = _asm_blocks("__device__ __forceinline__ void split_mad", GROUP_SRC)
SPLIT_ADD2 = _asm_blocks("__device__ __forceinline__ void split_add2", GROUP_SRC)
SPLIT_MUL = _asm_blocks("__device__ __forceinline__ Fe split_mont_mul", GROUP_SRC)


def split_mont_mul(a, b, p, n0):
    """csrc/group_ntt.cu split_mont_mul on its two threads (rank 0 holds
    a's and p's limbs 0-3, rank 1 limbs 4-7): nine steps of split_step, the
    halves of each rank's window trading roles from step to step, the
    shuffles of m and of the lowest word done between the steps, then the
    windows' merge, their sum and one conditional subtraction."""
    A, P = (a[:4], a[4:]), (p[:4], p[4:])
    e, o = [[0] * 6, [0] * 6], [[0] * 6, [0] * 6]
    m_in, h_in = [0, 0], [0, 0]
    for t in range(9):
        m_out, h_out = [0, 0], [0, 0]
        for r in (0, 1):
            x, y = (e[r], o[r]) if t % 2 == 0 else (o[r], e[r])
            w = (b[t - 1] if t > 0 else 0) if r else (b[t] if t < 8 else 0)
            out = _run(SPLIT_SHIFT[0], [x[0]] + y + [A[r][1], A[r][3], w])
            x[0], y[:] = out[0], out[1:7]
            y[5] = 0
            x[:5] = _run(SPLIT_MAD[0], x[:5] + [A[r][0], A[r][2], w])[:5]
            m = m_in[r] if r else (x[0] * n0 & MASK if t < 8 else 0)
            y[:5] = _run(SPLIT_MAD[0], y[:5] + [P[r][1], P[r][3], m])[:5]
            x[:5] = _run(SPLIT_MAD[0], x[:5] + [P[r][0], P[r][2], m])[:5]
            x[2:5] = _run(SPLIT_ADD2[0], x[2:5] + [h_in[r]])[:3]
            if r == 0 and t < 8:
                assert x[0] == 0                    # the word rank 0 hands rank 1
            m_out[r], h_out[r] = m, x[0]
        if t < 8:                                   # __shfl_xor_sync(..., 1)
            m_in, h_in = m_out[::-1], h_out[::-1]
    w = [[e[r][0]] + _run(SPLIT_MUL[0], [0] * 6 + e[r][1:6] + o[r][:5])[:6] for r in (0, 1)]
    top = _run(SPLIT_MUL[1], [0] * 5 + w[0][3:7] + w[1][:5])[:5]
    return reduce_once(w[0][:3] + top, p)


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_split_product_ptx_matches_big_integers(field):
    """K14 and K15's product on two threads gives fe_mont_mul's value on
    edge and seeded operands (and a chain end that drops a carry drops 0)."""
    p = FIELDS[field]
    n0 = -pow(p, -1, 1 << 32) % (1 << 32)
    r_inv = pow(1 << 256, -1, p)
    edge_words = [(1 << 224) - 1, (p >> 32) << 32, p - (1 << 32)]
    pairs = _pairs(p, seed=7 + len(field)) + [(x, y) for x in edge_words for y in edge_words]
    for x, y in pairs:
        got = split_mont_mul(limbs(x), limbs(y), limbs(p), n0)
        assert value(got) == x * y * r_inv % p, (x, y)


def test_split_ptx_uses_only_emulated_instructions():
    """Every asm statement of csrc/group_ntt.cu is one of the split's, and
    this file runs each."""
    assert GROUP_SRC.count("asm(") == 5
    assert len(SPLIT_SHIFT) == len(SPLIT_MAD) == len(SPLIT_ADD2) == 1 and len(SPLIT_MUL) == 2
