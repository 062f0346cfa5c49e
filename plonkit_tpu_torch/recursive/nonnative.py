"""Non-native BN254 Fq arithmetic inside Fr circuits (RNS limb gadgets).

Parity target: franklin-crypto's RnsParameters::new_for_field(68, 110, 4)
bigint gadgets used throughout the reference's aggregation circuit
(plonkit's src/plonk.rs:214, src/recursive/mod.rs:56,142,
src/utils.rs, SURVEY D2b).  Same limb shape: 4 limbs x 68 bits.

Soundness of fq_mul (the workhorse): to show  a*b + C === e  (mod p)
it enforces the integer identity

    a*b + C  =  q*p + e + 2^272 * d_hi        (d_hi a free carry)

via two residues:
  * mod 2^272: partial products t_ij = a_i*b_j with i+j <= 3, the constant
    C, and q*m (m = 2^272 - p, so q*m === -q*p) are folded into two
    136-bit-step carry equations EQ1/EQ2.  Every EQ is an Fr equation whose
    terms are integer-bounded far below r, so Fr equality IS integer
    equality -- carries are shifted (d + SHIFT) and range-checked with the
    two-bit-decomposition custom gate.
  * mod r: native recombinations (x_bar = sum x_i 2^{68 i} mod r) give
    a_bar*b_bar + C - q_bar*p_bar - e_bar === 0 with one mul gate.
CRT: both residues + |a*b + C - q*p - e| < 2^272 * r  =>  exact equality.
Bounds are tracked per-limb and asserted at every step.
"""

from typing import List, Optional

from ..fields import FQ_MODULUS as P, FR_MODULUS as R
from .cs import CsBuilder, Num

LIMB_BITS = 68
NLIMBS = 4
BASE = 1 << LIMB_BITS
DBASE = 1 << (2 * LIMB_BITS)              # 2^136
TMOD = 1 << (NLIMBS * LIMB_BITS)          # 2^272
M = TMOD - P                              # -p mod 2^272 (positive, 272 bits)
MAX_LIMB_BOUND = 1 << 85                  # inputs to fq_mul must stay below
EQ_BOUND = 1 << 250                       # every carry-equation term bound


def split_limbs(x: int) -> List[int]:
    return [(x >> (LIMB_BITS * i)) & (BASE - 1) for i in range(NLIMBS)]


M_LIMBS = split_limbs(M)
P_LO = P % DBASE
P_HI = (P >> (2 * LIMB_BITS)) % DBASE
POW68 = [pow(2, LIMB_BITS * i, R) for i in range(NLIMBS)]


class FqNum:
    """A non-native Fq element: 4 limb wires (LSB first), the exact integer
    value they encode (NOT reduced mod p), and per-limb inclusive bounds."""
    __slots__ = ("limbs", "bounds", "value", "_native")

    def __init__(self, limbs: List[Num], bounds: List[int], value: int):
        assert len(limbs) == NLIMBS
        self.limbs = limbs
        self.bounds = bounds
        self.value = value
        self._native = None
        assert value == sum(n.value * (1 << (LIMB_BITS * i))
                            for i, n in enumerate(limbs)), "limb/value mismatch"
        for n, b in zip(limbs, bounds):
            assert n.value <= b, "limb exceeds tracked bound"

    @property
    def value_bound(self) -> int:
        return sum(b << (LIMB_BITS * i) for i, b in enumerate(self.bounds))


def fq_alloc(cs: CsBuilder, x: int, top_width: int = 50) -> FqNum:
    """Allocate a (canonically-split) witness Fq value with range-checked
    limbs.  top_width restricts the most-significant limb: 50 bits for
    canonical values (p < 2^254), 64 for quotients (see fq_mul's CRT bound:
    q*p must stay below 2^272 * r, and p > r so q cannot get 68)."""
    assert 0 <= x < (1 << (3 * LIMB_BITS + top_width))
    limbs = [cs.alloc(v) for v in split_limbs(x)]
    widths = [LIMB_BITS] * (NLIMBS - 1) + [top_width]
    bounds = []
    for n, w in zip(limbs, widths):
        cs.enforce_range(n, w)
        bounds.append((1 << w) - 1)
    return FqNum(limbs, bounds, x)


def fq_from_limbs(cs: CsBuilder, limbs: List[Num], range_check: bool = True) -> FqNum:
    if range_check:
        for n in limbs:
            cs.enforce_range(n, LIMB_BITS)
    value = sum(n.value << (LIMB_BITS * i) for i, n in enumerate(limbs))
    return FqNum(list(limbs), [BASE - 1] * NLIMBS, value)


def fq_constant(cs: CsBuilder, x: int) -> FqNum:
    assert 0 <= x < TMOD
    ls = split_limbs(x)
    return FqNum([cs.constant(v) for v in ls], ls, x)


def fq_add(cs: CsBuilder, a: FqNum, b: FqNum) -> FqNum:
    limbs = [cs.lc([(x, 1), (y, 1)]) for x, y in zip(a.limbs, b.limbs)]
    bounds = [x + y for x, y in zip(a.bounds, b.bounds)]
    return FqNum(limbs, bounds, a.value + b.value)


def fq_add_const(cs: CsBuilder, a: FqNum, c: int) -> FqNum:
    cl = split_limbs(c)
    limbs = [cs.lc([(x, 1)], constant=k) if k else x
             for x, k in zip(a.limbs, cl)]
    bounds = [x + k for x, k in zip(a.bounds, cl)]
    return FqNum(limbs, bounds, a.value + c)


def _borrow_absorbed_multiple(bounds: List[int]):
    """Smallest s and limbs k_i with sum k_i 2^{68 i} = s*p and
    k_i >= bounds[i] for all i (so per-limb subtraction never underflows)."""
    s = (sum((b + 1) << (LIMB_BITS * i) for i, b in enumerate(bounds)) // P) + 1
    while True:
        t = s * P
        ks = []
        ok = True
        rem = t
        for i in range(NLIMBS):
            k = rem & (BASE - 1) if i < NLIMBS - 1 else rem
            borrow = 0
            if k < bounds[i]:
                borrow = -(-(bounds[i] - k) // BASE)  # ceil
                k += borrow * BASE
            ks.append(k)
            if i < NLIMBS - 1:
                rem = (rem >> LIMB_BITS) - borrow
                if rem < 0:
                    ok = False
                    break
            else:
                if borrow:
                    ok = False
        if ok and all(k >= b for k, b in zip(ks, bounds)):
            assert sum(k << (LIMB_BITS * i) for i, k in enumerate(ks)) == s * P
            return s, ks
        s += 1


def fq_sub(cs: CsBuilder, a: FqNum, b: FqNum) -> FqNum:
    """a - b + s*p with s chosen so every limb stays non-negative."""
    s, ks = _borrow_absorbed_multiple(b.bounds)
    limbs = [cs.lc([(x, 1), (y, R - 1)], constant=k)
             for x, y, k in zip(a.limbs, b.limbs, ks)]
    bounds = [x + k for x, k in zip(a.bounds, ks)]
    return FqNum(limbs, bounds, a.value - b.value + s * P)


def fq_neg(cs: CsBuilder, a: FqNum) -> FqNum:
    s, ks = _borrow_absorbed_multiple(a.bounds)
    limbs = [cs.lc([(y, R - 1)], constant=k) for y, k in zip(a.limbs, ks)]
    bounds = list(ks)
    return FqNum(limbs, bounds, s * P - a.value)


def fq_scale(cs: CsBuilder, a: FqNum, k: int) -> FqNum:
    assert k > 0
    limbs = [cs.lc([(x, k)]) for x in a.limbs]
    return FqNum(limbs, [b * k for b in a.bounds], a.value * k)


def fq_native(cs: CsBuilder, a: FqNum) -> Num:
    """x_bar = sum limb_i * 2^{68 i} mod r (memoized)."""
    if a._native is None:
        a._native = cs.lc([(n, POW68[i]) for i, n in enumerate(a.limbs)])
    return a._native


def _alloc_carry(cs: CsBuilder, s_value: int, pos_bound: int, neg_bound: int):
    """Carry witness for a 136-bit step: d = s_value / 2^136 (exact), with
    d in [-ceil(neg/2^136)-1, pos/2^136].  Allocates e = d + SHIFT >= 0,
    range-checks e, returns (e, SHIFT)."""
    assert s_value % DBASE == 0, "carry step not divisible (bad witness)"
    d = s_value // DBASE
    shift_bits = max((neg_bound // DBASE + 2).bit_length(), 1)
    shift = 1 << shift_bits
    e_bound = pos_bound // DBASE + shift + 1
    width = (e_bound.bit_length() + 1) & ~1
    assert d + shift >= 0
    e = cs.alloc(d + shift)
    cs.enforce_range(e, width)
    return e, shift, (1 << width) - 1


def fq_mul(cs: CsBuilder, a: FqNum, b: FqNum,
           expected: Optional[FqNum] = None) -> Optional[FqNum]:
    """If expected is None: return fresh reduced r with a*b === r (mod p).
    Else: enforce a*b === expected (mod p) and return None (saves the
    output allocation + range chain -- used for all lambda constraints)."""
    for x in (a, b):
        for bd in x.bounds:
            assert bd < MAX_LIMB_BOUND, "fq_mul operand limbs too lazy"

    prod = a.value * b.value
    if expected is None:
        e = fq_alloc(cs, prod % P)
        shift_c = 0
    else:
        e = expected
        # constant offset C = u*p so that q = (a*b + C - e)/p >= 0
        u = e.value_bound // P + 1
        shift_c = u * P
        assert (prod + shift_c - e.value) % P == 0, \
            "fq_mul: expected value not congruent to product"
    q_int = (prod + shift_c - e.value) // P
    assert 0 <= q_int < (1 << (3 * LIMB_BITS + 64)), "quotient out of range"
    q = fq_alloc(cs, q_int, top_width=64)

    # CRT bound: |a*b + C - q*p - e| < 2^272 * r.  Positive side is
    # a*b + C; negative side is q*p + e with q < 2^268 (top limb 64 bits,
    # needed because p > r so a full 2^272 quotient would overflow).
    assert a.value_bound * b.value_bound + shift_c < (1 << 268) * P
    assert (1 << 268) * P + e.value_bound < TMOD * R

    # partial products t_ij (i+j <= 3) as mul gates
    t = {}
    for i in range(NLIMBS):
        for j in range(NLIMBS - i):
            t[(i, j)] = cs.mul(a.limbs[i], b.limbs[j])

    c_lo = shift_c % DBASE
    c_hi = (shift_c >> (2 * LIMB_BITS)) % DBASE

    # ---- EQ1: weights 2^0 .. 2^135 --------------------------------------
    terms1 = [(t[(0, 0)], 1), (t[(0, 1)], BASE), (t[(1, 0)], BASE),
              (q.limbs[0], (M_LIMBS[0] + BASE * M_LIMBS[1]) % R),
              (q.limbs[1], (BASE * M_LIMBS[0]) % R),
              (e.limbs[0], R - 1), (e.limbs[1], (R - BASE) % R)]
    s1_val = (t[(0, 0)].value + BASE * (t[(0, 1)].value + t[(1, 0)].value)
              + q.limbs[0].value * (M_LIMBS[0] + BASE * M_LIMBS[1])
              + q.limbs[1].value * BASE * M_LIMBS[0]
              + c_lo - e.limbs[0].value - BASE * e.limbs[1].value)
    pos1 = (a.bounds[0] * b.bounds[0]
            + BASE * (a.bounds[0] * b.bounds[1] + a.bounds[1] * b.bounds[0])
            + (BASE - 1) * (M_LIMBS[0] + BASE * M_LIMBS[1])
            + (BASE - 1) * BASE * M_LIMBS[0] + c_lo)
    neg1 = e.bounds[0] + BASE * e.bounds[1]
    assert pos1 + neg1 < EQ_BOUND
    e1, sh1, e1_bound = _alloc_carry(cs, s1_val, pos1, neg1)
    terms1.append((e1, R - DBASE % R))
    cs.enforce_lc(terms1, constant=(c_lo + DBASE * sh1) % R)

    # ---- EQ2: weights 2^136 .. 2^271 ------------------------------------
    m_q = [  # coefficient of q_i in (q*m mod-part) at this 136-bit window
        (M_LIMBS[2] + BASE * M_LIMBS[3]) % R,   # q0
        (M_LIMBS[1] + BASE * M_LIMBS[2]) % R,   # q1
        (M_LIMBS[0] + BASE * M_LIMBS[1]) % R,   # q2
        (BASE * M_LIMBS[0]) % R,                # q3
    ]
    m_q_int = [M_LIMBS[2] + BASE * M_LIMBS[3], M_LIMBS[1] + BASE * M_LIMBS[2],
               M_LIMBS[0] + BASE * M_LIMBS[1], BASE * M_LIMBS[0]]
    terms2 = [(t[(0, 2)], 1), (t[(1, 1)], 1), (t[(2, 0)], 1),
              (t[(0, 3)], BASE), (t[(1, 2)], BASE), (t[(2, 1)], BASE),
              (t[(3, 0)], BASE)]
    terms2 += [(q.limbs[i], m_q[i]) for i in range(NLIMBS)]
    terms2 += [(e.limbs[2], R - 1), (e.limbs[3], (R - BASE) % R), (e1, 1)]
    s2_val = (t[(0, 2)].value + t[(1, 1)].value + t[(2, 0)].value
              + BASE * (t[(0, 3)].value + t[(1, 2)].value
                        + t[(2, 1)].value + t[(3, 0)].value)
              + sum(q.limbs[i].value * m_q_int[i] for i in range(NLIMBS))
              + c_hi + (e1.value - sh1)
              - e.limbs[2].value - BASE * e.limbs[3].value)
    pos2 = (a.bounds[0] * b.bounds[2] + a.bounds[1] * b.bounds[1]
            + a.bounds[2] * b.bounds[0]
            + BASE * (a.bounds[0] * b.bounds[3] + a.bounds[1] * b.bounds[2]
                      + a.bounds[2] * b.bounds[1] + a.bounds[3] * b.bounds[0])
            + (BASE - 1) * sum(m_q_int) + c_hi + e1_bound)
    neg2 = e.bounds[2] + BASE * e.bounds[3] + sh1
    assert pos2 + neg2 < EQ_BOUND
    e2, sh2, _ = _alloc_carry(cs, s2_val, pos2, neg2)
    terms2.append((e2, R - DBASE % R))
    cs.enforce_lc(terms2, constant=(c_hi - sh1 + DBASE * sh2) % R)

    # ---- native (mod r) residue -----------------------------------------
    # The TRUE integer X = a*b + C - q*p - e must vanish mod r (the top
    # carry e2 is NOT part of X: EQ1/EQ2 already prove X == 0 mod 2^272;
    # together with this residue and |X| < 2^272 * r, X = 0 over Z).
    an, bn = fq_native(cs, a), fq_native(cs, b)
    qn, en = fq_native(cs, q), fq_native(cs, e)
    ab = cs.mul(an, bn)
    cs.enforce_lc([(ab, 1), (qn, R - P % R), (en, R - 1)],
                  constant=shift_c % R)

    return None if expected is not None else e


def fq_enforce_zero(cs: CsBuilder, a: FqNum):
    """a === 0 (mod p) for a non-negative limbed value."""
    assert a.value % P == 0, "fq_enforce_zero: witness not divisible by p"
    k_int = a.value // P
    k_bound = a.value_bound // P
    assert k_bound < R
    k_width = (max(k_bound.bit_length(), 2) + 1) & ~1
    k = cs.alloc(k_int)
    cs.enforce_range(k, k_width)
    k_rng = (1 << k_width) - 1

    # EQ1: a0 + 2^68 a1 - k*P_lo = 2^136 * d1
    s1_val = a.limbs[0].value + BASE * a.limbs[1].value - k.value * P_LO
    pos1 = a.bounds[0] + BASE * a.bounds[1]
    neg1 = k_rng * P_LO
    assert pos1 + neg1 < EQ_BOUND
    e1, sh1, e1_bound = _alloc_carry(cs, s1_val, pos1, neg1)
    cs.enforce_lc([(a.limbs[0], 1), (a.limbs[1], BASE),
                   (k, (R - P_LO) % R), (e1, R - DBASE % R)],
                  constant=DBASE * sh1 % R)

    # EQ2: a2 + 2^68 a3 + d1 - k*P_hi = 2^136 * d2, and d2 must be 0
    s2_val = (a.limbs[2].value + BASE * a.limbs[3].value
              + (e1.value - sh1) - k.value * P_HI)
    pos2 = a.bounds[2] + BASE * a.bounds[3] + e1_bound
    neg2 = k_rng * P_HI + sh1
    assert pos2 + neg2 < EQ_BOUND
    e2, sh2, _ = _alloc_carry(cs, s2_val, pos2, neg2)
    cs.enforce_lc([(a.limbs[2], 1), (a.limbs[3], BASE),
                   (k, (R - P_HI) % R), (e1, 1), (e2, R - DBASE % R)],
                  constant=(DBASE * sh2 - sh1) % R)
    # top carry must vanish: a = k*p exactly requires a < 2^272 * 1 slack;
    # enforce d2 == 0 i.e. e2 == sh2
    cs.enforce_constant(e2, sh2)


def fq_enforce_equal(cs: CsBuilder, a: FqNum, b: FqNum):
    fq_enforce_zero(cs, fq_sub(cs, a, b))
