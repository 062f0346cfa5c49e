"""In-circuit BN254 G1 arithmetic over non-native Fq limbs: affine
add/double and a shared-doubling Straus multi-scalar-multiplication.

Reference counterpart: franklin-crypto's aux_data/point gadgets driving the
in-circuit proof verification of the aggregation circuit (SURVEY D2c/D3).
Affine coordinates are the right in-circuit representation: field inversion
is witness + one mul-enforce, so an add is 3 multiplications instead of
Jacobian's ~11.

Soundness notes:
  * every allocated point is curve-checked (y^2 = x^3 + 3);
  * ec_add enforces x1 != x2 via an inverse witness -- without it the
    doubling case would leave lambda unconstrained and the prover could
    steer the aggregate to any point (negligible completeness loss:
    honest Straus traversal hits x-collisions with cryptographically
    small probability);
  * scalar decomposition reuses the range-chain 2-bit chunks; decomposing
    a canonical Fr scalar to 256 bits is unambiguous up to +r, and +r
    shifts the result by r*P = infinity, i.e. not at all;
  * identity points are not representable (affine) -- the accumulator is
    offset by a fixed point O and 2^bits * O is subtracted at the end, the
    standard completeness fix.
"""

from typing import List, Sequence, Tuple

from ..curve import G1_GEN, g1_mul, g1_neg
from ..fields import FQ_MODULUS as P, FR_MODULUS as R
from ..keccak import keccak256
from .cs import CsBuilder, Num
from .nonnative import (FqNum, NLIMBS, fq_add, fq_alloc, fq_constant,
                        fq_mul, fq_neg, fq_scale, fq_sub)


class PointG:
    """Affine G1 point gadget (never the identity)."""
    __slots__ = ("x", "y", "point")

    def __init__(self, x: FqNum, y: FqNum, point: Tuple[int, int]):
        self.x = x
        self.y = y
        self.point = point     # host-side (x, y) for witness computation


def _find_offset_point():
    """Fixed nothing-up-my-sleeve offset: G1_GEN * keccak(tag)."""
    k = int.from_bytes(keccak256(b"plonkit-tpu/straus-offset/v1"), "big") % R
    return g1_mul(G1_GEN, k)


OFFSET_POINT = _find_offset_point()


def point_alloc(cs: CsBuilder, pt: Tuple[int, int], check_curve: bool = True) -> PointG:
    assert pt is not None, "cannot allocate the identity in affine gadgets"
    x = fq_alloc(cs, pt[0])
    y = fq_alloc(cs, pt[1])
    g = PointG(x, y, pt)
    if check_curve:
        enforce_on_curve(cs, g)
    return g


def point_from_coords(cs: CsBuilder, x: FqNum, y: FqNum,
                      check_curve: bool = True) -> PointG:
    g = PointG(x, y, (x.value % P, y.value % P))
    if check_curve:
        enforce_on_curve(cs, g)
    return g


def point_constant(cs: CsBuilder, pt: Tuple[int, int]) -> PointG:
    return PointG(fq_constant(cs, pt[0]), fq_constant(cs, pt[1]), pt)


def enforce_on_curve(cs: CsBuilder, p: PointG):
    """y^2 - x^3 - 3 === 0 (mod p)."""
    y2 = fq_mul(cs, p.y, p.y)
    x2 = fq_mul(cs, p.x, p.x)
    rhs = fq_sub(cs, y2, fq_constant(cs, 3))
    fq_mul(cs, x2, p.x, expected=rhs)


def _host_add(p, q):
    (x1, y1), (x2, y2) = p, q
    assert x1 != x2, "affine add degenerate (x collision)"
    lam = (y2 - y1) * pow(x2 - x1, -1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return x3, y3, lam


def _host_double(p):
    x1, y1 = p
    assert y1 != 0
    lam = 3 * x1 * x1 * pow(2 * y1, -1, P) % P
    x3 = (lam * lam - 2 * x1) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return x3, y3, lam


def ec_add(cs: CsBuilder, p: PointG, q: PointG) -> PointG:
    """p + q, affine; enforces x_p != x_q."""
    x3v, y3v, lamv = _host_add(p.point, q.point)
    dx = fq_sub(cs, q.x, p.x)
    dy = fq_sub(cs, q.y, p.y)
    # x1 != x2: dx * inv(dx) == 1
    inv = fq_alloc(cs, pow(dx.value % P, -1, P))
    fq_mul(cs, dx, inv, expected=fq_constant(cs, 1))
    lam = fq_alloc(cs, lamv)
    fq_mul(cs, lam, dx, expected=dy)
    x3 = fq_alloc(cs, x3v)
    fq_mul(cs, lam, lam, expected=fq_add(cs, fq_add(cs, x3, p.x), q.x))
    y3 = fq_alloc(cs, y3v)
    fq_mul(cs, lam, fq_sub(cs, p.x, x3), expected=fq_add(cs, y3, p.y))
    return PointG(x3, y3, (x3v, y3v))


def ec_double(cs: CsBuilder, p: PointG) -> PointG:
    x3v, y3v, lamv = _host_double(p.point)
    lam = fq_alloc(cs, lamv)
    x2 = fq_mul(cs, p.x, p.x)
    fq_mul(cs, lam, fq_scale(cs, p.y, 2), expected=fq_scale(cs, x2, 3))
    x3 = fq_alloc(cs, x3v)
    fq_mul(cs, lam, lam, expected=fq_add(cs, fq_add(cs, x3, p.x), p.x))
    y3 = fq_alloc(cs, y3v)
    fq_mul(cs, lam, fq_sub(cs, p.x, x3), expected=fq_add(cs, y3, p.y))
    return PointG(x3, y3, (x3v, y3v))


def ec_neg(cs: CsBuilder, p: PointG) -> PointG:
    return PointG(p.x, fq_neg(cs, p.y), (p.point[0], (-p.point[1]) % P))


class _MuxTable:
    """Per-point window table [P, 2P, 3P] with per-limb deltas
    precomputed once, so each window mux is 2 mul_adds per limb."""

    def __init__(self, cs: CsBuilder, p: PointG):
        p2 = ec_double(cs, p)
        p3 = ec_add(cs, p2, p)
        self.entries = [p, p2, p3]
        self.cs = cs
        # limb lists: x0..x3, y0..y3 per entry
        self.e_limbs = [e.x.limbs + e.y.limbs for e in self.entries]
        self.e_bounds = [e.x.bounds + e.y.bounds for e in self.entries]
        self.d21 = [cs.lc([(b, 1), (a, R - 1)])
                    for a, b in zip(self.e_limbs[0], self.e_limbs[1])]
        self.d32 = [cs.lc([(b, 1), (a, R - 1)])
                    for a, b in zip(self.e_limbs[1], self.e_limbs[2])]

    def mux(self, b0: Num, b1: Num, bb: Num) -> PointG:
        """entry for chunk in {0->P(garbage), 1->P, 2->2P, 3->3P}:
        m = E1 + b1*(E2-E1) + bb*(E3-E2)."""
        cs = self.cs
        limbs = []
        for i in range(2 * NLIMBS):
            t = cs.mul_add(b1, self.d21[i], self.e_limbs[0][i])
            limbs.append(cs.mul_add(bb, self.d32[i], t))
        bounds = [max(b[i] for b in self.e_bounds) for i in range(2 * NLIMBS)]
        chunk = b0.value + 2 * b1.value
        pt = self.entries[max(chunk, 1) - 1].point
        x = FqNum(limbs[:NLIMBS], bounds[:NLIMBS],
                  sum(n.value << (68 * i) for i, n in enumerate(limbs[:NLIMBS])))
        y = FqNum(limbs[NLIMBS:], bounds[NLIMBS:],
                  sum(n.value << (68 * i) for i, n in enumerate(limbs[NLIMBS:])))
        return PointG(x, y, pt)


class _MuxTable4:
    """4-bit window table [P..15P] muxed through the multilinear (Moebius)
    expansion m(b) = sum_S c_S prod_{i in S} b_i: the 16 coefficient limbs
    c_S are linear combinations of the entry limbs, precomputed ONCE per
    point (15 lc gates/limb); each window then costs one 16-term lc per
    limb plus the 11 shared bit-products.  Entry 0 aliases P (chunk-0 adds
    are discarded by the select)."""

    def __init__(self, cs: CsBuilder, p: PointG):
        self.cs = cs
        entries = [p, ec_double(cs, p)]       # 2P via doubling (P+P is
        for _ in range(13):                   # degenerate for affine add)
            entries.append(ec_add(cs, entries[-1], p))
        self.entries = [p] + entries          # index by chunk, E0 = E1 = P
        e_limbs = [e.x.limbs + e.y.limbs for e in self.entries]
        e_bounds = [e.x.bounds + e.y.bounds for e in self.entries]
        # Moebius transform over the 4-cube, per limb
        self.coeffs = []                      # [16][2*NLIMBS] of (Num|const0)
        for s in range(16):
            if s == 0:
                self.coeffs.append(list(e_limbs[0]))
                continue
            row = []
            for i in range(2 * NLIMBS):
                terms = []
                for t in range(16):
                    if t & s == t:            # t subset of s
                        sign = 1 if (bin(s ^ t).count("1")) % 2 == 0 else R - 1
                        terms.append((e_limbs[t][i], sign))
                row.append(cs.lc(terms))
            self.coeffs.append(row)
        self.mux_bounds = [max(b[i] for b in e_bounds) for i in range(2 * NLIMBS)]

    def mux(self, bits, prods) -> PointG:
        """bits = [b0..b3] (LSB first); prods = {bitmask >= 3 with >=2 bits
        set -> Num product of those bits}, computed once per (point,
        window) by the caller.  m = c_0 + sum_{s>=1} sel_s * c_s: both
        factors are wires, so one mul_add per (limb, s)."""
        cs = self.cs
        sel = [None] * 16
        for s in range(1, 16):
            idx = [i for i in range(4) if s >> i & 1]
            sel[s] = bits[idx[0]] if len(idx) == 1 else prods[s]
        limbs = []
        for i in range(2 * NLIMBS):
            acc = self.coeffs[0][i]
            for s in range(1, 16):
                acc = cs.mul_add(sel[s], self.coeffs[s][i], acc)
            limbs.append(acc)
        chunk = sum(b.value << i for i, b in enumerate(bits))
        pt = self.entries[max(chunk, 1)].point
        x = FqNum(limbs[:NLIMBS], self.mux_bounds[:NLIMBS],
                  sum(n.value << (68 * i) for i, n in enumerate(limbs[:NLIMBS])))
        y = FqNum(limbs[NLIMBS:], self.mux_bounds[NLIMBS:],
                  sum(n.value << (68 * i) for i, n in enumerate(limbs[NLIMBS:])))
        return PointG(x, y, pt)


def _select_point(cs: CsBuilder, flag: Num, p: PointG, q: PointG) -> PointG:
    """flag ? p : q, limb-wise."""
    limbs = []
    for a, b in zip(p.x.limbs + p.y.limbs, q.x.limbs + q.y.limbs):
        limbs.append(cs.select(flag, a, b))
    bounds = [max(a, b) for a, b in zip(p.x.bounds + p.y.bounds,
                                        q.x.bounds + q.y.bounds)]
    pt = p.point if flag.value else q.point
    x = FqNum(limbs[:NLIMBS], bounds[:NLIMBS],
              sum(n.value << (68 * i) for i, n in enumerate(limbs[:NLIMBS])))
    y = FqNum(limbs[NLIMBS:], bounds[NLIMBS:],
              sum(n.value << (68 * i) for i, n in enumerate(limbs[NLIMBS:])))
    return PointG(x, y, pt)


def ec_multi_msm(cs: CsBuilder, groups: Sequence[Sequence[Tuple[PointG, Num]]],
                 width: int = 256, window_bits: int = 4) -> List[PointG]:
    """Straus multi-MSM with shared window schedule: groups[k] is a list of
    (point, scalar) pairs; returns [sum_i s_i * P_i for each group].
    All scalars share one doubling ladder per group accumulator.  width is
    the scalar bit width (256 covers canonical Fr; the +r decomposition
    freedom is harmless since r*P = O).  window_bits: 4 (default, [P..15P]
    multilinear mux) or 2 ([P,2P,3P] delta mux) -- 4 is ~30% fewer rows."""
    assert width % 8 == 0
    assert window_bits in (2, 4)

    # scalar chunk decomposition (MSB-first 2-bit chunks from range chains)
    all_chunks = []
    for group in groups:
        gch = []
        for pt, sc in group:
            assert sc.value < (1 << width), "scalar exceeds decomposition width"
            gch.append(cs.decompose_chunks(sc, width))
        all_chunks.append(gch)

    if window_bits == 2:
        tables = [[_MuxTable(cs, pt) for pt, _ in group] for group in groups]
    else:
        tables = [[_MuxTable4(cs, pt) for pt, _ in group] for group in groups]
    windows = width // window_bits

    accs = [point_constant(cs, OFFSET_POINT) for _ in groups]
    for w in range(windows):
        for k, group in enumerate(groups):
            acc = accs[k]
            for _ in range(window_bits // 2):
                acc = ec_double(cs, ec_double(cs, acc))
            for j, (pt, sc) in enumerate(group):
                if window_bits == 2:
                    ch = all_chunks[k][j][w]
                    b0 = cs.boolean(ch.value & 1)
                    b1 = cs.boolean((ch.value >> 1) & 1)
                    cs.enforce_lc([(ch, 1), (b0, R - 1), (b1, R - 2)])
                    bb = cs.mul(b0, b1)
                    entry = tables[k][j].mux(b0, b1, bb)
                    nz = cs.lc([(b0, 1), (b1, 1), (bb, R - 1)])
                else:
                    # window value = 4*chunk_{2w} + chunk_{2w+1} (MSB-first)
                    hi = all_chunks[k][j][2 * w]
                    lo = all_chunks[k][j][2 * w + 1]
                    val = 4 * hi.value + lo.value
                    bits = [cs.boolean((val >> i) & 1) for i in range(4)]
                    # bind bits to the two range-chain chunks
                    cs.enforce_lc([(hi, 4), (lo, 1), (bits[0], R - 1),
                                   (bits[1], R - 2), (bits[2], R - 4),
                                   (bits[3], R - 8)])
                    prods = {}
                    for s in range(3, 16):
                        if s & (s - 1) == 0:
                            continue
                        low = s & -s
                        rest = s ^ low
                        left = bits[low.bit_length() - 1]
                        right = bits[rest.bit_length() - 1] if rest & (rest - 1) == 0 \
                            else prods[rest]
                        prods[s] = cs.mul(left, right)
                    entry = tables[k][j].mux(bits, prods)
                    # nz = 1 - prod(1 - b_i): zero iff all bits zero
                    q01 = cs.mul(cs.lc([(bits[0], R - 1)], constant=1),
                                 cs.lc([(bits[1], R - 1)], constant=1))
                    q23 = cs.mul(cs.lc([(bits[2], R - 1)], constant=1),
                                 cs.lc([(bits[3], R - 1)], constant=1))
                    q = cs.mul(q01, q23)
                    nz = cs.lc([(q, R - 1)], constant=1)
                added = ec_add(cs, acc, entry)
                acc = _select_point(cs, nz, added, acc)
            accs[k] = acc

    # subtract 2^width * O from each accumulator
    correction = g1_neg(g1_mul(OFFSET_POINT, pow(2, width, R)))
    out = []
    for acc in accs:
        corr = point_constant(cs, correction)
        out.append(ec_add(cs, acc, corr))
    return out


def ec_msm(cs: CsBuilder, pairs: Sequence[Tuple[PointG, Num]],
           width: int = 256, window_bits: int = 4) -> PointG:
    return ec_multi_msm(cs, [pairs], width=width, window_bits=window_bits)[0]
