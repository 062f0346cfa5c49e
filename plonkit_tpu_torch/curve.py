"""Host-side BN254 G1/G2 elliptic-curve arithmetic (python ints).

Behavioral parity with pairing_ce's bn256 curve (SURVEY D1a).  The host layer
is used for small O(1) work: SRS point validation, G2 handling, verifier-side
scalar muls, and as the correctness oracle.  Bulk MSMs run in the native
host Pippenger (plonkit_tpu_torch/native.py).

Points are represented as:
  G1: (x, y) int tuples in affine form; None = point at infinity.
  G2: ((x0, x1), (y0, y1)) Fq2 coordinate pairs (c0 + c1*u); None = infinity.
"""

from .fields import FQ_MODULUS as Q, FR_MODULUS as _R, fq_inv

# Generators
G1_GEN = (1, 2)  # contrib/template.sol:68 P1()
# contrib/template.sol:103-112 P2() lists [c1, c0]; canonical (c0, c1) order here:
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# Fq2 = Fq[u]/(u^2 + 1)


def fq2_add(a, b):
    return ((a[0] + b[0]) % Q, (a[1] + b[1]) % Q)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % Q, (a[1] - b[1]) % Q)


def fq2_neg(a):
    return ((-a[0]) % Q, (-a[1]) % Q)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = (a0b0 - a1b1) + (a0b1 + a1b0) u
    a0b0 = a[0] * b[0]
    a1b1 = a[1] * b[1]
    return ((a0b0 - a1b1) % Q, ((a[0] + a[1]) * (b[0] + b[1]) - a0b0 - a1b1) % Q)


def fq2_sq(a):
    return fq2_mul(a, a)


def fq2_inv(a):
    norm = (a[0] * a[0] + a[1] * a[1]) % Q
    inv_norm = fq_inv(norm)
    return (a[0] * inv_norm % Q, (-a[1]) * inv_norm % Q)


def fq2_mul_scalar(a, s):
    return (a[0] * s % Q, a[1] * s % Q)


# ---------------------------------------------------------------------------
# Generic short-Weierstrass affine ops, parameterized by the field ops
# ---------------------------------------------------------------------------

class _CurveOps:
    def __init__(self, add, sub, neg, mul, sq, inv, zero, scalar3):
        self.add, self.sub, self.neg, self.mul, self.sq, self.inv = add, sub, neg, mul, sq, inv
        self.zero = zero
        self.scalar3 = scalar3  # the literal 3 in this field


_G1OPS = _CurveOps(
    add=lambda a, b: (a + b) % Q,
    sub=lambda a, b: (a - b) % Q,
    neg=lambda a: (-a) % Q,
    mul=lambda a, b: (a * b) % Q,
    sq=lambda a: (a * a) % Q,
    inv=fq_inv,
    zero=0,
    scalar3=3,
)

_G2OPS = _CurveOps(
    add=fq2_add, sub=fq2_sub, neg=fq2_neg, mul=fq2_mul, sq=fq2_sq, inv=fq2_inv,
    zero=(0, 0), scalar3=(3, 0),
)


def _ec_add(p, q, ops):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2:
        if y1 == y2:
            return _ec_double(p, ops)
        return None
    lam = ops.mul(ops.sub(y2, y1), ops.inv(ops.sub(x2, x1)))
    x3 = ops.sub(ops.sub(ops.sq(lam), x1), x2)
    y3 = ops.sub(ops.mul(lam, ops.sub(x1, x3)), y1)
    return (x3, y3)


def _ec_double(p, ops):
    if p is None:
        return None
    x, y = p
    if y == ops.zero:
        return None
    three_x2 = ops.mul(ops.sq(x), ops.scalar3)
    lam = ops.mul(three_x2, ops.inv(ops.add(y, y)))
    x3 = ops.sub(ops.sq(lam), ops.add(x, x))
    y3 = ops.sub(ops.mul(lam, ops.sub(x, x3)), y)
    return (x3, y3)


def _ec_mul(p, k, ops):
    if k == 0 or p is None:
        return None
    acc = None
    addend = p
    while k:
        if k & 1:
            acc = _ec_add(acc, addend, ops)
        addend = _ec_double(addend, ops)
        k >>= 1
    return acc


# G1 public API

def g1_add(p, q):
    return _ec_add(p, q, _G1OPS)


def g1_double(p):
    return _ec_double(p, _G1OPS)


def g1_neg(p):
    if p is None:
        return None
    return (p[0], (-p[1]) % Q)


def g1_mul(p, k):
    from .fields import FR_MODULUS
    return _ec_mul(p, k % FR_MODULUS, _G1OPS)


# BN254's endomorphism (GLV): phi(x, y) = (GLV_BETA x, y) = [GLV_LAMBDA] (x, y)
# on G1, with GLV_BETA a cube root of unity in Fq and GLV_LAMBDA one in Fr
# (each has two; these are a matching pair, their squares the other).
GLV_BETA = 0x59e26bcea0d48bacd4f263f1acdb5c4f5763473177fffffe
GLV_LAMBDA = 0xb3c4d79d41a917585bfc41088d8daaa78b17ea66b99c90dd
# The short basis (a1, b1), (a2, b2) of {(a, b) : a + b GLV_LAMBDA = 0 mod r}
# from the extended Euclidean algorithm on (r, GLV_LAMBDA), with a1 b2 - a2 b1
# = r.  Both vectors are under 2^127.
GLV_A1, GLV_B1 = 0x89d3256894d213e3, -0x6f4d8248eeb859fc8211bbeb7d4f1128
GLV_A2, GLV_B2 = 0x6f4d8248eeb859fd0be4e1541221250b, 0x89d3256894d213e3
# Babai rounding by precomputed constants: c1 = round(k G1 / 2^256) and c2 =
# round(k G2 / 2^256) for the coordinates k b2 / r and -k b1 / r of (k, 0)
# in the basis, G_i rounded to the nearest integer.
GLV_G1 = ((GLV_B2 << 256) + _R // 2) // _R
GLV_G2 = ((-GLV_B1 << 256) + _R // 2) // _R
# |k1| <= (5/8)(a1 + a2) and |k2| <= (5/8)(|b1| + b2) for 0 <= k < r: each
# c_i is off its coordinate by at most 1/2 (its rounding) + r / 2^257 (G_i's,
# scaled by k < r < 2^254), under 5/8.  Both bounds are under 2^126.13.
GLV_BOUND = (5 * max(GLV_A1 + GLV_A2, -GLV_B1 + GLV_B2) + 7) // 8


def glv_split(k: int) -> tuple:
    """k1, k2 with k1 + k2 GLV_LAMBDA = k (mod r) and |k1|, |k2| <=
    GLV_BOUND, for 0 <= k < r: csrc/group_ntt.cu's glv_split in python ints."""
    c1 = (k * GLV_G1 + (1 << 255)) >> 256
    c2 = (k * GLV_G2 + (1 << 255)) >> 256
    return k - c1 * GLV_A1 - c2 * GLV_A2, -c1 * GLV_B1 - c2 * GLV_B2


def g1_is_on_curve(p):
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + 3)) % Q == 0


def g1_msm_host(points, scalars):
    """Reference Pippenger MSM on host (for tests / tiny inputs)."""
    from .fields import FR_MODULUS
    assert len(points) >= len(scalars)
    pairs = [(p, s % FR_MODULUS) for p, s in zip(points, scalars) if s % FR_MODULUS and p is not None]
    if not pairs:
        return None
    c = 8 if len(pairs) > 32 else 3
    num_windows = (254 + c - 1) // c
    acc = None
    for w in range(num_windows - 1, -1, -1):
        if acc is not None:
            for _ in range(c):
                acc = g1_double(acc)
        buckets = {}
        shift = w * c
        mask = (1 << c) - 1
        for p, s in pairs:
            digit = (s >> shift) & mask
            if digit:
                buckets[digit] = g1_add(buckets.get(digit), p)
        running = None
        window_sum = None
        for digit in range(max(buckets) if buckets else 0, 0, -1):
            running = g1_add(running, buckets.get(digit))
            window_sum = g1_add(window_sum, running)
        acc = g1_add(acc, window_sum)
    return acc


# G2 public API

def g2_add(p, q):
    return _ec_add(p, q, _G2OPS)


def g2_mul(p, k):
    from .fields import FR_MODULUS
    return _ec_mul(p, k % FR_MODULUS, _G2OPS)


def g2_neg(p):
    if p is None:
        return None
    return (p[0], fq2_neg(p[1]))


# b' for the twist curve y^2 = x^3 + 3/(9+u) on which G2 lives
_B2 = fq2_mul_scalar(fq2_inv((9, 1)), 3)


def g2_is_on_curve(p):
    if p is None:
        return True
    x, y = p
    lhs = fq2_sq(y)
    rhs = fq2_add(fq2_mul(fq2_sq(x), x), _B2)
    return lhs == rhs
