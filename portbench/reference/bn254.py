"""BN254 for the plain reference: the two prime fields as python ints and
G1 in Jacobian coordinates.  Written for this benchmark; it imports nothing
of the program.

Points are affine (x, y) int pairs, None for infinity, at the interface;
inside, Jacobian (X, Y, Z) with Z = 0 for infinity.  Everything is
canonical (no Montgomery form)."""

import numpy as np

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583  # Fq
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617  # Fr
G1 = (1, 2)
TWO_ADICITY = 28
# bellman's root of unity: the multiplicative generator 7 to the power (r - 1) / 2^28
ROOT_OF_UNITY = pow(7, (R - 1) >> TWO_ADICITY, R)


def omega(size: int) -> int:
    """The primitive root of unity of a power-of-two domain (bellman's
    Domain::new_for_size)."""
    log2 = size.bit_length() - 1
    if size != 1 << log2 or log2 > TWO_ADICITY:
        raise ValueError(f"no domain of size {size}")
    return pow(ROOT_OF_UNITY, 1 << (TWO_ADICITY - log2), R)


def inv(a: int, m: int) -> int:
    return pow(a, m - 2, m)


def batch_inverse(values: list, m: int) -> list:
    """Inverses of non-zero values mod m by Montgomery's trick."""
    prefix = [1] * len(values)
    acc = 1
    for i, v in enumerate(values):
        prefix[i] = acc
        acc = acc * v % m
    acc = inv(acc, m)
    out = [0] * len(values)
    for i in range(len(values) - 1, -1, -1):
        out[i] = acc * prefix[i] % m
        acc = acc * values[i] % m
    return out


# -- G1 --------------------------------------------------------------------------

INF = (1, 1, 0)


def to_jac(p):
    return INF if p is None else (p[0], p[1], 1)


def to_affine(j):
    x, y, z = j
    if z % P == 0:
        return None
    zi = inv(z, P)
    zi2 = zi * zi % P
    return (x * zi2 % P, y * zi2 * zi % P)


def jdouble(j):
    x, y, z = j
    if z == 0 or y == 0:
        return INF
    a = x * x % P
    b = y * y % P
    c = b * b % P
    d = 2 * ((x + b) * (x + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return (x3, (e * (d - x3) - 8 * c) % P, 2 * y * z % P)


def jadd(p, q):
    """p + q for Jacobian p, q, every case included."""
    if p[2] == 0:
        return q
    if q[2] == 0:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1 % P
    z2z2 = z2 * z2 % P
    u1 = x1 * z2z2 % P
    u2 = x2 * z1z1 % P
    s1 = y1 * z2 * z2z2 % P
    s2 = y2 * z1 * z1z1 % P
    if u1 == u2:
        return jdouble(p) if s1 == s2 else INF
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return (x3, (r * (v - x3) - s1 * hhh) % P, z1 * z2 * h % P)


def jadd_affine(p, x2: int, y2: int):
    """p + (x2, y2) for Jacobian p and a finite affine point."""
    x1, y1, z1 = p
    if z1 == 0:
        return (x2, y2, 1)
    z1z1 = z1 * z1 % P
    u2 = x2 * z1z1 % P
    s2 = y2 * z1 * z1z1 % P
    if u2 == x1:
        return jdouble(p) if s2 == y1 else INF
    h = (u2 - x1) % P
    r = (s2 - y1) % P
    hh = h * h % P
    hhh = h * hh % P
    v = x1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return (x3, (r * (v - x3) - y1 * hhh) % P, z1 * h % P)


def mul(p, k: int):
    """[k] p for an affine point p (None for infinity); returns affine."""
    k %= R
    acc = INF
    if p is None or k == 0:
        return None
    for bit in bin(k)[2:]:
        acc = jdouble(acc)
        if bit == "1":
            acc = jadd_affine(acc, p[0], p[1])
    return to_affine(acc)


def add(p, q):
    return to_affine(jadd(to_jac(p), to_jac(q)))


def neg(p):
    return None if p is None else (p[0], (-p[1]) % P)


# -- limb rows -------------------------------------------------------------------

def ints_of_rows(rows) -> list:
    """[N, 8] little-endian 32-bit limb rows -> N python ints."""
    raw = np.ascontiguousarray(rows, dtype="<u4").tobytes()
    frm = int.from_bytes
    return [frm(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


def sum_affine_rows(x_rows, y_rows, inf) -> tuple:
    """The sum of the affine points given as limb rows (x, y [N, 8], inf
    [N] bool), as an affine point, with one inversion at the end."""
    acc = INF
    for xi, yi, fi in zip(ints_of_rows(x_rows), ints_of_rows(y_rows), np.asarray(inf).tolist()):
        if not fi:
            acc = jadd_affine(acc, xi, yi)
    return to_affine(acc)


def lagrange_at(size: int, at: int, indices) -> list:
    """L_i(at) over the domain of `size` points for each i of `indices`:
    w^i (at^n - 1) / (n (at - w^i))."""
    w = omega(size)
    vanishing = (pow(at, size, R) - 1) % R
    if vanishing == 0:
        raise ValueError("the point lies in the domain")
    pows = [pow(w, i, R) for i in indices]
    dens = batch_inverse([(at - p) * size % R for p in pows], R)
    return [vanishing * p % R * d % R for p, d in zip(pows, dens)]


def lagrange_all(size: int, at: int) -> list:
    """L_i(at) for every i < size."""
    w = omega(size)
    vanishing = (pow(at, size, R) - 1) % R
    if vanishing == 0:
        raise ValueError("the point lies in the domain")
    pows = [1] * size
    for i in range(1, size):
        pows[i] = pows[i - 1] * w % R
    dens = batch_inverse([(at - p) * size % R for p in pows], R)
    return [vanishing * p % R * d % R for p, d in zip(pows, dens)]
