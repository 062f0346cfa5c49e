"""Deterministic dev SRS: the G1 powers tau^i * G for a small public tau.

plonkit_tpu/api.py:gen_key_monomial_form multiplies the generator by every
tau^i from scratch (one full scalar multiplication, ~15 ms of python, per
point).  With tau = 42 each point is the previous one times 42: five
doublings and two additions in Jacobian coordinates, then one batch
inversion for the whole run to return affine points.  The points are the
same, and at 2^20 this takes minutes instead of hours.
"""

from .curve import G1_GEN
from .fields import FQ_MODULUS as Q, FR_MODULUS


def _double(X, Y, Z):
    A = X * X % Q
    B = Y * Y % Q
    C = B * B % Q
    D = 2 * ((X + B) * (X + B) - A - C) % Q
    E = 3 * A % Q
    X3 = (E * E - 2 * D) % Q
    return X3, (E * (D - X3) - 8 * C) % Q, 2 * Y * Z % Q


def _add(X1, Y1, Z1, X2, Y2, Z2):
    """P1 + P2 for P1 != +-P2, neither at infinity."""
    Z1Z1 = Z1 * Z1 % Q
    Z2Z2 = Z2 * Z2 % Q
    U1 = X1 * Z2Z2 % Q
    U2 = X2 * Z1Z1 % Q
    S1 = Y1 * Z2 * Z2Z2 % Q
    S2 = Y2 * Z1 * Z1Z1 % Q
    H = (U2 - U1) % Q
    r = (S2 - S1) % Q
    HH = H * H % Q
    HHH = H * HH % Q
    V = U1 * HH % Q
    X3 = (r * r - HHH - 2 * V) % Q
    return X3, (r * (V - X3) - S1 * HHH) % Q, Z1 * Z2 * H % Q


def dev_srs_g1(count: int, tau: int):
    """Affine points tau^i * G for 0 <= i < count."""
    if not 1 < tau < FR_MODULUS:
        raise ValueError("tau must be in (1, r)")
    bits = bin(tau)[3:]                      # below the leading one
    jac = [(*G1_GEN, 1)]
    for _ in range(count - 1):
        P = jac[-1]
        acc = P
        for b in bits:                       # left-to-right double and add
            acc = _double(*acc)
            if b == "1":
                acc = _add(*acc, *P)
        jac.append(acc)
    # one inversion for the whole run (Montgomery's trick)
    prefix = [1] * (count + 1)
    for i, (_, _, z) in enumerate(jac):
        prefix[i + 1] = prefix[i] * z % Q
    inv = pow(prefix[count], -1, Q)
    out = [None] * count
    for i in range(count - 1, -1, -1):
        x, y, z = jac[i]
        zi = prefix[i] * inv % Q
        inv = inv * z % Q
        zi2 = zi * zi % Q
        out[i] = (x * zi2 % Q, y * zi2 * zi % Q)
    return out

