"""BN254 G1 arithmetic in Jacobian coordinates over Fq, in plain PyTorch.

Ported from plonkit_tpu/tpu/ec.py.  A batch of N points is a tuple
(X, Y, Z) of [N, 8] int32 Montgomery rows (gpu/mont.py layout); Z == 0
encodes infinity.  An affine batch is (x, y, inf) with `inf` an [N] bool
mask.  Every formula is the reference's, in the reference's order, and
every field result is fully reduced, so each output limb equals the JAX
package's, degenerate cases included: P + P in the complete `add` and
`add_mixed` goes through `double`, P + (-P) gives all zeros there, and the
unchecked forms return the raw formula (Z = 0, X and Y whatever it gives)
with a `bad` flag on finite P + P.

These are the plain versions of csrc/ec.cuh, which the kernels K6 (bucket
sweep), K7 (padd) and K8 (combine) of csrc/msm.cu run on the card; the
wrappers in gpu/msm_kernels.py take them for CPU tensors.  They compute
the generic formula only on the rows that keep it (both operands finite)
and `double` only on the rows that meet P + P: the reference computes
every branch on every lane and selects, which gives the same limbs.
"""

import numpy as np
import torch

from . import mont
from .mont import FQ, NLIMBS, to_numpy, to_tensor

SPEC = FQ


def _mul(a, b):
    return mont.mont_mul(SPEC, a, b)


def _sqr(a):
    return mont.mont_mul(SPEC, a, a)


def _add(a, b):
    return mont.add(SPEC, a, b)


def _sub(a, b):
    return mont.sub(SPEC, a, b)


def _dbl_f(a):
    return mont.add(SPEC, a, a)


def _is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=1)


def _rows(p, mask):
    return tuple(a[mask] for a in p)


def _put(dst, mask, src):
    """dst with the rows of `mask` replaced by src (a tuple of row sets)."""
    out = tuple(a.clone() for a in dst)
    for o, s in zip(out, src):
        o[mask] = s
    return out


def infinity(n: int, device) -> tuple:
    z = torch.zeros((n, NLIMBS), dtype=torch.int32, device=device)
    return (z, z.clone(), z.clone())


def is_infinity(p) -> torch.Tensor:
    return _is_zero(p[2])


def select(flag, p, q):
    """flag [N] bool: rows of p where true, else rows of q."""
    return tuple(torch.where(flag[:, None], a, b) for a, b in zip(p, q))


def double(p):
    """dbl-2009-l: 2M + 5S (a = 0 curve).  Infinity (Z = 0) stays Z = 0."""
    X, Y, Z = p
    A = _sqr(X)
    B = _sqr(Y)
    C = _sqr(B)
    t = _sub(_sqr(_add(X, B)), _add(A, C))
    D = _dbl_f(t)
    E = _add(_dbl_f(A), A)
    F = _sqr(E)
    X3 = _sub(F, _dbl_f(D))
    eight_c = _dbl_f(_dbl_f(_dbl_f(C)))
    Y3 = _sub(_mul(E, _sub(D, X3)), eight_c)
    Z3 = _dbl_f(_mul(Y, Z))
    return (X3, Y3, Z3)


def _add_generic(p, q):
    """add-2007-bl on finite operands: (X3, Y3, Z3), H, r."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = _sqr(Z1)
    Z2Z2 = _sqr(Z2)
    U1 = _mul(X1, Z2Z2)
    U2 = _mul(X2, Z1Z1)
    S1 = _mul(Y1, _mul(Z2, Z2Z2))
    S2 = _mul(Y2, _mul(Z1, Z1Z1))
    H = _sub(U2, U1)
    r = _sub(S2, S1)
    HH = _sqr(H)
    HHH = _mul(H, HH)
    V = _mul(U1, HH)
    X3 = _sub(_sub(_sqr(r), HHH), _dbl_f(V))
    Y3 = _sub(_mul(r, _sub(V, X3)), _mul(S1, HHH))
    Z3 = _mul(_mul(Z1, Z2), H)
    return (X3, Y3, Z3), H, r


def _madd_generic(p, x2, y2):
    """madd-2007-bl (Z2 = 1) on finite operands: (X3, Y3, Z3), H, r."""
    X1, Y1, Z1 = p
    Z1Z1 = _sqr(Z1)
    U2 = _mul(x2, Z1Z1)
    S2 = _mul(y2, _mul(Z1, Z1Z1))
    H = _sub(U2, X1)
    r = _sub(S2, Y1)
    HH = _sqr(H)
    HHH = _mul(H, HH)
    V = _mul(X1, HH)
    X3 = _sub(_sub(_sqr(r), HHH), _dbl_f(V))
    Y3 = _sub(_mul(r, _sub(V, X3)), _mul(Y1, HHH))
    Z3 = _mul(Z1, H)
    return (X3, Y3, Z3), H, r


def _complete(p_fin, res, H, r):
    """The complete forms' fallbacks on the finite rows: P + P -> double(P),
    P + (-P) -> all zeros."""
    h0 = _is_zero(H)
    if not bool(h0.any()):
        return res
    same = h0 & _is_zero(r)
    res = tuple(torch.where(h0[:, None], torch.zeros_like(a), a) for a in res)
    if bool(same.any()):
        res = _put(res, same, double(_rows(p_fin, same)))
    return res


def _one_rows(n: int, device) -> torch.Tensor:
    return SPEC.const(1, n, device)


def add(p, q):
    """Complete Jacobian + Jacobian addition (add-2007-bl with the doubling
    and inverse fallbacks), as tpu/ec.py:add: q if P is infinity, p if Q is
    (so p when both are)."""
    p_inf, q_inf = is_infinity(p), is_infinity(q)
    out = select(p_inf & ~q_inf, q, p)
    fin = ~p_inf & ~q_inf
    if bool(fin.any()):
        pf, qf = _rows(p, fin), _rows(q, fin)
        res, H, r = _add_generic(pf, qf)
        out = _put(out, fin, _complete(pf, res, H, r))
    return out


def add_mixed(p, q_affine):
    """Complete Jacobian + affine (x, y, inf) addition, as tpu/ec.py:
    add_mixed: an infinite P takes (x, y, 1) of a finite Q."""
    x2, y2, q_inf = q_affine
    p_inf = is_infinity(p)
    n = x2.shape[0]
    lifted = (x2, y2, _one_rows(n, x2.device))
    out = select(p_inf & ~q_inf, lifted, p)
    fin = ~p_inf & ~q_inf
    if bool(fin.any()):
        pf = _rows(p, fin)
        res, H, r = _madd_generic(pf, x2[fin], y2[fin])
        out = _put(out, fin, _complete(pf, res, H, r))
    return out


def add_mixed_unchecked(p, q_affine):
    """Jacobian + affine madd-2007-bl without the doubling fallback, as
    tpu/ec.py:add_mixed_unchecked.  Returns (result, bad): `bad` flags
    finite P + P; finite P + (-P) gives the formula's Z = 0."""
    x2, y2, q_inf = q_affine
    p_inf = is_infinity(p)
    res, H, r = _madd_generic(p, x2, y2)
    bad = ~p_inf & ~q_inf & _is_zero(H) & _is_zero(r)
    one = _one_rows(x2.shape[0], x2.device)
    lifted = (x2, y2, torch.where(q_inf[:, None], torch.zeros_like(one), one))
    res = select(p_inf, lifted, res)
    res = select(q_inf, p, res)
    return res, bad


def add_unchecked(p, q):
    """Jacobian + Jacobian add-2007-bl without the doubling fallback, as
    tpu/ec.py:add_unchecked.  Returns (result, bad)."""
    p_inf, q_inf = is_infinity(p), is_infinity(q)
    res, H, r = _add_generic(p, q)
    bad = ~p_inf & ~q_inf & _is_zero(H) & _is_zero(r)
    res = select(p_inf, q, res)
    res = select(q_inf, p, res)
    return res, bad


def neg(p):
    X, Y, Z = p
    return (X, mont.neg(SPEC, Y), Z)


def to_affine_host(p) -> list:
    """A Jacobian batch -> host affine points (python ints; None for
    infinity)."""
    from ..fields import fq_inv
    q = SPEC.p
    xs, ys, zs = (SPEC.from_mont_np(to_numpy(a)) for a in p)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
            continue
        zi = fq_inv(z)
        zi2 = zi * zi % q
        out.append((x * zi2 % q, y * zi2 % q * zi % q))
    return out


def affine_from_host(points, device) -> tuple:
    """Host affine points (None = infinity) -> (x, y) Montgomery rows and
    the [N] infinity mask, on `device`."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [0 if p is None else p[1] for p in points]
    inf = torch.from_numpy(np.array([p is None for p in points], dtype=bool))
    return (to_tensor(SPEC.to_mont_np(xs), device), to_tensor(SPEC.to_mont_np(ys), device),
            inf.to(device))


def jacobian_from_affine(aff) -> tuple:
    x, y, inf = aff
    zero = torch.zeros_like(x)
    one = _one_rows(x.shape[0], x.device)
    m = inf[:, None]
    return (torch.where(m, zero, x), torch.where(m, zero, y), torch.where(m, zero, one))
