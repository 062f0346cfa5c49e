"""Radix-2 NTT over Fr on the K3 butterfly (csrc/ntt.cu), ported from
plonkit_tpu/tpu/ntt.py.

Constant-geometry (Pease) formulation, as there: every stage applies

    u = y[:h] + y[h:]
    v = (y[:h] - y[h:]) * tw[t]        (DIF butterfly, one K3 launch)
    y = interleave(u, v)               (y'[2i] = u[i], y'[2i+1] = v[i])

with stage twiddles tw[t][j] = w^(2^t * (j >> t)), then one bit-reversal
gather.  In the [N, 8] row layout y[:h] and y[h:] are contiguous views, so
a stage costs one launch plus the interleave copy; the bit reversal is an
`index_select`, data movement as the JAX package leaves it to XLA.  Tables
(domain-root powers, bit-reversal indices, coset powers) are built on the
device through K1 and cached per size.
"""

from functools import lru_cache

import numpy as np
import torch

from ..fields import FR_GENERATOR, FR_MODULUS as R, fr_inv, get_domain_omega
from . import build, field_kernels as fk, mont
from .mont import FR, NLIMBS

launches = {"butterfly_dif": 0}


def butterfly_dif(lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor):
    """K3 over Fr: (lo + hi, (lo - hi) * w), each [N, 8]."""
    fk.check_operands(lo, hi, w)
    if not lo.is_cuda:
        return mont.add(FR, lo, hi), mont.mont_mul(FR, w, mont.sub(FR, lo, hi))
    u = torch.empty_like(lo)
    v = torch.empty_like(lo)
    if lo.shape[0]:
        lib = build.load("ntt")
        build.check(lib.plonkit_butterfly_dif(
            lo.data_ptr(), hi.data_ptr(), w.data_ptr(), u.data_ptr(),
            v.data_ptr(), lo.shape[0], FR.kernel_id, fk.stream_ptr(lo)), "K3 butterfly_dif")
        launches["butterfly_dif"] += 1
    return u, v


def powers(base: int, n: int, device) -> torch.Tensor:
    """[1, base, base^2, ..., base^(n-1)] in Montgomery form, [n, 8]:
    doubling, out[m:2m] = out[:m] * base^m, n K1 products in all."""
    out = FR.const(1, 1, device)
    m = 1
    while m < n:
        step = FR.const(pow(base, m, R), m, device)
        out = torch.cat([out, fk.mul(FR, out, step)])
        m *= 2
    return out[:n]


@lru_cache(maxsize=None)
def _bitrev_np(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@lru_cache(maxsize=16)
def _tables(n: int, inverse: bool, device: str):
    """Per-size device tables: domain-root powers [n/2, 8], bit-reversal
    indices [n], and n^-1 [1, 8] (inverse transforms)."""
    omega = get_domain_omega(n)
    if inverse:
        omega = fr_inv(omega)
    omega_pows = powers(omega, max(n // 2, 1), device)
    rev = torch.from_numpy(_bitrev_np(n)).to(device)
    n_inv = FR.const(fr_inv(n), 1, device)
    return omega_pows, rev, n_inv


def ntt(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """values: [n, 8] Montgomery rows in natural order -> evaluations on the
    size-n domain (coefficients scaled by n^-1 if inverse)."""
    n = values.shape[0]
    if n == 1:
        return values
    omega_pows, rev, n_inv = _tables(n, inverse, str(values.device))
    half = n // 2
    y = values.contiguous()
    for t in range(n.bit_length() - 1):
        distinct = omega_pows[::1 << t][:half >> t]
        tw = distinct.repeat_interleave(1 << t, dim=0)
        u, v = butterfly_dif(y[:half], y[half:], tw)
        y = torch.stack([u, v], dim=1).reshape(n, NLIMBS)
    y = y.index_select(0, rev)
    if inverse:
        y = fk.mul(FR, y, n_inv.expand(n, NLIMBS).contiguous())
    return y


def intt(values: torch.Tensor) -> torch.Tensor:
    return ntt(values, inverse=True)


@lru_cache(maxsize=8)
def _coset_pows(shift: int, n: int, device: str) -> torch.Tensor:
    return powers(shift, n, device)


def coset_scale(coeffs: torch.Tensor, shift: int) -> torch.Tensor:
    """Multiply coefficient i by shift^i (for coset NTTs)."""
    pows = _coset_pows(shift % R, coeffs.shape[0], str(coeffs.device))
    return fk.mul(FR, coeffs.contiguous(), pows)


def coset_ntt(coeffs: torch.Tensor, shift: int = FR_GENERATOR) -> torch.Tensor:
    return ntt(coset_scale(coeffs, shift))


def coset_intt(values: torch.Tensor, shift: int = FR_GENERATOR) -> torch.Tensor:
    return coset_scale(intt(values), fr_inv(shift))


def coset_lde(coeffs: torch.Tensor, factor: int, shift: int = FR_GENERATOR) -> torch.Tensor:
    n = coeffs.shape[0]
    ext = torch.zeros((factor * n, NLIMBS), dtype=torch.int32, device=coeffs.device)
    ext[:n] = coeffs
    return coset_ntt(ext, shift)
