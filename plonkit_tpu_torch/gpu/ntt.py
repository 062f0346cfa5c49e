"""Radix-2 NTT over Fr on the K3 and K5 butterflies (csrc/ntt.cu), ported
from plonkit_tpu/tpu/ntt.py.

The forward transform is the constant-geometry (Pease) formulation of the
JAX package: every stage applies

    u = y[:h] + y[h:]
    v = (y[:h] - y[h:]) * tw[t]        (DIF butterfly, one K3 launch)
    y = interleave(u, v)               (y'[2i] = u[i], y'[2i+1] = v[i])

with stage twiddles tw[t][j] = w^(2^t * (j >> t)), then one bit-reversal
gather.  As a matrix that is F = P S_{L-1} ... S_0 with S_t the interleave
after the butterfly.  The DFT matrix is symmetric, so the inverse
transform runs the transpose, F = S_0^T ... S_{L-1}^T P, over w^-1: one
bit-reversal gather, then for t = L-1 down to 0

    a = y[0::2], b = y[1::2]
    y = concat(a + tw[t] * b, a - tw[t] * b)   (DIT butterfly, one K5 launch)

and a last product by n^-1 (K1).  K5 reads the even and odd rows where
they lie and writes the two halves of the next buffer, so an inverse stage
needs no copy of the data besides its launch (both forms build a stage's
twiddle rows); a forward stage also pays the interleave copy.  Every
result is fully reduced, so both forms give the same rows.  The bit
reversal is an `index_select`, data movement as the JAX package leaves it
to XLA.  Tables (domain-root powers, bit-reversal indices, coset powers)
are built on the device through K1 and cached per size.

Both forms run batched (ntt_batched): B independent length-m transforms
over [m, B, 8], the building block of parallel/ntt.py's 4-step transform;
ntt and intt are its B = 1 case.
"""

from functools import lru_cache

import numpy as np
import torch

from ..fields import FR_GENERATOR, FR_MODULUS as R, fr_inv, get_domain_omega
from ..profiling import register_launches
from . import build, field_kernels as fk, mont
from .mont import FR, NLIMBS, FieldSpec

launches = {"butterfly_dif": 0, "butterfly": 0}
register_launches(launches)


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


def _strided_rows(lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor):
    """(rows, row_stride, batch) of K5's lo and hi: int32 views shaped and
    placed alike, limbs dense, either [n, 8] with rows a whole number of
    rows apart (as y[0::2] and y[1::2] are), or [h, B, 8]: h blocks of B
    contiguous rows a whole number of rows apart (the even and odd rows of
    a batched stage).  w holds one contiguous row for each of their rows."""
    for t in (lo, hi):
        if (t.dtype != torch.int32 or t.shape != lo.shape or t.device != w.device
                or t.dim() not in (2, 3) or t.shape[-1] != NLIMBS):
            raise ValueError(f"expected lo and hi of one shape [n, {NLIMBS}] or "
                             f"[h, B, {NLIMBS}] int32 on {w.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if (t.stride() != lo.stride() or t.stride(-1) != 1 or t.stride(0) % NLIMBS
                or (t.dim() == 3 and t.stride(1) != NLIMBS)):
            raise ValueError("lo and hi must share a row stride that is a multiple of a row")
        if t.is_cuda and t.data_ptr() % 16:
            raise ValueError("operand rows must be 16-byte aligned")
    batch = lo.shape[1] if lo.dim() == 3 else 1
    rows = lo.shape[0] * batch
    if w.shape[0] != rows:
        raise ValueError(f"{w.shape[0]} twiddle rows for {rows} butterflies")
    return rows, lo.stride(0) // NLIMBS, batch


def butterfly(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor,
              out: torch.Tensor = None):
    """K5, radix-2 DIT: t = w * hi; (lo + t, lo - t), each [N, 8].  lo and
    hi may be row-strided views of one buffer (y[0::2], y[1::2]), or
    [h, B, 8] views of its blocks of B rows (a batched stage); w is
    contiguous.  The two outputs are the halves of `out`, a contiguous
    [2N, 8] buffer (a fresh one if it is not given)."""
    fk.check_operands(w)
    n, row_stride, batch = _strided_rows(lo, hi, w)
    if out is None:
        out = torch.empty((2 * n, NLIMBS), dtype=torch.int32, device=lo.device)
    fk.check_operands(out)
    if out.shape[0] != 2 * n or out.device != lo.device:
        raise ValueError(f"out must be [{2 * n}, {NLIMBS}] on {lo.device}")
    if not lo.is_cuda:
        out[:n], out[n:] = mont.butterfly(spec, lo.reshape(n, NLIMBS), hi.reshape(n, NLIMBS), w)
    elif n:
        lib = build.load("ntt")
        build.check(lib.plonkit_butterfly(
            lo.data_ptr(), hi.data_ptr(), w.data_ptr(), out.data_ptr(),
            out[n:].data_ptr(), n, row_stride, batch, spec.kernel_id,
            fk.stream_ptr(lo)), "K5 butterfly")
        launches["butterfly"] += 1
    return out[:n], out[n:]


def _table_split(n: int) -> tuple:
    """(s, t) of power_table: s = 2^ceil(log2(n) / 2) rows of base^j, t =
    ceil(n / s) rows of base^(s i)."""
    s = 1 << ((max(n, 1) - 1).bit_length() + 1) // 2
    return s, -(-n // s)


def power_table(base: int, n: int, montgomery: bool = True) -> np.ndarray:
    """The rows powers_from multiplies out to base^j for j < n: base^j for
    j < s, then base^(s i) for i < t (_table_split), as [s + t, 8] uint32
    Fr limbs in Montgomery form.  With montgomery=False the first s rows
    are canonical instead, and so is every product of one of them by a
    Montgomery row: the powers then come out in canonical form."""
    s, t = _table_split(n)
    low, high = [1], [1]
    for _ in range(1, s):
        low.append(low[-1] * base % R)
    step = pow(base, s, R)
    for _ in range(1, t):
        high.append(high[-1] * step % R)
    low = FR.to_mont_np(low) if montgomery else FR.to_limbs_np(low)
    return np.concatenate([low, FR.to_mont_np(high[:t])])


def powers_from(table: torch.Tensor, n: int) -> torch.Tensor:
    """[n, 8]: base^j for j < n, in the form of power_table's first rows,
    from those rows on the device: out[s i + j] = base^j * base^(s i), one
    K1 over both parts of the table repeated on the device, so no copy
    from the host."""
    if not n:
        return table[:0].clone()
    s, t = _table_split(n)
    return fk.mul(FR, table[:s].repeat(t, 1)[:n],
                  table[s:s + t].repeat_interleave(s, dim=0)[:n])


def powers(base: int, n: int, device) -> torch.Tensor:
    """[1, base, base^2, ..., base^(n-1)] in Montgomery form, [n, 8]: one
    upload of power_table, then powers_from's one K1."""
    return powers_from(mont.to_tensor(power_table(base % R, n), device), n)


_BYTE_REVERSAL = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], dtype=np.int64)


def bit_reversal(n: int) -> np.ndarray:
    """[n] int64: i -> i with its log2(n) bits reversed, n a power of two
    (a byte at a time)."""
    bits = n.bit_length() - 1
    i = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for shift in range(0, bits, 8):
        rev = (rev << 8) | _BYTE_REVERSAL[(i >> shift) & 255]
    return rev >> (-bits % 8)


@lru_cache(maxsize=16)
def _tables(n: int, inverse: bool, device: str):
    """Per-size device tables: domain-root powers [n/2, 8], bit-reversal
    indices [n], and n^-1 [1, 8] (inverse transforms)."""
    omega = get_domain_omega(n)
    if inverse:
        omega = fr_inv(omega)
    omega_pows = powers(omega, max(n // 2, 1), device)
    rev = mont.upload(bit_reversal(n), device)
    n_inv = FR.row(fr_inv(n), device)
    return omega_pows, rev, n_inv


def _stage_twiddles(omega_pows: torch.Tensor, t: int, half: int, batch: int = 1) -> torch.Tensor:
    """tw[t][j] = w^(2^t * (j >> t)) for j < half, each row repeated for
    the `batch` columns of a batched stage: [half * batch, 8]."""
    return omega_pows[::1 << t][:half >> t].repeat_interleave(batch << t, dim=0)


def ntt_batched(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """values: [m, B, 8] Montgomery rows -> length-m transforms along axis 0,
    one for each of the B columns (plonkit_tpu/tpu/ntt.py ntt_batched, whose
    [16, m, B] keeps the transform axis first too).  The transform axis is
    outermost, so a stage's halves y[:m/2] and y[m/2:] are contiguous
    blocks of m/2 * B rows (K3 as it is, the stage's twiddle row repeated
    B times) and its even and odd rows are blocks of B rows 2B apart (K5's
    batch).  inverse=True includes the 1/m scaling."""
    m, batch = values.shape[0], values.shape[1]
    if m == 1:
        return values
    omega_pows, rev, m_inv = _tables(m, inverse, str(values.device))
    half = m // 2
    rows = m * batch
    if not inverse:
        # Pease DIF on K3, then one bit-reversal gather
        y = values.reshape(rows, NLIMBS).contiguous()
        for t in range(m.bit_length() - 1):
            u, v = butterfly_dif(y[:half * batch], y[half * batch:],
                                 _stage_twiddles(omega_pows, t, half, batch))
            y = torch.stack([u.view(half, batch, NLIMBS), v.view(half, batch, NLIMBS)],
                            dim=1).reshape(rows, NLIMBS)
        return y.view(m, batch, NLIMBS).index_select(0, rev)
    # the transposed form on K5, then 1/m by K1
    y = values.index_select(0, rev).reshape(rows, NLIMBS)
    for t in reversed(range(m.bit_length() - 1)):
        pairs = y.view(half, 2 * batch, NLIMBS)
        out = torch.empty_like(y)
        butterfly(FR, pairs[:, :batch], pairs[:, batch:],
                  _stage_twiddles(omega_pows, t, half, batch), out)
        y = out
    return fk.mul_row(FR, y, m_inv).view(m, batch, NLIMBS)


def ntt(values: torch.Tensor) -> torch.Tensor:
    """values: [n, 8] Montgomery rows in natural order -> evaluations on the
    size-n domain (Pease DIF on K3)."""
    return ntt_batched(values.reshape(-1, 1, NLIMBS)).reshape(-1, NLIMBS)


def intt(values: torch.Tensor) -> torch.Tensor:
    """values: [n, 8] evaluations on the size-n domain -> coefficients
    (the transposed Pease form on K5, then n^-1 by K1)."""
    return ntt_batched(values.reshape(-1, 1, NLIMBS), inverse=True).reshape(-1, NLIMBS)


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
