"""Tensor-core NTT over Fr on the int8 kernels K9-K11 (csrc/ntt_mxu.cu),
ported from plonkit_tpu/tpu/ntt_mxu.py, the JAX package's NTT engine on
its chip.

A radix-r DFT is one int8 matrix product.  Split each input element (its
Montgomery limbs, canonical) into 33 balanced base-256 digits in
[-128, 127], and fold both a digit's weight 2^(8j) and a Montgomery
compensation 2^48 into a constant int8 table

    A[(m,t), (k,j)] = digit_t( W[m,k] * 2^(8j) * 2^48 mod p )

(W the radix-r DFT matrix, times 1/r for the inverse), so that the product
G = A . X gives, for each output, 33 "generalized digits" G_t with
sum_t G_t 2^(8t) = (W X) 2^48 (mod p) and |G_t| <= r * 33 * 128^2 < 2^28.
A fold then adds 2^31 p, ripples the carries into 36 clean bytes and runs
a Montgomery REDC by 2^48, which cancels the 2^48 and leaves the canonical
Montgomery rows of W X.  The three steps are K9 balanced_digits
(`_to_balanced`), K10 dft_product (the `dot_general`, on int8 wgmma fed by TMA)
and K11 fold_redc (`_fold_redc`).

Transforms of m = N1 * N2 points run the 4-step recursion of the JAX
package on x[i1 + N1 * i2]: length-N2 transforms over i2 (recursive,
batched over the N1 * B other rows), the twiddles w_m^(i1 j2) by K1, a
transpose, and radix-N1 transforms as one product.  The output is in
natural order, with no bit reversal; the per-radix 1/r of the inverse
tables multiplies out to 1/n.  The port keeps the JAX package's radix plan
(`plan_radices`) so the tables and every level's shapes equal its own.
Rows are [m, B, 8] int32 with the transform axis outermost (gpu/ntt.py's
ntt_batched layout); ntt_mxu and the coset forms take [n, 8].

The tables are built on the device (K1 products, digits by K9) and cached
in memory per size, direction and device; nothing is written to disk.
A tensor on the CPU takes each kernel's plain version; a CUDA tensor
launches the kernel or raises.  `launches` counts the launches.
"""

from functools import lru_cache

import torch

from ..fields import FR_GENERATOR, FR_MODULUS as P, fr_inv, get_domain_omega
from ..profiling import register_launches
from . import build, field_kernels as fk, mont, ntt as gntt
from .mont import FR, NLIMBS

NB = 33                    # balanced base-256 digits per field element
REDC_LIMBS = 3             # 16-bit Montgomery steps folded via the 2^48 premul
PREMUL = 1 << (16 * REDC_LIMBS)
OFFSET_C = 1 << 31         # V + OFFSET_C*p >= 0 for any balanced-digit V
FOLD_BYTES = 36            # byte positions of OFFSET_C*p (2^285 < 2^288)
MAX_RADIX_LOG2 = 8         # keep A tables <= [8448, 8448] int8 (71 MB)
K_STEP = 32                # depth of one wgmma k-step: K is padded to it

_OFF_BYTES = [((OFFSET_C * P) >> (8 * t)) & 0xFF for t in range(FOLD_BYTES)]
assert (OFFSET_C * P) >> (8 * FOLD_BYTES) == 0

launches = {"balanced_digits": 0, "dft_product": 0, "fold_redc": 0}
register_launches(launches)


def plan_radices(n: int) -> tuple:
    """Factor n=2^k into the fewest balanced radices <= 2^MAX_RADIX_LOG2.
    Fewest factors minimizes twiddle passes (levels-1); balance minimizes
    sum-of-radices (the MAC cost)."""
    k = n.bit_length() - 1
    levels = -(-k // MAX_RADIX_LOG2)
    base, extra = divmod(k, levels)
    return tuple(1 << (base + (1 if i < extra else 0)) for i in range(levels))


def padded_depth(r: int) -> int:
    """Kp: the r * 33 digit columns rounded up to a multiple of K_STEP."""
    return -(-r * NB // K_STEP) * K_STEP


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(t: torch.Tensor, dtype, dim: int, what: str) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous {dim}-d {dtype} tensor, "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.is_cuda and t.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be 16-byte aligned")


# -- K9: balanced digits -------------------------------------------------------

def _digits(rows: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 rows -> [N, 33] int8 balanced base-256 digits of their
    little-endian bytes (tpu/ntt_mxu.py _to_balanced)."""
    b = rows.contiguous().view(torch.uint8).reshape(-1, 4 * NLIMBS).to(torch.int32)
    out = torch.empty((b.shape[0], NB), dtype=torch.int8, device=rows.device)
    carry = torch.zeros(b.shape[0], dtype=torch.int32, device=rows.device)
    for t in range(NB):
        v = (b[:, t] if t < 4 * NLIMBS else 0) + carry
        ge = (v >= 128).to(torch.int32)
        out[:, t] = (v - 256 * ge).to(torch.int8)
        carry = ge
    return out


def balanced_digits_plain(x: torch.Tensor) -> torch.Tensor:
    """The plain version of K9 (the same layout)."""
    r, batch = x.shape[0], x.shape[1]
    out = torch.zeros((batch, padded_depth(r)), dtype=torch.int8, device=x.device)
    out[:, :r * NB] = _digits(x.reshape(-1, NLIMBS)).view(r, batch, NB).transpose(0, 1) \
        .reshape(batch, r * NB)
    return out


def balanced_digits(x: torch.Tensor) -> torch.Tensor:
    """K9: [r, B, 8] int32 canonical rows -> [B, Kp] int8: column b's 33
    digits of element k at k * 33 + j, zeros from r * 33 to Kp
    (`padded_depth`).  Each output row is one operand column of K10."""
    _check(x, torch.int32, 3, "balanced_digits")
    if x.shape[2] != NLIMBS:
        raise ValueError(f"balanced_digits: expected [r, B, {NLIMBS}] rows, got {tuple(x.shape)}")
    if not x.is_cuda:
        return balanced_digits_plain(x)
    r, batch = x.shape[0], x.shape[1]
    kp = padded_depth(r)
    out = torch.empty((batch, kp), dtype=torch.int8, device=x.device)
    if r * batch:
        build.check(build.load("ntt_mxu").plonkit_balanced_digits(
            x.data_ptr(), out.data_ptr(), r, batch, kp, _stream(x)), "K9 balanced_digits")
        launches["balanced_digits"] += 1
    return out


# -- K10: the int8 product -------------------------------------------------------

def dft_product_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The plain version of K10, in float64: every partial sum is an
    integer below 2^31, so the product is exact in any order.  A is
    converted 1024 rows at a time (the radix-256 table is 571 MB in
    float64)."""
    xt = x.to(torch.float64).T
    return torch.cat([(rows.to(torch.float64) @ xt).to(torch.int32) for rows in a.split(1024)])


def dft_product(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """K10: G = A . X^T, int8 A [M, K] and X [N, K] row-major with K a
    multiple of 32 -> int32 G [M, N]."""
    _check(a, torch.int8, 2, "dft_product A")
    _check(x, torch.int8, 2, "dft_product X")
    if a.shape[1] != x.shape[1] or a.shape[1] % K_STEP or a.device != x.device:
        raise ValueError(f"dft_product: A {tuple(a.shape)} and X {tuple(x.shape)} on "
                         f"{a.device}, {x.device}: one device, one depth, a multiple of {K_STEP}")
    if not a.is_cuda:
        return dft_product_plain(a, x)
    g = torch.empty((a.shape[0], x.shape[0]), dtype=torch.int32, device=a.device)
    if g.numel():
        build.check(build.load("ntt_mxu").plonkit_dft_product(
            a.data_ptr(), x.data_ptr(), g.data_ptr(), a.shape[0], x.shape[0], a.shape[1],
            _stream(a)), "K10 dft_product")
        launches["dft_product"] += 1
    return g


# -- K11: fold and REDC -----------------------------------------------------------

def fold_redc_plain(g: torch.Tensor) -> torch.Tensor:
    """The plain version of K11: tpu/ntt_mxu.py _fold_redc on int64 limbs
    (offset bytes, carry ripple, three 16-bit REDC steps, one conditional
    subtraction)."""
    r, batch = g.shape[0] // NB, g.shape[1]
    G = g.view(r, NB, batch).to(torch.int64)
    zero = torch.zeros((r, batch), dtype=torch.int64, device=g.device)
    bts, carry = [], zero
    for t in range(FOLD_BYTES):
        u = (G[:, t] if t < NB else zero) + _OFF_BYTES[t] + carry
        b = u & 255
        bts.append(b)
        carry = (u - b) >> 8
    T = [bts[2 * j] | (bts[2 * j + 1] << 8) for j in range(FOLD_BYTES // 2)] + [zero]
    for _ in range(REDC_LIMBS):
        m = (T[0] * FR.n0_16) & 0xFFFF
        for j in range(2 * NLIMBS):
            prod = m * FR.p16[j]
            T[j] = T[j] + (prod & 0xFFFF)
            T[j + 1] = T[j + 1] + (prod >> 16)
        T[1] = T[1] + (T[0] >> 16)      # T[0] is 0 mod 2^16 by construction
        T = T[1:] + [zero]
    limbs = mont._carry16(torch.stack(T[:2 * NLIMBS]).reshape(2 * NLIMBS, r * batch))
    return mont._join16(mont._cond_sub_p(FR, limbs)).view(r, batch, NLIMBS)


def fold_redc(g: torch.Tensor) -> torch.Tensor:
    """K11: int32 G [r * 33, B], read as [r, 33, B] -> [r, B, 8] int32
    canonical Montgomery rows of (sum_t G_t 2^(8t)) * 2^-48 mod p."""
    _check(g, torch.int32, 2, "fold_redc")
    if g.shape[0] % NB:
        raise ValueError(f"fold_redc: {g.shape[0]} rows is not r * {NB}")
    if not g.is_cuda:
        return fold_redc_plain(g)
    r, batch = g.shape[0] // NB, g.shape[1]
    out = torch.empty((r, batch, NLIMBS), dtype=torch.int32, device=g.device)
    if r * batch:
        build.check(build.load("ntt_mxu").plonkit_fold_redc(
            g.data_ptr(), out.data_ptr(), r, batch, _stream(g)), "K11 fold_redc")
        launches["fold_redc"] += 1
    return out


# -- tables ------------------------------------------------------------------------

@lru_cache(maxsize=16)
def _dft_table(r: int, inverse: bool, device: str) -> torch.Tensor:
    """[r * 33, Kp] int8, A[(m,t), (k,j)] = digit_t(s * w^(mk) * 2^(8j+48)
    mod p) with w the r-th root (its inverse and s = 1/r for the inverse,
    else s = 1), zero columns from r * 33 to Kp: tpu/ntt_mxu.py
    _dft_table_np, built by r^2 * 33 K1 products of the Montgomery powers
    of w with the raw constants s * 2^(8j+48) (a canonical product) and
    their digits by K9."""
    omega, scale = get_domain_omega(r), 1
    if inverse:
        omega, scale = fr_inv(omega), fr_inv(r)
    idx = torch.arange(r, device=device)
    w = gntt.powers(omega, r, device).index_select(0, (idx[:, None] * idx[None, :] % r).view(-1))
    c = mont.to_tensor(FR.to_limbs_np([scale * (1 << 8 * j) * PREMUL % P for j in range(NB)]),
                       device)
    vals = fk.mul(FR, w[:, None].expand(r * r, NB, NLIMBS).reshape(-1, NLIMBS),
                  c[None].expand(r * r, NB, NLIMBS).reshape(-1, NLIMBS))
    digits = balanced_digits(vals.view(1, -1, NLIMBS))[:, :NB]      # [(m, k, j), t]
    out = torch.zeros((r * NB, padded_depth(r)), dtype=torch.int8, device=device)
    out[:, :r * NB] = digits.view(r, r, NB, NB).permute(0, 3, 1, 2).reshape(r * NB, r * NB)
    return out


@lru_cache(maxsize=16)
def _twiddles(m: int, n1: int, inverse: bool, device: str) -> torch.Tensor:
    """[N2, N1, 8] Montgomery twiddles w_m^(i1 j2) (w_m^-1 for the inverse):
    tpu/ntt_mxu.py _twiddle_table_np, gathered from one table of powers."""
    n2 = m // n1
    omega = get_domain_omega(m)
    if inverse:
        omega = fr_inv(omega)
    idx = torch.arange(n2, device=device)[:, None] * torch.arange(n1, device=device)[None, :]
    return gntt.powers(omega, m, device).index_select(0, idx.view(-1)).view(n2, n1, NLIMBS)


# -- transforms -----------------------------------------------------------------------

def _dft_base(x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """[r, B, 8] -> [r, B, 8]: the radix-r DFT along axis 0, one product."""
    r = x.shape[0]
    return fold_redc(dft_product(_dft_table(r, inverse, str(x.device)), balanced_digits(x)))


def _transform(x: torch.Tensor, radices: tuple, inverse: bool) -> torch.Tensor:
    """[m, B, 8]: length-m transforms along axis 0 (m = prod(radices))."""
    m, batch = x.shape[0], x.shape[1]
    if len(radices) == 1:
        return _dft_base(x, inverse)
    n1 = radices[0]
    n2 = m // n1
    s1 = _transform(x.reshape(n2, n1 * batch, NLIMBS), radices[1:], inverse)
    tw = _twiddles(m, n1, inverse, str(x.device))[:, :, None].expand(n2, n1, batch, NLIMBS)
    c = fk.mul(FR, s1.view(m * batch, NLIMBS), tw.reshape(m * batch, NLIMBS))
    c = c.view(n2, n1, batch, NLIMBS).transpose(0, 1).contiguous()
    return _dft_base(c.view(n1, n2 * batch, NLIMBS), inverse).view(m, batch, NLIMBS)


def ntt_mxu(values: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """[n, 8] Montgomery rows -> the NTT (natural order in and out);
    inverse=True gives the n^-1-scaled iNTT.  Drop-in for gpu/ntt.ntt."""
    n = values.shape[0]
    if n == 1:
        return values
    x = values.reshape(n, 1, NLIMBS).contiguous()
    return _transform(x, plan_radices(n), inverse).view(n, NLIMBS)


def intt_mxu(values: torch.Tensor) -> torch.Tensor:
    return ntt_mxu(values, inverse=True)


def coset_ntt_mxu(coeffs: torch.Tensor, shift: int = FR_GENERATOR) -> torch.Tensor:
    return ntt_mxu(gntt.coset_scale(coeffs, shift))


def coset_intt_mxu(values: torch.Tensor, shift: int = FR_GENERATOR) -> torch.Tensor:
    return gntt.coset_scale(intt_mxu(values), fr_inv(shift))


def coset_lde_mxu(coeffs: torch.Tensor, factor: int, shift: int = FR_GENERATOR) -> torch.Tensor:
    n = coeffs.shape[0]
    ext = torch.zeros((factor * n, NLIMBS), dtype=torch.int32, device=coeffs.device)
    ext[:n] = coeffs
    return coset_ntt_mxu(ext, shift)
