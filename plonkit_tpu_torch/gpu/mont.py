"""Montgomery field arithmetic over BN254 Fr and Fq in plain PyTorch.

Layout: one field element is one row of eight little-endian 32-bit limbs,
so a vector of N elements is an [N, 8] int32 tensor whose bits are read as
uint32.  The Montgomery radix is R = 2^256, the same as the JAX package's
planar [16, N] 16-bit limbs (plonkit_tpu/tpu/mont.py), so both hold the same
value for every element; convert.py repacks one layout into the other.
Every result is fully reduced into [0, p).

The ops here are the plain versions of the CUDA kernels in csrc/ (K1 mul,
K2 add/sub, K4 mul_add, K5 butterfly; K3 is composed in ntt.py): the
wrappers in field_kernels.py and ntt.py take them for tensors on the CPU,
and chip_smoke.py holds each kernel against them on the card.  They compute
on int64 tensors holding 16-bit limbs, so no product or column sum can
overflow; add, sub and mont_mul come in two forms with one result (below).
"""

from functools import lru_cache

import numpy as np
import torch

from ..fields import FQ_MODULUS, FR_MODULUS

NLIMBS = 8          # 32-bit limbs per element
_M16 = 0xFFFF
_NL16 = 16          # 16-bit limbs per element inside the plain ops


def _limbs(x: int, bits: int, count: int):
    return [(x >> (bits * i)) & ((1 << bits) - 1) for i in range(count)]


class FieldSpec:
    """Montgomery constants for a 254-bit prime field.  `kernel_id` is the
    field argument the CUDA kernels take (0 = Fr, 1 = Fq)."""

    def __init__(self, p: int, kernel_id: int):
        self.p = p
        self.kernel_id = kernel_id
        self.r = 1 << 256
        self.r_mod_p = self.r % p
        self.r2_mod_p = self.r * self.r % p
        self.n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)      # CUDA CIOS
        self.n0_16 = (-pow(p, -1, 1 << 16)) % (1 << 16)   # plain CIOS
        self.p32 = _limbs(p, 32, NLIMBS)
        self.p16 = _limbs(p, 16, _NL16)

    # -- host conversions (numpy, no per-limb python loops) ----------------

    def to_limbs_np(self, values) -> np.ndarray:
        """python ints (canonical) -> [N, 8] uint32 raw limbs."""
        values = list(values)
        buf = b"".join(int(v).to_bytes(32, "little") for v in values)
        return np.frombuffer(buf, dtype="<u4").reshape(len(values), NLIMBS).astype(np.uint32)

    def from_limbs_np(self, limbs) -> list:
        """[N, 8] uint32 raw limbs -> python ints."""
        data = np.ascontiguousarray(limbs, dtype="<u4").tobytes()
        return [int.from_bytes(data[32 * i:32 * (i + 1)], "little")
                for i in range(len(data) // 32)]

    def to_mont_np(self, values) -> np.ndarray:
        return self.to_limbs_np([int(v) * self.r_mod_p % self.p for v in values])

    def from_mont_np(self, limbs) -> list:
        inv_r = pow(self.r, -1, self.p)
        return [v * inv_r % self.p for v in self.from_limbs_np(limbs)]

    def const_raw(self, value: int, n: int, device) -> torch.Tensor:
        """[n, 8] contiguous tensor whose every row holds the limbs of
        `value` (0 <= value < 2^256) as they are."""
        row = to_tensor(self.to_limbs_np([value]), device)
        return row.expand(n, NLIMBS).contiguous()

    def const(self, value: int, n: int, device) -> torch.Tensor:
        """[n, 8] contiguous tensor holding `value` in Montgomery form."""
        return self.const_raw(value % self.p * self.r_mod_p % self.p, n, device)


FR = FieldSpec(FR_MODULUS, 0)
FQ = FieldSpec(FQ_MODULUS, 1)


def to_tensor(limbs: np.ndarray, device) -> torch.Tensor:
    """[N, 8] uint32 numpy limbs -> [N, 8] int32 tensor on `device`."""
    arr = np.ascontiguousarray(limbs, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """[N, 8] int32 tensor -> [N, 8] uint32 numpy limbs on the host."""
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# plain ops: [N, 8] int32 in, [N, 8] int32 out
# ---------------------------------------------------------------------------

def _split16(a: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 -> [16, N] int64 16-bit limbs."""
    w = a.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & _M16, w >> 16], dim=2).reshape(a.shape[0], _NL16).T.contiguous()


def _join16(limbs: torch.Tensor) -> torch.Tensor:
    """[16, N] int64 limbs (each < 2^16) -> [N, 8] int32."""
    w = limbs[0::2] | (limbs[1::2] << 16)
    w = torch.where(w >= (1 << 31), w - (1 << 32), w)
    return w.T.to(torch.int32).contiguous()


def _p16(spec: FieldSpec, device) -> torch.Tensor:
    return torch.tensor(spec.p16, dtype=torch.int64, device=device)


def _carry16(t: torch.Tensor) -> torch.Tensor:
    """Propagate carries so every limb is < 2^16 (carry out dropped)."""
    out = torch.empty_like(t)
    carry = torch.zeros_like(t[0])
    for i in range(t.shape[0]):
        c = t[i] + carry
        out[i] = c & _M16
        carry = c >> 16
    return out


def _sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """a - b over 16-bit limbs ([16, N] minus [16, N] or [16, 1]);
    returns (difference mod 2^256, borrow flag [N])."""
    out = torch.empty_like(a)
    borrow = torch.zeros_like(a[0])
    for i in range(_NL16):
        d = a[i] - b[i] - borrow
        borrow = (d < 0).to(torch.int64)
        out[i] = d & _M16
    return out, borrow


def _cond_sub_p(spec: FieldSpec, limbs: torch.Tensor) -> torch.Tensor:
    """Subtract p where limbs >= p (input < 2p)."""
    d, borrow = _sub_borrow(limbs, _p16(spec, limbs.device)[:, None])
    return torch.where((borrow == 0)[None], d, limbs)


# Two forms of the element ops, one result.  The limb loop (the CIOS loop
# of tpu/mont.py:mont_mul over [16, N] limbs) makes some hundreds of
# PyTorch calls on vectors of N; the vectorised form works on [N, 16] rows
# (limb axis last): a product is one broadcast of the 256 limb products
# summed into columns, Montgomery's reduction takes m = T * (-p^-1) mod
# 2^256 whole, and carries are a few shift-and-add passes and one prefix
# scan for the unit carries left, some tens of calls in all but ~2 KB of
# temporaries a row.  For few rows the calls cost the time (the ladders of
# gpu/group_ntt.py run 2^12 lanes through hundreds of sequential point
# operations), for many the bytes: the loop takes over above VEC_ROWS rows.
# `python -m plonkit_tpu_torch.gpu.plain_forms` times both (ms, loop /
# vectorised; H100 80GB HBM3 at 700 W): mont_mul 3.41 / 1.06 at 2^14
# rows, 3.95 / 3.21 at 2^16, 6.81 / 12.8 at 2^18, 23.3 / 50.5 at 2^20;
# add 1.36 / 0.49 at 2^14, 1.53 / 1.68 at 2^16; the plain K15 ladder on
# 2^12 lanes 14.6 / 6.1 s.  On a shared 8-thread CPU (medians, which
# vary by tens of percent there): mont_mul 3.60 / 1.69 at 2^8 rows, 4.79 /
# 2.93 at 2^10, add 1.23 / 1.19 at 2^10; the ladder on 2 lanes 7.8 / 2.9
# s.
VEC_ROWS = {"cpu": 1 << 10, "cuda": 1 << 16}


def _vectorised(a: torch.Tensor) -> bool:
    return a.shape[0] <= VEC_ROWS[a.device.type]


def _rows16(a: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 -> [N, 16] int64 16-bit limbs."""
    w = a.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([w & _M16, w >> 16], dim=2).reshape(a.shape[0], _NL16)


def _rows32(x: torch.Tensor) -> torch.Tensor:
    """[N, 16] int64 limbs (each < 2^16) -> [N, 8] int32."""
    w = x[:, 0::2] | (x[:, 1::2] << 16)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


@lru_cache(maxsize=None)
def _consts(spec: FieldSpec, device) -> tuple:
    """p and -p^-1 mod 2^256 as [16] int64 limbs, and the column of each
    of the 256 limb products (i + j), on `device`."""
    limbs = (torch.tensor(_limbs(v, 16, _NL16), dtype=torch.int64, device=device)
             for v in (spec.p, -pow(spec.p, -1, spec.r) % spec.r))
    col = torch.arange(_NL16, device=device)
    return (*limbs, (col[:, None] + col[None, :]).reshape(-1))


def _convolve(x: torch.Tensor, y: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """out[:, k] = sum over i + j = k of x[:, i] * y[:, j] (y[j] for a
    [16] row): x and y [N, 16] -> [N, 31]."""
    prod = x[:, :, None] * (y[:, None, :] if y.dim() == 2 else y)
    out = torch.zeros((x.shape[0], 2 * _NL16 - 1), dtype=torch.int64, device=x.device)
    return out.index_add_(1, cols, prod.reshape(x.shape[0], _NL16 * _NL16))


def _ripple(x: torch.Tensor, borrow: bool) -> torch.Tensor:
    """Limbs in [0, 2^16] (unit carries left) or [-1, 2^16) (unit borrows
    left) -> exact 16-bit limbs, the carry or borrow out of the top
    dropped.  A limb takes a carry (borrow) when the nearest limb below it
    that does not pass one on (0xFFFF for a carry, 0 for a borrow) makes
    one (2^16, or -1): one cummax over the limb axis."""
    n, width = x.shape
    idx = torch.arange(width, device=x.device).expand(n, width)
    stop = torch.where(x == (0 if borrow else _M16), -1, idx).cummax(dim=1).values
    below = torch.nn.functional.pad(stop[:, :-1], (1, 0), value=-1)
    made = x == (-1 if borrow else _M16 + 1)
    take = (made.gather(1, below.clamp(min=0)) & (below >= 0)).to(torch.int64)
    return (x - take if borrow else x + take) & _M16


def _carry(x: torch.Tensor, passes: int) -> torch.Tensor:
    """Limbs >= 0 -> exact 16-bit limbs of the value mod 2^(16 width).
    Each pass moves every limb's bits above 16 into the next limb; limbs
    below 2^(16 + 16 k) need k + 1 passes to be left at most 2^16."""
    for _ in range(passes):
        c = x >> 16
        x = x & _M16
        x[:, 1:] += c[:, :-1]
    return _ripple(x, borrow=False)


def _signed(x: torch.Tensor) -> torch.Tensor:
    """Limbs in (-2^16, 2^16) -> exact 16-bit limbs of the value mod
    2^(16 width): a negative value wraps."""
    c = x >> 16
    x = x & _M16
    x[:, 1:] += c[:, :-1]
    return _ripple(x, borrow=True)


def _reduce_once(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """t - p where t >= p, else t: t [N, 16] exact limbs of a value < 2p."""
    d = _signed(torch.nn.functional.pad(t - p, (0, 1)))
    return torch.where(d[:, _NL16:] == 0, d[:, :_NL16], t)


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p."""
    if not _vectorised(a):
        s = _carry16(_split16(a) + _split16(b))   # < 2p < 2^255: no carry out
        return _join16(_cond_sub_p(spec, s))
    s = _carry(_rows16(a) + _rows16(b), 1)
    return _rows32(_reduce_once(_consts(spec, a.device)[0], s))


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p."""
    if not _vectorised(a):
        d, borrow = _sub_borrow(_split16(a), _split16(b))
        plus_p = _carry16(d + _p16(spec, a.device)[:, None])
        return _join16(torch.where((borrow > 0)[None], plus_p, d))
    d = _signed(torch.nn.functional.pad(_rows16(a) - _rows16(b), (0, 1)))
    plus_p = _carry(d[:, :_NL16] + _consts(spec, a.device)[0], 1)
    return _rows32(torch.where(d[:, _NL16:] != 0, plus_p, d[:, :_NL16]))


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """-a mod p (zero stays zero)."""
    return sub(spec, torch.zeros_like(a), a)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * 2^-256 mod p.  The limb loop keeps the
    accumulator T [17, N] redundant (limbs < 2^23) as tpu/mont.py:mont_mul;
    the vectorised form takes T = a * b (columns below 2^36), m = T *
    (-p^-1) mod 2^256 (columns below 2^56: four passes), then (T + m p) /
    2^256 < 2p (below 2^38: three passes) and one conditional
    subtraction."""
    if not _vectorised(a):
        return _mont_mul_loop(spec, a, b)
    p, np_, cols = _consts(spec, a.device)
    T = _convolve(_rows16(a), _rows16(b), cols)
    m = _carry(_convolve(T[:, :_NL16], np_, cols)[:, :_NL16], 4)
    U = _carry(torch.nn.functional.pad(T + _convolve(m, p, cols), (0, 2)), 3)
    return _rows32(_reduce_once(p, U[:, _NL16:2 * _NL16]))


def _mont_mul_loop(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    A, B = _split16(a), _split16(b)
    n = A.shape[1]
    pvec = _p16(spec, a.device)[:, None]
    z1 = torch.zeros((1, n), dtype=torch.int64, device=a.device)
    T = torch.zeros((_NL16 + 1, n), dtype=torch.int64, device=a.device)
    for i in range(_NL16):
        prod = A[i][None] * B                              # [16, N]
        T[:_NL16] += prod & _M16
        T[1:] += prod >> 16
        m = ((T[0] & _M16) * spec.n0_16) & _M16            # [N]
        prod2 = m[None] * pvec
        T[:_NL16] += prod2 & _M16
        T[1:] += prod2 >> 16
        # T[0] is now divisible by 2^16: shift down one limb
        T = torch.cat([(T[1] + (T[0] >> 16))[None], T[2:], z1])
    return _join16(_cond_sub_p(spec, _carry16(T[:_NL16])))


def mul_add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 + c mod p (K4)."""
    return add(spec, mont_mul(spec, a, b), c)


def butterfly(spec: FieldSpec, lo: torch.Tensor, hi: torch.Tensor, w: torch.Tensor):
    """Radix-2 DIT butterfly (K5): t = w * hi; (lo + t, lo - t)."""
    t = mont_mul(spec, w, hi)
    return add(spec, lo, t), sub(spec, lo, t)


def to_mont(spec: FieldSpec, raw: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, raw, spec.const_raw(spec.r2_mod_p, raw.shape[0], raw.device))


def from_mont(spec: FieldSpec, m: torch.Tensor) -> torch.Tensor:
    return mont_mul(spec, m, spec.const_raw(1, m.shape[0], m.device))


def mont_pow(spec: FieldSpec, base: torch.Tensor, exponent: int) -> torch.Tensor:
    """base^exponent (Montgomery in and out), square and multiply."""
    acc = spec.const(1, base.shape[0], base.device)
    sq = base
    for i in range(max(exponent.bit_length(), 1)):
        if (exponent >> i) & 1:
            acc = mont_mul(spec, acc, sq)
        sq = mont_mul(spec, sq, sq)
    return acc


def inverse(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a^(p-2): the inverse, zero maps to zero."""
    return mont_pow(spec, a, spec.p - 2)
