"""Montgomery field arithmetic over BN254 Fr and Fq in plain PyTorch.

Layout: one field element is one row of eight little-endian 32-bit limbs,
so a vector of N elements is an [N, 8] int32 tensor whose bits are read as
uint32.  The Montgomery radix is R = 2^256, the same as the JAX package's
planar [16, N] 16-bit limbs (plonkit_tpu/tpu/mont.py), so both hold the same
value for every element; convert.py repacks one layout into the other.
Every result is fully reduced into [0, p).

The ops here are the plain versions of the CUDA kernels in csrc/: the
wrappers in field_kernels.py and ntt.py take them for tensors on the CPU,
and chip_smoke.py holds each kernel against them on the card.  They compute
on int64 tensors holding 16-bit limbs (limb axis first), so no product or
column sum can overflow: the CIOS loop is the one of tpu/mont.py:mont_mul.
"""

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


def add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p."""
    s = _carry16(_split16(a) + _split16(b))   # < 2p < 2^255: no carry out
    return _join16(_cond_sub_p(spec, s))


def sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p."""
    d, borrow = _sub_borrow(_split16(a), _split16(b))
    plus_p = _carry16(d + _p16(spec, a.device)[:, None])
    return _join16(torch.where((borrow > 0)[None], plus_p, d))


def neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """-a mod p (zero stays zero)."""
    return sub(spec, torch.zeros_like(a), a)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a * b * 2^-256 mod p: CIOS over 16-bit limbs, the
    accumulator T [17, N] kept redundant (limbs < 2^23) as in
    tpu/mont.py:mont_mul."""
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
