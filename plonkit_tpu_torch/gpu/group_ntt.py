"""The G1 group NTT: wrappers of K14 g1_butterfly and K15 g1_scale
(csrc/group_ntt.cu), each beside its plain PyTorch version, and group_intt,
the inverse transform over SRS points that api.crs_lagrange_form runs to
make the Lagrange form of a key.

No TPU kernel stands behind them: the JAX package's group NTT is host
python (plonkit_tpu/api.py:99 _group_ntt, one g1_mul a butterfly), which
would take days at a 2^20 domain.  Here the transform stays on the device
from the key's limb rows to the Lagrange key's; no python int per point is
made.

Points are Jacobian triples of [N, 8] int32 Montgomery Fq rows (gpu/ec.py);
scalars are [N, 8] int32 rows of canonical little-endian Fr limbs.  A CPU
tensor takes the plain version; a CUDA tensor launches the kernel on the
current stream or raises.  `launches` counts kernel launches, one per call
that launched.
"""

import numpy as np
import torch

from ..fields import fr_inv, get_domain_omega
from . import build, ec, field_kernels as fk, ntt as gntt
from .field_kernels import check_operands, stream_ptr
from .fixed_base import affine_batch_to_limbs, to_affine_batch
from .mont import FQ, FR, to_tensor

launches = {"g1_butterfly": 0, "g1_scale": 0}

WINDOW = 4                      # bits a ladder window (csrc/group_ntt.cu)
NUM_WINDOWS = 256 // WINDOW


def window_digits(s: torch.Tensor) -> torch.Tensor:
    """[N, 8] canonical scalar rows -> [N, 64] int64 4-bit window digits,
    least significant first."""
    w = s.to(torch.int64) & 0xFFFFFFFF
    shifts = torch.arange(0, 32, WINDOW, device=s.device)
    return ((w[:, :, None] >> shifts) & ((1 << WINDOW) - 1)).reshape(s.shape[0], NUM_WINDOWS)


def scalar_mul_plain(p, digits: torch.Tensor):
    """[s_i] p_i for every lane, by csrc/group_ntt.cu's ladder over all
    lanes at once: a table T[d] = T[d - 1] + p (T[0] infinity, T[1] = p, up
    to the largest digit used), then from the top window that has a non-zero
    digit in any lane, four doublings and one complete add of T[digit] a
    window.  A lane below its own top window holds infinity, which the
    doublings keep and an add of T[0] leaves: so each lane's rows are the
    kernel's, whose thread starts at its top window."""
    n = digits.shape[0]
    used = (digits != 0).any(dim=0).nonzero()
    if n == 0 or used.numel() == 0:
        return ec.infinity(n, digits.device)
    table = [ec.infinity(n, digits.device), p]
    for _ in range(2, int(digits.max()) + 1):
        table.append(ec.add(table[-1], p))
    cols = [torch.stack([t[c] for t in table]) for c in range(3)]
    lanes = torch.arange(n, device=digits.device)
    top = int(used.max())
    acc = ec.infinity(n, digits.device)
    for w in range(top, -1, -1):
        if w < top:
            for _ in range(WINDOW):
                acc = ec.double(acc)
        d = digits[:, w]
        acc = ec.add(acc, tuple(c[d, lanes] for c in cols))
    return acc


# -- K14 ---------------------------------------------------------------------

def g1_butterfly_plain(lo, hi, w):
    t = scalar_mul_plain(hi, window_digits(w))
    return ec.add(lo, t), ec.add(lo, ec.neg(t))


def g1_butterfly(lo, hi, w):
    """K14, one radix-2 DIT stage over G1: (lo + [w]hi, lo - [w]hi) lane
    by lane; lo and hi Jacobian triples, w [N, 8] canonical Fr rows."""
    check_operands(*lo, *hi, w)
    if not w.is_cuda:
        return g1_butterfly_plain(lo, hi, w)
    n = w.shape[0]
    out = tuple(torch.empty_like(w) for _ in range(6))
    if n:
        lib = build.load("group_ntt")
        build.check(lib.plonkit_g1_butterfly(*(t.data_ptr() for t in (*lo, *hi, w, *out)), n,
                                             stream_ptr(w)), "K14 g1_butterfly")
        launches["g1_butterfly"] += 1
    return out[:3], out[3:]


# -- K15 ---------------------------------------------------------------------

def _scalar_row(s: int, device) -> torch.Tensor:
    if not 0 <= s < 1 << 256:
        raise ValueError(f"scalar {s} does not fit 256 bits")
    return FR.const_raw(s, 1, device)


def g1_scale_plain(p, s: int):
    digits = window_digits(_scalar_row(s, p[0].device))
    return scalar_mul_plain(p, digits.expand(p[0].shape[0], NUM_WINDOWS))


def g1_scale(p, s: int):
    """K15: [s] p lane by lane, for one scalar 0 <= s < 2^256."""
    check_operands(*p)
    row = _scalar_row(s, p[0].device)
    if not p[0].is_cuda:
        return g1_scale_plain(p, s)
    n = p[0].shape[0]
    out = tuple(torch.empty_like(p[0]) for _ in range(3))
    if n:
        lib = build.load("group_ntt")
        build.check(lib.plonkit_g1_scale(*(t.data_ptr() for t in (*p, row, *out)), n,
                                         stream_ptr(p[0])), "K15 g1_scale")
        launches["g1_scale"] += 1
    return out


# -- the transform -------------------------------------------------------------

def group_intt(x, y, inf, device="cuda"):
    """The inverse NTT over G1 of n = 2^k affine points given as canonical
    limb rows (x, y [n, 8] uint32, inf [n] bool: load_crs_g1_limbs's
    layout): out_i = (1/n) sum_j [w^-ij] P_j for the domain's root w, in the
    same layout.  For SRS points tau^j G these are L_i(tau) G.  The points
    go to Montgomery form by K1, one gather puts them in bit-reversed order,
    then the transposed Pease form of gpu/ntt.py's intt, over G1: k K14
    stages on the even and odd rows, with w^-1's stage twiddles (ntt.powers,
    then out of Montgomery form by K1), one K15 by 1/n, and the affine
    conversion of gpu/fixed_base.py (two K12 and one K13 for the inverse
    of Z, K1)."""
    n = x.shape[0]
    if n < 1 or n & (n - 1) or y.shape[0] != n or len(inf) != n:
        raise ValueError(f"{n} points: the transform takes a power of two of them")
    fin = ~torch.from_numpy(np.asarray(inf, dtype=bool)).to(device)[:, None]
    r2 = FQ.const_raw(FQ.r2_mod_p, n, device)
    zero = torch.zeros((n, 8), dtype=torch.int32, device=device)
    pts = (torch.where(fin, fk.mul(FQ, to_tensor(x, device), r2), zero),
           torch.where(fin, fk.mul(FQ, to_tensor(y, device), r2), zero),
           torch.where(fin, FQ.const(1, n, device), zero))
    rev = torch.from_numpy(gntt._bitrev_np(n)).to(device)
    pts = tuple(c.index_select(0, rev) for c in pts)
    half = n // 2
    if half:
        pows = gntt.powers(fr_inv(get_domain_omega(n)), half, device)
        tw = fk.mul(FR, pows, FR.const_raw(1, half, device))
        for t in reversed(range(n.bit_length() - 1)):
            lo, hi = g1_butterfly(tuple(c[0::2].contiguous() for c in pts),
                                  tuple(c[1::2].contiguous() for c in pts),
                                  gntt._stage_twiddles(tw, t, half))
            pts = tuple(torch.cat([a, b]) for a, b in zip(lo, hi))
    pts = g1_scale(pts, fr_inv(n))
    return affine_batch_to_limbs(to_affine_batch(pts))
