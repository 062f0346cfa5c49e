"""Batched fixed-base scalar multiplication on the card: P_i = s_i * G for a
vector of scalars and the G1 generator, and the tau = 42 dev SRS made with
it.  Ported from plonkit_tpu/tpu/fixed_base.py, which composes XLA ops over
tpu/ec.py; here the same method is a composition over the port's own
kernels, with no kernel of its own:

- windowed fixed-base method with 8-bit windows: the 32 tables
  table[w][d] = d * 2^(8w) * G (d < 256) are made once on the host and
  kept on the device as Jacobian rows with Z = 1 (Z = 0 for d = 0);
- a scalar's window digits are the bytes of its canonical little-endian
  limbs;
- each window gathers its table row for every lane (`index_select`) and
  adds it with one K7 `padd` launch over all lanes: 32 launches a chunk;
- the affine conversion inverts Z over Fq by Montgomery's trick (the K1
  scans of field_kernels.batch_inverse), then X * Z^-2 and Y * Z^-3 by K1.

The SRS's tau powers are made on the device too (ntt.powers, K1), so no
python int per point is made anywhere; the points leave the card as
canonical limb rows, which serialization.save_crs_g1_limbs writes as a key.
A CPU tensor takes every kernel's plain version, as everywhere in the port.
"""

from functools import lru_cache

import numpy as np
import torch

from ..fields import FR_MODULUS
from . import field_kernels as fk, msm_kernels as mk, ntt as gntt
from .mont import FQ, FR, NLIMBS, to_numpy, to_tensor

WINDOW = 8
NUM_WINDOWS = 256 // WINDOW
CRS_CHUNK_LOG2 = 22     # points a chunk: bounds the ladder's temporaries


@lru_cache(maxsize=None)
def _window_tables_host():
    """[NUM_WINDOWS][2^WINDOW] affine multiples: table[w][d] = d * 2^(8w) * G
    (None for d = 0)."""
    from ..curve import G1_GEN, g1_add, g1_double
    tables = []
    cur = G1_GEN
    for _ in range(NUM_WINDOWS):
        row = [None]
        acc = None
        for _ in range(1, 1 << WINDOW):
            acc = g1_add(acc, cur)
            row.append(acc)
        tables.append(row)
        for _ in range(WINDOW):
            cur = g1_double(cur)
    return tables


@lru_cache(maxsize=4)
def _window_tables(device: str):
    """The tables as Jacobian Montgomery rows [NUM_WINDOWS * 2^WINDOW, 8]
    each (row w * 2^WINDOW + d), Z = 1 for a finite point and 0 for d = 0."""
    pts = [p for row in _window_tables_host() for p in row]
    xs = [0 if p is None else p[0] for p in pts]
    ys = [0 if p is None else p[1] for p in pts]
    zs = [0 if p is None else 1 for p in pts]
    return tuple(to_tensor(FQ.to_mont_np(v), device) for v in (xs, ys, zs))


def _scalar_mul_digits(digits: torch.Tensor):
    """digits: [N, 32] uint8, byte w of each canonical scalar.  Returns
    the Jacobian batch sum_w table[w][digit_w] (32 K7 launches)."""
    tx, ty, tz = _window_tables(str(digits.device))
    n = digits.shape[0]
    acc = (torch.zeros((n, NLIMBS), dtype=torch.int32, device=digits.device),) * 3
    for w in range(NUM_WINDOWS):
        idx = digits[:, w].long() + (w << WINDOW)
        acc = mk.padd(acc, (tx.index_select(0, idx), ty.index_select(0, idx),
                            tz.index_select(0, idx)))
    return acc


def _digits_of_raw(raw: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 canonical limb rows -> [N, 32] uint8 window digits."""
    return raw.contiguous().view(torch.uint8).reshape(raw.shape[0], 32)


def batch_scalar_mul_base(scalars, device="cuda"):
    """[s_i * G] as a Jacobian batch (X, Y, Z) of [N, 8] Montgomery Fq
    rows on `device`; the digits come from numpy."""
    raw = FR.to_limbs_np([s % FR_MODULUS for s in scalars])
    return _scalar_mul_digits(_digits_of_raw(to_tensor(raw, device)))


def to_affine_batch(jac):
    """Jacobian batch -> (x, y, inf) affine Montgomery batch on its device;
    a point at infinity (Z = 0) gives x = y = 0 and inf set."""
    X, Y, Z = jac
    zinv = fk.batch_inverse(FQ, Z)
    zinv2 = fk.mul(FQ, zinv, zinv)
    zinv3 = fk.mul(FQ, zinv2, zinv)
    return fk.mul(FQ, X, zinv2), fk.mul(FQ, Y, zinv3), (Z == 0).all(dim=1)


def affine_batch_to_limbs(aff):
    """(x, y, inf) affine Montgomery batch -> canonical limb rows on the
    host: (x [N, 8] uint32, y [N, 8] uint32, inf [N] bool), the layout of
    serialization.load_crs_g1_limbs."""
    x, y, inf = aff
    one = FQ.const_raw(1, x.shape[0], x.device)
    return (to_numpy(fk.mul(FQ, x, one)), to_numpy(fk.mul(FQ, y, one)),
            inf.cpu().numpy())


def gen_crs_g1_device(power: int, tau: int = 42, device="cuda"):
    """tau^i * G for i < 2^power as canonical limb rows (x, y, inf), the
    points of srs.dev_srs_g1 (and of the reference's Crs::crs_42), made in
    chunks of 2^CRS_CHUNK_LOG2 points: tau powers by ntt.powers, then
    batch_scalar_mul_base's ladder and to_affine_batch."""
    if not 1 < tau < FR_MODULUS:
        raise ValueError("tau must be in (1, r)")
    n = 1 << power
    chunk = min(n, 1 << CRS_CHUNK_LOG2)
    pows = gntt.powers(tau, chunk, device)
    one = FR.const_raw(1, chunk, device)
    step = FR.const(pow(tau, chunk, FR_MODULUS), chunk, device)
    parts = []
    for start in range(0, n, chunk):
        if start:
            pows = fk.mul(FR, pows, step)
        digits = _digits_of_raw(fk.mul(FR, pows, one))
        parts.append(affine_batch_to_limbs(to_affine_batch(_scalar_mul_digits(digits))))
    return tuple(np.concatenate(cols) for cols in zip(*parts))
