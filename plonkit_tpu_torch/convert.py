"""Carry the JAX package's state into the port's layout and back.

The JAX package holds Fr and Fq vectors as planar [16, N] uint32 arrays of
16-bit little-endian limbs (plonkit_tpu/tpu/mont.py); the port holds them as
[N, 8] rows of 32-bit little-endian limbs (gpu/mont.py).  Both use
R = 2^256, so a repack carries every Montgomery or raw value over
unchanged.  G1 point batches carry over coordinate by coordinate: the JAX
package's affine (x, y, inf) and Jacobian (X, Y, Z) triples of [16, N]
Fq limbs become the port's triples of [N, 8] rows (gpu/ec.py), and back.
Nothing here imports the JAX package: the functions take numpy arrays, or
objects that expose one (`.data` of a backend_jax.FrVec, `.path` of a
serialization.CrsHandle).
"""

import numpy as np
import torch

from .backend_torch import FrVec
from .gpu.mont import to_numpy, to_tensor
from .serialization import CrsHandle


def limbs16_to_rows(planar) -> np.ndarray:
    """[16, N] uint32 16-bit limbs -> [N, 8] uint32 32-bit limb rows."""
    arr = np.asarray(planar)
    if arr.ndim != 2 or arr.shape[0] != 16:
        raise ValueError(f"expected [16, N] limbs, got {arr.shape}")
    if arr.size and int(arr.max()) > 0xFFFF:
        raise ValueError("16-bit limbs out of range")
    u16 = np.ascontiguousarray(arr.T.astype("<u2"))           # [N, 16]
    return u16.view("<u4").astype(np.uint32)                  # [N, 8]


def rows_to_limbs16(rows) -> np.ndarray:
    """[N, 8] uint32 32-bit limb rows -> [16, N] uint32 16-bit limbs."""
    arr = np.ascontiguousarray(rows, dtype="<u4")
    if arr.ndim != 2 or arr.shape[1] != 8:
        raise ValueError(f"expected [N, 8] rows, got {arr.shape}")
    return np.ascontiguousarray(arr.view("<u2").T.astype(np.uint32))


def frvec_to_port(v, device="cuda") -> FrVec:
    """A JAX-package FrVec (or its [16, N] array) -> a port FrVec."""
    planar = np.asarray(getattr(v, "data", v))
    return FrVec(to_tensor(limbs16_to_rows(planar), device))


def frvec_from_port(v: FrVec) -> np.ndarray:
    """A port FrVec (or its [N, 8] tensor) -> the JAX package's [16, N]."""
    data = v.data if isinstance(v, FrVec) else v
    if not isinstance(data, torch.Tensor):
        raise TypeError("expected a port FrVec or tensor")
    return rows_to_limbs16(to_numpy(data))


def jacobian_to_port(p, device="cuda") -> tuple:
    """JAX-package Jacobian (X, Y, Z), each [16, N] -> port [N, 8] rows."""
    return tuple(to_tensor(limbs16_to_rows(a), device) for a in p)


def jacobian_from_port(p) -> tuple:
    """Port Jacobian rows -> the JAX package's three [16, N] arrays."""
    return tuple(rows_to_limbs16(to_numpy(a)) for a in p)


def affine_to_port(aff, device="cuda") -> tuple:
    """JAX-package affine (x [16, N], y [16, N], inf [N]) -> port
    (x rows, y rows, inf [N] bool tensor)."""
    x, y, inf = aff
    mask = torch.from_numpy(np.asarray(inf, dtype=bool).copy())
    return (to_tensor(limbs16_to_rows(x), device), to_tensor(limbs16_to_rows(y), device),
            mask.to(device))


def affine_from_port(aff) -> tuple:
    """Port affine (x rows, y rows, inf) -> ([16, N], [16, N], [N] bool)."""
    x, y, inf = aff
    return (rows_to_limbs16(to_numpy(x)), rows_to_limbs16(to_numpy(y)),
            inf.detach().cpu().numpy().astype(bool))


def crs_handle(handle) -> CrsHandle:
    """The JAX package's CrsHandle (anything with `.path`) -> the port's,
    over the same SRS file."""
    return CrsHandle(handle.path)
