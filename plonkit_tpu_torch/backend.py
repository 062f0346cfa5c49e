"""The compute-backend interface of the prover, and the host MSM.

The PLONK orchestration (plonk/setup.py, plonk/prover.py) is written
against `Backend`; backend_torch.TorchBackend implements it on the card
(or on the CPU through the kernels' plain versions).  Vectors are opaque
handles; scalars cross the boundary as python ints, since they feed the
byte-exact Fiat-Shamir transcript.

`HostMSMContext` commits on the host, over the native Pippenger of
native/bn254.cpp: TorchBackend takes it on the CPU, as the JAX package does
(backend_jax.py:541).  On the card every commitment runs through
gpu/msm.py.
"""

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Protocol, Sequence

import numpy as np

from . import native
from .curve import g1_add
from .profiling import stage


class Backend(Protocol):
    """What plonk/setup.py, plonk/prover.py and plonk/extended.py call.
    Every vector operation is over Fr; semantics as in
    plonkit_tpu/backend.HostBackend."""

    def from_ints(self, values: Sequence[int], pad_to: int = None): ...
    def from_raw_limbs(self, raw: np.ndarray): ...
    def to_ints(self, v) -> List[int]: ...
    def ntt(self, v): ...
    def intt(self, v): ...
    def coset_lde(self, v, factor: int): ...
    def coset_intt(self, v): ...
    def scale(self, a, k: int): ...
    def scale_add(self, a, k: int, c): ...
    def sub(self, a, b): ...
    def gate_residual(self, sel_v, wires_v, pi_vec): ...
    def any_nonzero(self, v) -> bool: ...
    def quotient_column(self, sel_l, wires_l, d_next_l, z_l, z_next_l, pi_l,
                        x_coset, sigma_l, l0_l, vanishing_inv, beta: int,
                        gamma: int, alpha: int, k_cols): ...
    def permutation_grand_product(self, omega_pows, sigma_v, wires_v,
                                  beta: int, gamma: int, k_cols): ...
    def powers(self, base: int, n: int): ...
    def perm_from_labels(self, label_idx: np.ndarray): ...
    def poly_eval(self, coeffs, x: int) -> int: ...
    def poly_eval_many(self, polys, x: int) -> List[int]: ...
    def divide_by_linear(self, coeffs, point: int): ...
    def msm_context_from_crs(self, crs, size: int, key=None): ...
    def commit(self, msm_ctx, v): ...
    def commit_many(self, msm_ctx, vs): ...
    def slice(self, v, start: int, stop: int): ...
    def rotate(self, v, k: int): ...
    def tile_small(self, values: Sequence[int], total: int): ...
    # the extended prover (plonk/extended.py) also calls these
    def mul(self, a, b): ...
    def add(self, a, b): ...
    def add_scalar(self, a, k: int): ...
    def batch_inverse(self, v): ...
    def grand_product(self, factors): ...
    def offload(self, v): ...
    def onload(self, h): ...


# below this many points a chunk is not worth a thread of its own
_MIN_CHUNK = 1 << 14


class HostMSMContext:
    """KZG commitments over fixed bases on the host: the native Pippenger
    (native.bn254_g1_msm), one chunk of the points per thread, the chunk
    sums added on the host.  Bases are packed once, as [n, 64] uint8 rows
    (x || y little-endian, all zero for infinity)."""

    def __init__(self, bases: np.ndarray, threads: int = None):
        if bases.dtype != np.uint8 or bases.ndim != 2 or bases.shape[1] != 64:
            raise ValueError("bases: [n, 64] uint8 rows")
        self.bases = np.ascontiguousarray(bases)
        self.n = bases.shape[0]
        self.threads = threads or os.cpu_count() or 1

    @classmethod
    def from_points(cls, points, threads: int = None) -> "HostMSMContext":
        blob = b"".join(b"\x00" * 64 if p is None else
                        p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little")
                        for p in points)
        return cls(np.frombuffer(blob, dtype=np.uint8).reshape(-1, 64), threads)

    @classmethod
    def from_limbs(cls, x: np.ndarray, y: np.ndarray, inf: np.ndarray,
                   threads: int = None) -> "HostMSMContext":
        """From [N, 8] uint32 coordinate rows (serialization.load_crs_g1_limbs)."""
        rows = np.concatenate([np.ascontiguousarray(x, dtype="<u4").view(np.uint8),
                               np.ascontiguousarray(y, dtype="<u4").view(np.uint8)], axis=1)
        rows[inf] = 0
        return cls(rows, threads)

    def msm_rows(self, scalars: np.ndarray):
        """sum_i scalars[i] * bases[i] for [m, 32] uint8 canonical
        little-endian scalar rows, m <= n."""
        m = scalars.shape[0]
        if m > self.n:
            raise ValueError(f"{m} scalars for {self.n} bases")
        parts = max(1, min(self.threads, m // _MIN_CHUNK))
        bounds = [m * i // parts for i in range(parts + 1)]
        with stage("host msm"), ThreadPoolExecutor(parts) as pool:
            sums = list(pool.map(
                lambda i: native.bn254_g1_msm(self.bases[bounds[i]:bounds[i + 1]],
                                              scalars[bounds[i]:bounds[i + 1]]),
                range(parts)))
        acc = None
        for s in sums:
            acc = g1_add(acc, s)
        return acc


def from_ints_dedup(backend, values, pad_to: int = None):
    """backend.from_ints with distinct-value limb conversion: setup
    polynomials (selectors) repeat a small set of coefficients over the
    whole domain, so each DISTINCT value is converted to limbs once and the
    column is a numpy gather."""
    from .gpu.mont import FR
    uniq = {}
    n = len(values)
    total = pad_to if pad_to is not None and pad_to > n else n
    idx = np.empty(total, dtype=np.int64)
    for i, v in enumerate(values):
        j = uniq.get(v)
        if j is None:
            j = uniq[v] = len(uniq)
        idx[i] = j
    if total > n:
        z = uniq.get(0)
        if z is None:
            z = uniq[0] = len(uniq)
        idx[n:] = z
    limbs = FR.to_limbs_np(list(uniq))          # [n_distinct, 8]
    return backend.from_raw_limbs(np.ascontiguousarray(limbs[idx]))
