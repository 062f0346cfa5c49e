"""Distributed NTT over the mesh: the Bailey 4-step transform of
plonkit_tpu/parallel/ntt.py, with its three all-to-alls written out.

n = n1 * n2 (n1 <= n2); the vector is sharded in contiguous blocks
(parallel/mesh.py).  Viewing x as row-major [n1, n2], x[j1 * n2 + j2]:

  step 0: all_to_all     row blocks -> column blocks, [n1, n2/D] a rank
  step 1: length-n1 transforms down the columns (gpu/ntt.ntt_batched)
  step 2: twiddle A[k1, j2] *= w^(k1 * j2) with the rank's global j2, by K1
          over rows gathered from one power table
  step 3: all_to_all     -> [n2, n1/D]: the rank's k1 block, j2 outermost
  step 4: length-n2 transforms down the columns
  step 5: all_to_all     -> natural order, X[k1 + n1 * k2] = A[k1, k2]: the
          rank's block of k2 rows, all k1

Keeping the transform axis outermost (`[m, B, 8]`) lets K3 and K5 run the
batched stages on contiguous blocks.  With inverse=True the two
sub-transforms' 1/m scalings compose to 1/n, as in the JAX package.

A coset LDE of a vector of n/F rows enters at step 0 as the first rows of
the [n1, n2] view, without its zero padding: the all-to-all carries the
n/F rows and each rank pads its columns (`distributed_ntt`'s `rows`).
"""

from functools import lru_cache

import numpy as np
import torch

from ..fields import FR_MODULUS as R, fr_inv, get_domain_omega
from ..gpu import field_kernels as fk, ntt as gntt
from ..gpu.mont import FR, NLIMBS


def _split(n: int):
    """n = n1 * n2 with n1 <= n2, both powers of two."""
    log_n = n.bit_length() - 1
    l1 = log_n // 2
    return 1 << l1, 1 << (log_n - l1)


def can_distribute(n: int, d: int, rows: int = None) -> bool:
    """Whether the 4-step runs over d ranks at n points: D divides both
    n1 and n2; an input of `rows` < n rows (the coset LDE's unpadded
    coefficients) must fill whole rows of the [n1, n2] view, D of them at
    least."""
    if n & (n - 1) or n < 4:
        return False
    n1, n2 = _split(n)
    if n1 % d or n2 % d:
        return False
    rows = n if rows is None else rows
    return rows % n2 == 0 and (rows // n2) % d == 0


@lru_cache(maxsize=8)
def _twiddles(n: int, d: int, rank: int, inverse: bool, device: str) -> torch.Tensor:
    """w^(k1 * j2) for k1 < n1 and this rank's n2/d columns j2, [n/d, 8]
    (w^-1 for the inverse), rows gathered from the table of w's powers."""
    omega = get_domain_omega(n)
    if inverse:
        omega = fr_inv(omega)
    n1, n2 = _split(n)
    cols = n2 // d
    k1 = np.arange(n1, dtype=np.int64)[:, None]
    j2 = np.arange(rank * cols, (rank + 1) * cols, dtype=np.int64)[None, :]
    idx = torch.from_numpy((k1 * j2 % n).reshape(-1)).to(device)
    return gntt.powers(omega, n, device).index_select(0, idx)


def _to_columns(x: torch.Tensor, mesh, n1: int, n2: int) -> torch.Tensor:
    """Step 0: this rank's block of rows of the [m1, n2] view (m1 <= n1)
    -> its n2/D columns of all n1 rows, [n1, n2/D, 8], rows m1 and above
    zero."""
    d = mesh.size
    m1 = x.shape[0] * d // n2
    send = x.reshape(m1 // d, d, n2 // d, NLIMBS).transpose(0, 1)
    a = mesh.all_to_all(send.contiguous().reshape(-1, NLIMBS)).view(m1, n2 // d, NLIMBS)
    if m1 < n1:
        a = torch.cat([a, a.new_zeros((n1 - m1, n2 // d, NLIMBS))])
    return a


def distributed_ntt(x: torch.Tensor, mesh, n: int = None, inverse: bool = False) -> torch.Tensor:
    """x: this rank's [n/D, 8] block of a length-n vector in natural order
    (or its [rows/D, 8] block of the first `rows` < n coefficients of a
    zero-padded one) -> this rank's block of the transform, natural order.
    The caller checks can_distribute."""
    d, rank = mesh.size, mesh.rank
    n = x.shape[0] * d if n is None else n
    n1, n2 = _split(n)
    a = gntt.ntt_batched(_to_columns(x, mesh, n1, n2), inverse)            # steps 0-1
    tw = _twiddles(n, d, rank, inverse, str(x.device))
    a = fk.mul(FR, a.reshape(-1, NLIMBS), tw).view(d, n1 // d, n2 // d, NLIMBS)  # step 2
    b = mesh.all_to_all(a.transpose(1, 2).contiguous().reshape(-1, NLIMBS))    # step 3
    b = gntt.ntt_batched(b.view(n2, n1 // d, NLIMBS), inverse)             # step 4
    c = mesh.all_to_all(b.reshape(-1, NLIMBS)).view(d, n2 // d, n1 // d, NLIMBS)  # step 5
    return c.transpose(0, 1).reshape(n // d, NLIMBS)


def distributed_intt(x: torch.Tensor, mesh) -> torch.Tensor:
    return distributed_ntt(x, mesh, inverse=True)


@lru_cache(maxsize=8)
def coset_powers(shift: int, n: int, d: int, rank: int, device: str) -> torch.Tensor:
    """shift^i for this rank's rows i of a sharded length-n vector."""
    b = n // d
    pows = gntt.powers(shift % R, b, device)
    if rank:
        pows = fk.mul(FR, pows, FR.const(pow(shift, rank * b, R), b, device))
    return pows
