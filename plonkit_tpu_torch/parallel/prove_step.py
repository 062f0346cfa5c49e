"""Sharded prover step over the mesh (plonkit_tpu/parallel/prove_step.py):
the prover's hot pipeline on domain-sharded blocks, one rank per process.

One step, for wire polynomials given as values:
  1. distributed iNTT (values -> monomials), the 4-step of parallel/ntt.py;
  2. the 4x coset LDE: coset scaling by g^i with the rank's global i, then
     the 4-step over the zero-padded extended domain;
  3. the gate constraint on the coset, pointwise on the shard (K1, K4);
  4. the permutation grand product: local prefix products and the
     exclusive product of the lower shards' totals;
  5. a cross-shard field sum of the quotient values (the reduction that
     rides the MSM's all_gather in a prove).

Inputs and outputs are this rank's [rows, 8] Montgomery blocks.
"""

import torch

from ..fields import FR_GENERATOR
from ..gpu import field_kernels as fk
from ..gpu.mont import FR, NLIMBS
from .ntt import coset_powers, distributed_intt, distributed_ntt


def _mul(a, b):
    return fk.mul(FR, a, b)


def _add(a, b):
    return fk.add(FR, a, b)


def distributed_grand_product(factors: torch.Tensor, mesh) -> torch.Tensor:
    """Shifted prefix product of a domain-sharded factor vector:
    out[0] = 1, out[i] = prod(factors[:i]); this rank's block."""
    one = FR.const(1, 1, factors.device)
    local = fk.prefix_products(FR, torch.cat([one, factors[:-1]]))
    total = _mul(local[-1:], factors[-1:])
    offset = mesh.exclusive_scan(total, _mul, one)
    return _mul(local, offset.expand_as(local).contiguous())


def sharded_quotient_step(mesh, wires_v, selectors_v, pi_v, x_coset, vanishing_inv,
                          beta: int, gamma: int):
    """One sharded prover macro-step on this rank's blocks.

    wires_v: 4 blocks of [n/D, 8] wire values; selectors_v: 7 (the gate
    uses the first 6, as the JAX step); pi_v: [n/D, 8]; x_coset and
    vanishing_inv: [4n/D, 8] (x_coset, beta and gamma are unused, as in the
    JAX step).  Returns (t values [4n/D, 8], z values [n/D, 8], checksum
    [1, 8]: the sum of all of t)."""
    n = wires_v[0].shape[0] * mesh.size
    ext = 4 * n
    dev = str(pi_v.device)

    def lde(values):
        m = distributed_intt(values, mesh)
        m = _mul(m, coset_powers(FR_GENERATOR, n, mesh.size, mesh.rank, dev))
        return distributed_ntt(m, mesh, ext)

    wires_l = [lde(w) for w in wires_v]
    sel_l = [lde(s) for s in selectors_v]
    pi_l = lde(pi_v)

    one = FR.const(1, pi_l.shape[0], pi_l.device)
    terms = wires_l + [_mul(wires_l[0], wires_l[1]), one]
    gate = pi_l
    for s, t in zip(sel_l, terms):
        gate = fk.mul_add(FR, s, t, gate)
    t_l = _mul(gate, vanishing_inv)

    factors = fk.mul_add(FR, wires_v[0], selectors_v[0], wires_v[0])   # toy copy-factor w*(s+1)
    z_v = distributed_grand_product(factors, mesh)

    acc = t_l
    while acc.shape[0] > 1:
        half = acc.shape[0] // 2
        acc = _add(acc[:half], acc[half:2 * half])
    partials = mesh.all_gather(acc)
    checksum = partials[:1]
    for i in range(1, mesh.size):
        checksum = _add(checksum, partials[i:i + 1])
    return t_l, z_v, checksum.reshape(1, NLIMBS)
