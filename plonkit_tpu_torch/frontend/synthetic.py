"""Synthetic circuits: the multiplication chain, copied from
scripts/bench_prove.py:synth_circuit (which imports the JAX package).

z_{i+1} = z_i * z_i + z_i over 2^k - 2 constraints, one public output.
The transpiler makes two gates of each constraint, so synth_circuit(k)
fills a 2^(k+1) domain: k = 19 gives the 2^20 domain of the README's
headline size.

And the Poseidon hash chain of the same script (poseidon_chain_circuit).
"""

import random

from ..fields import FR_MODULUS as R
from .circuit import CircomCircuit
from .r1cs import R1CS


def synth_circuit(k: int, seed: int = 99) -> CircomCircuit:
    n = (1 << k) - 2  # leave room for the input gate + padding row
    rng = random.Random(seed)
    z = [rng.randrange(R)]
    for _ in range(n):
        z.append((z[-1] * z[-1] + z[-1]) % R)
    # wires: 0 = ONE, 1 = z_n (public), 2..n+1 = z_0..z_{n-1}
    wires = [z[n]] + z[:n]
    constraints = []
    for i in range(n):
        zi = 2 + i
        znext = 1 if i == n - 1 else 3 + i
        constraints.append(([(zi, 1)], [(zi, 1)], [(znext, 1), (zi, R - 1)]))
    r1cs = R1CS(num_inputs=2, num_aux=n, num_variables=n + 2, constraints=constraints)
    return CircomCircuit(r1cs=r1cs, witness=[1] + wires)


def poseidon_chain_circuit(k: int) -> CircomCircuit:
    """Poseidon hash-chain circuit whose transpiled gate count fills the
    2^k domain, copied from scripts/bench_prove.py:poseidon_chain_circuit
    (the JAX package's prove benchmark: the analogue of plonkit's
    test/test_poseidon_plonk.sh, circomlib Poseidon(2) against a 2^20 SRS).
    The gate count is linear in the chain length, so two small transpiles
    calibrate the slope; k = 20 gives a chain of 454 hashes."""
    from ..api import analyse
    from .poseidon import poseidon_circuit

    g1 = analyse(poseidon_circuit(2, chain=1)[0]).num_gates
    g2 = analyse(poseidon_circuit(2, chain=2)[0]).num_gates
    # domain rows available: 2^k - 1 usable (n = 2^k - 1), keep slack for
    # the padding gates the setup appends
    if g1 > (1 << k) - 16:
        raise ValueError(f"a Poseidon chain needs k >= 12 (one hash = {g1} gates)")
    chain = max(1, (((1 << k) - 16) - g1) // (g2 - g1) + 1)
    return poseidon_circuit(2, chain=chain)[0]
