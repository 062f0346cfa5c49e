"""The traffic's circuit and witnesses: the chain equals the program's own
generator's, each witness satisfies it, and the pool is fixed by the seed."""

import pytest

from portbench.circuits import poseidon_chain as chain
from portbench.reference.bn254 import R


def _satisfied(cons, w) -> bool:
    def val(lc):
        return sum(w[i] * c for i, c in lc) % R
    return all(val(a) * val(b) % R == val(c) for a, b, c in cons)


def test_poseidon_vector():
    # circomlibjs test/poseidon.js: poseidon([1, 2])
    assert chain.poseidon(1, 2) == \
        7853200120776062878684798364095072458815029376092732009249414926327459813530


@pytest.mark.parametrize("hashes", [1, 3])
def test_equals_the_programs_chain(hashes):
    from plonkit_tpu_torch.frontend.poseidon import poseidon_circuit
    inputs = [1, 2] + [1000 + i for i in range(hashes - 1)]
    circ, out = poseidon_circuit(2, chain=hashes, inputs=inputs[:2])
    assert chain.constraints(hashes) == [tuple(c) for c in circ.r1cs.constraints]
    assert chain.chain_witness(inputs) == circ.witness and circ.witness[1] == out
    assert chain.num_wires(hashes) == circ.r1cs.num_variables


def test_witnesses_satisfy_the_chain():
    cons = chain.constraints(2)
    for j in range(3):
        w = chain.chain_witness(chain.chain_inputs(99, j, 2))
        assert len(w) == chain.num_wires(2) and _satisfied(cons, w)
    bad = chain.chain_witness(chain.chain_inputs(99, 0, 2))
    bad[7] = (bad[7] + 1) % R
    assert not _satisfied(cons, bad)


def test_pool_repeats_for_a_seed_and_differs_between_seeds():
    big = 2 ** 31 + 7
    pool = [chain.chain_inputs(big, j, 454) for j in range(4)]
    assert pool == [chain.chain_inputs(big, j, 454) for j in range(4)]
    assert len({tuple(p) for p in pool}) == 4
    assert all(chain.chain_inputs(big + 1, j, 454) != pool[j] for j in range(4))
    assert all(0 <= v < R for p in pool for v in p)


def test_circuit_interface():
    conf = {"hashes": 2}
    inputs, wires, cons = chain.r1cs(conf)
    w = chain.witness(conf, 5, 1)
    assert (inputs, wires) == (2, chain.num_wires(2)) and _satisfied(cons, w)
    assert chain.public(w) == [w[1]] and w == chain.witness(conf, 5, 1) != chain.witness(conf, 5, 2)


def test_tau_is_seeded():
    from portbench.workload import seeded_tau
    assert seeded_tau(5, 0) == seeded_tau(5, 0) != seeded_tau(6, 0)
    assert len({seeded_tau(5, j) for j in range(4)}) == 4


def test_judged_sample_is_drawn_from_the_seed():
    from portbench.workload import drawn
    big = 2 ** 31 + 11
    picks = [i for i in range(4000) if drawn(big, i, 8)]
    assert picks == [i for i in range(4000) if drawn(big, i, 8)] and picks[0] == 0
    assert 400 < len(picks) < 600 and picks != [i for i in range(4000) if drawn(big + 1, i, 8)]
    assert all(drawn(big, i, 1) for i in range(50))
