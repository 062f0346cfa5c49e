"""The plain reference against the program at a size the CPU holds: the
verification key it works out again with tau equals the program's, its
verifier accepts the program's proof and refuses a tampered one or another
public input, and its Lagrange points equal the program's key."""

import pytest

from portbench.circuits import poseidon_chain as chain
from portbench.reference import bn254, plonk

TAU = 987654321987654321


@pytest.fixture(scope="module")
def proved():
    from plonkit_tpu_torch.api import SetupForProver
    from plonkit_tpu_torch.frontend.circuit import CircomCircuit
    from plonkit_tpu_torch.frontend.r1cs import R1CS
    from portbench.workload import device_key
    cons, wires = chain.constraints(1), chain.num_wires(1)
    w = chain.chain_witness(chain.chain_inputs(3, 0, 1))
    circ = CircomCircuit(r1cs=R1CS(num_inputs=2, num_aux=wires - 2, num_variables=wires,
                                   constraints=cons), witness=w)
    setup = SetupForProver(circ, device_key(12, TAU, "cpu"), device="cpu")
    return cons, wires, w, setup.make_verification_key(), setup.prove(circ)


def test_verification_key_equals_the_programs(proved):
    cons, wires, _, vk, _ = proved
    ref = plonk.verification_key(plonk.transpile(2, wires, cons), TAU)
    assert ref["size"] == 1 << 12
    assert [ref[k] for k in ("q_a", "q_b", "q_c", "q_d", "q_m", "q_const")] == \
        vk.selector_commitments
    assert [ref["q_d_next"]] == vk.next_step_selector_commitments
    assert [ref[f"sigma_{c}"] for c in range(4)] == vk.permutation_commitments


def test_verifier(proved):
    import copy
    cons, wires, w, _, proof = proved
    vk = plonk.verification_key(plonk.transpile(2, wires, cons), TAU)
    assert plonk.verify(vk, TAU, [w[1]], proof)
    assert not plonk.verify(vk, TAU, [(w[1] + 1) % bn254.R], proof)
    assert not plonk.verify(vk, TAU + 1, [w[1]], proof)
    bad = copy.copy(proof)
    bad.quotient_polynomial_at_z = (proof.quotient_polynomial_at_z + 1) % bn254.R
    assert not plonk.verify(vk, TAU, [w[1]], bad)
    bad = copy.copy(proof)
    bad.opening_at_z_proof = bn254.add(proof.opening_at_z_proof, bn254.G1)
    assert not plonk.verify(vk, TAU, [w[1]], bad)


def test_lagrange_points_equal_the_programs():
    from plonkit_tpu_torch.api import crs_lagrange_form
    from portbench.workload import device_key
    n = 8
    x, y, inf = crs_lagrange_form(device_key(3, TAU, "cpu"), n, device="cpu").g1_limbs()
    got = list(zip(bn254.ints_of_rows(x), bn254.ints_of_rows(y)))
    want = [bn254.mul(bn254.G1, s) for s in bn254.lagrange_at(n, TAU, range(n))]
    assert not inf.any() and got == want
    assert bn254.sum_affine_rows(x, y, inf) == bn254.G1
    assert bn254.sum_affine_rows(x[1:], y[1:], inf[1:]) != bn254.G1
