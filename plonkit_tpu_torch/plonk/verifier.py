"""Host-side PLONK verifier for the width-4 + D-next system.

This is a line-for-line behavioral port of the on-chain verifier spec
(contrib/template.sol:309-786), which is the ground truth for the proof
system; also mirrors bellman_ce better_cs::verifier (SURVEY D1g).  O(1)
field work + 2 pairings per proof, so it stays on host; the pairing runs in
the native library (native.py).
"""

from typing import List

from ..curve import G1_GEN, G2_GEN, g1_add, g1_mul, g1_neg
from ..fields import FR_MODULUS as R, batch_inverse, get_domain_omega
from ..native import bn254_pairing_check as pairing_check
from ..serialization import Proof, VerificationKey
from ..transcript import make_transcript

STATE_WIDTH = 4


def _derive_challenges(proof: Proof, vk: VerificationKey, transcript: str = "keccak"):
    """Fiat-Shamir challenge derivation order: template.sol:691-755."""
    t = make_transcript(transcript)
    for v in proof.input_values:
        t.update_u256(v)
    for p in proof.wire_commitments:
        t.update_g1(p)
    beta = t.get_challenge()
    gamma = t.get_challenge()
    t.update_g1(proof.grand_product_commitment)
    alpha = t.get_challenge()
    for p in proof.quotient_poly_commitments:
        t.update_g1(p)
    z = t.get_challenge()
    # evaluations are absorbed before v
    ev = (
        list(proof.wire_values_at_z)
        + list(proof.wire_values_at_z_omega)
        + list(proof.permutation_polynomials_at_z)
        + [
            proof.quotient_polynomial_at_z,
            proof.linearization_polynomial_at_z,
            proof.grand_product_at_z_omega,
        ]
    )
    for e in ev:
        t.update_fr(e)
    v = t.get_challenge()
    t.update_g1(proof.opening_at_z_proof)
    t.update_g1(proof.opening_at_z_omega_proof)
    u = t.get_challenge()
    return beta, gamma, alpha, z, v, u


def batch_evaluate_lagrange_polys(poly_nums: List[int], domain_size: int, omega: int, at: int) -> List[int]:
    """L_i(at) for i in poly_nums; template.sol:379-435."""
    vanishing = (pow(at, domain_size, R) - 1) % R
    if vanishing == 0:
        raise ValueError("evaluation point in domain")
    nums, dens = [], []
    for i in poly_nums:
        w_i = pow(omega, i, R)
        nums.append(vanishing * w_i % R)
        dens.append((at - w_i) * domain_size % R)
    inv_dens = batch_inverse(dens, R)
    return [n * d % R for n, d in zip(nums, inv_dens)]


def verify(vk: VerificationKey, proof: Proof, transcript: str = "keccak") -> bool:
    pair = prepare_pairing_pair(vk, proof, transcript)
    if pair is None:
        return False
    pair_with_generator, pair_with_x = pair
    g2_base = vk.g2_elements[0] if vk.g2_elements else G2_GEN
    g2_x = vk.g2_elements[1]
    return pairing_check([(pair_with_generator, g2_base), (pair_with_x, g2_x)])


def prepare_pairing_pair(vk: VerificationKey, proof: Proof, transcript: str = "keccak"):
    """Runs everything up to (but not including) the final pairing; returns
    (pair_with_generator, pair_with_x) such that the proof is valid iff
    e(PG, G2) * e(PX, [x]_2) == 1, or None if the gate identity fails.
    This split is what proof aggregation builds on (the reference's
    make_aggregate, src/recursive/mod.rs:86)."""
    if len(proof.input_values) != vk.num_inputs or vk.num_inputs < 1:
        return None
    domain_size = vk.domain_size
    omega = get_domain_omega(domain_size)

    beta, gamma, alpha, z, v, u = _derive_challenges(proof, vk, transcript)
    lagrange_at_z = batch_evaluate_lagrange_polys(list(range(vk.num_inputs)), domain_size, omega, z)

    # ---- gate identity at z (template.sol:445-494) ----
    vanishing_at_z = (pow(z, domain_size, R) - 1) % R
    if vanishing_at_z == 0:
        return None
    lhs = vanishing_at_z * proof.quotient_polynomial_at_z % R

    rhs = proof.linearization_polynomial_at_z
    for i, x in enumerate(proof.input_values):
        rhs = (rhs + lagrange_at_z[i] * x) % R

    quotient_challenge = alpha
    z_part = proof.grand_product_at_z_omega
    for i, s in enumerate(proof.permutation_polynomials_at_z):
        z_part = z_part * ((s * beta + gamma + proof.wire_values_at_z[i]) % R) % R
    z_part = z_part * ((gamma + proof.wire_values_at_z[STATE_WIDTH - 1]) % R) % R
    z_part = z_part * quotient_challenge % R
    rhs = (rhs - z_part) % R

    quotient_challenge = quotient_challenge * alpha % R
    rhs = (rhs - lagrange_at_z[0] * quotient_challenge) % R

    if lhs != rhs:
        return None

    # ---- reconstruct D = [linearization]_1 contribution (template.sol:496-586) ----
    power_for_z_omega_opening = 1 + 1 + STATE_WIDTH + (STATE_WIDTH - 1)  # = 9
    d = vk.selector_commitments[STATE_WIDTH + 1]  # q_const commitment
    for i in range(STATE_WIDTH):
        d = g1_add(d, g1_mul(vk.selector_commitments[i], proof.wire_values_at_z[i]))
    d = g1_add(d, g1_mul(vk.selector_commitments[STATE_WIDTH],
                         proof.wire_values_at_z[0] * proof.wire_values_at_z[1] % R))
    d = g1_add(d, g1_mul(vk.next_step_selector_commitments[0], proof.wire_values_at_z_omega[0]))

    gp_part_at_z = (z * beta + proof.wire_values_at_z[0] + gamma) % R
    for i, k in enumerate(vk.non_residues):
        gp_part_at_z = gp_part_at_z * ((z * k % R * beta + gamma + proof.wire_values_at_z[i + 1]) % R) % R
    gp_part_at_z = gp_part_at_z * alpha % R
    gp_part_at_z = (gp_part_at_z + lagrange_at_z[0] * alpha % R * alpha) % R

    gp_part_at_z_omega = pow(v, power_for_z_omega_opening, R) * u % R

    last_perm_part_at_z = 1
    for i, s in enumerate(proof.permutation_polynomials_at_z):
        last_perm_part_at_z = last_perm_part_at_z * ((beta * s + gamma + proof.wire_values_at_z[i]) % R) % R
    last_perm_part_at_z = last_perm_part_at_z * beta % R * proof.grand_product_at_z_omega % R * alpha % R

    tmp = g1_add(
        g1_mul(proof.grand_product_commitment, gp_part_at_z),
        g1_neg(g1_mul(vk.permutation_commitments[STATE_WIDTH - 1], last_perm_part_at_z)),
    )
    d = g1_add(d, tmp)
    d = g1_mul(d, v)
    d = g1_add(d, g1_mul(proof.grand_product_commitment, gp_part_at_z_omega))

    # ---- batched KZG double opening (template.sol:588-689) ----
    z_in_domain_size = pow(z, domain_size, R)

    commitment_aggregation = proof.quotient_poly_commitments[0]
    tmp_fr = 1
    for i in range(1, len(proof.quotient_poly_commitments)):
        tmp_fr = tmp_fr * z_in_domain_size % R
        commitment_aggregation = g1_add(commitment_aggregation,
                                        g1_mul(proof.quotient_poly_commitments[i], tmp_fr))
    aggregation_challenge = v
    commitment_aggregation = g1_add(commitment_aggregation, d)
    for p in proof.wire_commitments:
        aggregation_challenge = aggregation_challenge * v % R
        commitment_aggregation = g1_add(commitment_aggregation, g1_mul(p, aggregation_challenge))
    for i in range(len(vk.permutation_commitments) - 1):
        aggregation_challenge = aggregation_challenge * v % R
        commitment_aggregation = g1_add(commitment_aggregation,
                                        g1_mul(vk.permutation_commitments[i], aggregation_challenge))
    aggregation_challenge = aggregation_challenge * v % R  # for grand product opening at z*omega
    aggregation_challenge = aggregation_challenge * v % R  # for d-wire opening at z*omega
    commitment_aggregation = g1_add(
        commitment_aggregation,
        g1_mul(proof.wire_commitments[STATE_WIDTH - 1], aggregation_challenge * u % R),
    )

    # aggregate claimed opening values with the same powers of v
    aggregation_challenge = v
    aggregated_value = proof.quotient_polynomial_at_z
    aggregated_value = (aggregated_value + proof.linearization_polynomial_at_z * aggregation_challenge) % R
    for w in proof.wire_values_at_z:
        aggregation_challenge = aggregation_challenge * v % R
        aggregated_value = (aggregated_value + w * aggregation_challenge) % R
    for s in proof.permutation_polynomials_at_z:
        aggregation_challenge = aggregation_challenge * v % R
        aggregated_value = (aggregated_value + s * aggregation_challenge) % R
    aggregation_challenge = aggregation_challenge * v % R
    aggregated_value = (aggregated_value + proof.grand_product_at_z_omega * aggregation_challenge % R * u) % R
    aggregation_challenge = aggregation_challenge * v % R
    aggregated_value = (aggregated_value + proof.wire_values_at_z_omega[0] * aggregation_challenge % R * u) % R

    commitment_aggregation = g1_add(commitment_aggregation, g1_neg(g1_mul(G1_GEN, aggregated_value)))

    pair_with_generator = g1_add(commitment_aggregation, g1_mul(proof.opening_at_z_proof, z))
    pair_with_generator = g1_add(
        pair_with_generator,
        g1_mul(proof.opening_at_z_omega_proof, z * omega % R * u % R),
    )
    pair_with_x = g1_add(g1_mul(proof.opening_at_z_omega_proof, u), proof.opening_at_z_proof)
    pair_with_x = g1_neg(pair_with_x)

    return pair_with_generator, pair_with_x
