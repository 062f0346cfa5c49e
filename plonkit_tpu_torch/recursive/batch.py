"""Batched verification / off-circuit proof aggregation.

For proofs P_1..P_N (1 <= N <= 255, matching src/recursive/mod.rs:44-45),
each proof reduces to a KZG pairing pair (PG_i, PX_i) with validity
  e(PG_i, [1]_2) * e(PX_i, [x]_2) == 1.
A random linear combination with Fiat-Shamir coefficients r_i collapses all
N checks into one:
  e(sum r_i PG_i, [1]_2) * e(sum r_i PX_i, [x]_2) == 1.

This is the same aggregated pair the reference's recursive pipeline commits
to as limbed public inputs (make_public_input_and_limbed_aggregate,
src/recursive/mod.rs:88, reconstructed + pairing-checked at
src/recursive/mod.rs:138-172); here it is produced and checked off-circuit.
The in-circuit re-verification (the SNARK of these checks) is the round-2
milestone.
"""

from typing import List

from ..curve import G2_GEN, g1_add, g1_mul
from ..native import bn254_pairing_check as pairing_check
from ..plonk.verifier import prepare_pairing_pair
from ..serialization import Proof, VerificationKey
from ..transcript import Transcript
from .rns import fq_to_limbs

MAX_PROOFS = 255


def _aggregation_challenges(vks: List[VerificationKey], proofs: List[Proof]) -> List[int]:
    """Fiat-Shamir coefficients binding every proof and its inputs."""
    t = Transcript()
    for vk, proof in zip(vks, proofs):
        t.update_u256(vk.n)
        t.update_u256(vk.num_inputs)
        for x in proof.input_values:
            t.update_fr(x)
        for p in proof.wire_commitments:
            t.update_g1(p)
        t.update_g1(proof.opening_at_z_proof)
        t.update_g1(proof.opening_at_z_omega_proof)
    return [t.get_challenge() for _ in proofs]


def aggregate_proofs(vk, proofs: List[Proof]):
    """Aggregate N proofs under one vk (the reference replicates a single vk
    through its vk tree, src/recursive/mod.rs:66).  Returns
    (pair_with_generator, pair_with_x, limbed_public_input) or None if any
    proof fails its gate identity."""
    if not 0 < len(proofs) <= MAX_PROOFS:
        raise ValueError("proof count out of range")
    vks = [vk] * len(proofs)
    pairs = []
    for v, p in zip(vks, proofs):
        pair = prepare_pairing_pair(v, p)
        if pair is None:
            return None
        pairs.append(pair)
    rs = _aggregation_challenges(vks, proofs)
    agg_pg = None
    agg_px = None
    for r, (pg, px) in zip(rs, pairs):
        agg_pg = g1_add(agg_pg, g1_mul(pg, r))
        agg_px = g1_add(agg_px, g1_mul(px, r))
    limbs = limbed_aggregate(agg_pg, agg_px)
    return agg_pg, agg_px, limbs


def limbed_aggregate(pg, px) -> List[int]:
    """Expose the aggregated pair coordinates as Fr limb values (the RNS
    encoding recursive verifiers publish as public inputs; cf.
    src/utils.rs / src/recursive/mod.rs:147-159)."""
    out: List[int] = []
    for pt in (pg, px):
        x, y = (0, 0) if pt is None else pt
        out.extend(fq_to_limbs(x))
        out.extend(fq_to_limbs(y))
    return out


def verify_aggregate(vk, pg, px) -> bool:
    g2_base = vk.g2_elements[0] if vk.g2_elements else G2_GEN
    g2_x = vk.g2_elements[1]
    return pairing_check([(pg, g2_base), (px, g2_x)])


def verify_batch(vk, proofs: List[Proof]) -> bool:
    """One pairing check for N proofs."""
    agg = aggregate_proofs(vk, proofs)
    if agg is None:
        return False
    pg, px, _ = agg
    return verify_aggregate(vk, pg, px)
