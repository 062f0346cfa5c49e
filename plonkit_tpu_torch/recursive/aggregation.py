"""Recursive proof aggregation: N base-system PLONK proofs (rescue
transcript) are re-verified inside one extended-system circuit whose single
public input commits to (vk-tree root, every inner public input, the
aggregated pairing pair in RNS limbs).

Host/orchestration mirror of the reference's src/recursive/mod.rs:
  prove            -> prove_aggregation         (mod.rs:38-136)
  verify           -> verify_aggregation        (mod.rs:175-193)
  export_vk        -> make_recursive_vk         (mod.rs:196-204)
  get_aggregated_input -> expected_aggregated_input (mod.rs:207-233)
  verify_subproof_limbs -> the native pairing over limb-reconstructed
                       points inside verify_aggregation (mod.rs:138-172)

Statement proven by the circuit (for each proof i):
  * rescue Fiat-Shamir challenges are derived from the witnessed proof,
  * the gate identity holds at zeta,
  * the pairing pair (PG_i, PX_i) is the verifier's commitment aggregation
    (one shared-doubling Straus MSM across all proofs),
  * the inner vk is Merkle-authenticated against the published root,
  * PG = sum rho_i PG_i, PX = sum rho_i PX_i match the published limbs,
    where rho_i is an extra challenge squeezed from proof i's own verifier
    transcript (random-oracle-bound to the full proof, so a batch
    containing any invalid pair passes the final pairing only with
    negligible probability).
The final check e(PG, G2) * e(PX, [x]_2) == 1 runs NATIVELY in
verify_aggregation -- exactly the reference's deferred-pairing design."""

import logging
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..curve import g1_add, g1_is_on_curve, g1_mul
from ..fields import FR_MODULUS as R
from ..plonk.extended import (VerificationKey2, make_verification_key2,
                              prove2, validate_witness2_fast, verify2)
from ..plonk.verifier import prepare_pairing_pair
from ..serialization import (Crs, Proof, VerificationKey, read_fr, read_u64,
                             write_fr, write_u64)
from ..profiling import stage
from ..transcript import make_transcript
from .cs import CsBuilder
from .ec_gadget import ec_multi_msm, ec_neg, point_constant
from .nonnative import fq_enforce_equal, fq_from_limbs
from .rescue import rescue_hash
from .rescue_gadget import merkle_verify_gadget, rescue_hash_gadget
from .rns import fq_to_limbs, limbs_to_fq
from .vk_tree import VK_TREE_DEPTH, build_vk_tree, vk_leaf_hash
from .verifier_gadget import ProofWitness, VkWitness, verify_proof_gadget

log = logging.getLogger("plonkit_tpu_torch")

MAX_PROOFS = 255


# --------------------------------------------------------------------------
# host-side mirrors
# --------------------------------------------------------------------------

def derive_rho(vk: VerificationKey, proof: Proof) -> int:
    """The per-proof aggregation challenge: replay the rescue verifier
    transcript and squeeze one extra challenge (mirrors
    verifier_gadget.verify_proof_gadget)."""
    t = make_transcript("rescue")
    for x in proof.input_values:
        t.update_u256(x)
    for p in proof.wire_commitments:
        t.update_g1(p)
    t.get_challenge()            # beta
    t.get_challenge()            # gamma
    t.update_g1(proof.grand_product_commitment)
    t.get_challenge()            # alpha
    for p in proof.quotient_poly_commitments:
        t.update_g1(p)
    t.get_challenge()            # z
    for e in (list(proof.wire_values_at_z) + list(proof.wire_values_at_z_omega)
              + list(proof.permutation_polynomials_at_z)
              + [proof.quotient_polynomial_at_z,
                 proof.linearization_polynomial_at_z,
                 proof.grand_product_at_z_omega]):
        t.update_fr(e)
    t.get_challenge()            # v
    t.update_g1(proof.opening_at_z_proof)
    t.update_g1(proof.opening_at_z_omega_proof)
    t.get_challenge()            # u
    return t.get_challenge()     # rho


def compute_aggregate(vk: VerificationKey, proofs: List[Proof]):
    """(PG, PX, limbs) or None if any proof fails its gate identity."""
    if not 0 < len(proofs) <= MAX_PROOFS:
        raise ValueError("proof count out of range")
    pg_total = None
    px_total = None
    for proof in proofs:
        pair = prepare_pairing_pair(vk, proof, "rescue")
        if pair is None:
            return None
        rho = derive_rho(vk, proof)
        pg_total = g1_add(pg_total, g1_mul(pair[0], rho))
        px_total = g1_add(px_total, g1_mul(pair[1], rho))
    limbs = []
    for pt in (pg_total, px_total):
        x, y = (0, 0) if pt is None else pt
        limbs.extend(fq_to_limbs(x))
        limbs.extend(fq_to_limbs(y))
    return pg_total, px_total, limbs


def expected_aggregated_input(vk: VerificationKey, proofs: List[Proof]):
    """The single public input the aggregation circuit must expose
    (reference: get_aggregated_input, mod.rs:207-233).  Returns
    (hash, limbs) or None for an invalid batch."""
    agg = compute_aggregate(vk, proofs)
    if agg is None:
        return None
    _, _, limbs = agg
    root = build_vk_tree([vk])[-1][0]
    preimage = [root]
    for proof in proofs:
        preimage.extend(proof.input_values)
    preimage.extend(limbs)
    return rescue_hash(preimage), limbs


# --------------------------------------------------------------------------
# the aggregation circuit
# --------------------------------------------------------------------------

def build_aggregation_circuit(vk: VerificationKey,
                              proofs: List[Proof]) -> Tuple[CsBuilder, List[int]]:
    """Synthesize the full aggregation circuit (gates + witness).  Returns
    (cs, aggregate limbs).  The witness is satisfiable iff every inner
    proof verifies; the gate STRUCTURE depends only on
    (len(proofs), per-proof num_inputs, vk.n/num_inputs/non_residues) --
    which is what lets make_recursive_vk synthesize with garbage
    witnesses."""
    if not 0 < len(proofs) <= MAX_PROOFS:
        raise ValueError("proof count out of range")
    cs = CsBuilder()

    # public input: allocate first; its value is fixed at the end
    pub = cs.alloc_input(0)

    # vk witness + Merkle authentication against the replicated-vk tree
    vkw = VkWitness(cs, vk)
    levels = build_vk_tree([vk])
    root_val = levels[-1][0]
    root = cs.alloc(root_val)
    leaf = rescue_hash_gadget(cs, vkw.leaf_encoding(cs))
    assert leaf.value == vk_leaf_hash(vk)
    index_bits = [cs.zero] * VK_TREE_DEPTH        # single vk at index 0
    path = []
    idx = 0
    for lvl in range(VK_TREE_DEPTH):
        path.append(cs.alloc(levels[lvl][idx ^ 1]))
        idx >>= 1
    merkle_verify_gadget(cs, leaf, index_bits, path, root)

    # per-proof verification gadgets
    pg_tasks = {}
    px_tasks = []
    task_points = {}
    gen_total = None
    all_input_nums = []
    for proof in proofs:
        pw = ProofWitness(cs, proof)
        all_input_nums.extend(pw.input_values)
        pg, px, gen_scalar, rho = verify_proof_gadget(cs, vkw, pw)
        for pt, sc in pg:
            s = cs.mul(sc, rho)
            key = id(pt)
            task_points[key] = pt
            if key in pg_tasks:
                pg_tasks[key] = cs.add(pg_tasks[key], s)
            else:
                pg_tasks[key] = s
        gs = cs.mul(gen_scalar, rho)
        gen_total = gs if gen_total is None else cs.add(gen_total, gs)
        for pt, sc in px:
            px_tasks.append((pt, cs.mul(sc, rho)))

    from ..curve import G1_GEN
    gen_pt = point_constant(cs, G1_GEN)
    pg_list = [(task_points[k], s) for k, s in pg_tasks.items()]
    pg_list.append((gen_pt, gen_total))

    pg_point, px_point_prenegate = ec_multi_msm(cs, [pg_list, px_tasks])
    px_point = ec_neg(cs, px_point_prenegate)

    # bind the aggregate to its published limbs
    limbs = []
    limb_nums = []
    for coord_gadget, host_val in ((pg_point.x, pg_point.point[0]),
                                   (pg_point.y, pg_point.point[1]),
                                   (px_point.x, px_point.point[0]),
                                   (px_point.y, px_point.point[1])):
        ls = fq_to_limbs(host_val)
        limbs.extend(ls)
        nums = [cs.alloc(v) for v in ls]
        limb_nums.extend(nums)
        fq_enforce_equal(cs, coord_gadget, fq_from_limbs(cs, nums))

    # the single public input: rescue(root, inner inputs..., limbs...)
    digest = rescue_hash_gadget(cs, [root] + all_input_nums + limb_nums)
    cs.enforce_equal(digest, pub)
    cs.values[pub.idx] = digest.value
    pub.value = digest.value

    return cs, limbs


# --------------------------------------------------------------------------
# aggregated proof container
# --------------------------------------------------------------------------

@dataclass
class AggregatedProof:
    """Outer proof + the data a verifier needs to reconstruct/validate the
    public input (mirrors the reference's AggregatedProof)."""
    proof: Proof                      # extended-system proof, 1 public input
    vk_root: int
    aggr_limbs: List[int]             # 16 x 68-bit limbs: PG.x PG.y PX.x PX.y
    individual_num_inputs: int
    individual_inputs: List[int]      # concatenated inner public inputs

    def write(self, w):
        write_u64(w, len(self.aggr_limbs))
        for v in self.aggr_limbs:
            write_fr(w, v)
        write_fr(w, self.vk_root)
        write_u64(w, self.individual_num_inputs)
        write_u64(w, len(self.individual_inputs))
        for v in self.individual_inputs:
            write_fr(w, v)
        self.proof.write(w)

    @classmethod
    def read(cls, r):
        n_limbs = read_u64(r)
        limbs = [read_fr(r) for _ in range(n_limbs)]
        vk_root = read_fr(r)
        per = read_u64(r)
        n_inputs = read_u64(r)
        inputs = [read_fr(r) for _ in range(n_inputs)]
        proof = Proof.read(r)
        return cls(proof, vk_root, limbs, per, inputs)

    def save(self, filename: str):
        with open(filename, "wb") as f:
            self.write(f)

    @classmethod
    def load(cls, filename: str):
        with open(filename, "rb") as f:
            return cls.read(f)

    def solidity_json(self) -> dict:
        """recursive-prove's recursive_proof.json: the arguments of the
        recursive verifier contract, as decimal strings."""
        inputs, serialized = self.proof.serialize_for_solidity()
        return {"proof": [str(w) for w in serialized],
                "inputs": [str(x) for x in inputs],
                "vk_root": str(self.vk_root),
                "aggr_limbs": [str(v) for v in self.aggr_limbs],
                "individual_inputs": [str(v) for v in self.individual_inputs]}


# --------------------------------------------------------------------------
# top-level operations
# --------------------------------------------------------------------------

def prove_aggregation(big_crs: Crs, proofs: List[Proof], vk: VerificationKey,
                      backend=None, validate: bool = True) -> AggregatedProof:
    num_inputs = len(proofs[0].input_values)
    if any(len(p.input_values) != num_inputs for p in proofs):
        raise ValueError("proofs must have equal input counts")
    with stage("aggregation: synthesis"):
        cs, limbs = build_aggregation_circuit(vk, proofs)
    log.info("aggregation circuit: %d gates, %d variables",
             cs.num_gates, len(cs.values))
    with stage("aggregation: setup polys"):
        setup = cs.setup(backend=backend)
        cols = cs.wire_columns()
        pub = cs.public_inputs()
    if validate:
        with stage("aggregation: validate"):
            validate_witness2_fast(setup, cols, pub, backend=backend)
    with stage("aggregation: prove2"):
        proof = prove2(setup, cols, pub, crs=big_crs, backend=backend,
                       skip_validation=True)
    root = build_vk_tree([vk])[-1][0]
    individual = [x for p in proofs for x in p.input_values]
    return AggregatedProof(proof, root, limbs, num_inputs, individual)


def dummy_proof(vk: VerificationKey, seed: int = 1) -> Proof:
    """A structurally-valid (but cryptographically meaningless) proof used
    to synthesize the aggregation circuit for vk export: the gate STRUCTURE
    is witness-independent, mirroring the reference's
    create_recursive_circuit_vk_and_setup which needs only
    (num proofs, num inputs) (src/bin/main.rs:507-519)."""
    import random
    from ..curve import G1_GEN
    rng = random.Random(seed)

    def pt():
        return g1_mul(G1_GEN, rng.randrange(1, R))

    def fr():
        return rng.randrange(1, R)

    return Proof(
        n=vk.n, num_inputs=vk.num_inputs,
        input_values=[fr() for _ in range(vk.num_inputs)],
        wire_commitments=[pt() for _ in range(4)],
        grand_product_commitment=pt(),
        quotient_poly_commitments=[pt() for _ in range(4)],
        wire_values_at_z=[fr() for _ in range(4)],
        wire_values_at_z_omega=[fr()],
        grand_product_at_z_omega=fr(),
        quotient_polynomial_at_z=fr(),
        linearization_polynomial_at_z=fr(),
        permutation_polynomials_at_z=[fr() for _ in range(3)],
        opening_at_z_proof=pt(),
        opening_at_z_omega_proof=pt(),
    )


def make_recursive_vk(big_crs: Crs, vk: VerificationKey, num_proofs: int,
                      backend=None) -> VerificationKey2:
    """Recursive vk export (reference: export_recursive_vk,
    mod.rs:196-204).  Synthesizes the circuit with dummy witnesses --
    only the gate structure matters for the setup polynomials."""
    proofs = [dummy_proof(vk, seed=i + 1) for i in range(num_proofs)]
    with stage("rvk: synthesis"):
        cs, _ = build_aggregation_circuit(vk, proofs)
    with stage("rvk: setup polys"):
        setup = cs.setup(backend=backend)
    with stage("rvk: commitments"):
        return make_verification_key2(setup, big_crs, backend=backend)


def verify_aggregation(rec_vk: VerificationKey2, agg: AggregatedProof,
                       inner_vk: Optional[VerificationKey] = None) -> bool:
    """Outer-proof verification + native pairing over the limb-reconstructed
    aggregate (reference: verify + verify_subproof_limbs,
    mod.rs:138-193)."""
    from ..native import bn254_pairing_check as pairing_check
    if len(agg.proof.input_values) != 1:
        return False
    if not verify2(rec_vk, agg.proof, transcript="keccak"):
        return False
    # reconstruct the pair from limbs and pairing-check it
    if len(agg.aggr_limbs) != 16:
        return False
    coords = [limbs_to_fq(agg.aggr_limbs[4 * i: 4 * (i + 1)]) for i in range(4)]
    pg = (coords[0], coords[1])
    px = (coords[2], coords[3])
    if not (g1_is_on_curve(pg) and g1_is_on_curve(px)):
        return False
    g2_base = rec_vk.g2_elements[0]
    g2_x = rec_vk.g2_elements[1]
    if not pairing_check([(pg, g2_base), (px, g2_x)]):
        return False
    # the public input must commit to (root, inputs, limbs)
    preimage = [agg.vk_root] + list(agg.individual_inputs) + list(agg.aggr_limbs)
    if rescue_hash(preimage) != agg.proof.input_values[0]:
        return False
    if inner_vk is not None and build_vk_tree([inner_vk])[-1][0] != agg.vk_root:
        return False
    return True


def check_aggregation(vk: VerificationKey, proofs: List[Proof],
                      agg: AggregatedProof) -> bool:
    """Recompute the expected aggregated input from the original proofs and
    compare (reference: check_aggregation, src/bin/main.rs:555-568)."""
    expected = expected_aggregated_input(vk, proofs)
    if expected is None:
        return False
    h, limbs = expected
    return h == agg.proof.input_values[0] and limbs == agg.aggr_limbs
