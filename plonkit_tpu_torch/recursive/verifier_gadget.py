"""In-circuit verification of a base-system PLONK proof (rescue
transcript): the core of the aggregation circuit.

Mirrors plonk/verifier.py::prepare_pairing_pair TERM FOR TERM (which itself
mirrors contrib/template.sol:309-786), but instead of performing the EC
work eagerly it returns (point, scalar) tasks: the Fr-side (challenge
derivation, gate identity at zeta, all multi-exp scalars) happens natively
in-circuit, and the EC side is batched into one shared-doubling Straus MSM
by the aggregation circuit.  Reference counterpart:
recursive_aggregation_circuit's RecursiveAggregationCircuitBn256
(plonkit's src/recursive/mod.rs:90-108, SURVEY D3).

Transcript binding: points are absorbed as two 136-bit double limbs per
coordinate, built by linear gates FROM THE SAME LIMB WIRES the EC gadget
uses -- so the challenges are bound to exactly the points entering the MSM.
"""

from typing import List, Tuple

from ..fields import FR_MODULUS as R, get_domain_omega
from ..serialization import Proof, VerificationKey
from .cs import CsBuilder, Num
from .ec_gadget import PointG, point_alloc
from .nonnative import LIMB_BITS
from .rescue_gadget import RescueTranscriptGadget

STATE_WIDTH = 4
POW68 = pow(2, LIMB_BITS, R)


class VkWitness:
    """Witnessed inner verification key: up to 11 curve-checked points plus
    the baked (constant) scalars n / num_inputs / non-residues.

    Identity commitments (all-zero selector columns of tiny circuits) are
    representable: the vk is baked per-circuit (pinned by the Merkle root),
    so an identity point simply never becomes an MSM task -- scalar * O = O
    exactly.  Identity PROOF commitments remain unsupported (affine
    gadgets), the same restriction the reference's in-circuit verifier
    carries."""

    def __init__(self, cs: CsBuilder, vk: VerificationKey):
        self.vk = vk

        def opt(p):
            return None if p is None else point_alloc(cs, p)

        self.selector_commitments = [opt(p) for p in vk.selector_commitments]
        self.next_step_selector_commitments = [
            opt(p) for p in vk.next_step_selector_commitments]
        self.permutation_commitments = [
            opt(p) for p in vk.permutation_commitments]

    def all_points(self):
        return (self.selector_commitments + self.next_step_selector_commitments
                + self.permutation_commitments)

    def leaf_encoding(self, cs: CsBuilder) -> List[Num]:
        """In-circuit mirror of vk_tree.vk_leaf_encoding: [n, num_inputs] +
        double limbs of every commitment coordinate + non-residues.  The
        double limbs are linear combinations of the SAME limb wires the EC
        gadgets consume, binding the Merkle authentication to the math.
        Identity points encode as [0, 0, 0, 0] like the host."""
        out = [cs.constant(self.vk.n), cs.constant(self.vk.num_inputs)]
        for p in self.all_points():
            if p is None:
                out.extend([cs.zero] * 4)
                continue
            for coord in (p.x, p.y):
                out.append(cs.lc([(coord.limbs[0], 1), (coord.limbs[1], POW68)]))
                out.append(cs.lc([(coord.limbs[2], 1), (coord.limbs[3], POW68)]))
        out += [cs.constant(k) for k in self.vk.non_residues]
        return out


class ProofWitness:
    """Witnessed inner proof: 11 curve-checked points + 11 evaluations +
    the inner public inputs."""

    def __init__(self, cs: CsBuilder, proof: Proof):
        self.proof = proof
        for p in (list(proof.wire_commitments) + [proof.grand_product_commitment]
                  + list(proof.quotient_poly_commitments)
                  + [proof.opening_at_z_proof, proof.opening_at_z_omega_proof]):
            if p is None:
                raise ValueError(
                    "proof contains an identity commitment; such proofs are "
                    "not aggregatable in-circuit (affine point gadgets) -- "
                    "use a non-degenerate inner circuit")
        self.input_values = [cs.alloc(x) for x in proof.input_values]
        self.wire_commitments = [point_alloc(cs, p) for p in proof.wire_commitments]
        self.grand_product_commitment = point_alloc(cs, proof.grand_product_commitment)
        self.quotient_poly_commitments = [
            point_alloc(cs, p) for p in proof.quotient_poly_commitments]
        self.opening_at_z_proof = point_alloc(cs, proof.opening_at_z_proof)
        self.opening_at_z_omega_proof = point_alloc(cs, proof.opening_at_z_omega_proof)
        self.wire_values_at_z = [cs.alloc(x) for x in proof.wire_values_at_z]
        self.wire_values_at_z_omega = [cs.alloc(x) for x in proof.wire_values_at_z_omega]
        self.grand_product_at_z_omega = cs.alloc(proof.grand_product_at_z_omega)
        self.quotient_polynomial_at_z = cs.alloc(proof.quotient_polynomial_at_z)
        self.linearization_polynomial_at_z = cs.alloc(proof.linearization_polynomial_at_z)
        self.permutation_polynomials_at_z = [
            cs.alloc(x) for x in proof.permutation_polynomials_at_z]


def _absorb_point(cs: CsBuilder, t: RescueTranscriptGadget, p: PointG):
    """Mirror of RescueTranscript.update_g1: double limbs, x then y."""
    for coord in (p.x, p.y):
        t.update_fr(cs.lc([(coord.limbs[0], 1), (coord.limbs[1], POW68)]))
        t.update_fr(cs.lc([(coord.limbs[2], 1), (coord.limbs[3], POW68)]))


def _neg(cs: CsBuilder, x: Num) -> Num:
    return cs.lc([(x, R - 1)])


def verify_proof_gadget(cs: CsBuilder, vkw: VkWitness, pw: ProofWitness):
    """Returns (pg_tasks, px_tasks, rho): (point, scalar-Num) lists such
    that the proof is valid iff e(sum pg, G2) * e(sum px_negated, [x]_2)=1;
    rho is the per-proof aggregation challenge (one extra squeeze of the
    same verifier transcript, binding it to the full proof)."""
    vk = vkw.vk
    domain_size = vk.domain_size
    assert domain_size & (domain_size - 1) == 0
    log_size = domain_size.bit_length() - 1
    omega = get_domain_omega(domain_size)

    # ---- Fiat-Shamir (rescue), template.sol:691-755 order ----------------
    t = RescueTranscriptGadget(cs)
    for x in pw.input_values:
        t.update_fr(x)
    for p in pw.wire_commitments:
        _absorb_point(cs, t, p)
    beta = t.get_challenge()
    gamma = t.get_challenge()
    _absorb_point(cs, t, pw.grand_product_commitment)
    alpha = t.get_challenge()
    for p in pw.quotient_poly_commitments:
        _absorb_point(cs, t, p)
    z = t.get_challenge()
    for e in (pw.wire_values_at_z + pw.wire_values_at_z_omega
              + pw.permutation_polynomials_at_z
              + [pw.quotient_polynomial_at_z,
                 pw.linearization_polynomial_at_z,
                 pw.grand_product_at_z_omega]):
        t.update_fr(e)
    v = t.get_challenge()
    _absorb_point(cs, t, pw.opening_at_z_proof)
    _absorb_point(cs, t, pw.opening_at_z_omega_proof)
    u = t.get_challenge()
    rho = t.get_challenge()        # aggregation challenge (this framework's
    #                                RLC binding; see recursive/aggregation.py)

    # ---- zeta^n, vanishing, Lagrange values ------------------------------
    z_pow = z
    for _ in range(log_size):
        z_pow = cs.mul(z_pow, z_pow)
    z_in_domain_size = z_pow                       # zeta^(n+1)
    vanishing = cs.lc([(z_in_domain_size, 1)], constant=R - 1)

    lagrange_at_z = []
    for i in range(vk.num_inputs):
        w_i = pow(omega, i, R)
        num = cs.lc([(vanishing, w_i)])
        den = cs.lc([(z, domain_size)], constant=(-domain_size * w_i) % R)
        lagrange_at_z.append(cs.div(num, den))     # proves den != 0

    # ---- gate identity at z (template.sol:445-494) -----------------------
    lhs = cs.mul(vanishing, pw.quotient_polynomial_at_z)

    pi_terms = [(pw.linearization_polynomial_at_z, 1)]
    for li, x in zip(lagrange_at_z, pw.input_values):
        pi_terms.append((cs.mul(li, x), 1))

    # z_part = z(z*omega) * prod_j (sigma_j(z) beta + gamma + a_j(z))
    #          * (gamma + d(z)) * alpha
    z_part = pw.grand_product_at_z_omega
    for s, a in zip(pw.permutation_polynomials_at_z, pw.wire_values_at_z):
        # (s*beta + gamma + a): beta is a wire, so one mul + one lc
        sb = cs.mul(s, beta)
        f = cs.lc([(sb, 1), (gamma, 1), (a, 1)])
        z_part = cs.mul(z_part, f)
    gd = cs.lc([(gamma, 1), (pw.wire_values_at_z[STATE_WIDTH - 1], 1)])
    z_part = cs.mul(z_part, gd)
    z_part = cs.mul(z_part, alpha)

    # L0(z) * alpha^2
    w0 = 1
    l0_num = cs.lc([(vanishing, w0)])
    l0_den = cs.lc([(z, domain_size)], constant=(-domain_size * w0) % R)
    l0_at_z = cs.div(l0_num, l0_den)
    alpha2 = cs.mul(alpha, alpha)
    l0_term = cs.mul(l0_at_z, alpha2)

    # lhs == linearization + sum L_i x_i - z_part - L0*alpha^2
    cs.enforce_lc([(lhs, R - 1)] + pi_terms + [(z_part, R - 1), (l0_term, R - 1)])

    # ---- scalars for the commitment aggregation --------------------------
    # powers of v
    v_pows = [None] * 11
    v_pows[1] = v
    for i in range(2, 11):
        v_pows[i] = cs.mul(v_pows[i - 1], v)

    a_z = pw.wire_values_at_z
    d_zw = pw.wire_values_at_z_omega[0]

    pg: List[Tuple[PointG, Num]] = []

    # quotient chunks: 1, zeta^N, zeta^2N, zeta^3N
    zN = z_in_domain_size
    zpow = None
    for i, tp in enumerate(pw.quotient_poly_commitments):
        if i == 0:
            pg.append((tp, cs.one))
        else:
            zpow = zN if i == 1 else cs.mul(zpow, zN)
            pg.append((tp, zpow))

    # D * v: selector commitments
    for i in range(STATE_WIDTH):
        pg.append((vkw.selector_commitments[i], cs.mul(v, a_z[i])))
    ab = cs.mul(a_z[0], a_z[1])
    pg.append((vkw.selector_commitments[STATE_WIDTH], cs.mul(v, ab)))      # q_m
    pg.append((vkw.selector_commitments[STATE_WIDTH + 1], v))              # q_const
    pg.append((vkw.next_step_selector_commitments[0], cs.mul(v, d_zw)))    # q_dnext

    # grand product commitment: v*(gp_part) + v^9*u
    gp = cs.lc([(cs.mul(z, beta), 1), (a_z[0], 1), (gamma, 1)])
    for i, k in enumerate(vk.non_residues):
        zkb = cs.mul(z, cs.lc([(beta, k)]))
        f = cs.lc([(zkb, 1), (gamma, 1), (a_z[i + 1], 1)])
        gp = cs.mul(gp, f)
    gp = cs.mul(gp, alpha)
    gp = cs.lc([(gp, 1), (cs.mul(l0_at_z, alpha2), 1)])
    v9u = cs.mul(v_pows[9], u)
    z_scalar = cs.lc([(cs.mul(v, gp), 1), (v9u, 1)])
    pg.append((pw.grand_product_commitment, z_scalar))

    # last permutation commitment: -v * beta * z(z*omega) * alpha * prod(...)
    lp = None
    for s, a in zip(pw.permutation_polynomials_at_z, a_z):
        sb = cs.mul(beta, s)
        f = cs.lc([(sb, 1), (gamma, 1), (a, 1)])
        lp = f if lp is None else cs.mul(lp, f)
    lp = cs.mul(lp, beta)
    lp = cs.mul(lp, pw.grand_product_at_z_omega)
    lp = cs.mul(lp, alpha)
    pg.append((vkw.permutation_commitments[STATE_WIDTH - 1],
               _neg(cs, cs.mul(v, lp))))

    # wire commitments: v^{2+i}; d-wire gets + v^10*u
    for i in range(STATE_WIDTH - 1):
        pg.append((pw.wire_commitments[i], v_pows[2 + i]))
    d_scalar = cs.lc([(v_pows[5], 1), (cs.mul(v_pows[10], u), 1)])
    pg.append((pw.wire_commitments[STATE_WIDTH - 1], d_scalar))

    # sigma commitments 0..2: v^{6+i}
    for i in range(STATE_WIDTH - 1):
        pg.append((vkw.permutation_commitments[i], v_pows[6 + i]))

    # -G * aggregated_value
    agg_terms = [(pw.quotient_polynomial_at_z, 1),
                 (cs.mul(pw.linearization_polynomial_at_z, v), 1)]
    for i in range(STATE_WIDTH):
        agg_terms.append((cs.mul(a_z[i], v_pows[2 + i]), 1))
    for i in range(STATE_WIDTH - 1):
        agg_terms.append((cs.mul(pw.permutation_polynomials_at_z[i], v_pows[6 + i]), 1))
    agg_terms.append((cs.mul(cs.mul(pw.grand_product_at_z_omega, v_pows[9]), u), 1))
    agg_terms.append((cs.mul(cs.mul(d_zw, v_pows[10]), u), 1))
    agg_value = cs.lc(agg_terms)
    gen_scalar = _neg(cs, agg_value)

    # opening proofs: W_z * zeta ; W_zw * (zeta*omega*u)
    pg.append((pw.opening_at_z_proof, z))
    zwu = cs.mul(cs.lc([(z, omega)]), u)
    pg.append((pw.opening_at_z_omega_proof, zwu))

    # PX (before negation): W_z * 1 + W_zw * u
    px = [(pw.opening_at_z_proof, cs.one),
          (pw.opening_at_z_omega_proof, u)]

    # identity vk commitments contribute scalar * O = O: drop their tasks
    pg = [(pt, sc) for pt, sc in pg if pt is not None]
    return pg, px, gen_scalar, rho
