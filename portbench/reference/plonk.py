"""The plain reference of a keccak proof of plonkit's width-4 PLONK (four
wires and the D-next selector): the circuit's gates from its R1CS, the
verification key worked out again with the key's secret tau, and a
verifier that needs no pairing.  It imports nothing of the program.

- transpile(): R1CS -> gates by the rules of bellman_ce's Transpiler as
  plonkit uses it: one input gate per public input first (q_a = -1), then
  per constraint A * B = C addition gates for constant sides or for
  linear combinations of more than one term (chained through d and
  q_d_next = -1 past four terms), and one multiplication gate.
- The permutation: each variable's cells in gate order (wires a..d within
  a gate), each cell labelled with its successor's K_c w^row, the dummy
  variable and cells of one occurrence labelled with their own.
- With tau known, the commitment of a polynomial f is [f(tau)] G, and f(tau)
  = sum_i f_i L_i(tau) from its values f_i on the domain: no MSM.
- The pairing check e(A, G2) e(B, [tau] G2) = 1 is A + [tau] B = O.
"""

from . import bn254
from .bn254 import R
from .keccak import Transcript

K_COLS = (1, 5, 7, 10)       # the permutation's coset of each wire column
DUMMY = -1
SELECTORS = ("q_a", "q_b", "q_c", "q_d", "q_m", "q_const", "q_d_next")


def _normalize(lc):
    """(terms, constant) of a linear combination [(wire, coeff)]: wire 0 is
    the constant one; repeated wires merged in first-occurrence order;
    zero terms dropped."""
    constant = 0
    coeffs = {}
    for w, c in lc:
        if w == 0:
            constant += c
        elif w in coeffs:
            coeffs[w] += c
        else:
            coeffs[w] = c
    return [(w, c % R) for w, c in coeffs.items() if c % R], constant % R


class Gates:
    """The gate rows: wires[j] and selectors[k] are lists over the rows."""

    def __init__(self, next_var: int):
        self.wires = ([], [], [], [])
        self.selectors = tuple([] for _ in SELECTORS)
        self.next_var = next_var

    def __len__(self):
        return len(self.wires[0])

    def gate(self, wires, q_a=0, q_b=0, q_c=0, q_d=0, q_m=0, q_const=0, q_d_next=0):
        for col, w in zip(self.wires, wires):
            col.append(w)
        for col, q in zip(self.selectors, (q_a, q_b, q_c, q_d, q_m, q_const, q_d_next)):
            col.append(q)

    def alloc(self) -> int:
        self.next_var += 1
        return self.next_var - 1

    def linear(self, work, constant) -> None:
        """sum(work) + constant = 0 in addition gates."""
        n = len(work)
        if n == 0:
            if constant:
                raise ValueError("an unsatisfiable constant constraint")
            return
        if n <= 4:
            pad = 4 - n
            self.gate([w for w, _ in work] + [DUMMY] * pad,
                      *([c for _, c in work] + [0] * pad), q_const=constant)
            return
        first, rest = work[:4], work[4:]
        acc = self.alloc()
        self.gate([w for w, _ in first], *[c for _, c in first], q_const=constant,
                  q_d_next=R - 1)
        while rest:
            chunk, rest = rest[:3], rest[3:]
            pad = 3 - len(chunk)
            wires = [w for w, _ in chunk] + [DUMMY] * pad + [acc]
            coeffs = [c for _, c in chunk] + [0] * pad
            if rest:
                acc = self.alloc()
            self.gate(wires, *coeffs, q_d=1, q_d_next=R - 1 if rest else 0)

    def collapse(self, terms, constant):
        """One (variable, coefficient) for a linear combination."""
        if len(terms) == 1 and constant == 0:
            return terms[0]
        out = self.alloc()
        self.linear(terms + [(out, R - 1)], constant)
        return out, 1

    def constraint(self, a, b, c) -> None:
        a, ka = _normalize(a)
        b, kb = _normalize(b)
        c, kc = _normalize(c)
        if not a and not b:
            if not c:
                if (kc - ka * kb) % R:
                    raise ValueError("an inconsistent constant constraint")
                return
            self.linear(c, (kc - ka * kb) % R)
            return
        if not a or not b:
            k, lin, klin = (ka, b, kb) if not a else (kb, a, ka)
            merged = {w: v * k % R for w, v in lin}
            for w, v in c:
                merged[w] = (merged.get(w, 0) - v) % R
            self.linear([(w, v) for w, v in merged.items() if v], (klin * k - kc) % R)
            return
        va, ca = self.collapse(a, ka)
        vb, cb = self.collapse(b, kb)
        if c:
            vc, cc = self.collapse(c, kc)
            self.gate([va, vb, vc, DUMMY], q_c=(R - cc) % R, q_m=ca * cb % R)
        else:
            self.gate([va, vb, DUMMY, DUMMY], q_m=ca * cb % R, q_const=(R - kc) % R)


def transpile(num_inputs: int, num_variables: int, constraints) -> Gates:
    """The gate rows of an R1CS (wire 0 the constant one, wires 1 ..
    num_inputs - 1 public), input gates first."""
    g = Gates(num_variables)
    for i in range(1, num_inputs):
        g.gate([i, DUMMY, DUMMY, DUMMY], q_a=R - 1)
    for a, b, c in constraints:
        if (a and b) or c:
            g.constraint(a, b, c)
    return g


def domain_size(rows: int) -> int:
    """The domain keeps n = size - 1 usable rows."""
    size = 1
    while size - 1 < rows:
        size <<= 1
    return size


def setup_at_tau(g: Gates, tau: int) -> dict:
    """The seven selectors and four permutation polynomials at tau, from
    their values on the domain."""
    rows = len(g)
    size = domain_size(rows)
    lag = bn254.lagrange_all(size, tau)
    w = bn254.omega(size)
    wpow = [1] * size
    for i in range(1, size):
        wpow[i] = wpow[i - 1] * w % R
    out = {}
    for name, col in zip(SELECTORS, g.selectors):
        acc = 0
        for q, l in zip(col, lag):
            if q:
                acc += q * l
        out[name] = acc % R
    cells = {}
    for r, row in enumerate(zip(*g.wires)):
        for c, v in enumerate(row):
            if v != DUMMY:
                cells.setdefault(v, []).append(c * size + r)
    # sigma_c(tau) = K_c tau + the change of every cell whose label moved
    sig = [K_COLS[c] * tau for c in range(4)]
    for lst in cells.values():
        if len(lst) < 2:
            continue
        for here, nxt in zip(lst, lst[1:] + lst[:1]):
            c, r = divmod(here, size)
            c2, r2 = divmod(nxt, size)
            sig[c] += (K_COLS[c2] * wpow[r2] - K_COLS[c] * wpow[r]) * lag[r]
    for c in range(4):
        out[f"sigma_{c}"] = sig[c] % R
    out["size"] = size
    return out


def verification_key(g: Gates, tau: int) -> dict:
    """The verification key's points [f(tau)] G and its domain size."""
    at = setup_at_tau(g, tau)
    vk = {k: bn254.mul(bn254.G1, v) for k, v in at.items() if k != "size"}
    vk["size"] = at["size"]
    return vk


def verify(vk: dict, tau: int, public_inputs: list, proof) -> bool:
    """True if `proof` (attributes as plonkit's Proof) verifies for the
    public inputs under the keccak transcript; the steps of plonkit's
    Solidity verifier, with the pairing replaced by tau."""
    mul, add, neg = bn254.mul, bn254.add, bn254.neg
    size = vk["size"]
    w = bn254.omega(size)
    t = Transcript()
    for x in public_inputs:
        t.update(x % R)
    for p in proof.wire_commitments:
        t.update_point(p)
    beta, gamma = t.challenge(), t.challenge()
    t.update_point(proof.grand_product_commitment)
    alpha = t.challenge()
    for p in proof.quotient_poly_commitments:
        t.update_point(p)
    z = t.challenge()
    a_z = list(proof.wire_values_at_z)
    s_z = list(proof.permutation_polynomials_at_z)
    d_zw = proof.wire_values_at_z_omega[0]
    z_zw = proof.grand_product_at_z_omega
    t_z = proof.quotient_polynomial_at_z
    r_z = proof.linearization_polynomial_at_z
    for e in a_z + [d_zw] + s_z + [t_z, r_z, z_zw]:
        t.update(e)
    v = t.challenge()
    t.update_point(proof.opening_at_z_proof)
    t.update_point(proof.opening_at_z_omega_proof)
    u = t.challenge()

    lag = bn254.lagrange_at(size, z, range(len(public_inputs)))
    # the gate identity at z
    van = (pow(z, size, R) - 1) % R
    rhs = r_z + sum(l * x for l, x in zip(lag, public_inputs))
    zp = z_zw
    for i in range(3):
        zp = zp * (s_z[i] * beta + gamma + a_z[i]) % R
    zp = zp * (gamma + a_z[3]) % R * alpha % R
    rhs = (rhs - zp - lag[0] * alpha * alpha) % R
    if van * t_z % R != rhs:
        return False
    # [r] from the key and the proof
    d = vk["q_const"]
    for i, name in enumerate(("q_a", "q_b", "q_c", "q_d")):
        d = add(d, mul(vk[name], a_z[i]))
    d = add(d, mul(vk["q_m"], a_z[0] * a_z[1]))
    d = add(d, mul(vk["q_d_next"], d_zw))
    gp = (z * beta + a_z[0] + gamma) % R
    for i in range(1, 4):
        gp = gp * (z * K_COLS[i] * beta + gamma + a_z[i]) % R
    gp = (gp * alpha + lag[0] * alpha * alpha) % R
    last = 1
    for i in range(3):
        last = last * (beta * s_z[i] + gamma + a_z[i]) % R
    last = last * beta * z_zw * alpha % R
    d = add(d, add(mul(proof.grand_product_commitment, gp), neg(mul(vk["sigma_3"], last))))
    d = add(mul(d, v), mul(proof.grand_product_commitment, pow(v, 9, R) * u))
    # the batched openings at z and z w
    zn = pow(z, size, R)
    agg = proof.quotient_poly_commitments[0]
    k = 1
    for p in proof.quotient_poly_commitments[1:]:
        k = k * zn % R
        agg = add(agg, mul(p, k))
    agg = add(agg, d)
    ch = v
    for p in proof.wire_commitments:
        ch = ch * v % R
        agg = add(agg, mul(p, ch))
    for i in range(3):
        ch = ch * v % R
        agg = add(agg, mul(vk[f"sigma_{i}"], ch))
    ch = ch * v * v % R
    agg = add(agg, mul(proof.wire_commitments[3], ch * u))
    ch = v
    value = t_z + r_z * ch
    for e in a_z + s_z:
        ch = ch * v % R
        value += e * ch
    ch = ch * v % R
    value += z_zw * ch * u
    ch = ch * v % R
    value = (value + d_zw * ch * u) % R
    agg = add(agg, neg(mul(bn254.G1, value)))
    with_g = add(add(agg, mul(proof.opening_at_z_proof, z)),
                 mul(proof.opening_at_z_omega_proof, z * w * u))
    with_x = neg(add(mul(proof.opening_at_z_omega_proof, u), proof.opening_at_z_proof))
    return add(with_g, mul(with_x, tau)) is None
