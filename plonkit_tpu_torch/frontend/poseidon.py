"""Poseidon hash (circomlib semantics) — parameters, host hash, and R1CS
circuit generation.  The port's copy of plonkit_tpu/frontend/poseidon.py
(host python, no tensors).

Reference workload: plonkit test/circuits/poseidon/circuit.circom:1-14
uses circomlib 0.5.1's Poseidon(2) (package.json:20).  circomlib's constants
come from the Poseidon paper's reference parameter generator: a Grain LFSR
seeded from (field, sbox, n, t, R_F, R_P), self-shrinking, with rejection
sampling for the round constants and a Cauchy matrix 1/(x_i + y_j) from two
further batches of samples for the MDS matrix.  This module reimplements
that generator (grain_parameters), the permutation (t = n_inputs + 1 state,
x^5 S-box, 8 full rounds, R_P partial rounds from the paper's table), and a
circom-equivalent R1CS emitter whose constraint shapes match what circom
produces for circomlib's poseidon.circom: 3 multiplication constraints per
S-box (x2 = x*x, x4 = x2*x2, x5 = x4*x) with the linear ark/mix layers
folded into the constraint LCs.

The generated parameters are pinned by tests/test_torch_poseidon.py against
the published circomlib test vector poseidon([1, 2]) (circomlibjs
test/poseidon.js), so this is genuine circomlib interoperability, not a
self-defined hash.
"""

from functools import lru_cache

from ..fields import FR_MODULUS as P

# partial-round counts from the Poseidon paper's BN254/alpha=5 table
# (circomlib poseidon.circom N_ROUNDS_P), indexed by t - 2
N_ROUNDS_P = [56, 57, 56, 60, 60, 63, 64, 63, 60, 66, 60, 65, 70, 60, 64, 68]
N_ROUNDS_F = 8


class _Grain:
    """Grain LFSR from the Poseidon reference implementation
    (generate_parameters_grain.sage): 80-bit state, taps 62/51/38/23/13/0,
    160 warmup outputs, self-shrinking output filter."""

    def __init__(self, t: int, r_f: int, r_p: int, n: int = 254,
                 field: int = 1, sbox: int = 0):
        bits = []
        for value, width in ((field, 2), (sbox, 4), (n, 12), (t, 12),
                             (r_f, 10), (r_p, 10), ((1 << 30) - 1, 30)):
            bits += [(value >> (width - 1 - i)) & 1 for i in range(width)]
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._next_raw()

    def _next_raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def next_bit(self) -> int:
        # self-shrinking: bits are consumed in PAIRS; the second bit of a
        # pair is emitted iff the first is 1 (a lone leading 0 must still
        # burn its partner — diverges from circomlib otherwise)
        while True:
            b1 = self._next_raw()
            b2 = self._next_raw()
            if b1 == 1:
                return b2

    def next_raw_int(self, n_bits: int = 254) -> int:
        v = 0
        for _ in range(n_bits):
            v = (v << 1) | self.next_bit()
        return v

    def next_field(self, n_bits: int = 254) -> int:
        # rejection sampling (round constants)
        while True:
            v = self.next_raw_int(n_bits)
            if v < P:
                return v

    def next_field_mod(self, n_bits: int = 254) -> int:
        # straight mod-p (MDS x/y samples — circomlib does NOT reject here;
        # pinned by the poseidon([1,2]) test vector)
        return self.next_raw_int(n_bits) % P


@lru_cache(maxsize=None)
def grain_parameters(t: int):
    """(C, M): round constants [(R_F + R_P) * t] and MDS matrix [t][t] for
    circomlib's Poseidon at state width t."""
    r_p = N_ROUNDS_P[t - 2]
    g = _Grain(t, N_ROUNDS_F, r_p)
    n_consts = (N_ROUNDS_F + r_p) * t
    C = [g.next_field() for _ in range(n_consts)]
    # MDS: Cauchy matrix m[i][j] = 1 / (x_i + y_j), sampled mod-p from the
    # SAME continuing grain stream
    xs = [g.next_field_mod() for _ in range(t)]
    ys = [g.next_field_mod() for _ in range(t)]
    M = [[pow((xs[i] + ys[j]) % P, P - 2, P) for j in range(t)]
         for i in range(t)]
    return C, M


def _sbox(x: int) -> int:
    x2 = x * x % P
    x4 = x2 * x2 % P
    return x4 * x % P


def poseidon_permutation(state):
    """Full Poseidon permutation on a length-t state (circomlib schedule:
    ark -> sbox (all lanes in full rounds, lane 0 in partial) -> mix)."""
    t = len(state)
    C, M = grain_parameters(t)
    r_p = N_ROUNDS_P[t - 2]
    n_rounds = N_ROUNDS_F + r_p
    state = list(state)
    for r in range(n_rounds):
        state = [(x + C[r * t + i]) % P for i, x in enumerate(state)]
        full = r < N_ROUNDS_F // 2 or r >= n_rounds - N_ROUNDS_F // 2
        if full:
            state = [_sbox(x) for x in state]
        else:
            state[0] = _sbox(state[0])
        state = [sum(M[i][j] * state[j] for j in range(t)) % P
                 for i in range(t)]
    return state


def poseidon(inputs):
    """circomlib poseidon: state = [0, *inputs], output = state[0] after
    the permutation."""
    t = len(inputs) + 1
    assert 2 <= t <= len(N_ROUNDS_P) + 1
    state = [0] + [x % P for x in inputs]
    return poseidon_permutation(state)[0]


# ---------------------------------------------------------------------------
# R1CS circuit generation (circom-equivalent constraint shapes)
# ---------------------------------------------------------------------------

class _R1CSBuilder:
    """Minimal R1CS accumulator in snarkjs wire convention: wire 0 = ONE,
    then public outputs, then private inputs, then aux."""

    def __init__(self, num_outputs: int, num_private: int):
        self.num_outputs = num_outputs
        self.num_private = num_private
        self.n_wires = 1 + num_outputs + num_private
        self.constraints = []
        self.witness = [1] + [0] * (num_outputs + num_private)

    def new_wire(self, value: int) -> int:
        w = self.n_wires
        self.n_wires += 1
        self.witness.append(value % P)
        return w

    def enforce(self, a, b, c):
        """a * b = c, each a sparse [(wire, coeff)] list."""
        self.constraints.append((list(a), list(b), list(c)))


def _lc_scale(lc, k):
    return [(w, coeff * k % P) for w, coeff in lc]


def _lc_add(*lcs):
    acc = {}
    for lc in lcs:
        for w, coeff in lc:
            acc[w] = (acc.get(w, 0) + coeff) % P
    return [(w, c) for w, c in acc.items() if c != 0]


def _lc_value(lc, witness):
    return sum(witness[w] * c for w, c in lc) % P


def _sbox_gadget(b: _R1CSBuilder, lc):
    """x^5 as circom's Sigma template: 3 constraints, 3 new wires."""
    x = _lc_value(lc, b.witness)
    x2 = b.new_wire(x * x % P)
    b.enforce(lc, lc, [(x2, 1)])
    x4 = b.new_wire(b.witness[x2] * b.witness[x2] % P)
    b.enforce([(x2, 1)], [(x2, 1)], [(x4, 1)])
    x5 = b.new_wire(b.witness[x4] * x % P)
    b.enforce([(x4, 1)], lc, [(x5, 1)])
    return [(x5, 1)]


def _permutation_gadget(b: _R1CSBuilder, state_lcs):
    """Poseidon permutation over LC-valued state; returns output LCs.
    Linear layers (ark, MDS mix) stay in LC space — exactly circom's
    behavior, which makes the resulting constraints LC-heavy (each S-box
    input is a t-term LC plus constant)."""
    t = len(state_lcs)
    C, M = grain_parameters(t)
    r_p = N_ROUNDS_P[t - 2]
    n_rounds = N_ROUNDS_F + r_p
    one = [(0, 1)]
    state = [list(lc) for lc in state_lcs]
    for r in range(n_rounds):
        state = [_lc_add(lc, _lc_scale(one, C[r * t + i]))
                 for i, lc in enumerate(state)]
        full = r < N_ROUNDS_F // 2 or r >= n_rounds - N_ROUNDS_F // 2
        if full:
            state = [_sbox_gadget(b, lc) for lc in state]
        else:
            state[0] = _sbox_gadget(b, state[0])
        state = [_lc_add(*[_lc_scale(state[j], M[i][j]) for j in range(t)])
                 for i in range(t)]
    return state


def poseidon_circuit(n_inputs: int = 2, chain: int = 1, inputs=None):
    """Build a CircomCircuit proving knowledge of preimages in a Poseidon
    hash chain: out = H(...H(H(in_1..in_k), in_2')...).

    chain=1 mirrors the reference's flagship circuit (circomlib
    Poseidon(2), one public output, private inputs); larger `chain` values
    scale the constraint count (~243 constraints per hash at t=3) for the
    2^20-class prove benchmarks.  Returns (circuit, expected_output)."""
    from .circuit import CircomCircuit
    from .r1cs import R1CS

    if inputs is None:
        inputs = list(range(1, n_inputs + 1))
    assert len(inputs) == n_inputs
    n_private = n_inputs + (chain - 1)
    b = _R1CSBuilder(num_outputs=1, num_private=n_private)
    # private input wires follow the output wire
    priv = []
    extra = []
    for i in range(n_inputs):
        w = 2 + i
        b.witness[w] = inputs[i] % P
        priv.append(w)
    for i in range(chain - 1):
        w = 2 + n_inputs + i
        b.witness[w] = (1000 + i) % P
        extra.append(w)

    cur = [[(w, 1)] for w in priv]
    out_lc = None
    for step in range(chain):
        state = [[]] + cur            # state[0] = 0
        out_state = _permutation_gadget(b, state)
        out_lc = out_state[0]
        if step + 1 < chain:
            cur = [out_lc, [(extra[step], 1)]]
    # bind the public output wire: out * 1 = H(...)
    expected = _lc_value(out_lc, b.witness)
    b.witness[1] = expected
    b.enforce([(1, 1)], [(0, 1)], out_lc)

    r1cs = R1CS(num_inputs=2, num_aux=b.n_wires - 2,
                num_variables=b.n_wires, constraints=b.constraints)
    return CircomCircuit(r1cs=r1cs, witness=b.witness), expected
