"""Circuit "poseidon_chain": a chain of circomlib Poseidon(2) hashes, out =
H(...H(H(in_1, in_2), e_1)..., e_{k-1}), with one public output, and its
witnesses, each from its own chain inputs.  Copied from the program's
frontend/poseidon.py (the Grain parameter generator, the permutation and
the circom-shaped R1CS: three constraints per S-box, x2 = x x, x4 = x2 x2,
x5 = x4 x, the linear layers folded into the constraints' linear
combinations) and frontend/synthetic.py's chain, with the witness made apart
from the constraints so that a pool of witnesses costs one permutation each.

Wires: 0 the constant one, 1 the public output, 2 and 3 the two inputs,
4 .. 4 + k - 2 the chain's further inputs e_i, then x2, x4, x5 of every
S-box in order.  The configuration's `hashes` is k; one hash is upstream's
own circuit.

A circuit file gives what a kind reads: `r1cs(config)` -> (public wires
with the constant one, all wires, constraints), `witness(config, seed,
index)` and `public(witness)`.  It imports nothing of the program."""

import random
from functools import lru_cache

from portbench.reference.bn254 import R as P

T = 3                           # Poseidon(2): a state of three
ROUNDS_F = 8
ROUNDS_P = 57                   # the Poseidon paper's partial rounds for t = 3


class _Grain:
    """The Grain LFSR of the Poseidon reference parameter generator:
    80-bit state, taps 62/51/38/23/13/0, 160 warm-up steps, self-shrinking."""

    def __init__(self, t: int, r_f: int, r_p: int):
        bits = []
        for value, width in ((1, 2), (0, 4), (254, 12), (t, 12), (r_f, 10), (r_p, 10),
                             ((1 << 30) - 1, 30)):
            bits += [(value >> (width - 1 - i)) & 1 for i in range(width)]
        self.state = bits
        for _ in range(160):
            self._raw()

    def _raw(self) -> int:
        s = self.state
        new = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        self.state = s[1:] + [new]
        return new

    def _bit(self) -> int:
        while True:
            b1, b2 = self._raw(), self._raw()
            if b1:
                return b2

    def _int(self) -> int:
        v = 0
        for _ in range(254):
            v = (v << 1) | self._bit()
        return v

    def field(self) -> int:
        while True:
            v = self._int()
            if v < P:
                return v


@lru_cache(maxsize=None)
def parameters():
    """(round constants [(R_F + R_P) t], MDS matrix [t][t]) of circomlib's
    Poseidon at t = 3: rejection-sampled constants, then a Cauchy matrix
    1 / (x_i + y_j) of samples taken mod p from the same stream."""
    g = _Grain(T, ROUNDS_F, ROUNDS_P)
    consts = [g.field() for _ in range((ROUNDS_F + ROUNDS_P) * T)]
    xs = [g._int() % P for _ in range(T)]
    ys = [g._int() % P for _ in range(T)]
    mds = [[pow((xs[i] + ys[j]) % P, P - 2, P) for j in range(T)] for i in range(T)]
    return consts, mds


def _full(r: int) -> bool:
    return r < ROUNDS_F // 2 or r >= ROUNDS_F // 2 + ROUNDS_P


def _permute(state: list, record: list) -> list:
    """The permutation over values; appends each S-box's x2, x4, x5."""
    consts, mds = parameters()
    for r in range(ROUNDS_F + ROUNDS_P):
        state = [(x + consts[r * T + i]) % P for i, x in enumerate(state)]
        for i in range(T if _full(r) else 1):
            x = state[i]
            x2 = x * x % P
            x4 = x2 * x2 % P
            x5 = x4 * x % P
            record += (x2, x4, x5)
            state[i] = x5
        state = [sum(m * s for m, s in zip(row, state)) % P for row in mds]
    return state


def poseidon(a: int, b: int) -> int:
    return _permute([0, a % P, b % P], [])[0]


def chain_witness(inputs: list) -> list:
    """The full witness of the chain over its inputs [in_1, in_2, e_1, ...,
    e_{k-1}]."""
    sboxes = []
    out = _permute([0, inputs[0] % P, inputs[1] % P], sboxes)[0]
    for e in inputs[2:]:
        out = _permute([0, out, e % P], sboxes)[0]
    return [1, out] + [x % P for x in inputs] + sboxes


def constraints(hashes: int) -> list:
    """The R1CS [(A, B, C)] of a chain of `hashes` hashes, each a list of
    (wire, coeff); the last constraint binds the output: out * 1 = H."""
    consts, mds = parameters()
    cons = []
    nxt = [2 + 1 + hashes]               # the next free wire

    def lc_add(*lcs):
        acc = {}
        for lc in lcs:
            for w, c in lc:
                acc[w] = (acc.get(w, 0) + c) % P
        return [(w, c) for w, c in acc.items() if c]

    def sbox(lc):
        x2, x4, x5 = nxt[0], nxt[0] + 1, nxt[0] + 2
        nxt[0] += 3
        cons.append((list(lc), list(lc), [(x2, 1)]))
        cons.append(([(x2, 1)], [(x2, 1)], [(x4, 1)]))
        cons.append(([(x4, 1)], list(lc), [(x5, 1)]))
        return [(x5, 1)]

    cur = [[(2, 1)], [(3, 1)]]
    out = None
    for step in range(hashes):
        state = [[]] + cur
        for r in range(ROUNDS_F + ROUNDS_P):
            state = [lc_add(lc, [(0, consts[r * T + i])]) for i, lc in enumerate(state)]
            for i in range(T if _full(r) else 1):
                state[i] = sbox(state[i])
            state = [lc_add(*[[(w, c * mds[i][j] % P) for w, c in state[j]] for j in range(T)])
                     for i in range(T)]
        out = state[0]
        if step + 1 < hashes:
            cur = [out, [(4 + step, 1)]]
    cons.append(([(1, 1)], [(0, 1)], out))
    return cons


def num_wires(hashes: int) -> int:
    return 4 + (hashes - 1) + hashes * 3 * (T * ROUNDS_F + ROUNDS_P)


def chain_inputs(seed: int, index: int, hashes: int) -> list:
    """The chain inputs of witness `index` of a run seeded with `seed`:
    hashes + 1 field elements, uniform below r."""
    rng = random.Random(f"portbench:{seed}:{index}")
    return [rng.randrange(P) for _ in range(hashes + 1)]


def r1cs(config: dict) -> tuple:
    return 2, num_wires(config["hashes"]), constraints(config["hashes"])


def witness(config: dict, seed: int, index: int) -> list:
    return chain_witness(chain_inputs(seed, index, config["hashes"]))


def public(witness: list) -> list:
    return [witness[1]]
