"""In-circuit rescue: permutation, sponge hash, Fiat-Shamir transcript and
Merkle-path verification gadgets over the extended gate system.

Mirrors the host implementations in recursive/rescue.py and
recursive/vk_tree.py element-for-element (same constants, same padding,
same flush semantics), so host- and circuit-derived challenges/roots agree.
Reference counterpart: franklin-crypto's rescue gadget +
RescueTranscriptForRNS used inside the aggregation circuit
(plonkit's src/recursive/mod.rs:56-66, SURVEY D2).

Costs: x^5 or x^(1/5) s-box = 3 mul gates per state element (the inverse
direction allocates y with y^5 = x, standard rescue trick); MDS row + round
constant = 1 linear gate per element; ~530 gates per permutation.
"""

from typing import List

from ..fields import FR_MODULUS as R
from .cs import CsBuilder, Num
from .rescue import (ALPHA_INV, MDS, NUM_ROUNDS, RATE, ROUND_CONSTANTS,
                     STATE_WIDTH)


def _sbox_forward(cs: CsBuilder, x: Num) -> Num:
    """y = x^5."""
    x2 = cs.mul(x, x)
    x4 = cs.mul(x2, x2)
    return cs.mul(x4, x)


def _sbox_inverse(cs: CsBuilder, x: Num) -> Num:
    """y = x^(1/5): allocate y, constrain y^5 == x."""
    y = cs.alloc(pow(x.value, ALPHA_INV, R))
    y2 = cs.mul(y, y)
    y4 = cs.mul(y2, y2)
    # y4 * y - x == 0
    cs.gate(y4.idx, y.idx, x.idx, 0, qm=1, qc=R - 1)
    return y


def rescue_permutation_gadget(cs: CsBuilder, state: List[Num]) -> List[Num]:
    # initial round-constant add
    s = [cs.lc([(x, 1)], constant=c)
         for x, c in zip(state, ROUND_CONSTANTS[0])]
    for rnd in range(2 * NUM_ROUNDS):
        sbox = _sbox_inverse if rnd % 2 == 0 else _sbox_forward
        s = [sbox(cs, x) for x in s]
        # MDS + next round constants, one gate per output element
        s = [cs.lc([(s[j], MDS[i][j]) for j in range(STATE_WIDTH)],
                   constant=ROUND_CONSTANTS[rnd + 1][i])
             for i in range(STATE_WIDTH)]
    return s


def rescue_hash_gadget(cs: CsBuilder, inputs: List[Num]) -> Num:
    """Fixed-length sponge mirroring rescue.rescue_hash (franklin
    `sponge_fixed_length`): capacity element = input length, ones pad."""
    length = cs.lc([(cs.one, len(inputs))])
    state = [cs.zero] * (STATE_WIDTH - 1) + [length]
    buf = list(inputs)
    if len(buf) % RATE:
        buf.append(cs.one)  # pad marker
    for i in range(0, len(buf), RATE):
        state = ([cs.add(state[j], buf[i + j]) for j in range(RATE)]
                 + state[RATE:])
        state = rescue_permutation_gadget(cs, state)
    return state[0]


class RescueTranscriptGadget:
    """In-circuit mirror of rescue.RescueTranscript (same flush/pad)."""

    def __init__(self, cs: CsBuilder):
        self.cs = cs
        self.state = [cs.zero] * STATE_WIDTH
        self._absorbed: List[Num] = []

    def update_fr(self, x: Num):
        self._absorbed.append(x)

    def update_u256(self, x: Num):
        self.update_fr(x)

    def _flush(self):
        cs = self.cs
        buf = self._absorbed
        self._absorbed = []
        if not buf:
            return
        if len(buf) % RATE:
            buf.append(cs.one)
        for i in range(0, len(buf), RATE):
            self.state = ([cs.add(self.state[j], buf[i + j]) for j in range(RATE)]
                          + self.state[RATE:])
            self.state = rescue_permutation_gadget(cs, self.state)

    def get_challenge(self) -> Num:
        self._flush()
        self.state = rescue_permutation_gadget(self.cs, self.state)
        return self.state[0]


def merkle_verify_gadget(cs: CsBuilder, leaf: Num, index_bits: List[Num],
                         path: List[Num], root: Num):
    """Authenticate leaf at position (index bits, LSB first) against root.
    index_bits must be boolean-constrained."""
    acc = leaf
    for bit, sib in zip(index_bits, path):
        left = cs.select(bit, sib, acc)
        right = cs.select(bit, acc, sib)
        acc = rescue_hash_gadget(cs, [left, right])
    cs.enforce_equal(acc, root)
