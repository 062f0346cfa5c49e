"""Rescue algebraic hash over BN254 Fr (sponge, 2-into-1), the in-circuit-
cheap hash the reference uses for its vk Merkle tree and rescue transcript
(franklin-crypto Bn256RescueParams::new_checked_2_into_1, SURVEY D2a;
reference: plonkit's src/plonk.rs:212-218).

Shape parity with the reference: state width 3 (rate 2 + capacity 1),
22 rounds, S-box x^{1/5} on even rounds / x^5 on odd rounds.  Round
constants and the MDS matrix come from recursive/franklin.py, which
re-implements franklin-crypto's deterministic generation procedure
(Blake2s counter constants over GH_FIRST_BLOCK; ChaCha-seeded Cauchy MDS
from the b"ResM0003" tag) — see that module's docstring for the exact
recovered algorithm and its validation status.  The fixed-length hash
specializes the capacity element to the input length and pads partial
blocks with ones, exactly like franklin's `sponge_fixed_length`.

Everything downstream (vk tree, rescue transcript, the in-circuit gadget)
is parameterized over this module's constants, so host- and
circuit-derived values always agree.
"""

from typing import List, Sequence

from ..fields import FR_MODULUS as R
from .franklin import (ALPHA, ALPHA_INV, CAPACITY, MDS, NUM_ROUNDS, RATE,
                       ROUND_CONSTANTS, STATE_WIDTH)
from .franklin import rescue_hash as _franklin_hash
from .franklin import rescue_mimc as _franklin_mimc

__all__ = [
    "STATE_WIDTH", "RATE", "CAPACITY", "NUM_ROUNDS", "ALPHA", "ALPHA_INV",
    "ROUND_CONSTANTS", "MDS", "rescue_permutation", "rescue_hash",
    "RescueTranscript",
]


def rescue_permutation(state: Sequence[int]) -> List[int]:
    """franklin-crypto `rescue_mimc` on a width-3 state."""
    return _franklin_mimc([x % R for x in state])


def rescue_hash(inputs: Sequence[int]) -> int:
    """Fixed-length sponge (franklin `rescue_hash`): capacity element
    specialized to the input length, ones padding, output state[0]."""
    return _franklin_hash(inputs)


class RescueTranscript:
    """Algebraic Fiat-Shamir transcript (shape of franklin-crypto's
    RescueTranscriptForRNS): absorbs Fr elements and G1 points (as RNS limb
    chunks), squeezes challenges by permuting the sponge state.  Buffered
    absorbs flush in rate-sized blocks with ones padding (StatefulRescue's
    pad_if_necessary)."""

    def __init__(self):
        self.state = [0] * STATE_WIDTH
        self._absorbed: List[int] = []

    def update_fr(self, value: int):
        self._absorbed.append(value % R)

    def update_u256(self, value: int):
        # public inputs / scalars are absorbed as Fr elements
        self.update_fr(value)

    def update_g1(self, p):
        from .rns import fq_to_double_limbs
        if p is None:
            self._absorbed.extend([0, 0])
            return
        for coord in p:
            self._absorbed.extend(fq_to_double_limbs(coord))

    def _flush(self):
        buf = self._absorbed
        self._absorbed = []
        if not buf:
            return
        if len(buf) % RATE:
            buf.append(1)
        for i in range(0, len(buf), RATE):
            for j in range(RATE):
                self.state[j] = (self.state[j] + buf[i + j]) % R
            self.state = rescue_permutation(self.state)

    def get_challenge(self) -> int:
        self._flush()
        self.state = rescue_permutation(self.state)
        return self.state[0]
