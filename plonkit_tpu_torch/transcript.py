"""Rolling keccak Fiat-Shamir transcript, bit-compatible with
bellman_ce's RollingKeccakTranscript and its Solidity mirror
(contrib/template.sol:267-307, SURVEY D1h).

State: two keccak256 chains (state_0, state_1) and a challenge counter.
  update(v):  s0' = keccak(DST_0 || s0 || s1 || v)
              s1' = keccak(DST_1 || s0 || s1 || v)     (both use the OLD s0, s1)
  challenge:  keccak(DST_CHALLENGE || s0 || s1 || counter) & FR_MASK
DST tags and the counter are encoded as 4-byte big-endian u32; field/point
values as 32-byte big-endian u256.  FR_MASK clears the top 3 bits so the
result always fits in Fr.
"""

from .keccak import keccak256

FR_MASK = (1 << 253) - 1
_DST_0 = (0).to_bytes(4, "big")
_DST_1 = (1).to_bytes(4, "big")
_DST_CHALLENGE = (2).to_bytes(4, "big")


def make_transcript(kind: str = "keccak"):
    """Transcript factory: "keccak" (RollingKeccakTranscript-compatible) or
    "rescue" (algebraic, cheap to re-derive inside the aggregation circuit;
    the reference's `prove -t rescue`, src/plonk.rs:160-170)."""
    if kind == "keccak":
        return Transcript()
    if kind == "rescue":
        from .recursive.rescue import RescueTranscript
        return RescueTranscript()
    raise ValueError(f"unknown transcript type: {kind!r}")


class Transcript:
    def __init__(self):
        self.state_0 = b"\x00" * 32
        self.state_1 = b"\x00" * 32
        self.counter = 0

    def update_u256(self, value: int):
        v = value.to_bytes(32, "big")
        old0, old1 = self.state_0, self.state_1
        self.state_0 = keccak256(_DST_0 + old0 + old1 + v)
        self.state_1 = keccak256(_DST_1 + old0 + old1 + v)

    def update_fr(self, value: int):
        self.update_u256(value)

    def update_g1(self, p):
        # template.sol:297-300: X then Y; infinity is encoded as (0, 0)
        if p is None:
            self.update_u256(0)
            self.update_u256(0)
        else:
            self.update_u256(p[0])
            self.update_u256(p[1])

    def get_challenge(self) -> int:
        query = keccak256(
            _DST_CHALLENGE + self.state_0 + self.state_1 + self.counter.to_bytes(4, "big")
        )
        self.counter += 1
        return int.from_bytes(query, "big") & FR_MASK
