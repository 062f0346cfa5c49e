"""Non-native field (RNS) limb encoding: representing BN254 Fq elements as
Fr limb witnesses, following the RnsParameters::new_for_field(68, 110, 4)
convention the reference fixes everywhere (src/plonk.rs:214,
src/recursive/mod.rs:56,142; helpers in src/utils.rs).

Layout: an Fq element (254 bits) is split into 4 little-endian limbs of
LIMB_BITS = 68 bits.  "Double limb witnesses" pack two adjacent limbs into
one Fr element (2 * 68 = 136 bits), halving the public-input count
(src/utils.rs:43-108 from_double_size_limb_witnesses)."""

from typing import List

from ..fields import FQ_MODULUS, FR_MODULUS

LIMB_BITS = 68
NUM_LIMBS = 4
DOUBLE_BITS = 2 * LIMB_BITS


def fq_to_limbs(x: int) -> List[int]:
    """Fq -> 4 single-size limb witnesses (68 bits each, little-endian)."""
    assert 0 <= x < FQ_MODULUS
    mask = (1 << LIMB_BITS) - 1
    return [(x >> (LIMB_BITS * i)) & mask for i in range(NUM_LIMBS)]


def limbs_to_fq(limbs: List[int]) -> int:
    """4 single-size limb witnesses -> Fq (src/utils.rs:15-41 behavior)."""
    assert len(limbs) == NUM_LIMBS
    acc = 0
    for i, limb in enumerate(reversed(limbs)):
        acc = (acc << LIMB_BITS) + limb
    assert acc < FQ_MODULUS, "limb witness out of field range"
    return acc


def fq_to_double_limbs(x: int) -> List[int]:
    """Fq -> 2 double-size limb witnesses (136 bits each)."""
    assert 0 <= x < FQ_MODULUS
    mask = (1 << DOUBLE_BITS) - 1
    return [(x >> (DOUBLE_BITS * i)) & mask for i in range(NUM_LIMBS // 2)]


def double_limbs_to_fq(limbs: List[int]) -> int:
    """2 double-size limb witnesses -> Fq (src/utils.rs:43-108 behavior)."""
    assert len(limbs) == NUM_LIMBS // 2
    acc = 0
    for limb in reversed(limbs):
        acc = (acc << DOUBLE_BITS) + limb
    assert acc < FQ_MODULUS, "limb witness out of field range"
    return acc


def witness_to_fq(limbs: List[int]) -> int:
    """Dispatch on witness shape (src/utils.rs:112-118
    can_allocate_from_double_limb_witness semantics)."""
    if len(limbs) == NUM_LIMBS // 2:
        return double_limbs_to_fq(limbs)
    return limbs_to_fq(limbs)
