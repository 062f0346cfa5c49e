"""Verification-key Merkle tree (rescue-hashed), depth 7 -- the structure
the reference's aggregation circuit authenticates per-proof vks against
(VK_TREE_DEPTH, src/recursive/mod.rs:35; create_vks_tree :66; per-proof
queries :72-84)."""

from typing import List, Tuple

from ..serialization import VerificationKey
from .rescue import rescue_hash
from .rns import fq_to_double_limbs

VK_TREE_DEPTH = 7


def vk_leaf_encoding(vk: VerificationKey) -> List[int]:
    """Flatten a vk into Fr elements (commitment coords as RNS double
    limbs + scalars)."""
    out = [vk.n, vk.num_inputs]
    for group in (vk.selector_commitments, vk.next_step_selector_commitments,
                  vk.permutation_commitments):
        for p in group:
            if p is None:
                out.extend([0, 0, 0, 0])
            else:
                out.extend(fq_to_double_limbs(p[0]))
                out.extend(fq_to_double_limbs(p[1]))
    out.extend(vk.non_residues)
    return out


def vk_leaf_hash(vk: VerificationKey) -> int:
    return rescue_hash(vk_leaf_encoding(vk))


def build_vk_tree(vks: List[VerificationKey]) -> List[List[int]]:
    """Levels from leaves (2^depth wide, padded by replicating the last vk's
    hash the way the reference replicates its single vk) up to the root."""
    width = 1 << VK_TREE_DEPTH
    assert 0 < len(vks) <= width
    leaves = [vk_leaf_hash(vk) for vk in vks]
    leaves = leaves + [leaves[-1]] * (width - len(leaves))
    levels = [leaves]
    cur = leaves
    while len(cur) > 1:
        cur = [rescue_hash([cur[i], cur[i + 1]]) for i in range(0, len(cur), 2)]
        levels.append(cur)
    return levels


def vk_tree_root(vks: List[VerificationKey]) -> int:
    return build_vk_tree(vks)[-1][0]


def merkle_query(levels: List[List[int]], index: int) -> Tuple[int, List[int]]:
    """(leaf, authentication path) for the given leaf index."""
    leaf = levels[0][index]
    path = []
    for level in levels[:-1]:
        path.append(level[index ^ 1])
        index >>= 1
    return leaf, path


def merkle_verify(root: int, leaf: int, index: int, path: List[int]) -> bool:
    acc = leaf
    for sib in path:
        if index & 1:
            acc = rescue_hash([sib, acc])
        else:
            acc = rescue_hash([acc, sib])
        index >>= 1
    return acc == root


def get_vk_tree_root_hash(vk: VerificationKey) -> int:
    """Root for a single vk replicated through the tree
    (src/bin/main.rs:463 generate-recursive-verifier path)."""
    return vk_tree_root([vk])
