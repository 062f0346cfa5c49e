"""Recursive proof aggregation of the port, copied from plonkit_tpu/recursive
(reference parity target: plonkit's src/recursive/mod.rs
+ the matter-labs franklin-crypto / recursive_aggregation_circuit stack,
SURVEY C8/D1i/D2/D3/D5) -- complete in this build:

  * cs.py               -- constraint-system builder + base gadget layer for
                           directly-synthesized circuits (better_better_cs
                           analogue, with the 2-bit range custom gate of
                           plonk/extended.py)
  * nonnative.py        -- RNS non-native Fq gadgets, 4x68-bit limbs
                           (RnsParameters(68,110,4) shape), CRT-checked mul
  * ec_gadget.py        -- affine G1 add/double + shared-doubling Straus
                           multi-MSM (4-bit multilinear-mux windows)
  * rescue.py           -- host rescue permutation/sponge/transcript
  * rescue_gadget.py    -- the in-circuit mirrors + Merkle verification
  * rns.py              -- limb encodings (src/utils.rs behavior)
  * vk_tree.py          -- depth-7 rescue vk Merkle tree
  * verifier_gadget.py  -- in-circuit PLONK verification of a base-system
                           rescue-transcript proof (challenges + gate
                           identity native, EC side emitted as MSM tasks)
  * aggregation.py      -- the aggregation circuit + host orchestration:
                           prove_aggregation / verify_aggregation /
                           make_recursive_vk / check_aggregation /
                           AggregatedProof
  * batch.py            -- off-circuit N-proof batched verification (one
                           pairing for N proofs; no SNARK)

Rescue parameters are self-generated by a documented keccak-counter
procedure (bit-compatibility with franklin-crypto's Bn256RescueParams is
shape-level, not bit-level).
"""

from .aggregation import (AggregatedProof, check_aggregation,
                          expected_aggregated_input, make_recursive_vk,
                          prove_aggregation, verify_aggregation)
from .batch import aggregate_proofs, verify_aggregate
