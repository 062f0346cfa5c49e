"""CircomCircuit: binds an R1CS to an (optional) witness, exposing the
constraint stream the transpiler consumes.

Behavioral parity: plonkit's src/circom_circuit.rs.  Index mapping
follows circom_circuit.rs:107-113: R1CS wire i < num_inputs is Input(i);
otherwise Aux(i - num_inputs + aux_offset).  aux_offset = 1
(src/plonk.rs:24) shifts aux indices so the two index spaces stay disjoint
from the implicit ONE input at Input(0)."""

from dataclasses import dataclass
from typing import List, Optional

from .r1cs import R1CS

AUX_OFFSET = 1


@dataclass(frozen=True)
class Var:
    """A constraint-system variable: ('input', i) or ('aux', i)."""
    kind: str  # 'input' | 'aux'
    index: int


@dataclass
class CircomCircuit:
    r1cs: R1CS
    witness: Optional[List[int]] = None
    wire_mapping: Optional[List[int]] = None
    aux_offset: int = AUX_OFFSET

    def get_public_inputs(self) -> Optional[List[int]]:
        # circom_circuit.rs:50-58: witness[1..num_inputs]
        if self.witness is None:
            return None
        if self.wire_mapping is None:
            return self.witness[1:self.r1cs.num_inputs]
        return [self.witness[self.wire_mapping[i]] for i in range(1, self.r1cs.num_inputs)]

    def witness_value(self, wire: int) -> int:
        if self.witness is None:
            # circom_circuit.rs:83/97: placeholder 1 when no witness bound
            return 1
        if self.wire_mapping is not None:
            return self.witness[self.wire_mapping[wire]]
        return self.witness[wire]

    def make_var(self, wire: int) -> Var:
        if wire < self.r1cs.num_inputs:
            return Var("input", wire)
        return Var("aux", wire - self.r1cs.num_inputs + self.aux_offset)

    def nontrivial_constraints(self):
        """Yield (index, a_lc, b_lc, c_lc) with wire indices mapped to Vars,
        skipping trivial 0*LC=0 rows (circom_circuit.rs:121-131)."""
        for i, (a, b, c) in enumerate(self.r1cs.constraints):
            if (not a or not b) and not c:
                continue
            yield i, self._map_lc(a), self._map_lc(b), self._map_lc(c)

    def _map_lc(self, lc):
        return [(self.make_var(w), coeff) for w, coeff in lc]
