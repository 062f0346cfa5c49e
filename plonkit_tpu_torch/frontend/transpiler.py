"""R1CS -> PLONK (width-4 + D-next) transpiler.

Rebuilds the behavior of bellman_ce's better_cs adaptor/Transpiler
(SURVEY D1f) for the PlonkCsWidth4WithNextStepParams gate system:

    q_a*a + q_b*b + q_c*c + q_d*d + q_m*a*b + q_const + q_d_next*d_next = 0

Layout conventions were reverse-engineered against the committed golden
artifacts (test/circuits/simple/{vk.bin,proof.bin}, dev SRS tau=42) and are
verified byte-exact by tests/test_golden.py:

  * one "input gate" per public input, first in the trace, wires
    (x_i, dummy, dummy, dummy) with q_a = -1 (the public-input polynomial
    PI(X) = sum_i x_i L_i(X) enters the quotient with a + sign,
    contrib/template.sol:457-463).
  * R1CS constraint A*B = C:
      - both A,B constant: C's LC is enforced to equal A*B (addition gates);
      - one of A,B constant: the merged linear constraint
        const*LC - C = 0 is enforced via addition gates;
      - general case: A and B (and C if multi-term) are collapsed into
        single variables via addition gates, then one multiplication gate
        (va, vb, vc, dummy) with q_m = ca*cb, q_c = -cc.
  * LC collapse ("addition gates"): terms in first-occurrence order after
    stable deduplication; output variable appended with coefficient -1;
    constant into q_const.  LCs longer than one gate chain through the
    D-next selector: row i holds 3 new terms plus the running accumulator
    in its d-wire (q_d = +1), with q_d_next = -1 on the previous row.
  * copy constraints: per-variable cell lists in gate order (a,b,c,d within
    a gate), sigma = cyclic left rotation; dummy variable Aux(0) excluded
    (its cells keep identity labels).

The per-constraint hint/stat bookkeeping mirrors plonkit's TranspilerWrapper
(src/transpile.rs:92-107) so `analyse` output matches
(src/tests.rs:14).
"""

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..fields import FR_MODULUS as R
from .circuit import CircomCircuit, Var

DUMMY = Var("aux", 0)

STATE_WIDTH = 4


@dataclass
class Gate:
    """One trace row: 4 wire variables + 7 selector coefficients."""
    wires: Tuple[Var, Var, Var, Var]
    q_a: int = 0
    q_b: int = 0
    q_c: int = 0
    q_d: int = 0
    q_m: int = 0
    q_const: int = 0
    q_d_next: int = 0

    def selector_row(self) -> Tuple[int, ...]:
        return (self.q_a, self.q_b, self.q_c, self.q_d, self.q_m, self.q_const, self.q_d_next)


@dataclass
class ConstraintStat:
    name: str
    num_gates: int


@dataclass
class TranspiledCircuit:
    num_input_variables: int          # public inputs (excluding the ONE wire)
    num_aux_variables: int            # aux vars incl. transpiler intermediates, excl. dummy Aux(0)
    gates: List[Gate]                 # constraint gates (input gates are implicit)
    hints: List[Tuple[int, str]]      # (constraint index, variant tag)
    constraint_stats: List[ConstraintStat]

    @property
    def num_constraint_gates(self) -> int:
        return len(self.gates)

    @property
    def total_gates(self) -> int:
        return self.num_input_variables + len(self.gates)

    def all_gates(self) -> List[Gate]:
        """Input gates followed by constraint gates (the full trace)."""
        out = []
        for i in range(1, self.num_input_variables + 1):
            out.append(Gate(wires=(Var("input", i), DUMMY, DUMMY, DUMMY), q_a=R - 1))
        out.extend(self.gates)
        return out


def _normalize_lc(lc) -> Tuple[List[Tuple[Var, int]], int]:
    """Stable-deduplicate an LC and split off the constant (ONE) term."""
    constant = 0
    order: List[Var] = []
    coeffs: Dict[Var, int] = {}
    for var, coeff in lc:
        coeff %= R
        if var.kind == "input" and var.index == 0:
            constant = (constant + coeff) % R
            continue
        if var in coeffs:
            coeffs[var] = (coeffs[var] + coeff) % R
        else:
            coeffs[var] = coeff
            order.append(var)
    terms = [(v, coeffs[v]) for v in order if coeffs[v] != 0]
    return terms, constant


class Transpiler:
    """Streams R1CS constraints into PLONK gates.

    When a witness is attached, transpiler-allocated intermediate variables
    get their values computed on the fly (witness extension)."""

    def __init__(self, circuit: CircomCircuit):
        self.circuit = circuit
        cs_inputs = circuit.r1cs.num_inputs - 1  # exclude ONE
        self.num_input_variables = cs_inputs
        # aux vars: circom aux wires occupy Aux(1)..Aux(num_aux) via aux_offset=1
        self.next_aux = circuit.r1cs.num_aux + 1
        self.gates: List[Gate] = []
        self.hints: List[Tuple[int, str]] = []
        self.constraint_stats: List[ConstraintStat] = []
        # witness extension: values for transpiler-allocated variables
        self.extra_values: Dict[int, int] = {}
        # defining LC for each transpiler-allocated variable, in allocation
        # order: (terms, constant) with terms over earlier variables.  Purely
        # structural — recorded with or without a bound witness — so a
        # WitnessPlan can replay witness extension without re-transpiling.
        self.defs: List[Tuple[Tuple[Tuple[Var, int], ...], int]] = []

    # -- witness access ---------------------------------------------------

    def value_of(self, var: Var) -> int:
        if var == DUMMY:
            return 0
        if var.kind == "input":
            return self.circuit.witness_value(var.index)
        # aux: circom wires first, then transpiler-allocated
        num_inputs = self.circuit.r1cs.num_inputs
        if var.index <= self.circuit.r1cs.num_aux:
            return self.circuit.witness_value(var.index - self.circuit.aux_offset + num_inputs)
        return self.extra_values[var.index]

    def _lc_value(self, terms, constant) -> int:
        acc = constant
        for v, c in terms:
            acc = (acc + c * self.value_of(v)) % R
        return acc

    def _alloc(self, value: Optional[int], lc=None) -> Var:
        var = Var("aux", self.next_aux)
        if self.circuit.witness is not None and value is not None:
            self.extra_values[self.next_aux] = value
        if lc is not None:
            self.defs.append(lc)
        self.next_aux += 1
        return var

    # -- gate emission ----------------------------------------------------

    def _emit_addition_gates(self, terms, constant, output: Optional[Var]):
        """Enforce sum(terms) + constant (+ -1*output) == 0 via one or more
        width-4 addition gates chained through D-next."""
        work = list(terms)
        if output is not None:
            work.append((output, R - 1))
        n = len(work)
        if n == 0:
            if constant % R != 0:
                raise ValueError("unsatisfiable constant constraint")
            return
        if n <= STATE_WIDTH:
            wires = [v for v, _ in work] + [DUMMY] * (STATE_WIDTH - n)
            coeffs = [c for _, c in work] + [0] * (STATE_WIDTH - n)
            self.gates.append(Gate(
                wires=tuple(wires),
                q_a=coeffs[0], q_b=coeffs[1], q_c=coeffs[2], q_d=coeffs[3],
                q_const=constant,
            ))
            return
        # chained: gate 0 takes 4 terms, later gates take 3 terms + accumulator
        # in their d-wire; previous row's q_d_next = -1 pulls it in.
        first = work[:STATE_WIDTH]
        rest = work[STATE_WIDTH:]
        running = (constant + sum(c * self.value_of(v) for v, c in first)) % R \
            if self.circuit.witness is not None else None
        acc = self._alloc(running, (tuple(first), constant))
        self.gates.append(Gate(
            wires=tuple(v for v, _ in first),
            q_a=first[0][1], q_b=first[1][1], q_c=first[2][1], q_d=first[3][1],
            q_const=constant, q_d_next=R - 1,
        ))
        while rest:
            chunk, rest = rest[:STATE_WIDTH - 1], rest[STATE_WIDTH - 1:]
            wires = [v for v, _ in chunk] + [DUMMY] * (STATE_WIDTH - 1 - len(chunk)) + [acc]
            coeffs = [c for _, c in chunk] + [0] * (STATE_WIDTH - 1 - len(chunk))
            gate = Gate(
                wires=tuple(wires),
                q_a=coeffs[0], q_b=coeffs[1], q_c=coeffs[2], q_d=1,
            )
            if rest:
                if self.circuit.witness is not None:
                    running = (running + sum(c * self.value_of(v) for v, c in chunk)) % R
                acc = self._alloc(running, (tuple(chunk) + ((acc, 1),), 0))
                gate.q_d_next = R - 1
            self.gates.append(gate)

    def _collapse_lc(self, terms, constant) -> Tuple[Var, int]:
        """Reduce an LC to (variable, coefficient), allocating an
        intermediate variable + addition gate(s) when necessary."""
        if len(terms) == 1 and constant == 0:
            return terms[0]
        value = self._lc_value(terms, constant) if self.circuit.witness is not None else None
        out = self._alloc(value, (tuple(terms), constant))
        self._emit_addition_gates(terms, constant, out)
        return (out, 1)

    # -- constraint ingestion ---------------------------------------------

    def enforce(self, index: int, a_lc, b_lc, c_lc):
        before = len(self.gates)
        a_terms, a_const = _normalize_lc(a_lc)
        b_terms, b_const = _normalize_lc(b_lc)
        c_terms, c_const = _normalize_lc(c_lc)
        hint = self._enforce_normalized(a_terms, a_const, b_terms, b_const, c_terms, c_const)
        self.hints.append((index, hint))
        self.constraint_stats.append(ConstraintStat(str(index), len(self.gates) - before))

    def _enforce_normalized(self, a_terms, a_const, b_terms, b_const, c_terms, c_const) -> str:
        if not a_terms and not b_terms:
            # constant * constant = C
            prod = a_const * b_const % R
            if not c_terms:
                if (c_const - prod) % R != 0:
                    raise ValueError("inconsistent constant constraint")
                return "is_constant"
            self._emit_addition_gates(c_terms, (c_const - prod) % R, None)
            return "merge_c_constant_ab"
        if not a_terms or not b_terms:
            # one side constant: const * LC(other) - C = 0
            if not a_terms:
                k, lin_terms, lin_const = a_const, b_terms, b_const
                tag = "merge_bc_through_constant_a"
            else:
                k, lin_terms, lin_const = b_const, a_terms, a_const
                tag = "merge_ac_through_constant_b"
            merged: List[Tuple[Var, int]] = [(v, c * k % R) for v, c in lin_terms]
            constant = (lin_const * k - c_const) % R
            # subtract C's terms (stable merge: keep lhs order, append new)
            index = {v: i for i, (v, _) in enumerate(merged)}
            for v, c in c_terms:
                if v in index:
                    i = index[v]
                    merged[i] = (v, (merged[i][1] - c) % R)
                else:
                    index[v] = len(merged)
                    merged.append((v, (R - c) % R))
            merged = [(v, c) for v, c in merged if c != 0]
            self._emit_addition_gates(merged, constant, None)
            return tag
        # true multiplication
        va, ca = self._collapse_lc(a_terms, a_const)
        vb, cb = self._collapse_lc(b_terms, b_const)
        if c_terms:
            vc, cc = self._collapse_lc(c_terms, c_const)
            extra_const = 0
        else:
            vc, cc = DUMMY, 0
            extra_const = (R - c_const) % R  # A*B = const -> q_const = -const
        self.gates.append(Gate(
            wires=(va, vb, vc, DUMMY),
            q_c=(R - cc) % R if cc else 0,
            q_m=ca * cb % R,
            q_const=extra_const,
        ))
        return "into_multiplication_gate"


def transpile(circuit: CircomCircuit) -> TranspiledCircuit:
    t = Transpiler(circuit)
    for index, a, b, c in circuit.nontrivial_constraints():
        t.enforce(index, a, b, c)
    return TranspiledCircuit(
        num_input_variables=t.num_input_variables,
        num_aux_variables=t.next_aux - 1,
        gates=t.gates,
        hints=t.hints,
        constraint_stats=t.constraint_stats,
    )


class WitnessPlan:
    """Precompiled witness-assignment program for one circuit structure.

    Re-running the transpiler per proof costs a full host-python pass over
    every constraint (tens of seconds at 2^20 — it dominated the round-4
    prove wall-time).  The structure is witness-independent, so this plan is
    built once (SetupForProver.__init__) and each prove only (a) evaluates
    the transpiler-allocated variables' defining LCs in allocation order and
    (b) gathers the wire columns through flat index lists.  Mirrors the
    reference's per-prove synthesize (src/plonk.rs:140-170) at plan-eval
    cost instead of transpile cost."""

    __slots__ = ("tc", "witness_len", "prog", "wire_idx", "pub_idx",
                 "dummy_idx", "_wire_idx_np", "_native_prog")

    def __init__(self, tc: TranspiledCircuit, witness_len: int, prog,
                 wire_idx, pub_idx, dummy_idx):
        self.tc = tc
        self.witness_len = witness_len
        self.prog = prog          # [(((flat_idx, coeff), ...), constant)]
        self.wire_idx = wire_idx  # 4 lists of flat indices over all gates
        self.pub_idx = pub_idx
        self.dummy_idx = dummy_idx
        self._wire_idx_np = None
        self._native_prog = None

    def _values(self, witness: List[int]) -> List[int]:
        if len(witness) != self.witness_len:
            raise ValueError((len(witness), self.witness_len))
        vals = list(witness)
        append = vals.append
        for terms, const in self.prog:
            acc = const
            for s, c in terms:
                acc += c * vals[s]
            append(acc % R)
        append(0)  # dummy slot (self.dummy_idx)
        return vals

    def evaluate(self, witness: List[int]) -> Tuple[List[List[int]], List[int]]:
        """(wire columns [a,b,c,d], public inputs) for one witness vector."""
        vals = self._values(witness)
        columns = [list(map(vals.__getitem__, idx)) for idx in self.wire_idx]
        public_inputs = [vals[i] for i in self.pub_idx]
        return columns, public_inputs

    def _padded_idx(self, pad_to: int):
        import numpy as np
        if self._wire_idx_np is None:
            self._wire_idx_np = [np.asarray(idx, dtype=np.int64)
                                 for idx in self.wire_idx]
        out = []
        for idx in self._wire_idx_np:
            if pad_to > idx.shape[0]:
                idx = np.concatenate(
                    [idx, np.full(pad_to - idx.shape[0], self.dummy_idx,
                                  dtype=np.int64)])
            out.append(idx[:pad_to])
        return out

    def _encode_native(self):
        """Flat-encode the extras program for bn254_witness_eval (once)."""
        import numpy as np
        srcs, coeffs, offs, consts = [], [], [0], []
        for terms, const in self.prog:
            for s, c in terms:
                srcs.append(s)
                coeffs.append((c % R).to_bytes(32, "little"))
            offs.append(len(srcs))
            consts.append((const % R).to_bytes(32, "little"))
        self._native_prog = (
            np.asarray(srcs, dtype=np.int64), b"".join(coeffs),
            np.asarray(offs, dtype=np.int64), b"".join(consts))

    def evaluate_limbs(self, witness: List[int], pad_to: int):
        """(wire columns as [pad_to, 8] uint32 raw limb rows, public inputs
        as ints).

        Native path: bn254_witness_eval replays the extras program and
        gathers the columns at Fr-CIOS speed (the python plan evaluation
        is ~2 s of bigint work per 2^20 prove).  Otherwise (a public input
        outside the witness) each DISTINCT value is converted to limbs once
        and the columns are numpy-gathered."""
        import numpy as np

        from ..native import bn254_witness_eval
        idx_cols = self._padded_idx(pad_to)
        if all(i < self.witness_len for i in self.pub_idx):
            if self._native_prog is None:
                self._encode_native()
            srcs, coeffs, offs, consts = self._native_prog
            wb = b"".join((v % R).to_bytes(32, "little") for v in witness)
            cols = bn254_witness_eval(
                wb, self.witness_len, srcs, coeffs, offs, consts,
                len(self.prog), np.concatenate(idx_cols), len(idx_cols),
                pad_to)
            public_inputs = [witness[i] % R for i in self.pub_idx]
            return list(cols), public_inputs

        from ..gpu.mont import FR
        vals = self._values(witness)
        limbs = FR.to_limbs_np(vals)                     # [n_vals, 8]
        cols = [np.ascontiguousarray(limbs[idx]) for idx in idx_cols]
        public_inputs = [vals[i] for i in self.pub_idx]
        return cols, public_inputs


def build_witness_plan(circuit: CircomCircuit) -> WitnessPlan:
    """Transpile once (witness not required) and compile the wire/value
    index program.  The returned plan's .tc is the transpiled circuit."""
    t = Transpiler(circuit)
    for index, a, b, c in circuit.nontrivial_constraints():
        t.enforce(index, a, b, c)
    tc = TranspiledCircuit(
        num_input_variables=t.num_input_variables,
        num_aux_variables=t.next_aux - 1,
        gates=t.gates,
        hints=t.hints,
        constraint_stats=t.constraint_stats,
    )
    r1cs = circuit.r1cs
    if circuit.witness is not None:
        witness_len = len(circuit.witness)
    elif circuit.wire_mapping is not None:
        witness_len = max(circuit.wire_mapping) + 1
    else:
        witness_len = r1cs.num_inputs + r1cs.num_aux
    num_extras = (t.next_aux - 1) - r1cs.num_aux
    assert num_extras == len(t.defs), (num_extras, len(t.defs))
    dummy_idx = witness_len + num_extras
    mapping = circuit.wire_mapping

    def flat(var: Var) -> int:
        if var == DUMMY:
            return dummy_idx
        if var.kind == "input":
            wire = var.index
        else:
            if var.index > r1cs.num_aux:  # transpiler-allocated
                return witness_len + (var.index - r1cs.num_aux - 1)
            wire = var.index - circuit.aux_offset + r1cs.num_inputs
        return mapping[wire] if mapping is not None else wire

    prog = [(tuple((flat(v), c) for v, c in terms), const)
            for terms, const in t.defs]
    wire_idx = [[flat(g.wires[j]) for g in tc.all_gates()]
                for j in range(STATE_WIDTH)]
    pub_idx = [flat(Var("input", i))
               for i in range(1, t.num_input_variables + 1)]
    return WitnessPlan(tc, witness_len, prog, wire_idx, pub_idx, dummy_idx)


def synthesize_witness(circuit: CircomCircuit) -> Tuple[TranspiledCircuit, List[List[int]], List[int]]:
    """Transpile with a bound witness; returns (transpiled, wire value columns
    [a,b,c,d] over the unpadded trace, public input values)."""
    assert circuit.witness is not None
    plan = build_witness_plan(circuit)
    columns, public_inputs = plan.evaluate(circuit.witness)
    return plan.tc, columns, public_inputs
