"""Entry points of the port, mirroring plonkit_tpu/api.py (and plonkit's
src/plonk.rs orchestration layer): SetupForProver, make_verification_key,
verify, analyse, the deterministic dev SRS and the Lagrange form of a key
(a group NTT on the card).

The card is the default: SetupForProver builds a TorchBackend on
`device="cuda"` unless it is given a backend or another device.
"""

import json
import logging
from dataclasses import asdict, dataclass, field
from typing import List, Optional

import numpy as np

from .backend_torch import TorchBackend
from .curve import G2_GEN, g2_mul
from .frontend.circuit import CircomCircuit
from .frontend.transpiler import build_witness_plan, transpile
from .gpu.group_ntt import group_intt
from .gpu.mont import FQ
from .plonk.prover import ProverContext, prove as _prove, validate_witness
from .plonk.setup import (SETUP_MAX_POW2, SETUP_MIN_POW2,
                          make_setup_polynomials, make_verification_key)
from .plonk.verifier import verify as _verify
from .profiling import stage
from .serialization import Crs, CrsLimbs, Proof, VerificationKey
from .srs import dev_srs_g1

log = logging.getLogger("plonkit_tpu_torch")

# the reference's deterministic dev-SRS secret (kate_commitment crs_42)
DEV_TAU = 42


@dataclass
class AnalyseResult:
    num_inputs: int
    num_aux: int
    num_variables: int
    num_constraints: int
    num_nontrivial_constraints: int
    num_gates: int
    num_hints: int
    constraint_stats: List[dict] = field(default_factory=list)

    def to_json(self, include_stats: bool = True, pretty: bool = False) -> str:
        d = asdict(self)
        if not include_stats or not d["constraint_stats"]:
            d.pop("constraint_stats")
        return json.dumps(d, indent=2 if pretty else None,
                          separators=None if pretty else (",", ":"))


def analyse(circuit: CircomCircuit) -> AnalyseResult:
    tc = transpile(circuit)
    return AnalyseResult(
        num_inputs=circuit.r1cs.num_inputs,
        num_aux=circuit.r1cs.num_aux,
        num_variables=circuit.r1cs.num_variables,
        num_constraints=len(circuit.r1cs.constraints),
        num_nontrivial_constraints=len(tc.constraint_stats),
        num_gates=tc.num_constraint_gates,
        num_hints=len(tc.hints),
        constraint_stats=[{"name": s.name, "num_gates": s.num_gates} for s in tc.constraint_stats],
    )


def gen_key_monomial_form(power: int) -> Crs:
    """Deterministic dev SRS with tau = 42, the same points as
    plonkit_tpu.api.gen_key_monomial_form (srs.py says how it is faster)."""
    if not (SETUP_MIN_POW2 <= power <= SETUP_MAX_POW2):
        raise ValueError("setup power of two is not in the correct range")
    g1 = dev_srs_g1(1 << power, DEV_TAU)
    return Crs(g1, [G2_GEN, g2_mul(G2_GEN, DEV_TAU)])


def crs_lagrange_form(crs, domain_size: int, device="cuda") -> CrsLimbs:
    """Monomial -> Lagrange form: L_i(tau) * G for i < domain_size, the
    inverse group NTT of the key's first `domain_size` G1 points
    (gpu/group_ntt.group_intt: K14 and K15 on the card by default, their
    plain versions for device="cpu").  `crs` is a CrsHandle (its limb rows
    are read as they are) or a Crs.  Returns a key held as limb rows, which
    SetupForProver takes as key_lagrange_form and save() writes.  One
    stage, "lagrange key" (profiling: under PLONKIT_TPU_TRACE its trace is
    lagrange_key.json), which does not synchronize: the key ends in its
    read-back, so the stage's time is whole without, and a synchronize
    after it costs tens of microseconds a key."""
    with stage("lagrange key", sync=False):
        if domain_size < 1 or domain_size & (domain_size - 1):
            raise ValueError(f"domain size {domain_size} is not a power of two")
        TorchBackend(device)                          # raises for "cuda" without a card
        if hasattr(crs, "g1_limbs"):
            x, y, inf = crs.g1_limbs(domain_size)
        else:
            pts = crs.g1_bases[:domain_size]
            x, y = (FQ.to_limbs_np([0 if p is None else p[c] for p in pts]) for c in (0, 1))
            inf = np.array([p is None for p in pts], dtype=bool)
        if x.shape[0] < domain_size:
            raise ValueError(f"the key has {x.shape[0]} points, the domain {domain_size}")
        return CrsLimbs(*group_intt(x, y, inf, device), list(crs.g2_monomial_bases))


class SetupForProver:
    """Prepared proving state for one circuit (mirrors src/plonk.rs:50-119)."""

    def __init__(self, circuit: CircomCircuit, key_monomial_form,
                 key_lagrange_form: Optional[Crs] = None, backend=None,
                 device="cuda"):
        # one transpile; its witness plan replays witness extension per
        # prove without re-transpiling (frontend/transpiler.WitnessPlan)
        self._witness_plan = build_witness_plan(circuit)
        tc = self._witness_plan.tc
        log.info("transpile done, gates_count %d hints size %d",
                 tc.num_constraint_gates, len(tc.hints))
        self.setup_polynomials = make_setup_polynomials(tc)
        size_log = max(self.setup_polynomials.domain_size.bit_length() - 1, SETUP_MIN_POW2)
        if not (SETUP_MIN_POW2 <= size_log <= SETUP_MAX_POW2):
            raise ValueError("setup power of two is not in the correct range")
        if backend is None:
            backend = TorchBackend(device)
        self.crs = key_monomial_form
        self.key_lagrange_form = key_lagrange_form
        self.backend = backend
        self._prover_ctx = None

    def make_verification_key(self) -> VerificationKey:
        return make_verification_key(self.setup_polynomials, self.crs, backend=self.backend)

    def validate_witness(self, circuit: CircomCircuit) -> None:
        """Raise ProvingError unless the witness satisfies every gate."""
        cols, pub = self._witness_plan.evaluate(circuit.witness)
        validate_witness(self.setup_polynomials, cols, pub, backend=self.backend)

    def prove(self, circuit: CircomCircuit, transcript: str = "keccak") -> Proof:
        with stage("witness synthesis"):
            size = self.setup_polynomials.domain_size
            raw_cols, pub = self._witness_plan.evaluate_limbs(circuit.witness, size)
            cols = [self.backend.from_raw_limbs(rc) for rc in raw_cols]
        if self._prover_ctx is None:
            self._prover_ctx = ProverContext(self.setup_polynomials, self.crs,
                                             self.backend,
                                             crs_lagrange=self.key_lagrange_form)
        return _prove(self.setup_polynomials, cols, pub, ctx=self._prover_ctx,
                      transcript=transcript)

    def get_srs_lagrange_form_from_monomial_form(self) -> CrsLimbs:
        return crs_lagrange_form(self.crs, self.setup_polynomials.domain_size,
                                 device=self.backend.device)


def verify(vk: VerificationKey, proof: Proof, transcript: str = "keccak") -> bool:
    return _verify(vk, proof, transcript)
