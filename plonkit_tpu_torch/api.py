"""Entry points of the port, mirroring plonkit_tpu/api.py (and plonkit's
src/plonk.rs orchestration layer): SetupForProver, make_verification_key,
verify, and the deterministic dev SRS.

The card is the default: SetupForProver builds a TorchBackend on
`device="cuda"` unless it is given a backend or another device.
"""

import logging
from typing import Optional

from .curve import G2_GEN, g2_mul
from .frontend.circuit import CircomCircuit
from .frontend.transpiler import build_witness_plan
from .plonk.prover import ProverContext, prove as _prove
from .plonk.setup import (SETUP_MAX_POW2, SETUP_MIN_POW2,
                          make_setup_polynomials, make_verification_key)
from .plonk.verifier import verify as _verify
from .profiling import stage
from .serialization import Crs, Proof, VerificationKey
from .srs import dev_srs_g1

log = logging.getLogger("plonkit_tpu_torch")

# the reference's deterministic dev-SRS secret (kate_commitment crs_42)
DEV_TAU = 42


def gen_key_monomial_form(power: int) -> Crs:
    """Deterministic dev SRS with tau = 42, the same points as
    plonkit_tpu.api.gen_key_monomial_form (srs.py says how it is faster)."""
    if not (SETUP_MIN_POW2 <= power <= SETUP_MAX_POW2):
        raise ValueError("setup power of two is not in the correct range")
    g1 = dev_srs_g1(1 << power, DEV_TAU)
    return Crs(g1, [G2_GEN, g2_mul(G2_GEN, DEV_TAU)])


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
            from .backend_torch import TorchBackend
            backend = TorchBackend(device)
        self.crs = key_monomial_form
        self.key_lagrange_form = key_lagrange_form
        self.backend = backend
        self._prover_ctx = None

    def make_verification_key(self) -> VerificationKey:
        return make_verification_key(self.setup_polynomials, self.crs, backend=self.backend)

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


def verify(vk: VerificationKey, proof: Proof, transcript: str = "keccak") -> bool:
    return _verify(vk, proof, transcript)
