"""PLONK setup: selector/permutation polynomial construction and
verification-key generation for the width-4 + D-next system.

Behavioral parity: bellman_ce better_cs setup/make_verification_key
(SURVEY D1g); layout conventions verified byte-exact against
test/circuits/simple/vk.bin (see frontend/transpiler.py docstring)."""

from typing import List

import numpy as np

from ..fields import FR_MODULUS as R, NON_RESIDUES, get_domain_omega
from ..frontend.transpiler import DUMMY, STATE_WIDTH, TranspiledCircuit
from ..serialization import Crs, VerificationKey

SETUP_MIN_POW2 = 10
SETUP_MAX_POW2 = 26

# permutation coset labels: column j uses k_j * omega^i, k = [1, 5, 7, 10]
K_COLS = (1,) + NON_RESIDUES


class SetupPolynomials:
    """Value-form setup polynomials over the full domain (size n+1).

    Permutation polynomials are stored as LABEL INDICES (`perm_label_idx`
    [4, size] int64, label c*size + r meaning the value K_COLS[c]*omega^r):
    device backends build the sigma limb vectors directly from the index
    array (JaxBackend.perm_from_labels — one device pow-scan + gather)
    instead of round-tripping 2^k distinct python bigints through
    to_limbs_np (~5 s/vector at 2^20, the whole of the old `make vk`
    cost).  The python-int view `permutations` materializes lazily for
    host paths."""

    def __init__(self, n: int, num_inputs: int, selectors: List[List[int]],
                 *, perm_label_idx: "np.ndarray" = None,
                 permutations: List[List[int]] = None):
        self.n = n
        self.num_inputs = num_inputs
        self.selectors = selectors
        self.perm_label_idx = perm_label_idx
        self._permutations = permutations
        assert perm_label_idx is not None or permutations is not None

    @property
    def domain_size(self) -> int:
        return self.n + 1

    @property
    def permutations(self) -> List[List[int]]:
        """4 sigma value vectors as python ints (host prover paths /
        serialization); computed on demand from perm_label_idx."""
        if self._permutations is None:
            size = self.domain_size
            omega = get_domain_omega(size)
            pows = [1] * size
            for i in range(1, size):
                pows[i] = pows[i - 1] * omega % R
            labels = [k * p % R for k in K_COLS for p in pows]  # [4*size]
            self._permutations = [[labels[j] for j in col]
                                  for col in self.perm_label_idx]
        return self._permutations


def domain_size_for_gates(total_gates: int) -> int:
    """bellman keeps n = 2^k - 1 usable rows; the domain is 2^k."""
    size = 1
    while size - 1 < total_gates:
        size <<= 1
    return size


def make_setup_polynomials(tc: TranspiledCircuit) -> SetupPolynomials:
    total = tc.total_gates
    size = domain_size_for_gates(total)
    n = size - 1

    selectors = [[0] * size for _ in range(7)]
    all_gates = tc.all_gates()
    for row, gate in enumerate(all_gates):
        for sel_idx, coeff in enumerate(gate.selector_row()):
            selectors[sel_idx][row] = coeff

    # copy-constraint cycles: per-variable cell lists in gate order
    # (columns a..d within each gate); dummy Aux(0) cells keep identity.
    positions = {}
    for row, gate in enumerate(all_gates):
        for col in range(STATE_WIDTH):
            var = gate.wires[col]
            if var == DUMMY:
                continue
            positions.setdefault(var, []).append((row, col))

    # labels as indices (c*size + r); value materialization is lazy and
    # device backends never materialize at all (class docstring)
    sigma_idx = np.empty((STATE_WIDTH, size), dtype=np.int64)
    for c in range(STATE_WIDTH):
        sigma_idx[c] = np.arange(size, dtype=np.int64) + c * size
    for plist in positions.values():
        if len(plist) < 2:
            continue
        labels = [c * size + r for (r, c) in plist]
        rotated = labels[1:] + labels[:1]
        for (r, c), lab in zip(plist, rotated):
            sigma_idx[c][r] = lab

    return SetupPolynomials(n=n, num_inputs=tc.num_input_variables,
                            selectors=selectors, perm_label_idx=sigma_idx)


def make_verification_key(setup: SetupPolynomials, crs: Crs, backend=None) -> VerificationKey:
    """Commit to the 11 setup polynomials over the monomial-form SRS."""
    if backend is None:
        from ..backend_torch import TorchBackend
        backend = TorchBackend()
    size = setup.domain_size
    num_g1 = getattr(crs, "num_g1", None) or len(crs.g1_bases)
    if num_g1 < size:
        raise ValueError("SRS too small for circuit")
    msm_ctx = backend.msm_context_from_crs(crs, size, key=("srs", id(crs), size))

    from ..backend import from_ints_dedup
    from .prover import _commit_many, sigma_value_vectors

    sel_vecs = [backend.intt(from_ints_dedup(backend, setup.selectors[i]))
                for i in range(7)]
    perm_vecs = [backend.intt(v) for v in sigma_value_vectors(setup, backend)]
    comms = _commit_many(backend, msm_ctx, sel_vecs + perm_vecs)
    sel_comms, next_comms, perm_comms = comms[:6], comms[6:7], comms[7:]
    return VerificationKey(
        n=setup.n,
        num_inputs=setup.num_inputs,
        selector_commitments=sel_comms,
        next_step_selector_commitments=next_comms,
        permutation_commitments=perm_comms,
        non_residues=list(NON_RESIDUES),
        g2_elements=list(crs.g2_monomial_bases[:2]),
    )
