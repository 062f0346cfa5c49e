"""Second-generation gate system: width-4 + D-next main gate PLUS a
two-bit-decomposition range-check custom gate.

Behavioral parity target: bellman_ce's better_better_cs constraint system
(PlonkCsWidth4WithNextStepAndCustomGatesParams + the TwoBitDecomposition
range-check custom gate), which the reference uses exclusively for the
recursive aggregation circuit (plonkit's src/recursive/mod.rs:8-14,
111-127, SURVEY D1i).  The protocol here is self-defined (proof/vk formats
are this framework's own, as the reference's are its dependency's own): the
aggregated proof must round-trip through prove2/verify2 and the generated
recursive Solidity verifier, not match foreign bytes.

Gate equations (row i, state wires a,b,c,d, next-row wire d'):

  main gate (selectors q_a..q_d, q_m, q_const, q_dnext):
      q_a a + q_b b + q_c c + q_d d + q_m a b + q_const + q_dnext d' + PI = 0

  range gate (selector q_range), with g(e) = e(e-1)(e-2)(e-3):
      C1 = g(c - 4d)   C2 = g(b - 4c)   C3 = g(a - 4b)   C4 = g(d' - 4a)
  i.e. the accumulator runs d -> c -> b -> a -> next d, two bits per hop
  (8 bits per row).  g has degree 4 in the wires, so q_range * C_k has
  degree 5(N-1) -- the same bound as the copy-permutation term -- and the
  quotient still fits the 4N coset LDE with 4 chunks.

Quotient combination (alpha powers, this framework's fixed order):
  alpha^0 main+PI | alpha^1..4 C1..C4 | alpha^5 permutation | alpha^6 L0(z-1)

The verification key carries 12 commitments (6 selector + 1 next-step +
1 range + 4 permutation).  The proof layout is identical to the base
system's Proof (4 quotient chunks, same evaluation set) -- the range-gate
contribution folds entirely into the linearization polynomial r(X) since
all four C_k are evaluable from the proof's wire evaluations at zeta and
zeta*omega.

Copied from plonkit_tpu/plonk/extended.py for the port: the prover runs over
backend_torch.TorchBackend (the card unless asked otherwise), whose `mul`,
`add`, `add_scalar`, `fma_acc`, `add_into` and `mul_into` are the field
kernels K1, K2a and K4, `grand_product` the K1 prefix-product scan, and
`offload`/`onload` the copies to and from host memory; the final pairing of
verify2 runs in the native library (native.py).
"""

import logging
from dataclasses import dataclass
from typing import List, Tuple

log = logging.getLogger("plonkit_tpu_torch")

from ..fields import FR_MODULUS as R, FR_GENERATOR, NON_RESIDUES, fr_inv, get_domain_omega
from ..serialization import (Crs, Proof, read_fr, read_g1, read_u64, write_fr,
                             write_g1, write_g2, read_g2, write_u64)
from ..transcript import make_transcript

STATE_WIDTH = 4
NUM_SELECTORS = 8          # q_a q_b q_c q_d q_m q_const q_dnext q_range
Q_RANGE = 7
LDE_FACTOR = 4
K_COLS = (1,) + NON_RESIDUES


class SetupPolynomials2:
    """Value-form setup polynomials for the extended system.  Permutations
    are stored as label indices (c*size + r -> K_COLS[c]*omega^r) exactly
    as the base system's SetupPolynomials: device backends build sigma
    limb vectors straight from the index array (one powers table and four
    gathers) instead of converting a python int per entry."""

    def __init__(self, n: int, num_inputs: int, selectors: List[List[int]],
                 perm_label_idx=None, permutations: List[List[int]] = None):
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
        if self._permutations is None:
            size = self.domain_size
            omega = get_domain_omega(size)
            pows = [1] * size
            for i in range(1, size):
                pows[i] = pows[i - 1] * omega % R
            labels = [k * p % R for k in K_COLS for p in pows]
            self._permutations = [[labels[j] for j in col]
                                  for col in self.perm_label_idx]
        return self._permutations


@dataclass
class VerificationKey2:
    """Extended-system vk ('recursive verification key' at the CLI surface,
    mirroring the role of the reference's better_better_cs
    VerificationKey<E, RecursiveAggregationCircuit>)."""
    n: int
    num_inputs: int
    selector_commitments: List[Tuple[int, int]]            # 6
    next_step_selector_commitments: List[Tuple[int, int]]  # 1
    range_selector_commitments: List[Tuple[int, int]]      # 1
    permutation_commitments: List[Tuple[int, int]]         # 4
    non_residues: List[int]
    g2_elements: List[tuple]

    @property
    def domain_size(self) -> int:
        return self.n + 1

    def write(self, w):
        write_u64(w, self.n)
        write_u64(w, self.num_inputs)
        for group in (self.selector_commitments, self.next_step_selector_commitments,
                      self.range_selector_commitments, self.permutation_commitments):
            for p in group:
                write_g1(w, p)
        for k in self.non_residues:
            write_fr(w, k)
        for g2 in self.g2_elements:
            write_g2(w, g2)

    @classmethod
    def read(cls, r):
        n = read_u64(r)
        num_inputs = read_u64(r)
        sel = [read_g1(r) for _ in range(6)]
        nxt = [read_g1(r)]
        rng = [read_g1(r)]
        perm = [read_g1(r) for _ in range(STATE_WIDTH)]
        non_res = [read_fr(r) for _ in range(3)]
        g2 = [read_g2(r) for _ in range(2)]
        return cls(n, num_inputs, sel, nxt, rng, perm, non_res, g2)

    def save(self, filename: str):
        with open(filename, "wb") as f:
            self.write(f)

    @classmethod
    def load(cls, filename: str):
        with open(filename, "rb") as f:
            return cls.read(f)


def domain_size_for_gates(total_gates: int) -> int:
    size = 1
    while size - 1 < total_gates:
        size <<= 1
    return size


def make_setup_polynomials2(num_inputs: int, input_vars: List[int],
                            wires, selectors_rows, backend=None) -> SetupPolynomials2:
    """Build setup polynomials from raw synthesized arrays.

    wires: list of rows, each a 4-tuple of variable indices (0 = dummy,
    excluded from copy constraints).  selectors_rows: list of 8-tuples.
    Input gates (one per public input, q_a=-1, wire in column a) are
    generated here and PREPENDED, matching the base system's convention so
    PI(X) = sum_i x_i L_i(X).

    Permutations come out as a label-index array (SetupPolynomials2
    docstring): no 254-bit python modmuls at all — the cycle rotation is
    pure index shuffling, and device backends evaluate the labels with one
    pow-scan.  `backend` is accepted for API compatibility but no longer
    needed here."""
    total = num_inputs + len(wires)
    size = domain_size_for_gates(total)
    n = size - 1

    selectors = [[0] * size for _ in range(NUM_SELECTORS)]
    for row, v in enumerate(input_vars):
        selectors[0][row] = R - 1
    for row, q in enumerate(selectors_rows):
        base = num_inputs + row
        for k in range(NUM_SELECTORS):
            if q[k]:
                selectors[k][base] = q[k] % R

    positions = {}
    for row, var in enumerate(input_vars):
        positions.setdefault(var, []).append((row, 0))
    for row, ws in enumerate(wires):
        base = num_inputs + row
        for col in range(STATE_WIDTH):
            var = ws[col]
            if var == 0:
                continue
            positions.setdefault(var, []).append((base, col))

    import numpy as np
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

    return SetupPolynomials2(n=n, num_inputs=num_inputs,
                             selectors=selectors, perm_label_idx=sigma_idx)


def make_verification_key2(setup: SetupPolynomials2, crs: Crs, backend=None) -> VerificationKey2:
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
                for i in range(NUM_SELECTORS)]
    perm_vecs = [backend.intt(v) for v in sigma_value_vectors(setup, backend)]
    comms = _commit_many(backend, msm_ctx, sel_vecs + perm_vecs)
    sel, nxt, rng = comms[:6], comms[6:7], comms[7:8]
    perm = comms[8:]
    return VerificationKey2(
        n=setup.n, num_inputs=setup.num_inputs,
        selector_commitments=sel, next_step_selector_commitments=nxt,
        range_selector_commitments=rng, permutation_commitments=perm,
        non_residues=list(NON_RESIDUES), g2_elements=list(crs.g2_monomial_bases[:2]))


def _range_terms_eval(a, b, c, d, d_next, alpha):
    """sum_{k=1..4} alpha^k * C_k evaluated on scalars."""
    total = 0
    apow = 1
    for e in ((c - 4 * d) % R, (b - 4 * c) % R, (a - 4 * b) % R, (d_next - 4 * a) % R):
        apow = apow * alpha % R
        t1 = (e * e - 3 * e) % R
        total = (total + apow * (t1 * (t1 + 2) % R)) % R
    return total


class ProverError(Exception):
    pass


def validate_witness2(setup: SetupPolynomials2, wire_columns: List[List[int]],
                      public_inputs: List[int]) -> None:
    """TrivialAssembly-style satisfiability check (main + range gates)."""
    size = setup.domain_size
    cols = [list(col) + [0] * (size - len(col)) for col in wire_columns]
    q = setup.selectors
    for row in range(size):
        a, b, c, d = (cols[j][row] for j in range(4))
        d_next = cols[3][(row + 1) % size]
        pi = public_inputs[row] if row < len(public_inputs) else 0
        acc = (q[0][row] * a + q[1][row] * b + q[2][row] * c + q[3][row] * d
               + q[4][row] * a * b + q[5][row] + q[6][row] * d_next + pi) % R
        if acc != 0:
            raise ProverError(f"main gate not satisfied at row {row}")
        if q[Q_RANGE][row]:
            for e in ((c - 4 * d) % R, (b - 4 * c) % R, (a - 4 * b) % R,
                      (d_next - 4 * a) % R):
                if q[Q_RANGE][row] * e * ((e - 1) % R) % R * ((e - 2) % R) % R \
                        * ((e - 3) % R) % R != 0:
                    raise ProverError(f"range gate not satisfied at row {row}")


def validate_witness2_fast(setup: SetupPolynomials2, wire_columns: List[List[int]],
                           public_inputs: List[int], backend=None) -> None:
    """Backend-vectorized satisfiability check (device-friendly: ~25 O(n)
    vector ops instead of a Python row loop -- required at the aggregation
    circuit's 2^21 rows)."""
    if backend is None:
        from ..backend_torch import TorchBackend
        backend = TorchBackend()
    from ..backend import from_ints_dedup
    b = backend
    size = setup.domain_size
    w = [b.from_ints(col, pad_to=size) for col in wire_columns]
    d_next = b.rotate(w[3], 1)
    pi = [0] * size
    for i, x in enumerate(public_inputs):
        pi[i] = x
    q = [from_ints_dedup(b, s) for s in setup.selectors]
    acc = b.from_ints(pi)
    for j in range(STATE_WIDTH):
        acc = b.add(acc, b.mul(q[j], w[j]))
    acc = b.add(acc, b.mul(q[4], b.mul(w[0], w[1])))
    acc = b.add(acc, q[5])
    acc = b.add(acc, b.mul(q[6], d_next))

    def nonzero(v):
        # single-scalar device pull when the backend supports it (the
        # full to_ints pull is ~64 MB per check at 2^20)
        f = getattr(b, "any_nonzero", None)
        return f(v) if f is not None else any(b.to_ints(v))

    if nonzero(acc):
        raise ProverError("main gate not satisfied")
    for e in (b.sub(w[2], b.scale(w[3], 4)), b.sub(w[1], b.scale(w[2], 4)),
              b.sub(w[0], b.scale(w[1], 4)), b.sub(d_next, b.scale(w[0], 4))):
        t1 = b.sub(b.mul(e, e), b.scale(e, 3))
        ck = b.mul(b.mul(t1, b.add_scalar(t1, 2)), q[Q_RANGE])
        if nonzero(ck):
            raise ProverError("range gate not satisfied")


class ProverContext2:
    """Reusable prover state for the extended system.  Unlike the base
    ProverContext, monomial forms are kept HOST-resident (backend.offload)
    and LDEs are streamed one at a time, as the JAX package does: device
    memory then holds a few LDEs (4 x 32 bytes x the domain each) at a time,
    not all twelve, which bounds the peak of the aggregation circuit and of
    its two-proof variant at the next power of two."""

    def __init__(self, setup: SetupPolynomials2, crs: Crs, backend=None):
        if backend is None:
            from ..backend_torch import TorchBackend
            backend = TorchBackend()
        self.backend = backend
        self.setup = setup
        size = setup.domain_size
        num_g1 = getattr(crs, "num_g1", None) or len(crs.g1_bases)
        if num_g1 < size:
            raise ValueError("SRS too small for circuit")
        self.msm_ctx = backend.msm_context_from_crs(crs, size, key=("srs", id(crs), size))
        from ..backend import from_ints_dedup
        from .prover import sigma_value_vectors
        b = backend
        self.sel_m = [b.offload(b.intt(from_ints_dedup(b, s)))
                      for s in setup.selectors]
        sigma_dev = sigma_value_vectors(setup, b)
        self.sigma_m = [b.offload(b.intt(v)) for v in sigma_dev]
        self.sigma_v = [b.offload(v) for v in sigma_dev]
        del sigma_dev
        self.omega = get_domain_omega(size)

    def lde(self, hosted):
        out = self.backend.coset_lde(self.backend.onload(hosted), LDE_FACTOR)
        # drain the queue, so the caching allocator can hand this LDE's
        # workspace to the next one instead of holding several at once
        from ..profiling import sync_device
        sync_device()
        return out


def prove2(setup: SetupPolynomials2, wire_columns: List[List[int]],
           public_inputs: List[int], crs: Crs = None, backend=None,
           ctx: ProverContext2 = None, skip_validation: bool = False,
           transcript: str = "keccak") -> Proof:
    if ctx is None:
        ctx = ProverContext2(setup, crs, backend)
    b = ctx.backend
    size = setup.domain_size
    n = setup.n
    omega = ctx.omega

    import os as _os
    _memlog = _os.environ.get("PLONKIT_TPU_MEMLOG")

    def _mem(tag):
        # device memory probe (PLONKIT_TPU_MEMLOG=1): the caching
        # allocator's allocated bytes, after a queue drain so transients
        # are settled; a backend on the CPU has nothing to report
        if not _memlog or b.device.type != "cuda":
            return
        import torch
        from ..profiling import sync_device
        sync_device()
        st = torch.cuda.memory_stats(b.device)
        log.info("[mem] %-28s in_use=%.2f GiB peak=%.2f GiB", tag,
                 st.get("allocated_bytes.all.current", 0) / 2**30,
                 st.get("allocated_bytes.all.peak", 0) / 2**30)

    _mem("after context build")

    if not skip_validation:
        # vectorized check: the python row loop is far too slow at the
        # aggregation circuit's 2^21 rows
        validate_witness2_fast(setup, wire_columns, public_inputs, backend=b)

    transcript = make_transcript(transcript)
    for x in public_inputs:
        transcript.update_u256(x)

    from ..profiling import stage
    from .prover import _commit_many, _eval_many

    # ---- round 1: wire polynomials -------------------------------------
    _r1 = stage("x r1 wires: intt + 4 commits")
    _r1.__enter__()
    wires_v = [b.from_ints(col, pad_to=size) for col in wire_columns]
    wires_m = [b.intt(v) for v in wires_v]
    wire_comms = _commit_many(b, ctx.msm_ctx, wires_m)
    _r1.__exit__(None, None, None)
    _mem("after r1")
    for p in wire_comms:
        transcript.update_g1(p)
    beta = transcript.get_challenge()
    gamma = transcript.get_challenge()

    # ---- round 2: grand product ----------------------------------------
    _r2 = stage("x r2 grand product + commit")
    _r2.__enter__()
    omega_pows = b.powers(ctx.omega, size)
    num = None
    den = None
    for j in range(STATE_WIDTH):
        kj_beta = K_COLS[j] * beta % R
        term_n = b.add_scalar(b.scale_add(omega_pows, kj_beta, wires_v[j]), gamma)
        term_d = b.add_scalar(b.scale_add(b.onload(ctx.sigma_v[j]), beta, wires_v[j]),
                              gamma)
        num = term_n if num is None else b.mul(num, term_n)
        den = term_d if den is None else b.mul(den, term_d)
    del omega_pows
    ratio = b.mul(num, b.batch_inverse(den))
    del num, den
    z_v = b.grand_product(ratio)
    del ratio
    z_m = b.intt(z_v)
    del z_v
    z_comm = b.commit(ctx.msm_ctx, z_m)
    _r2.__exit__(None, None, None)
    _mem("after r2")
    transcript.update_g1(z_comm)
    alpha = transcript.get_challenge()
    alpha_pows = [1] * 7
    for i in range(1, 7):
        alpha_pows[i] = alpha_pows[i - 1] * alpha % R

    # ---- round 3: quotient (streamed: recompute wire LDEs on demand) ----
    # A 2-entry recompute cache bounds the live wire LDEs at 2 (each is
    # 4 x 32 bytes x the domain): a recompute is one coset NTT, as in the
    # JAX package, which needs it to fit its device memory.
    _r3 = stage("x r3 quotient: streamed LDEs + 4 commits")
    _r3.__enter__()
    del wires_v
    wires_m_host = [b.offload(m) for m in wires_m]
    del wires_m
    _mem("r3 entry")

    class _WireLDE:
        cap = 2

        def __init__(self):
            self.live = {}
            self.order = []

        def get(self, i):
            if i in self.live:
                return self.live[i]
            while len(self.order) >= self.cap:
                del self.live[self.order.pop(0)]
            v = ctx.lde(wires_m_host[i])
            self.live[i] = v
            self.order.append(i)
            return v

    wl = _WireLDE()

    def d_next():
        return b.rotate(wl.get(3), LDE_FACTOR)

    numerator = None
    # the backend's accumulators when it has them (TorchBackend's fma_acc
    # is one K4 launch for the pair mul, add)
    _fma = getattr(b, "fma_acc", None)
    _addi = getattr(b, "add_into", None)
    _muli = getattr(b, "mul_into", None)

    def acc(term):
        nonlocal numerator
        if numerator is None:
            numerator = term
        elif _addi is not None:
            numerator = _addi(numerator, term)
        else:
            numerator = b.add(numerator, term)

    def acc_mul(x, y):
        nonlocal numerator
        if numerator is not None and _fma is not None:
            numerator = _fma(numerator, x, y)
        else:
            acc(b.mul(x, y))

    def mul_chain(acc_v, t):
        return _muli(acc_v, t) if _muli is not None else b.mul(acc_v, t)

    _w0 = wl.get(0)
    _mem("w0 LDE live")
    _w1 = wl.get(1)
    _mem("w0+w1 LDEs live")
    _ab = b.mul(_w0, _w1)
    del _w0, _w1
    _mem("a*b live")
    acc_mul(ctx.lde(ctx.sel_m[4]), _ab)
    del _ab
    _mem("q_m term accumulated")
    for i in range(STATE_WIDTH):
        acc_mul(ctx.lde(ctx.sel_m[i]), wl.get(i))
    _mem("wire terms accumulated")
    acc(ctx.lde(ctx.sel_m[5]))
    acc_mul(ctx.lde(ctx.sel_m[6]), d_next())

    pi_v = [0] * size
    for i, x in enumerate(public_inputs):
        pi_v[i] = x
    acc(b.coset_lde(b.intt(b.from_ints(pi_v)), LDE_FACTOR))

    # range-gate constraints C1..C4 at alpha^1..alpha^4 (expression pairs
    # ordered so consecutive exprs share a cached wire LDE)
    range_exprs = (
        lambda: b.sub(wl.get(2), b.scale(wl.get(3), 4)),   # c - 4d
        lambda: b.sub(wl.get(1), b.scale(wl.get(2), 4)),   # b - 4c
        lambda: b.sub(wl.get(0), b.scale(wl.get(1), 4)),   # a - 4b
        lambda: b.sub(d_next(), b.scale(wl.get(0), 4)),    # d' - 4a
    )
    range_total = None
    for k, mk in enumerate(range_exprs):
        e = mk()
        t1 = b.sub(b.mul(e, e), b.scale(e, 3))              # e^2 - 3e
        ck = b.mul(t1, b.add_scalar(t1, 2))                 # * (e^2 - 3e + 2)
        del e, t1
        ck = b.scale(ck, alpha_pows[k + 1])
        if range_total is None:
            range_total = ck
        elif _addi is not None:
            range_total = _addi(range_total, ck)
        else:
            range_total = b.add(range_total, ck)
    acc_mul(ctx.lde(ctx.sel_m[Q_RANGE]), range_total)
    del range_total

    z_m_host = b.offload(z_m)
    del z_m
    z_l = ctx.lde(z_m_host)

    # permutation argument at alpha^5
    ext = LDE_FACTOR * size
    eta = get_domain_omega(ext)
    x_coset = b.scale(b.powers(eta, ext), FR_GENERATOR)
    perm_num = b.scale(z_l, 1)  # private copy: z_l is reused below
    for j in range(STATE_WIDTH):
        kj_beta = K_COLS[j] * beta % R
        perm_num = mul_chain(perm_num, b.add_scalar(
            b.scale_add(x_coset, kj_beta, wl.get(j)), gamma))
    del x_coset
    acc(b.scale(perm_num, alpha_pows[5]))
    del perm_num
    perm_den = b.rotate(z_l, LDE_FACTOR)
    for j in range(STATE_WIDTH):
        perm_den = mul_chain(perm_den, b.add_scalar(
            b.scale_add(ctx.lde(ctx.sigma_m[j]), beta, wl.get(j)), gamma))
    acc(b.scale(perm_den, (R - alpha_pows[5]) % R))
    del perm_den

    l0 = [0] * size
    l0[0] = 1
    l0_l = b.coset_lde(b.intt(b.from_ints(l0)), LDE_FACTOR)
    z_minus_1_l0 = b.mul(b.add_scalar(z_l, R - 1), l0_l)
    del l0_l, z_l
    acc(b.scale(z_minus_1_l0, alpha_pows[6]))
    del z_minus_1_l0
    wl.live.clear()

    # Z_H^-1 on the coset (period-LDE_FACTOR values)
    shift_pow = pow(FR_GENERATOR, size, R)
    eta_pow = pow(eta, size, R)
    van = []
    vacc = shift_pow
    for _ in range(LDE_FACTOR):
        van.append((vacc - 1) % R)
        vacc = vacc * eta_pow % R
    vanishing_inv = b.tile_small([fr_inv(v) for v in van], ext)

    t_l = b.mul(numerator, vanishing_inv)
    del numerator, vanishing_inv
    t_m = b.coset_intt(t_l)
    del t_l
    top = b.to_ints(b.slice(t_m, LDE_FACTOR * size - (LDE_FACTOR - 1), LDE_FACTOR * size))
    if any(top):
        raise ProverError("quotient degree check failed (unsatisfied witness?)")

    t_chunks = [b.slice(t_m, i * size, (i + 1) * size) for i in range(LDE_FACTOR)]
    t_comms = _commit_many(b, ctx.msm_ctx, t_chunks)
    _r3.__exit__(None, None, None)
    for p in t_comms:
        transcript.update_g1(p)
    zeta = transcript.get_challenge()

    # ---- round 4: evaluations + linearization --------------------------
    _r4 = stage("x r4 evaluations + linearization")
    _r4.__enter__()
    zeta_omega = zeta * omega % R
    # all 11 zeta evaluations in one fused program, both zeta*omega in a
    # second (see plonk.prover round 4)
    evals_z = _eval_many(
        b, [b.onload(m) for m in wires_m_host]
        + [b.onload(ctx.sigma_m[j]) for j in range(STATE_WIDTH - 1)]
        + t_chunks, zeta)
    wire_evals = evals_z[:STATE_WIDTH]
    a_z, b_z, c_z, d_z = wire_evals
    sigma_z = evals_z[STATE_WIDTH:2 * STATE_WIDTH - 1]
    t_chunk_z = evals_z[2 * STATE_WIDTH - 1:]
    d_zw, z_zw = _eval_many(
        b, [b.onload(wires_m_host[3]), b.onload(z_m_host)], zeta_omega)

    zeta_n = pow(zeta, size, R)
    t_z = 0
    power = 1
    for ez in t_chunk_z:
        t_z = (t_z + power * ez) % R
        power = power * zeta_n % R

    vanishing_z = (pow(zeta, size, R) - 1) % R
    l0_z = vanishing_z * fr_inv((zeta - 1) * size % R) % R

    gp_factor = (a_z + beta * zeta + gamma) % R
    for j in range(1, STATE_WIDTH):
        gp_factor = gp_factor * ((wire_evals[j] + K_COLS[j] * beta % R * zeta + gamma) % R) % R
    z_coeff = (gp_factor * alpha_pows[5] + l0_z * alpha_pows[6]) % R

    sigma_factor = alpha_pows[5] * beta % R * z_zw % R
    for j in range(STATE_WIDTH - 1):
        sigma_factor = sigma_factor * ((wire_evals[j] + beta * sigma_z[j] + gamma) % R) % R

    range_at_z = _range_terms_eval(a_z, b_z, c_z, d_z, d_zw, alpha)

    r_m = b.onload(ctx.sel_m[5])
    for j in range(STATE_WIDTH):
        r_m = b.scale_add(b.onload(ctx.sel_m[j]), wire_evals[j], r_m)
    r_m = b.scale_add(b.onload(ctx.sel_m[4]), a_z * b_z % R, r_m)
    r_m = b.scale_add(b.onload(ctx.sel_m[6]), d_zw, r_m)
    r_m = b.scale_add(b.onload(ctx.sel_m[Q_RANGE]), range_at_z, r_m)
    r_m = b.scale_add(b.onload(z_m_host), z_coeff, r_m)
    r_m = b.sub(r_m, b.scale(b.onload(ctx.sigma_m[STATE_WIDTH - 1]), sigma_factor))
    r_z = b.poly_eval(r_m, zeta)
    _r4.__exit__(None, None, None)

    for e in wire_evals:
        transcript.update_fr(e)
    transcript.update_fr(d_zw)
    for e in sigma_z:
        transcript.update_fr(e)
    transcript.update_fr(t_z)
    transcript.update_fr(r_z)
    transcript.update_fr(z_zw)
    v = transcript.get_challenge()

    # ---- round 5: opening proofs ---------------------------------------
    _r5 = stage("x r5 openings: 2 divisions + 2 commits")
    _r5.__enter__()
    t_agg = t_chunks[0]
    power = 1
    for ch in t_chunks[1:]:
        power = power * zeta_n % R
        t_agg = b.scale_add(ch, power, t_agg)

    agg = t_agg
    vpow = v
    agg = b.scale_add(r_m, vpow, agg)
    del r_m
    for m in wires_m_host:
        vpow = vpow * v % R
        agg = b.scale_add(b.onload(m), vpow, agg)
    for j in range(STATE_WIDTH - 1):
        vpow = vpow * v % R
        agg = b.scale_add(b.onload(ctx.sigma_m[j]), vpow, agg)
    w_z = b.divide_by_linear(agg, zeta)
    del agg

    v9 = pow(v, 9, R)
    agg_w = b.scale_add(b.onload(wires_m_host[3]), v9 * v % R,
                        b.scale(b.onload(z_m_host), v9))
    w_zw = b.divide_by_linear(agg_w, zeta_omega)
    opening_z, opening_zw = _commit_many(b, ctx.msm_ctx, [w_z, w_zw])
    del w_z
    _r5.__exit__(None, None, None)

    return Proof(
        n=n,
        num_inputs=setup.num_inputs,
        input_values=list(public_inputs),
        wire_commitments=wire_comms,
        grand_product_commitment=z_comm,
        quotient_poly_commitments=t_comms,
        wire_values_at_z=wire_evals,
        wire_values_at_z_omega=[d_zw],
        grand_product_at_z_omega=z_zw,
        quotient_polynomial_at_z=t_z,
        linearization_polynomial_at_z=r_z,
        permutation_polynomials_at_z=sigma_z,
        opening_at_z_proof=opening_z,
        opening_at_z_omega_proof=opening_zw,
    )


def _derive_challenges2(proof: Proof, transcript: str):
    t = make_transcript(transcript)
    for x in proof.input_values:
        t.update_u256(x)
    for p in proof.wire_commitments:
        t.update_g1(p)
    beta = t.get_challenge()
    gamma = t.get_challenge()
    t.update_g1(proof.grand_product_commitment)
    alpha = t.get_challenge()
    for p in proof.quotient_poly_commitments:
        t.update_g1(p)
    z = t.get_challenge()
    ev = (list(proof.wire_values_at_z) + list(proof.wire_values_at_z_omega)
          + list(proof.permutation_polynomials_at_z)
          + [proof.quotient_polynomial_at_z,
             proof.linearization_polynomial_at_z,
             proof.grand_product_at_z_omega])
    for e in ev:
        t.update_fr(e)
    v = t.get_challenge()
    t.update_g1(proof.opening_at_z_proof)
    t.update_g1(proof.opening_at_z_omega_proof)
    u = t.get_challenge()
    return beta, gamma, alpha, z, v, u


def prepare_pairing_pair2(vk: VerificationKey2, proof: Proof,
                          transcript: str = "keccak"):
    """Extended-system verifier up to (excluding) the final pairing.
    Mirrors verifier.prepare_pairing_pair with the shifted alpha powers and
    the range-selector linearization term."""
    from ..curve import G1_GEN, g1_add, g1_mul, g1_neg
    from .verifier import batch_evaluate_lagrange_polys
    if len(proof.input_values) != vk.num_inputs or vk.num_inputs < 1:
        return None
    domain_size = vk.domain_size
    omega = get_domain_omega(domain_size)

    beta, gamma, alpha, z, v, u = _derive_challenges2(proof, transcript)
    alpha_pows = [1] * 7
    for i in range(1, 7):
        alpha_pows[i] = alpha_pows[i - 1] * alpha % R
    lagrange_at_z = batch_evaluate_lagrange_polys(
        list(range(vk.num_inputs)), domain_size, omega, z)

    vanishing_at_z = (pow(z, domain_size, R) - 1) % R
    if vanishing_at_z == 0:
        return None
    lhs = vanishing_at_z * proof.quotient_polynomial_at_z % R

    rhs = proof.linearization_polynomial_at_z
    for i, x in enumerate(proof.input_values):
        rhs = (rhs + lagrange_at_z[i] * x) % R

    z_part = proof.grand_product_at_z_omega
    for i, s in enumerate(proof.permutation_polynomials_at_z):
        z_part = z_part * ((s * beta + gamma + proof.wire_values_at_z[i]) % R) % R
    z_part = z_part * ((gamma + proof.wire_values_at_z[STATE_WIDTH - 1]) % R) % R
    rhs = (rhs - z_part * alpha_pows[5]) % R

    l0_z = vanishing_at_z * fr_inv((z - 1) * domain_size % R) % R
    rhs = (rhs - l0_z * alpha_pows[6]) % R

    if lhs != rhs:
        return None

    # ---- reconstruct D ----
    power_for_z_omega_opening = 1 + 1 + STATE_WIDTH + (STATE_WIDTH - 1)
    d = vk.selector_commitments[STATE_WIDTH + 1]
    for i in range(STATE_WIDTH):
        d = g1_add(d, g1_mul(vk.selector_commitments[i], proof.wire_values_at_z[i]))
    d = g1_add(d, g1_mul(vk.selector_commitments[STATE_WIDTH],
                         proof.wire_values_at_z[0] * proof.wire_values_at_z[1] % R))
    d = g1_add(d, g1_mul(vk.next_step_selector_commitments[0],
                         proof.wire_values_at_z_omega[0]))
    range_at_z = _range_terms_eval(
        proof.wire_values_at_z[0], proof.wire_values_at_z[1],
        proof.wire_values_at_z[2], proof.wire_values_at_z[3],
        proof.wire_values_at_z_omega[0], alpha)
    d = g1_add(d, g1_mul(vk.range_selector_commitments[0], range_at_z))

    gp_part_at_z = (z * beta + proof.wire_values_at_z[0] + gamma) % R
    for i, k in enumerate(vk.non_residues):
        gp_part_at_z = gp_part_at_z * ((z * k % R * beta + gamma
                                        + proof.wire_values_at_z[i + 1]) % R) % R
    gp_part_at_z = gp_part_at_z * alpha_pows[5] % R
    gp_part_at_z = (gp_part_at_z + lagrange_at_z[0] * alpha_pows[6]) % R

    gp_part_at_z_omega = pow(v, power_for_z_omega_opening, R) * u % R

    last_perm_part_at_z = 1
    for i, s in enumerate(proof.permutation_polynomials_at_z):
        last_perm_part_at_z = last_perm_part_at_z * (
            (beta * s + gamma + proof.wire_values_at_z[i]) % R) % R
    last_perm_part_at_z = last_perm_part_at_z * beta % R \
        * proof.grand_product_at_z_omega % R * alpha_pows[5] % R

    tmp = g1_add(
        g1_mul(proof.grand_product_commitment, gp_part_at_z),
        g1_neg(g1_mul(vk.permutation_commitments[STATE_WIDTH - 1], last_perm_part_at_z)))
    d = g1_add(d, tmp)
    d = g1_mul(d, v)
    d = g1_add(d, g1_mul(proof.grand_product_commitment, gp_part_at_z_omega))

    # ---- batched KZG double opening ----
    z_in_domain_size = pow(z, domain_size, R)
    commitment_aggregation = proof.quotient_poly_commitments[0]
    tmp_fr = 1
    for i in range(1, len(proof.quotient_poly_commitments)):
        tmp_fr = tmp_fr * z_in_domain_size % R
        commitment_aggregation = g1_add(
            commitment_aggregation,
            g1_mul(proof.quotient_poly_commitments[i], tmp_fr))
    aggregation_challenge = v
    commitment_aggregation = g1_add(commitment_aggregation, d)
    for p in proof.wire_commitments:
        aggregation_challenge = aggregation_challenge * v % R
        commitment_aggregation = g1_add(commitment_aggregation,
                                        g1_mul(p, aggregation_challenge))
    for i in range(len(vk.permutation_commitments) - 1):
        aggregation_challenge = aggregation_challenge * v % R
        commitment_aggregation = g1_add(
            commitment_aggregation,
            g1_mul(vk.permutation_commitments[i], aggregation_challenge))
    aggregation_challenge = aggregation_challenge * v % R
    aggregation_challenge = aggregation_challenge * v % R
    commitment_aggregation = g1_add(
        commitment_aggregation,
        g1_mul(proof.wire_commitments[STATE_WIDTH - 1], aggregation_challenge * u % R))

    aggregation_challenge = v
    aggregated_value = proof.quotient_polynomial_at_z
    aggregated_value = (aggregated_value
                        + proof.linearization_polynomial_at_z * aggregation_challenge) % R
    for w in proof.wire_values_at_z:
        aggregation_challenge = aggregation_challenge * v % R
        aggregated_value = (aggregated_value + w * aggregation_challenge) % R
    for s in proof.permutation_polynomials_at_z:
        aggregation_challenge = aggregation_challenge * v % R
        aggregated_value = (aggregated_value + s * aggregation_challenge) % R
    aggregation_challenge = aggregation_challenge * v % R
    aggregated_value = (aggregated_value
                        + proof.grand_product_at_z_omega * aggregation_challenge % R * u) % R
    aggregation_challenge = aggregation_challenge * v % R
    aggregated_value = (aggregated_value
                        + proof.wire_values_at_z_omega[0] * aggregation_challenge % R * u) % R

    commitment_aggregation = g1_add(commitment_aggregation,
                                    g1_neg(g1_mul(G1_GEN, aggregated_value)))

    pair_with_generator = g1_add(commitment_aggregation,
                                 g1_mul(proof.opening_at_z_proof, z))
    pair_with_generator = g1_add(
        pair_with_generator,
        g1_mul(proof.opening_at_z_omega_proof, z * omega % R * u % R))
    pair_with_x = g1_add(g1_mul(proof.opening_at_z_omega_proof, u),
                         proof.opening_at_z_proof)
    pair_with_x = g1_neg(pair_with_x)
    return pair_with_generator, pair_with_x


def verify2(vk: VerificationKey2, proof: Proof, transcript: str = "keccak") -> bool:
    from ..curve import G2_GEN
    from ..native import bn254_pairing_check as pairing_check
    pair = prepare_pairing_pair2(vk, proof, transcript)
    if pair is None:
        return False
    g2_base = vk.g2_elements[0] if vk.g2_elements else G2_GEN
    g2_x = vk.g2_elements[1]
    return pairing_check([(pair[0], g2_base), (pair[1], g2_x)])
