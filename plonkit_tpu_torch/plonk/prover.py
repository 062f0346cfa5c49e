"""PLONK prover for the width-4 + D-next system.

Behavioral parity: bellman_ce better_cs prover (prove / prove_by_steps,
SURVEY D1g).  Deterministic (no blinding) -- the reference's own bar is
byte-identical proof.bin across runs (src/tests.rs:68-72), which this
implementation meets (tests/test_golden.py).

Protocol (matches the verifier spec contrib/template.sol:309-786):
  round 1: wire polynomials a,b,c,d -- iNTT + 4 MSM commitments
  round 2: permutation grand product z(X)  (parallel prefix scan) -- MSM
  round 3: quotient t(X) on a 4x coset LDE, split into 4 chunks -- 4 MSMs
  round 4: evaluations at zeta / zeta*omega; linearization r(X)
  round 5: two batched KZG opening quotients -- 2 MSMs

All O(n) math is expressed through the compute backend (host python ints or
the torch backend -- backend_torch.TorchBackend keeps every vector on the
card).
"""

from typing import List

from ..fields import FR_MODULUS as R, FR_GENERATOR, fr_inv, get_domain_omega
from ..profiling import stage
from ..serialization import Crs, Proof
from ..transcript import make_transcript
from .setup import K_COLS, STATE_WIDTH, SetupPolynomials

LDE_FACTOR = 4


class ProvingError(Exception):
    pass


def _validate_on_backend(b, sel_v, wires_v, pi_vec) -> None:
    """Gate-identity satisfaction over prepared backend vectors (one fused
    device program + a single-scalar any-nonzero pull; the per-row python
    loop took ~30 s at 2^20 inside every prove).  Works for any backend —
    HostBackend's list ops included."""
    acc = b.gate_residual(sel_v, wires_v, pi_vec)
    if b.any_nonzero(acc):
        vals = b.to_ints(acc)
        row = next(i for i, v in enumerate(vals) if v)
        raise ProvingError(
            f"constraint system is not satisfied at row {row}")


def validate_witness(setup: SetupPolynomials, wire_columns: List[List[int]],
                     public_inputs: List[int], backend=None) -> None:
    """Equivalent of is_satisfied_using_one_shot_check (src/plonk.rs:127-129)."""
    size = setup.domain_size
    if backend is not None:
        b = backend
        _validate_on_backend(
            b,
            [b.from_ints(q) for q in setup.selectors],
            [b.from_ints(col, pad_to=size) for col in wire_columns],
            b.from_ints(list(public_inputs), pad_to=size))
        return
    cols = [list(col) + [0] * (size - len(col)) for col in wire_columns]
    q = setup.selectors
    for row in range(size):
        d_next = cols[3][(row + 1) % size]
        pi = public_inputs[row] if row < len(public_inputs) else 0
        acc = (
            q[0][row] * cols[0][row] + q[1][row] * cols[1][row]
            + q[2][row] * cols[2][row] + q[3][row] * cols[3][row]
            + q[4][row] * cols[0][row] * cols[1][row]
            + q[5][row] + q[6][row] * d_next + pi
        ) % R
        if acc != 0:
            raise ProvingError(f"constraint system is not satisfied at row {row}")


def sigma_value_vectors(setup: SetupPolynomials, b):
    """Device sigma value vectors: built from the label-index array when the
    backend supports it (one pow-scan + 4 gathers, no python-int conversion
    — SetupPolynomials docstring), else via dedup limb conversion of the
    materialized int view."""
    idx = getattr(setup, "perm_label_idx", None)
    if idx is not None and hasattr(b, "perm_from_labels"):
        return b.perm_from_labels(idx)
    from ..backend import from_ints_dedup
    return [from_ints_dedup(b, s) for s in setup.permutations]


def _commit_many(b, msm_ctx, vs):
    """Batched commits when the backend supports it (queue all programs,
    then resolve flags), per-commit otherwise."""
    f = getattr(b, "commit_many", None)
    if f is not None:
        return f(msm_ctx, vs)
    return [b.commit(msm_ctx, v) for v in vs]


def _eval_many(b, polys, x):
    f = getattr(b, "poly_eval_many", None)
    if f is not None:
        return f(polys, x)
    return [b.poly_eval(p, x) for p in polys]


class ProverContext:
    """Device-resident prover state reusable across proofs for one circuit:
    setup polynomials (value + monomial + LDE forms) and the SRS MSM tables."""

    def __init__(self, setup: SetupPolynomials, crs: Crs, backend=None,
                 crs_lagrange: Crs = None):
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
        # lagrange-form fast path (reference: `prove` vs `prove_by_steps`,
        # src/plonk.rs:140-170): value-form polynomials commit directly over
        # L_i(tau)*G bases, skipping their iNTT->monomial hop for the MSM
        self.lagrange_msm_ctx = None
        if crs_lagrange is not None:
            num_l = getattr(crs_lagrange, "num_g1", None) or len(crs_lagrange.g1_bases)
            if num_l < size:
                raise ValueError("lagrange SRS too small for circuit")
            self.lagrange_msm_ctx = backend.msm_context_from_crs(
                crs_lagrange, size, key=("srs-l", id(crs_lagrange), size))
        from ..backend import from_ints_dedup
        b = backend
        # setup polynomials repeat few distinct coefficients: dedup limb
        # conversion (see backend.from_ints_dedup)
        self.sel_v = [from_ints_dedup(b, s) for s in setup.selectors]
        self.sel_m = [b.intt(v) for v in self.sel_v]
        self.sigma_v = sigma_value_vectors(setup, b)
        self.sigma_m = [b.intt(v) for v in self.sigma_v]
        self.sel_l = [b.coset_lde(m, LDE_FACTOR) for m in self.sel_m]
        self.sigma_l = [b.coset_lde(m, LDE_FACTOR) for m in self.sigma_m]
        # L_0 over the coset LDE
        l0 = [0] * size
        l0[0] = 1
        self.l0_l = b.coset_lde(b.intt(b.from_ints(l0)), LDE_FACTOR)
        # coset point vector: X = g * eta^t over the 4N domain
        ext = LDE_FACTOR * size
        eta = get_domain_omega(ext)
        self.x_coset = b.scale(b.powers(eta, ext), FR_GENERATOR)
        # Z_H^-1 on the coset (period-4 values)
        shift_pow = pow(FR_GENERATOR, size, R)
        eta_pow = pow(eta, size, R)
        van = []
        acc = shift_pow
        for _ in range(LDE_FACTOR):
            van.append((acc - 1) % R)
            acc = acc * eta_pow % R
        van_inv = [fr_inv(v) for v in van]
        self.vanishing_inv = b.tile_small(van_inv, ext)
        self.omega = get_domain_omega(size)
        self.omega_pows = b.powers(self.omega, size)


def prove(setup: SetupPolynomials, wire_columns: List[List[int]],
          public_inputs: List[int], crs: Crs = None, backend=None,
          ctx: ProverContext = None, skip_validation: bool = False,
          transcript: str = "keccak") -> Proof:
    if ctx is None:
        ctx = ProverContext(setup, crs, backend)
    b = ctx.backend
    size = setup.domain_size
    n = setup.n
    omega = ctx.omega

    # one host->device conversion per wire, shared by the satisfaction
    # check and round 1 (the transfer, not the math, is the cost).
    # Columns may arrive pre-built as backend vectors (SetupForProver's
    # raw-limb fast path) — anything that isn't a plain int list is
    # assumed device-ready.
    with stage("witness transfer"):
        wires_v = [col if not isinstance(col, list)
                   else b.from_ints(col, pad_to=size)
                   for col in wire_columns]
        pi_vec = b.from_ints(list(public_inputs), pad_to=size)

    if not skip_validation:
        with stage("witness satisfaction check"):
            _validate_on_backend(b, ctx.sel_v, wires_v, pi_vec)

    transcript = make_transcript(transcript)
    for x in public_inputs:
        transcript.update_u256(x)

    # ---- round 1: wire polynomials -------------------------------------
    with stage("r1 wires: intt + 4 commits"):
        wires_m = [b.intt(v) for v in wires_v]
        if ctx.lagrange_msm_ctx is not None:
            wire_comms = _commit_many(b, ctx.lagrange_msm_ctx, wires_v)
        else:
            wire_comms = _commit_many(b, ctx.msm_ctx, wires_m)
    for p in wire_comms:
        transcript.update_g1(p)
    beta = transcript.get_challenge()
    gamma = transcript.get_challenge()

    # ---- round 2: grand product ----------------------------------------
    with stage("r2 grand product + commit"):
        z_v = b.permutation_grand_product(ctx.omega_pows, ctx.sigma_v,
                                          wires_v, beta, gamma, K_COLS)
        z_m = b.intt(z_v)
        if ctx.lagrange_msm_ctx is not None:
            z_comm = b.commit(ctx.lagrange_msm_ctx, z_v)
        else:
            z_comm = b.commit(ctx.msm_ctx, z_m)
    transcript.update_g1(z_comm)
    alpha = transcript.get_challenge()

    # ---- round 3: quotient ---------------------------------------------
    _r3 = stage("r3 quotient: LDEs + 4 commits")
    _r3.__enter__()
    wires_l = [b.coset_lde(m, LDE_FACTOR) for m in wires_m]
    z_l = b.coset_lde(z_m, LDE_FACTOR)

    pi_l = b.coset_lde(b.intt(pi_vec), LDE_FACTOR)

    d_next_l = b.rotate(wires_l[3], LDE_FACTOR)
    z_next_l = b.rotate(z_l, LDE_FACTOR)

    alpha2 = alpha * alpha % R
    t_l = b.quotient_column(ctx.sel_l, wires_l, d_next_l, z_l, z_next_l,
                            pi_l, ctx.x_coset, ctx.sigma_l, ctx.l0_l,
                            ctx.vanishing_inv, beta, gamma, alpha, K_COLS)
    t_m = b.coset_intt(t_l)
    # t has degree <= 4n - 1 < 4(n+1); the top coefficients must vanish
    top = b.to_ints(b.slice(t_m, LDE_FACTOR * size - (LDE_FACTOR - 1), LDE_FACTOR * size))
    if any(top):
        raise ProvingError("quotient degree check failed (unsatisfied witness?)")

    t_chunks = [b.slice(t_m, i * size, (i + 1) * size) for i in range(LDE_FACTOR)]
    t_comms = _commit_many(b, ctx.msm_ctx, t_chunks)
    _r3.__exit__(None, None, None)
    for p in t_comms:
        transcript.update_g1(p)
    zeta = transcript.get_challenge()

    # ---- round 4: evaluations + linearization --------------------------
    _r4 = stage("r4 evaluations + linearization")
    _r4.__enter__()
    zeta_omega = zeta * omega % R
    # all 11 zeta evaluations in one fused program, both zeta*omega
    # evaluations in a second — instead of 13 serial powers-scan + pull
    # round trips
    evals_z = _eval_many(
        b, wires_m + [ctx.sigma_m[j] for j in range(STATE_WIDTH - 1)]
        + t_chunks, zeta)
    wire_evals = evals_z[:STATE_WIDTH]
    a_z, b_z, c_z, d_z = wire_evals
    sigma_z = evals_z[STATE_WIDTH:STATE_WIDTH + STATE_WIDTH - 1]
    t_chunk_z = evals_z[STATE_WIDTH + STATE_WIDTH - 1:]
    d_zw, z_zw = _eval_many(b, [wires_m[3], z_m], zeta_omega)

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
    z_coeff = (gp_factor * alpha + l0_z * alpha2) % R

    sigma_factor = alpha * beta % R * z_zw % R
    for j in range(STATE_WIDTH - 1):
        sigma_factor = sigma_factor * ((wire_evals[j] + beta * sigma_z[j] + gamma) % R) % R

    r_m = ctx.sel_m[5]
    for j in range(STATE_WIDTH):
        r_m = b.scale_add(ctx.sel_m[j], wire_evals[j], r_m)
    r_m = b.scale_add(ctx.sel_m[4], a_z * b_z % R, r_m)
    r_m = b.scale_add(ctx.sel_m[6], d_zw, r_m)
    r_m = b.scale_add(z_m, z_coeff, r_m)
    r_m = b.sub(r_m, b.scale(ctx.sigma_m[STATE_WIDTH - 1], sigma_factor))
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
    _r5 = stage("r5 openings: 2 divisions + 2 commits")
    _r5.__enter__()
    t_agg = t_chunks[0]
    power = 1
    for ch in t_chunks[1:]:
        power = power * zeta_n % R
        t_agg = b.scale_add(ch, power, t_agg)

    agg = t_agg
    vpow = v
    agg = b.scale_add(r_m, vpow, agg)
    for m in wires_m:
        vpow = vpow * v % R
        agg = b.scale_add(m, vpow, agg)
    for j in range(STATE_WIDTH - 1):
        vpow = vpow * v % R
        agg = b.scale_add(ctx.sigma_m[j], vpow, agg)
    w_z = b.divide_by_linear(agg, zeta)

    v9 = pow(v, 9, R)
    agg_w = b.scale_add(wires_m[3], v9 * v % R, b.scale(z_m, v9))
    w_zw = b.divide_by_linear(agg_w, zeta_omega)
    opening_z, opening_zw = _commit_many(b, ctx.msm_ctx, [w_z, w_zw])
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
