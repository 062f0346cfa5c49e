"""PyTorch compute backend: the engine behind the port's PLONK prover,
ported from plonkit_tpu/backend_jax.py.

Vectors are `FrVec` handles over [N, 8] int32 Montgomery rows
(gpu/mont.py) that stay on the backend's device; python ints cross the
boundary only for file IO and transcript scalars.  Every field operation
goes through the kernel wrappers (gpu/field_kernels.py K1/K2/K4 and
the scans K12/K13, gpu/ntt.py K3/K5): on the card each is one kernel
launch, on the CPU the plain version.  The JAX package's scans (prefix
products, suffix sums, batch inverse) are one K12 launch each, a batch
inverse two K12 and one K13.  Its fused programs (_gate_residual_jit,
_quotient_column_jit, _perm_grand_product_jit) become sequences of
launches: each add(x, mul(a, b)) they compose from pk.mul/pk.add is one
K4 mul_add(a, b, x) here, the rest K1/K2; fusing longer chains is later
work.
Transforms take the NTT engine that PLONKIT_TPU_NTT names, as in
backend_jax: the tensor-core engine (gpu/ntt_mxu.py, K9-K11) or the Pease
butterflies (gpu/ntt.py, K3/K5).
Commitments of a backend on the card run on the card at every size
(gpu/msm.py over the MSM kernels K6-K8); a backend on the CPU commits in
the host Pippenger (backend.HostMSMContext), as backend_jax does on a CPU.
backend_jax's switch to the host at or below 4096 points is not taken
over: no crossover has been measured on the card.
"""

import os
from typing import List, Sequence

import numpy as np
import torch

from .backend import HostMSMContext
from .fields import FR_GENERATOR, FR_MODULUS as R, fr_inv, get_domain_omega
from .gpu import ec, field_kernels as fk, ntt as gntt, ntt_mxu as gmxu
from .gpu.mont import FQ, FR, NLIMBS, to_numpy, to_tensor
from .gpu.msm import MSMContext
from .profiling import stage

# Coset transforms at or above this many elements run as `factor` split
# n-point transforms (as backend_jax._SPLIT_NTT_MIN): 2^24 = the LDE of a
# 2^22 domain.
SPLIT_NTT_MIN = 1 << 24

# NTT engine selection, as backend_jax._NTT_ENGINE reads it: "auto" runs
# the tensor-core engine for transforms of 512 points or more on the card
# and the butterflies otherwise (on the CPU always); "mxu" and "pease" name
# one engine for every transform.  Each engine launches its own kernels or
# raises: the variable chooses, nothing falls back.  The variable and the
# 512-point threshold are the JAX package's, kept for parity; the threshold
# was not chosen from the H100's times (chip_smoke.py phase 15 times both
# engines per size).
_NTT_ENGINE = os.environ.get("PLONKIT_TPU_NTT", "auto")


def _use_mxu_ntt(n: int, device: torch.device) -> bool:
    if _NTT_ENGINE == "mxu":
        return True
    if _NTT_ENGINE == "pease":
        return False
    if _NTT_ENGINE != "auto":
        raise ValueError(f"PLONKIT_TPU_NTT={_NTT_ENGINE!r}: expected auto, mxu or pease")
    return n >= 512 and device.type == "cuda"


def _engine(op: str, n: int, device: torch.device):
    """The transform `op` (ntt, intt, coset_ntt, coset_intt, coset_lde) of
    the engine that runs n points on `device`."""
    return getattr(gmxu, op + "_mxu") if _use_mxu_ntt(n, device) else getattr(gntt, op)


class FrVec:
    """Device-resident vector of Fr elements (Montgomery form)."""

    __slots__ = ("data",)

    def __init__(self, data: torch.Tensor):
        self.data = data

    def __len__(self):
        return self.data.shape[0]


class TorchBackend:
    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TorchBackend: no CUDA device (the CPU path "
                               "must be asked for with device='cpu')")
        self._msm_cache = {}

    # -- helpers -----------------------------------------------------------

    def _const(self, k: int, n: int) -> torch.Tensor:
        return FR.const(k % R, n, self.device)

    def _mul(self, a, b):
        return fk.mul(FR, a, b)

    def _add(self, a, b):
        return fk.add(FR, a, b)

    def _mul_add(self, a, b, c):
        return fk.mul_add(FR, a, b, c)

    def _scale(self, a: torch.Tensor, k: int) -> torch.Tensor:
        return fk.mul_row(FR, a, FR.row(k, self.device))

    def _suffix_sums(self, v: torch.Tensor) -> torch.Tensor:
        """S_k = sum_{j>=k} v_j (one K12 launch)."""
        return fk.scan(FR, v, "add", reverse=True)

    def _vec(self, data: torch.Tensor, like=None) -> FrVec:
        """The handle of a result; `like` is an operand of the same length
        (parallel/backend_mesh.MeshBackend carries its global length)."""
        return FrVec(data)

    def _to_ints(self, data: torch.Tensor) -> List[int]:
        return FR.from_limbs_np(to_numpy(fk.from_mont(FR, data.contiguous())))

    # -- conversions ---------------------------------------------------------

    def from_ints(self, values: Sequence[int], pad_to: int = None) -> FrVec:
        vals = [v % R for v in values]
        if pad_to is not None and len(vals) < pad_to:
            vals += [0] * (pad_to - len(vals))
        return self.from_raw_limbs(FR.to_limbs_np(vals))

    def from_raw_limbs(self, raw: np.ndarray) -> FrVec:
        """[N, 8] uint32 raw (canonical) limb rows -> Montgomery vector."""
        return FrVec(fk.to_mont(FR, to_tensor(raw, self.device)))

    def zeros(self, n: int) -> FrVec:
        return FrVec(torch.zeros((n, NLIMBS), dtype=torch.int32, device=self.device))

    def to_ints(self, v: FrVec) -> List[int]:
        return self._to_ints(v.data)

    # -- NTT -----------------------------------------------------------------

    def ntt(self, v: FrVec) -> FrVec:
        return FrVec(_engine("ntt", len(v), self.device)(v.data))

    def intt(self, v: FrVec) -> FrVec:
        return FrVec(_engine("intt", len(v), self.device)(v.data))

    def coset_ntt(self, v: FrVec, shift: int = FR_GENERATOR) -> FrVec:
        if len(v) >= SPLIT_NTT_MIN and len(v) % 4 == 0:
            return self._coset_ntt_split(v, 4, shift)
        return FrVec(_engine("coset_ntt", len(v), self.device)(v.data, shift))

    def coset_intt(self, v: FrVec, shift: int = FR_GENERATOR) -> FrVec:
        if len(v) >= SPLIT_NTT_MIN and len(v) % 4 == 0:
            return self._coset_intt_split(v, 4, shift)
        return FrVec(_engine("coset_intt", len(v), self.device)(v.data, shift))

    def coset_lde(self, v: FrVec, factor: int, shift: int = FR_GENERATOR) -> FrVec:
        if len(v) * factor >= SPLIT_NTT_MIN:
            return self._coset_lde_split(v, factor, shift)
        return FrVec(_engine("coset_lde", len(v) * factor, self.device)(v.data, factor, shift))

    # -- split (workspace-bounded) large coset transforms --------------------
    # As backend_jax: LDE[F*t + j] = coset_ntt_n(p, g*eta^j)[t] with
    # eta = omega_{F*n}; the inverse recombines coset_intt_n(v[j::F],
    # g*eta^j) with a 4-point DFT across j (see backend_jax.py:458-468).
    # The coset NTT of a length-N vector v folds its F blocks of m = N/F
    # first: X[F*t + j] = coset_ntt_m(u_j, g*eta^j)[t] with eta = omega_N
    # and u_j = sum_q (g*eta^j)^(m*q) * v[q*m:(q+1)*m] (backend_jax's
    # coset_ntt has no split path).  The parts take the selected engine, as
    # backend_jax's call self.coset_ntt / self.coset_intt; here through
    # `_engine`, since MeshBackend's overrides take a shard, not a whole
    # vector.

    def _coset_ntt_split(self, v: FrVec, factor: int, shift: int) -> FrVec:
        total = len(v)
        m = total // factor
        eta = get_domain_omega(total)
        blocks = [v.data[q * m:(q + 1) * m] for q in range(factor)]
        parts = []
        for j in range(factor):
            s = shift * pow(eta, j, R) % R
            s_m = pow(s, m, R)
            u = blocks[0]
            for q in range(1, factor):
                u = self._mul_add(blocks[q], self._const(pow(s_m, q, R), m), u)
            parts.append(_engine("coset_ntt", m, self.device)(u, s))
        # [m, F, 8] -> [F*m, 8] puts part j at rows F*t + j
        return FrVec(torch.stack(parts, dim=1).reshape(total, NLIMBS))

    def _coset_lde_split(self, v: FrVec, factor: int, shift: int) -> FrVec:
        n = len(v)
        eta = get_domain_omega(factor * n)
        coset_ntt = _engine("coset_ntt", n, self.device)
        parts = [coset_ntt(v.data, shift * pow(eta, j, R) % R) for j in range(factor)]
        # [n, F, 8] -> [F*n, 8] puts part j at rows F*t + j
        return FrVec(torch.stack(parts, dim=1).reshape(factor * n, NLIMBS))

    def _coset_intt_split(self, v: FrVec, factor: int, shift: int) -> FrVec:
        total = len(v)
        n = total // factor
        eta = get_domain_omega(total)
        u_inv = fr_inv(pow(eta, n, R))
        g_n_inv = fr_inv(pow(shift, n, R))
        f_inv = fr_inv(factor)
        coset_intt = _engine("coset_intt", n, self.device)
        cs = [FrVec(coset_intt(v.data[j::factor].contiguous(), shift * pow(eta, j, R) % R))
              for j in range(factor)]
        chunks = []
        for m in range(factor):
            gm = pow(g_n_inv, m, R) * f_inv % R
            acc = self.scale(cs[0], gm)
            for j in range(1, factor):
                acc = self.scale_add(cs[j], gm * pow(u_inv, j * m, R) % R, acc)
            chunks.append(acc.data)
        return FrVec(torch.cat(chunks))

    # -- MSM ---------------------------------------------------------------

    def _cached_msm(self, key, size: int):
        ctx = self._msm_cache.get(key) if key is not None else None
        return ctx if ctx is not None and ctx.n >= size else None

    def msm_context_from_crs(self, crs, size: int, key=None):
        """MSM context over the first `size` SRS points, as
        backend_jax.msm_context_from_crs: the device MSM on the card at
        every size, the host Pippenger on the CPU.  On the card a CrsHandle's limb
        rows are carried over as they are and put in Montgomery form there
        by K1 over Fq (x R^2 mod q); a Crs goes through ec.affine_from_host.
        The host context reads a CrsHandle with numpy and packs a Crs from
        its points."""
        ctx = self._cached_msm(key, size)
        if ctx is not None:
            return ctx
        if self.device.type == "cpu":
            if hasattr(crs, "g1_limbs"):
                ctx = HostMSMContext.from_limbs(*crs.g1_limbs(size))
            else:
                ctx = HostMSMContext.from_points(crs.g1_bases[:size])
        else:
            ctx = self.device_msm_context(crs, size)
        if key is not None:
            self._msm_cache[key] = ctx
        return ctx

    def device_msm_context(self, crs, size: int) -> MSMContext:
        """gpu/msm.MSMContext on this backend's device over the first
        `size` SRS points (msm_context_from_crs takes it on the card; the
        CPU tests call it directly)."""
        if not hasattr(crs, "g1_limbs"):
            return MSMContext.from_device_affine(
                *ec.affine_from_host(crs.g1_bases[:size], self.device))
        x_raw, y_raw, inf = crs.g1_limbs(size)
        x = fk.to_mont(FQ, to_tensor(x_raw, self.device))
        y = fk.to_mont(FQ, to_tensor(y_raw, self.device))
        return MSMContext.from_device_affine(x, y, torch.from_numpy(inf).to(self.device))

    def commit(self, msm_ctx, v: FrVec):
        """KZG-commit.  A device context takes the Montgomery vector where it
        lies; the host context (a backend on the CPU) takes the canonical
        scalars as one [m, 32] byte array."""
        if isinstance(msm_ctx, MSMContext):
            return msm_ctx.msm_vec(v.data)
        return msm_ctx.msm_rows(to_numpy(fk.from_mont(FR, v.data.contiguous())).view(np.uint8))

    def commit_many(self, msm_ctx, vs: Sequence[FrVec]):
        """Several commitments: on a device context every MSM is queued,
        then one K8 launch combines them all and one copy brings the
        points back."""
        if isinstance(msm_ctx, MSMContext):
            with stage("msm"):
                return msm_ctx.msm_vec_end_many([msm_ctx.msm_vec_begin(v.data) for v in vs])
        return [self.commit(msm_ctx, v) for v in vs]

    # -- elementwise ---------------------------------------------------------

    def sub(self, a: FrVec, b: FrVec) -> FrVec:
        return self._vec(fk.sub(FR, a.data, b.data), a)

    def scale(self, a: FrVec, k: int) -> FrVec:
        return self._vec(self._scale(a.data, k), a)

    def scale_add(self, a: FrVec, k: int, c: FrVec) -> FrVec:
        """a * k + c (one K4 launch)."""
        return self._vec(self._mul_add(a.data, self._const(k, a.data.shape[0]), c.data), a)

    def mul(self, a: FrVec, b: FrVec) -> FrVec:
        return self._vec(self._mul(a.data, b.data), a)

    def add(self, a: FrVec, b: FrVec) -> FrVec:
        return self._vec(self._add(a.data, b.data), a)

    def add_scalar(self, a: FrVec, k: int) -> FrVec:
        """a + k (one K2a launch against a constant row)."""
        return self._vec(self._add(a.data, self._const(k, a.data.shape[0])), a)

    # -- accumulators of the extended prover (plonk/extended.py) -------------
    # backend_jax donates `acc` to these; here each returns a new buffer and
    # the caller drops `acc`, whose memory the caching allocator hands to the
    # next result.  The kernels take no aliased output.

    def fma_acc(self, acc: FrVec, x: FrVec, y: FrVec) -> FrVec:
        """acc + x * y (one K4 launch)."""
        return self._vec(self._mul_add(x.data, y.data, acc.data), acc)

    def add_into(self, acc: FrVec, t: FrVec) -> FrVec:
        return self.add(acc, t)

    def mul_into(self, acc: FrVec, t: FrVec) -> FrVec:
        return self.mul(acc, t)

    def grand_product(self, factors: FrVec) -> FrVec:
        """[1, f_0, f_0 f_1, ...]: the exclusive prefix products of the
        factors (one K12 launch)."""
        return FrVec(fk.scan(FR, factors.data, "mul", exclusive=True))

    # -- memory placement ------------------------------------------------------
    # The extended prover keeps monomial forms in host memory and brings
    # each back when a round needs it (as backend_jax's pull_np / push_dev).

    def offload(self, v: FrVec) -> torch.Tensor:
        """The vector's rows in host memory (pinned on a card, so `onload`
        copies back without staging); on the CPU the tensor itself."""
        if self.device.type == "cpu":
            return v.data
        host = torch.empty(v.data.shape, dtype=v.data.dtype, pin_memory=True)
        host.copy_(v.data)
        return host

    def onload(self, h) -> FrVec:
        if isinstance(h, FrVec):
            return h
        return FrVec(h.to(self.device, non_blocking=True))

    # -- composite rounds ----------------------------------------------------

    def gate_residual(self, sel_v, wires_v, pi_vec) -> FrVec:
        """q_a*a + q_b*b + q_c*c + q_d*d + q_m*a*b + q_const + q_dnext*rot(d)
        + PI, as backend_jax._gate_residual_jit."""
        mul, add, mul_add = self._mul, self._add, self._mul_add
        q = [s.data for s in sel_v]
        w = [x.data for x in wires_v]
        acc = mul_add(q[1], w[1], mul(q[0], w[0]))
        acc = mul_add(q[2], w[2], acc)
        acc = mul_add(q[3], w[3], acc)
        acc = mul_add(q[4], mul(w[0], w[1]), acc)
        acc = add(acc, q[5])
        acc = mul_add(q[6], self.rotate(wires_v[3], 1).data, acc)
        return self._vec(add(acc, pi_vec.data), pi_vec)

    def any_nonzero(self, v: FrVec) -> bool:
        return bool(torch.any(v.data != 0))

    def quotient_column(self, sel_l, wires_l, d_next_l, z_l, z_next_l,
                        pi_l, x_coset, sigma_l, l0_l, vanishing_inv,
                        beta: int, gamma: int, alpha: int, k_cols) -> FrVec:
        """Round 3's coset-domain pipeline, as
        backend_jax._quotient_column_jit: t = (gate + alpha*perm +
        alpha^2*(z-1)*L0) * Z_H^-1 over the LDE domain."""
        mul, add, mul_add = self._mul, self._add, self._mul_add
        n = z_l.data.shape[0]

        def bc(k):
            return self._const(k, n)
        sel = [s.data for s in sel_l]
        wires = [w.data for w in wires_l]
        gate = mul(sel[0], wires[0])
        gate = mul_add(sel[1], wires[1], gate)
        gate = mul_add(sel[2], wires[2], gate)
        gate = mul_add(sel[3], wires[3], gate)
        gate = mul_add(sel[4], mul(wires[0], wires[1]), gate)
        gate = add(gate, sel[5])
        gate = mul_add(sel[6], d_next_l.data, gate)
        gate = add(gate, pi_l.data)

        gamma_v, beta_v = bc(gamma), bc(beta)
        perm_num = z_l.data
        perm_den = z_next_l.data
        for j, k in enumerate(k_cols):
            w_gamma = add(wires[j], gamma_v)
            t_n = mul_add(x_coset.data, bc(k * beta), w_gamma)
            t_d = mul_add(sigma_l[j].data, beta_v, w_gamma)
            perm_num = mul(perm_num, t_n)
            perm_den = mul(perm_den, t_d)
        perm = fk.sub(FR, perm_num, perm_den)

        numerator = mul_add(perm, bc(alpha), gate)
        z_minus_1_l0 = mul(add(z_l.data, bc(R - 1)), l0_l.data)
        numerator = mul_add(z_minus_1_l0, bc(alpha * alpha), numerator)
        return self._vec(mul(numerator, vanishing_inv.data), z_l)

    def permutation_grand_product(self, omega_pows, sigma_v, wires_v,
                                  beta: int, gamma: int, k_cols) -> FrVec:
        """Round 2: z = grand_product(prod_j (k_j*beta*X + w_j + gamma) /
        prod_j (beta*sigma_j + w_j + gamma)), as
        backend_jax._perm_grand_product_jit."""
        mul, add, mul_add = self._mul, self._add, self._mul_add
        n = wires_v[0].data.shape[0]
        gamma_v, beta_v = self._const(gamma, n), self._const(beta, n)
        num = den = None
        for j, k in enumerate(k_cols):
            w_gamma = add(wires_v[j].data, gamma_v)
            t_n = mul_add(omega_pows.data, self._const(k * beta, n), w_gamma)
            t_d = mul_add(sigma_v[j].data, beta_v, w_gamma)
            num = t_n if num is None else mul(num, t_n)
            den = t_d if den is None else mul(den, t_d)
        return self.grand_product(self._vec(mul(num, fk.batch_inverse(FR, den)), wires_v[0]))

    def batch_inverse(self, v: FrVec) -> FrVec:
        return self._vec(fk.batch_inverse(FR, v.data), v)

    def powers(self, base: int, n: int) -> FrVec:
        return FrVec(gntt.powers(base % R, n, self.device))

    def perm_from_labels(self, label_idx) -> List[FrVec]:
        """Sigma value vectors from the [4, size] label-index array (label
        c*size + r == K_COLS[c] * omega^r): one powers table, four scalings
        and four gathers."""
        table = self._label_table(int(label_idx.shape[1]))
        idx = torch.from_numpy(np.ascontiguousarray(label_idx, dtype=np.int64)).to(self.device)
        return [FrVec(table.index_select(0, row)) for row in idx]

    def _label_table(self, size: int) -> torch.Tensor:
        """[4 * size, 8]: row c*size + r holds K_COLS[c] * omega^r."""
        from .plonk.setup import K_COLS
        pows = gntt.powers(get_domain_omega(size), size, self.device)
        return torch.cat([self._scale(pows, k) for k in K_COLS])

    def poly_eval(self, coeffs: FrVec, x: int) -> int:
        return self.poly_eval_many([coeffs], x)[0]

    def poly_eval_many(self, polys: Sequence[FrVec], x: int) -> List[int]:
        """All polynomials (same length) at one point: one powers table,
        one K1 product per polynomial, then carry-deferred limb sums: the
        Montgomery products are summed limb by limb as plain integers in
        int64 (n * 2^32 < 2^63 for n < 2^31) and reduced mod p once on the
        host, as backend_jax._eval_many_jit does in u32 halves."""
        n = len(polys[0])
        if any(len(p) != n for p in polys):
            raise ValueError("poly_eval_many: polynomials of unequal length")
        return self._reduce_limb_sums(self._limb_sums(polys, gntt.powers(x % R, n, self.device)))

    def _limb_sums(self, polys, pows: torch.Tensor) -> torch.Tensor:
        """[P, 8] int64: the limbs of each polynomial's products with pows,
        summed column by column without carries."""
        return torch.stack([
            (self._mul(p.data.contiguous(), pows).to(torch.int64) & 0xFFFFFFFF).sum(dim=0)
            for p in polys])

    @staticmethod
    def _reduce_limb_sums(sums: torch.Tensor) -> List[int]:
        inv_r = pow(1 << 256, -1, R)
        return [sum(int(s) << (32 * i) for i, s in enumerate(row)) % R * inv_r % R
                for row in sums.cpu().tolist()]

    def divide_by_linear(self, coeffs: FrVec, point: int) -> FrVec:
        """Quotient of p(X) / (X - point), remainder dropped:
        q_k = z^-(k+1) * S_{k+1} where S_k = suffix sum of c_j z^j."""
        n = len(coeffs)
        z_pows = gntt.powers(point % R, n, self.device)
        # S_{k+1}: the exclusive suffix sums (one K12 launch)
        s_next = fk.scan(FR, self._mul(coeffs.data.contiguous(), z_pows), "add", reverse=True,
                         exclusive=True)
        zinv = fr_inv(point % R)
        zi_shift = self._scale(gntt.powers(zinv, n, self.device), zinv)  # z^-(k+1)
        return FrVec(self._mul(s_next, zi_shift)[:n - 1])

    # -- structural ----------------------------------------------------------

    def slice(self, v: FrVec, start: int, stop: int) -> FrVec:
        return FrVec(v.data[start:stop])

    def concat(self, vs: Sequence[FrVec]) -> FrVec:
        return FrVec(torch.cat([v.data for v in vs]))

    def rotate(self, v: FrVec, k: int) -> FrVec:
        return FrVec(torch.roll(v.data, -k, dims=0))

    def tile_small(self, values: Sequence[int], total: int) -> FrVec:
        base = to_tensor(FR.to_mont_np([v % R for v in values]), self.device)
        reps = -(-total // base.shape[0])
        return FrVec(base.repeat(reps, 1)[:total])
