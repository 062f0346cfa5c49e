"""Mesh-sharded compute backend: the port's multi-rank engine behind the
same PLONK prover (plonkit_tpu/parallel/backend_mesh.py MeshBackend).

`MeshBackend` is a TorchBackend over a parallel/mesh.Mesh, so
plonk/prover.py and plonk/setup.py run unchanged with one rank per
process.  Every rank runs the prover's python: the scalars that cross the
backend (evaluations, commitments) are the same on every rank, and so is
the transcript.  A vector of n rows is a domain shard when n >= D and D
divides n (rank r holds rows [r n/D, (r + 1) n/D)), and replicated
otherwise (`Mesh.sharded`); `MeshVec` carries its global length.

The JAX package inherits JaxBackend's scans, evaluations and rolls and
lets XLA's SPMD partitioner write their communication.  PyTorch has no
partitioner, so the Backend protocol (backend.py) falls into three groups:

- local on the shard, inherited from TorchBackend: mul, add, sub, scale,
  scale_add, add_scalar, fma_acc, add_into, mul_into, batch_inverse
  (Montgomery's trick on a shard gives the same inverses), quotient_column
  (its d_next and z_next arrive rotated), gate_residual (through `rotate`)
  and permutation_grand_product (through `grand_product`); here:
  from_ints, from_raw_limbs, tile_small and zeros, where each rank makes
  its own block, and offload / onload, which keep the rank's block;
- a collective written out: the NTT family through parallel/ntt.py (the
  4-step, when can_distribute; else on the gathered vector), grand_product
  (local prefix products times the exclusive product of the lower shards'
  totals), divide_by_linear (local suffix sums plus the higher shards'
  totals, z powers from the rank's global offset), poly_eval_many (local
  carry-deferred limb sums, gathered and reduced once on the host),
  powers (the block starts at base^(rank n/D)), rotate (the next rank's
  first k rows), any_nonzero (an all-reduce), and commit / commit_many:
  parallel/msm.DistributedMSMContext on the card at every size, the host
  Pippenger over the gathered scalars on a CPU mesh (as the JAX package's
  CPU mesh commits on the host);
- gathered: to_ints, slice, concat, and perm_from_labels, which builds the
  replicated 4n label table and takes its block.

`distributed` and `gathered` count the calls of each operation that took
the collective path and the gathered one.
"""

from collections import Counter
from typing import List, Sequence

import numpy as np
import torch

from ..backend_torch import FrVec, TorchBackend
from ..fields import FR_GENERATOR, FR_MODULUS as R, fr_inv
from ..gpu import field_kernels as fk
from ..gpu.mont import FR, NLIMBS, to_tensor
from ..profiling import stage
from .mesh import make_mesh
from .msm import DistributedMSMContext
from .ntt import can_distribute, coset_powers, distributed_ntt
from .prove_step import distributed_grand_product


class MeshVec(FrVec):
    """This rank's rows of a vector of `n` rows (its block, or all of it)."""

    __slots__ = ("n",)

    def __init__(self, data: torch.Tensor, n: int):
        super().__init__(data)
        self.n = n

    def __len__(self):
        return self.n


class MeshBackend(TorchBackend):
    name = "mesh"

    def __init__(self, mesh=None, device="cuda"):
        super().__init__(device if mesh is None else mesh.device)
        self.mesh = make_mesh(self.device) if mesh is None else mesh
        self.D, self.rank = self.mesh.size, self.mesh.rank
        self.distributed, self.gathered = Counter(), Counter()

    # -- placement -----------------------------------------------------------

    def _vec(self, data: torch.Tensor, like=None) -> MeshVec:
        return MeshVec(data, len(like))

    def _place(self, full: torch.Tensor) -> MeshVec:
        """A vector every rank holds whole -> its placement."""
        lo, hi = self.mesh.block(full.shape[0])
        return MeshVec(full[lo:hi], full.shape[0])

    def _gathered(self, op: str, v: MeshVec) -> torch.Tensor:
        """The whole vector on every rank: an all_gather of a shard
        (counted under `op`), a replicated vector as it is."""
        if not self.mesh.sharded(len(v)):
            return v.data
        self.gathered[op] += 1
        return self.mesh.all_gather(v.data)

    # -- conversions ---------------------------------------------------------

    def from_ints(self, values: Sequence[int], pad_to: int = None) -> MeshVec:
        n = max(len(values), pad_to or 0)
        lo, hi = self.mesh.block(n)
        vals = [v % R for v in values[lo:hi]]
        vals += [0] * (hi - lo - len(vals))
        return MeshVec(TorchBackend.from_raw_limbs(self, FR.to_limbs_np(vals)).data, n)

    def from_raw_limbs(self, raw: np.ndarray) -> MeshVec:
        lo, hi = self.mesh.block(raw.shape[0])
        return MeshVec(TorchBackend.from_raw_limbs(self, raw[lo:hi]).data, raw.shape[0])

    def to_ints(self, v: MeshVec) -> List[int]:
        return self._to_ints(self._gathered("to_ints", v))

    def zeros(self, n: int) -> MeshVec:
        lo, hi = self.mesh.block(n)
        return MeshVec(TorchBackend.zeros(self, hi - lo).data, n)

    def tile_small(self, values: Sequence[int], total: int) -> MeshVec:
        lo, hi = self.mesh.block(total)
        base = to_tensor(FR.to_mont_np([v % R for v in values]), self.device)
        idx = torch.arange(lo, hi, device=self.device) % base.shape[0]
        return MeshVec(base.index_select(0, idx), total)

    def offload(self, v: MeshVec) -> MeshVec:
        """This rank's rows in host memory (pinned on a card)."""
        return MeshVec(TorchBackend.offload(self, v), len(v))

    def onload(self, h: MeshVec) -> MeshVec:
        return MeshVec(h.data.to(self.device, non_blocking=True), len(h))

    # -- NTT family ----------------------------------------------------------

    def _transform(self, op: str, v: MeshVec, n: int, inverse: bool, shift: int = None,
                   whole=None) -> MeshVec:
        """The 4-step transform of n points when it distributes, with the
        coset scaling by shift^i before a forward one and by shift^-i after
        an inverse one; else `whole` on the gathered vector."""
        if not (self.mesh.sharded(len(v)) and can_distribute(n, self.D, len(v))):
            return self._place(whole(FrVec(self._gathered(op, v))).data)
        self.distributed[op] += 1
        x = v.data
        if shift is not None and not inverse:
            x = fk.mul(FR, x, coset_powers(shift % R, len(v), self.D, self.rank, str(self.device)))
        y = distributed_ntt(x, self.mesh, n, inverse)
        if shift is not None and inverse:
            y = fk.mul(FR, y, coset_powers(fr_inv(shift % R), n, self.D, self.rank,
                                           str(self.device)))
        return MeshVec(y, n)

    def ntt(self, v: MeshVec) -> MeshVec:
        return self._transform("ntt", v, len(v), False, whole=super().ntt)

    def intt(self, v: MeshVec) -> MeshVec:
        return self._transform("intt", v, len(v), True, whole=super().intt)

    def coset_ntt(self, v: MeshVec, shift: int = FR_GENERATOR) -> MeshVec:
        return self._transform("coset_ntt", v, len(v), False, shift,
                               whole=lambda u: TorchBackend.coset_ntt(self, u, shift))

    def coset_intt(self, v: MeshVec, shift: int = FR_GENERATOR) -> MeshVec:
        return self._transform("coset_intt", v, len(v), True, shift,
                               whole=lambda u: TorchBackend.coset_intt(self, u, shift))

    def coset_lde(self, v: MeshVec, factor: int, shift: int = FR_GENERATOR) -> MeshVec:
        return self._transform("coset_lde", v, len(v) * factor, False, shift,
                               whole=lambda u: TorchBackend.coset_lde(self, u, factor, shift))

    # -- scans, evaluations, rotations -----------------------------------------

    def grand_product(self, factors: MeshVec) -> MeshVec:
        """[1, f_0, f_0 f_1, ...]: each shard's shifted prefix products
        times the product of the lower shards' factors."""
        if not self.mesh.sharded(len(factors)):
            return MeshVec(super().grand_product(factors).data, len(factors))
        self.distributed["grand_product"] += 1
        return MeshVec(distributed_grand_product(factors.data, self.mesh), len(factors))

    def powers(self, base: int, n: int) -> MeshVec:
        if not self.mesh.sharded(n):
            return MeshVec(super().powers(base, n).data, n)
        self.distributed["powers"] += 1
        return MeshVec(coset_powers(base % R, n, self.D, self.rank, str(self.device)), n)

    def poly_eval_many(self, polys: Sequence[MeshVec], x: int) -> List[int]:
        """Each rank sums its products limb by limb in int64 (as
        TorchBackend.poly_eval_many) with powers from its global offset;
        one all_gather of the [P, 8] sums, reduced mod p on the host."""
        n = len(polys[0])
        if any(len(p) != n for p in polys):
            raise ValueError("poly_eval_many: polynomials of unequal length")
        sums = self._limb_sums(polys, self.powers(x, n).data)
        if self.mesh.sharded(n):
            self.distributed["poly_eval_many"] += 1
            sums = self.mesh.all_gather(sums[None]).sum(dim=0)
        return self._reduce_limb_sums(sums)

    def divide_by_linear(self, coeffs: MeshVec, point: int) -> MeshVec:
        """q_k = z^-(k+1) * S_{k+1}, S_k = sum_{j>=k} c_j z^j: each shard's
        suffix sums plus the higher shards' totals.  The quotient has n - 1
        rows, which D > 1 does not divide: it is gathered, and replicated."""
        n = len(coeffs)
        if not self.mesh.sharded(n):
            return MeshVec(super().divide_by_linear(FrVec(coeffs.data), point).data, n - 1)
        self.distributed["divide_by_linear"] += 1
        z = point % R
        zinv = fr_inv(z)
        terms = self._mul(coeffs.data.contiguous(), self.powers(z, n).data)
        suffix = self._suffix_sums(terms)
        # the sum of the higher shards' terms: the exclusive scan of the
        # totals in reversed rank order
        totals = self.mesh.all_gather(suffix[:1])
        later = self._const(0, 1)
        for s in range(self.rank + 1, self.D):
            later = self._add(later, totals[s:s + 1])
        suffix = self._add(suffix, later.expand_as(suffix).contiguous())
        s_next = torch.cat([suffix[1:], later])
        zi_shift = self._scale(self.powers(zinv, n).data, zinv)          # z^-(k+1)
        q = MeshVec(self._mul(s_next, zi_shift), n)
        if self.D == 1:
            return MeshVec(q.data[:n - 1], n - 1)
        return self._place(self._gathered("divide_by_linear", q)[:n - 1])

    def rotate(self, v: MeshVec, k: int) -> MeshVec:
        """Row i of the result is row i + k (mod n): a shard's own rows from
        k on, then the next rank's first k rows."""
        n = len(v)
        k %= n
        b = v.data.shape[0]
        if not self.mesh.sharded(n) or not k:
            return MeshVec(torch.roll(v.data, -k, dims=0), n)
        if k > b:
            return self._place(torch.roll(self._gathered("rotate", v), -k, dims=0))
        self.distributed["rotate"] += 1
        heads = self.mesh.all_gather(v.data[:k])
        nxt = (self.rank + 1) % self.D
        return MeshVec(torch.cat([v.data[k:], heads[nxt * k:(nxt + 1) * k]]), n)

    def any_nonzero(self, v: MeshVec) -> bool:
        local = bool(torch.any(v.data != 0))
        if not self.mesh.sharded(len(v)):
            return local
        self.distributed["any_nonzero"] += 1
        return self.mesh.any(local)

    # -- structural ------------------------------------------------------------

    def slice(self, v: MeshVec, start: int, stop: int) -> MeshVec:
        return self._place(self._gathered("slice", v)[start:stop])

    def concat(self, vs: Sequence[MeshVec]) -> MeshVec:
        return self._place(torch.cat([self._gathered("concat", v) for v in vs]))

    def perm_from_labels(self, label_idx) -> List[MeshVec]:
        """Every rank builds the replicated 4n label table (label c*size + r
        == K_COLS[c] * omega^r) and takes its block's rows."""
        size = int(label_idx.shape[1])
        lo, hi = self.mesh.block(size)
        self.gathered["perm_from_labels"] += 1
        table = self._label_table(size)
        idx = torch.from_numpy(np.ascontiguousarray(label_idx[:, lo:hi], dtype=np.int64))
        return [MeshVec(table.index_select(0, row), size) for row in idx.to(self.device)]

    # -- MSM -------------------------------------------------------------------

    def msm_context_from_crs(self, crs, size: int, key=None):
        """DistributedMSMContext over this rank's block of the first `size`
        SRS points on the card (a CrsHandle's limb rows carried over and put
        in Montgomery form there by K1 over Fq); the host Pippenger over all
        of them on a CPU mesh."""
        ctx = self._cached_msm(key, size)
        if ctx is not None:
            return ctx
        if self.device.type == "cpu":
            return TorchBackend.msm_context_from_crs(self, crs, size, key)
        if hasattr(crs, "g1_limbs"):
            ctx = DistributedMSMContext.from_crs(self.mesh, crs, size)
        else:
            ctx = DistributedMSMContext(self.mesh, crs.g1_bases[:size])
        if key is not None:
            self._msm_cache[key] = ctx
        return ctx

    def _msm_block(self, ctx: DistributedMSMContext, v: MeshVec) -> torch.Tensor:
        """The rows of v that meet this rank's block of points: from the rows
        the rank holds when every rank's cover its block (a shard of the
        block's size, a replicated vector, any vector of a one-rank mesh),
        else from the gathered vector.  The choice depends on n alone, so
        every rank makes it alike (a gather is a collective)."""
        n = len(v)
        lo = self.rank * ctx.block
        hi = max(lo, min(lo + ctx.block, n))
        if not self.mesh.sharded(n) or self.D == 1 or n // self.D == ctx.block:
            held_lo = self.mesh.block(n)[0]
            part = v.data[lo - held_lo:hi - held_lo]
        else:
            part = self._gathered("commit", v)[lo:hi]
        return part if part.shape[0] else v.data.new_zeros((1, NLIMBS))

    def commit(self, msm_ctx, v: MeshVec):
        if isinstance(msm_ctx, DistributedMSMContext):
            self.distributed["commit"] += 1
            return msm_ctx.msm_vec(self._msm_block(msm_ctx, v))
        return TorchBackend.commit(self, msm_ctx, FrVec(self._gathered("commit", v)))

    def commit_many(self, msm_ctx, vs: Sequence[MeshVec]):
        if isinstance(msm_ctx, DistributedMSMContext):
            self.distributed["commit"] += len(vs)
            with stage("msm"):
                return msm_ctx.msm_vec_end_many(
                    [msm_ctx.msm_vec_begin(self._msm_block(msm_ctx, v)) for v in vs])
        return [self.commit(msm_ctx, v) for v in vs]
