"""Distributed Pippenger MSM over the mesh (plonkit_tpu/parallel/msm.py
DistributedMSMContext).

Each rank holds a contiguous block of the SRS points, the n points padded
with points at infinity to a multiple of 8 * D, and runs the port's
single-card engine on it (gpu/msm.MSMContext: K6, the K7r/K7w reduction and
one K7 join, `_run`), which leaves its W window totals on the device as a
Jacobian [W, 8] triple without synchronising.  A queued group of k MSMs
then ends with one all_gather of the D ranks' [3, k * W, 8] totals, a fold
of the D partials by D - 1 K7 (padd) launches, and one K8 (combine)
launch over the k MSMs (`msm_vec_end_many`): as on one card, one K8
launch a group.  Every rank ends with the same points.

The JAX version's lane-overflow retry and host fallback (its
`_host_fallback`) have no counterpart: the port's segmented buckets cannot
overflow, every add is complete, and nothing falls back to a host MSM.
"""

import numpy as np
import torch

from ..fields import FR_MODULUS
from ..gpu import ec, field_kernels as fk
from ..gpu import msm_kernels as mk
from ..gpu.mont import FQ, FR, NLIMBS, to_tensor
from ..gpu.msm import MSMContext
from ..profiling import stage


def padded_points(n_pts: int, d: int) -> int:
    """The point count padded with infinity to a multiple of 8 * d."""
    step = 8 * d
    return -(-max(n_pts, d) // step) * step


class DistributedMSMContext:
    """Mesh-sharded bases for repeated MSMs over one SRS: this rank's block
    of `block` points, on the mesh's device."""

    def __init__(self, mesh, points):
        """From the host affine points (None for infinity), the same list on
        every rank."""
        n = padded_points(len(points), mesh.size)
        b = n // mesh.size
        block = list(points[mesh.rank * b:(mesh.rank + 1) * b])
        block += [None] * (b - len(block))
        self._init(mesh, *ec.affine_from_host(block, mesh.device), len(points))

    @classmethod
    def from_device_affine(cls, mesh, x, y, inf, n_pts: int) -> "DistributedMSMContext":
        """From this rank's block ([b, 8] Montgomery Fq rows and the [b]
        infinity mask) of the n_pts points padded to padded_points."""
        ctx = cls.__new__(cls)
        ctx._init(mesh, x, y, inf, n_pts)
        return ctx

    @classmethod
    def from_crs(cls, mesh, crs, size: int) -> "DistributedMSMContext":
        """Over the first `size` points of a CrsHandle: this rank's block of
        its limb rows, padded with infinity, carried to the device and put
        in Montgomery form there by K1 over Fq (x R^2 mod q), as
        TorchBackend.device_msm_context does."""
        x_raw, y_raw, inf = crs.g1_limbs(size)
        b = padded_points(size, mesh.size) // mesh.size
        lo = mesh.rank * b
        m = max(0, min(lo + b, size) - lo)
        x, y = (np.zeros((b, NLIMBS), dtype=np.uint32) for _ in range(2))
        mask = np.ones(b, dtype=bool)
        x[:m], y[:m], mask[:m] = x_raw[lo:lo + m], y_raw[lo:lo + m], inf[lo:lo + m]
        return cls.from_device_affine(mesh, fk.to_mont(FQ, to_tensor(x, mesh.device)),
                                      fk.to_mont(FQ, to_tensor(y, mesh.device)),
                                      torch.from_numpy(mask).to(mesh.device), size)

    def _init(self, mesh, x, y, inf, n_pts):
        self.mesh = mesh
        self.n_pts = n_pts
        self.block = x.shape[0]
        self.n = self.block * mesh.size
        if self.n != padded_points(n_pts, mesh.size):
            raise ValueError(f"a block of {self.block} points for {n_pts} points "
                             f"over {mesh.size} ranks")
        self.local = MSMContext.from_device_affine(x, y, inf)
        self.c = self.local.c
        self.num_windows = self.local.num_windows

    def msm_vec_begin(self, v_block):
        """Queue the local windows of this rank's [m, 8] block (m <= block)
        of a Montgomery scalar vector: the handle is their totals."""
        return self.local.msm_vec_begin(v_block)

    def msm_vec_end_many(self, handles) -> list:
        """One all_gather, D - 1 K7 launches and one K8 launch for a queued
        group; the affine points (None for infinity) in order."""
        if not handles:
            return []
        k, w = len(handles), self.num_windows
        local = torch.stack([torch.cat(parts) for parts in zip(*handles)])   # [3, k*W, 8]
        parts = self.mesh.all_gather(local).view(self.mesh.size, 3, k * w, NLIMBS)
        acc = tuple(parts[0])
        for r in range(1, self.mesh.size):
            acc = mk.padd(acc, tuple(parts[r]))
        points = torch.stack(mk.combine(acc, self.c, k)).cpu()
        return ec.to_affine_host(tuple(points))

    def msm_vec_end(self, handle):
        return self.msm_vec_end_many([handle])[0]

    def msm_vec(self, v_block):
        with stage("msm"):
            return self.msm_vec_end(self.msm_vec_begin(v_block))

    def msm(self, scalars):
        """sum_i scalars[i] * points[i] for python ints (the same list on
        every rank, len <= n_pts): the host affine point."""
        if len(scalars) > self.n_pts:
            raise ValueError(f"{len(scalars)} scalars for {self.n_pts} points")
        lo = self.mesh.rank * self.block
        mine = [s % FR_MODULUS for s in scalars[lo:lo + self.block]] or [0]
        raw = to_tensor(FR.to_limbs_np(mine), self.mesh.device)
        with stage("msm"):
            return self.msm_vec_end(self.local._run(raw))

