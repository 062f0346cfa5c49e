"""The mesh's end-to-end check: the port's counterpart of
__graft_entry__.dryrun_multichip, on `n_ranks` spawned processes.

    dryrun_multichip(4, "cpu", "gloo", key)     # four CPU ranks
    dryrun_multichip(4, "cuda", "gloo", key)    # four ranks sharing one card

Every rank (parallel/mesh.run_ranks) runs the same checks; rank 0
compares, and dryrun_multichip returns its result:

1. the in-repo domain-64 circuit (scratch/recursive_r22) proved on the
   mesh: vk.bin equal to the fixture's, and the rescue-transcript proof of
   witness_0 equal to its proof_0.bin (the JAX version proves plonkit's
   golden `simple` circuit, which the repository does not hold);
2. parallel/msm.DistributedMSMContext against the host Pippenger
   (backend.HostMSMContext) on uniform scalars over 2^msm points, and on
   0/1 scalars over 2^msm - 6 points (padded with infinity);
3. the distributed NTT and iNTT at 2^ntt points against gpu/ntt's,
   bit for bit;
4. the synthetic chain at a 2^chain domain proved on the mesh and on one
   device (TorchBackend on rank 0): the same vk.bin and proof.bin.  On the
   card every commitment of the mesh prove runs through
   DistributedMSMContext; a CPU mesh commits in the host Pippenger.

The caller gives the tau = 42 key (`key`, at least 2^max(chain, msm, 10)
points): the repository's scratch/recursive_r22/srs_2pow22.key, or one made
by `setup -p` (on the card by gpu/fixed_base.py).
"""

import os
import random
import tempfile
import time

import numpy as np
import torch

from .mesh import run_ranks

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scratch", "recursive_r22")

# log2 sizes of checks 2-4 by device type
SIZES = {"cpu": {"msm": 10, "ntt": 12, "chain": 10},
         "cuda": {"msm": 16, "ntt": 20, "chain": 16}}


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _check_fixture(mesh, key: str) -> dict:
    from ..api import SetupForProver
    from ..frontend import CircomCircuit, load_r1cs, load_witness
    from ..serialization import CrsHandle
    from .backend_mesh import MeshBackend
    circuit = CircomCircuit(r1cs=load_r1cs(os.path.join(FIXTURES, "circuit.r1cs.json")),
                            witness=load_witness(os.path.join(FIXTURES, "witness_0.json")))
    setup = SetupForProver(circuit, CrsHandle(key), backend=MeshBackend(mesh))
    vk = setup.make_verification_key().to_bytes()
    proof = setup.prove(circuit, "rescue").to_bytes()
    return {"domain": setup.setup_polynomials.domain_size,
            "vk.bin = fixture vk.bin": vk == _read(os.path.join(FIXTURES, "vk.bin")),
            "rescue proof = fixture proof_0.bin":
                proof == _read(os.path.join(FIXTURES, "proof_0.bin"))}


def _check_msm(mesh, key: str, log2: int) -> dict:
    from ..backend import HostMSMContext
    from ..fields import FR_MODULUS as R
    from ..gpu.mont import FR
    from ..serialization import CrsHandle
    from .msm import DistributedMSMContext
    crs = CrsHandle(key)
    rng = random.Random(11)
    n = 1 << log2
    cases = {"uniform": (n, [rng.randrange(R) for _ in range(n)]),
             "zero_one_padded": (n - 6, [rng.randrange(2) for _ in range(n - 6)])}
    out = {}
    for name, (size, scalars) in cases.items():
        ctx = DistributedMSMContext.from_crs(mesh, crs, size)
        got = ctx.msm(scalars)
        if mesh.rank == 0:
            host = HostMSMContext.from_limbs(*crs.g1_limbs(size))
            want = host.msm_rows(FR.to_limbs_np(scalars).view(np.uint8))
            out[name] = {"points": size, "padded_to": ctx.n, "c": ctx.c, "equal": got == want}
    return out


def _check_ntt(mesh, log2: int) -> dict:
    from ..gpu import ntt as gntt
    from ..gpu.mont import to_tensor
    from .ntt import distributed_intt, distributed_ntt
    n = 1 << log2
    rows = np.random.default_rng(7).integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    rows = rows.astype(np.uint32)
    rows[:, 7] = 0                       # canonical: below 2^224 < r
    x = to_tensor(rows, mesh.device)
    lo, hi = mesh.block(n)
    y = distributed_ntt(x[lo:hi], mesh)
    back = distributed_intt(y, mesh)
    y_all, back_all = mesh.all_gather(y), mesh.all_gather(back)
    if mesh.rank:
        return {}
    want = gntt.ntt(x)
    return {"points": n, "ntt": torch.equal(y_all, want),
            "intt": torch.equal(back_all, gntt.intt(want)),
            "round_trip": torch.equal(back_all, x)}


def _check_chain(mesh, key: str, log2: int) -> dict:
    from ..api import SetupForProver
    from ..backend_torch import TorchBackend
    from ..frontend.synthetic import synth_circuit
    from ..serialization import CrsHandle
    from .backend_mesh import MeshBackend
    circuit = synth_circuit(log2 - 1)
    backend = MeshBackend(mesh)
    setup = SetupForProver(circuit, CrsHandle(key), backend=backend)
    vk, proof = setup.make_verification_key().to_bytes(), setup.prove(circuit).to_bytes()
    if mesh.rank:
        return {}
    one = SetupForProver(circuit, CrsHandle(key), backend=TorchBackend(mesh.device))
    return {"domain": setup.setup_polynomials.domain_size,
            "vk.bin = one device": vk == one.make_verification_key().to_bytes(),
            "proof.bin = one device": proof == one.prove(circuit).to_bytes(),
            "vk_hex": vk.hex(), "proof_hex": proof.hex(),
            "distributed": dict(backend.distributed), "gathered": dict(backend.gathered)}


def _checks(mesh, key: str) -> dict:
    sizes = SIZES[mesh.device.type]
    out, seconds = {}, {}
    for name, check in (("fixture_64", lambda: _check_fixture(mesh, key)),
                        ("msm", lambda: _check_msm(mesh, key, sizes["msm"])),
                        ("ntt", lambda: _check_ntt(mesh, sizes["ntt"])),
                        ("chain", lambda: _check_chain(mesh, key, sizes["chain"]))):
        t0 = time.perf_counter()
        out[name] = check()
        seconds[name] = time.perf_counter() - t0
    out.update(ranks=mesh.size, device=str(mesh.device), backend=mesh.backend,
               seconds=seconds, collectives=mesh.counts)
    return out


def dryrun_multichip(n_ranks: int, device: str, backend: str, key: str,
                     timeout_s: float = 600, workdir: str = None) -> dict:
    """Run the four checks on n_ranks spawned ranks (parallel/mesh.run_ranks)
    over the SRS file `key`, and return rank 0's result; raises if a rank
    fails or the run outlasts timeout_s.  The libraries the ranks load are
    built here first, once; the ranks' store goes to a temp dir under
    `workdir`."""
    from .. import native
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: no CUDA device")
    native.build()
    if dev.type == "cuda":
        from ..gpu import build
        build.build_all()
    with tempfile.TemporaryDirectory(prefix="plonkit_dryrun_", dir=workdir) as tmp:
        t0 = time.perf_counter()
        out = run_ranks(_checks, n_ranks, device, backend, (key,), timeout_s, tmp)
        out["wall_s"] = time.perf_counter() - t0
        return out
