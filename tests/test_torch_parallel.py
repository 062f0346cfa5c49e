"""The port's mesh (plonkit_tpu_torch/parallel/*) on four gloo ranks of the
CPU against the JAX package's parallel/* on a 4-device sub-mesh of the
virtual CPU mesh, on the same seeded inputs, exactly (field results: no
tolerance):

- every MeshBackend operation at 2^12, where the 4-step NTT distributes
  (as tests/test_mesh_prover.py's op check);
- distributed_ntt / distributed_intt, and the zero-padded form the coset
  LDE enters with;
- distributed_grand_product and sharded_quotient_step at n = 64;
- DistributedMSMContext at 2^10 points, uniform, and 0/1 scalars over
  2^10 - 6 points padded with infinity (as tests/test_parallel_msm.py),
  against plonkit_tpu.native's MSM;
- gpu/ntt.ntt_batched against plonkit_tpu/tpu/ntt.py's, in one process.

The ranks run once for the module (parallel/mesh.run_ranks: a file://
store under tmp_path, one thread a rank, at most 120 s); rank 0 returns
integers.  The ranks import this module to find their function, so its
top level imports neither jax nor the JAX package."""

import os
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from plonkit_tpu_torch.fields import FR_MODULUS as R
from plonkit_tpu_torch.parallel.mesh import run_ranks

D = 4
LOG2 = 12
STEP_N = 64
MSM_LOG2 = 10
KEY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "scratch", "recursive_r22", "srs_2pow22.key")


def _elems(n, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(max(n - 4, 0))]
    return (vals + [0, 1, R - 1, R - 2])[:n]


def _drive(b, k_cols, fr) -> dict:
    """Every Backend operation on one backend (the port's MeshBackend on each
    rank, or the JAX package's MeshBackend), as python ints.  fr: the
    package's Fr spec, for its raw limb layout."""
    n = 1 << LOG2
    vals, other = _elems(n, 1), _elems(n, 2)
    v, o = b.from_ints(vals), b.from_ints(other)
    ws = [b.from_ints(_elems(n, 10 + i)) for i in range(4)]
    sel = [b.from_ints(_elems(n, 20 + i)) for i in range(7)]
    sig = [b.from_ints(_elems(n, 30 + i)) for i in range(4)]
    ints = b.to_ints
    out = {
        "from_ints pad_to": ints(b.from_ints(vals[:n - 8], pad_to=n)),
        "from_raw_limbs": ints(b.from_raw_limbs(fr.to_limbs_np(vals))),
        "mul": ints(b.mul(v, o)), "add": ints(b.add(v, o)), "sub": ints(b.sub(v, o)),
        "scale": ints(b.scale(v, 987654321)),
        "scale_add": ints(b.scale_add(v, 5551212, o)),
        "add_scalar": ints(b.add_scalar(v, R - 3)),
        "fma_acc": ints(b.fma_acc(b.from_ints(vals), o, ws[0])),
        "add_into": ints(b.add_into(b.from_ints(vals), o)),
        "mul_into": ints(b.mul_into(b.from_ints(vals), o)),
        "grand_product": ints(b.grand_product(v)),
        "batch_inverse": ints(b.batch_inverse(b.add_scalar(v, 7))),
        "powers": ints(b.powers(99, n)),
        "poly_eval_many": b.poly_eval_many([v, o, ws[1]], 777),
        "poly_eval": b.poly_eval(o, 31337),
        "divide_by_linear": ints(b.divide_by_linear(v, 12345)),
        "rotate 1": ints(b.rotate(v, 1)), "rotate 5": ints(b.rotate(v, 5)),
        "slice": ints(b.slice(v, 3, n - 5)),
        "concat": ints(b.concat([v, o])),
        "zeros": ints(b.zeros(n)),
        "tile_small": ints(b.tile_small([1, 2, 3, 4], n)),
        "any_nonzero": [b.any_nonzero(v), b.any_nonzero(b.zeros(n))],
        "onload offload": ints(b.onload(b.offload(v))),
        "ntt": ints(b.ntt(v)), "intt": ints(b.intt(v)),
        "coset_ntt": ints(b.coset_ntt(v)), "coset_intt": ints(b.coset_intt(v)),
        "coset_lde": ints(b.coset_lde(v, 4)),
        "gate_residual": ints(b.gate_residual(sel, ws, o)),
        "permutation_grand_product": ints(b.permutation_grand_product(
            b.powers(5, n), sig, ws, 21, 22, k_cols)),
    }
    ext = [b.from_ints(_elems(4 * n, 40 + i)) for i in range(20)]
    out["quotient_column"] = ints(b.quotient_column(
        ext[:7], ext[7:11], ext[11], ext[12], ext[13], ext[14], ext[15], ext[16:20],
        ext[0], ext[1], 21, 22, 23, k_cols))
    labels = np.random.default_rng(3).permutation(4 * n).reshape(4, n)
    out["perm_from_labels"] = [ints(x) for x in b.perm_from_labels(labels)]
    return out


def _step_inputs(n):
    """sharded_quotient_step's inputs as value lists."""
    wires = [_elems(n, 50 + i) for i in range(4)]
    sels = [_elems(n, 60 + i) for i in range(7)]
    return wires, sels, _elems(n, 70), _elems(4 * n, 71), _elems(4 * n, 72)


def _port_side(mesh):
    """Every rank: the port's results; rank 0's are returned."""
    from plonkit_tpu_torch.gpu.mont import FR, to_numpy, to_tensor
    from plonkit_tpu_torch.parallel import prove_step
    from plonkit_tpu_torch.parallel.backend_mesh import MeshBackend
    from plonkit_tpu_torch.parallel.msm import DistributedMSMContext
    from plonkit_tpu_torch.parallel.ntt import distributed_intt, distributed_ntt
    from plonkit_tpu_torch.plonk.setup import K_COLS
    from plonkit_tpu_torch.serialization import CrsHandle
    backend = MeshBackend(mesh)
    out = {"backend": _drive(backend, K_COLS, FR)}

    def mont(vals):
        return to_tensor(FR.to_mont_np(vals), "cpu")

    def block(t):
        lo, hi = mesh.block(t.shape[0])
        return t[lo:hi]

    def gathered(t):
        return FR.from_mont_np(to_numpy(mesh.all_gather(t)))

    n = 1 << LOG2
    x = mont(_elems(n, 1))
    y = distributed_ntt(block(x), mesh)
    padded = distributed_ntt(block(x[:n // 4]), mesh, 4 * n)
    out["dist"] = {"ntt": gathered(y), "intt": gathered(distributed_intt(y, mesh)),
                   "ntt zero-padded to 4n": gathered(padded)}

    wires, sels, pi, x_coset, vinv = _step_inputs(STEP_N)
    t, z, checksum = prove_step.sharded_quotient_step(
        mesh, [block(mont(w)) for w in wires], [block(mont(s)) for s in sels],
        block(mont(pi)), block(mont(x_coset)), block(mont(vinv)), 5, 6)
    out["step"] = {"t": gathered(t), "z": gathered(z),
                   "checksum": FR.from_mont_np(to_numpy(checksum)),
                   "grand_product": gathered(prove_step.distributed_grand_product(
                       block(mont(wires[1])), mesh))}

    # the rows of a commitment's vector that meet each rank's block of
    # points: a shard of the block's size, a replicated vector of n - 1 rows,
    # and a shard of half the block's size (gathered)
    m = 256
    full = mont(_elems(m, 80))
    got = []
    for length, blk in ((m, m // D), (m - 1, m // D), (m, 2 * m // D)):
        vec = backend.from_ints(FR.from_mont_np(to_numpy(full[:length])))
        part = backend._msm_block(SimpleNamespace(block=blk), vec)
        lo, hi = mesh.rank * blk, min((mesh.rank + 1) * blk, length)
        want = full[lo:hi] if hi > lo else full.new_zeros((1, 8))
        got.append(bool(torch.equal(part, want)))
    out["msm_block"] = mesh.all_gather(torch.tensor([got])).tolist()
    out["msm_block gathered"] = backend.gathered["commit"]

    crs = CrsHandle(KEY)
    rng = random.Random(11)
    size = 1 << MSM_LOG2
    uniform = [rng.randrange(R) for _ in range(size)]
    sparse = [rng.randrange(2) for _ in range(size - 6)]
    ctx = DistributedMSMContext.from_crs(mesh, crs, size)
    padded_ctx = DistributedMSMContext(mesh, _points(crs, size - 6))
    out["msm"] = {"uniform": ctx.msm(uniform), "sparse padded": padded_ctx.msm(sparse),
                  "padded_to": padded_ctx.n, "scalars": {"uniform": uniform,
                                                         "sparse padded": sparse}}
    return out


def _points(crs, count):
    """The first `count` SRS points as host affine pairs."""
    x, y, inf = crs.g1_limbs(count)
    weights = np.array([1 << (32 * k) for k in range(8)], dtype=object)
    xs, ys = x.astype(object) @ weights, y.astype(object) @ weights
    return [None if i else (int(a), int(b)) for a, b, i in zip(xs, ys, inf)]


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    return run_ranks(_port_side, D, "cpu", "gloo", timeout_s=120,
                     workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def jax_mesh():
    from plonkit_tpu.parallel.mesh import make_mesh
    return make_mesh(D)


@pytest.fixture(scope="module")
def ref_backend_ops(jax_mesh):
    from plonkit_tpu.parallel.backend_mesh import MeshBackend as RefMeshBackend
    from plonkit_tpu.plonk.setup import K_COLS as REF_K_COLS
    from plonkit_tpu.tpu.mont import FR as REF_FR
    return _drive(RefMeshBackend(mesh=jax_mesh), REF_K_COLS, REF_FR)


OPS = ["from_ints pad_to", "from_raw_limbs", "mul", "add", "sub", "scale", "scale_add",
       "add_scalar", "fma_acc", "add_into", "mul_into", "grand_product", "batch_inverse",
       "powers", "poly_eval_many", "poly_eval", "divide_by_linear", "rotate 1", "rotate 5",
       "slice", "concat", "zeros", "tile_small", "any_nonzero", "onload offload", "ntt",
       "intt", "coset_ntt", "coset_intt", "coset_lde", "gate_residual",
       "permutation_grand_product", "quotient_column", "perm_from_labels"]


@pytest.mark.parametrize("op", OPS)
def test_mesh_backend_op_matches_jax_mesh(port, ref_backend_ops, op):
    assert port["backend"][op] == ref_backend_ops[op]


def test_mesh_backend_ops_cover_the_drive(port):
    assert sorted(port["backend"]) == sorted(OPS)


def _planar(vals):
    import jax.numpy as jnp
    from plonkit_tpu.tpu.mont import FR as REF_FR
    return jnp.asarray(REF_FR.to_mont_np(vals))


def _ints(planar):
    from plonkit_tpu.tpu.mont import FR as REF_FR
    return REF_FR.from_mont_np(np.asarray(planar))


def test_distributed_transforms_match_jax(port, jax_mesh):
    from plonkit_tpu.parallel.ntt import distributed_intt, distributed_ntt
    n = 1 << LOG2
    xs = _elems(n, 1)
    y = distributed_ntt(_planar(xs), jax_mesh)
    assert port["dist"]["ntt"] == _ints(y)
    assert port["dist"]["intt"] == _ints(distributed_intt(y, jax_mesh)) == xs
    padded = distributed_ntt(_planar(xs[:n // 4] + [0] * (4 * n - n // 4)), jax_mesh)
    assert port["dist"]["ntt zero-padded to 4n"] == _ints(padded)


@pytest.fixture(scope="module")
def ref_step(jax_mesh):
    from plonkit_tpu.parallel import prove_step as ref_prove_step
    wires, sels, pi, x_coset, vinv = _step_inputs(STEP_N)
    t, z, checksum = ref_prove_step.sharded_quotient_step(
        jax_mesh, [_planar(w) for w in wires], [_planar(s) for s in sels], _planar(pi),
        _planar(x_coset), _planar(vinv), 5, 6, interpret=True)
    return {"t": _ints(t), "z": _ints(z), "checksum": _ints(checksum),
            "grand_product": _ints(ref_prove_step.distributed_grand_product(
                _planar(wires[1]), jax_mesh))}


@pytest.mark.parametrize("what", ["t", "z", "checksum", "grand_product"])
def test_prove_step_matches_jax(port, ref_step, what):
    assert port["step"][what] == ref_step[what]


def test_commit_rows_of_each_rank(port):
    """MeshBackend._msm_block: every rank's rows for its block of points,
    from its own rows where they cover the block, else gathered (the
    third case only: once a rank)."""
    assert port["msm_block"] == [[True, True, True]] * D
    assert port["msm_block gathered"] == 1


@pytest.mark.parametrize("case", ["uniform", "sparse padded"])
def test_distributed_msm_matches_native(port, case):
    from plonkit_tpu.native import msm_native
    scalars = port["msm"]["scalars"][case]
    from plonkit_tpu_torch.serialization import CrsHandle
    points = _points(CrsHandle(KEY), len(scalars))
    assert port["msm"][case] == msm_native(points, scalars)
    assert port["msm"]["padded_to"] == 1 << MSM_LOG2


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("m, batch", [(2, 3), (32, 8), (64, 1)])
def test_ntt_batched_matches_jax(m, batch, inverse):
    import jax.numpy as jnp
    from plonkit_tpu.tpu import ntt as ref_ntt
    from plonkit_tpu.tpu.mont import FR as REF_FR
    from plonkit_tpu_torch.gpu import ntt
    from plonkit_tpu_torch.gpu.mont import FR, to_numpy, to_tensor
    torch.set_num_threads(1)
    vals = _elems(m * batch, 100 + m)
    port = ntt.ntt_batched(to_tensor(FR.to_mont_np(vals), "cpu").view(m, batch, 8), inverse)
    ref = ref_ntt.ntt_batched(jnp.asarray(REF_FR.to_mont_np(vals)).reshape(16, m, batch),
                              inverse=inverse, interpret=True)
    assert FR.from_mont_np(to_numpy(port.reshape(-1, 8))) == \
        REF_FR.from_mont_np(np.asarray(ref).reshape(16, -1))
