"""Every TorchBackend method the prover and setup call, on the CPU (the
kernels' plain versions), against the JAX package's JaxBackend on the same
numpy-made inputs, carried across with plonkit_tpu_torch.convert.  Vectors
compare as [16, N] limb arrays, scalars and points as ints: exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkit_tpu.backend_jax import FrVec as RefVec, JaxBackend
from plonkit_tpu.fields import FR_MODULUS as R
from plonkit_tpu.plonk.setup import K_COLS
from plonkit_tpu.serialization import CrsHandle as RefCrsHandle
from plonkit_tpu.tpu import mont as ref_mont
from plonkit_tpu_torch import convert, native
from plonkit_tpu_torch.api import gen_key_monomial_form
from plonkit_tpu_torch.backend_torch import FrVec, TorchBackend

N = 16          # value-domain length
LDE = 4 * N     # coset-domain length


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


@pytest.fixture(scope="module")
def backends():
    return JaxBackend(), TorchBackend(device="cpu")


@pytest.fixture(scope="module")
def srs_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("srs") / "srs_2pow10.key")
    gen_key_monomial_form(10).save(path)
    return path


class Vecs:
    """Seeded random Montgomery vectors in both packages."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def ints(self, n):
        vals = [int.from_bytes(self.rng.bytes(32), "little") % R for _ in range(n - 4)]
        return vals + [0, 1, R - 1, R - 2]

    def pair(self, n):
        planar = ref_mont.FR.to_mont_np(self.ints(n))
        ref = RefVec(jnp.asarray(planar))
        return ref, convert.frvec_to_port(ref, "cpu")

    def many(self, k, n):
        pairs = [self.pair(n) for _ in range(k)]
        return [p[0] for p in pairs], [p[1] for p in pairs]


def same(port, ref):
    """Equal results: vectors limb for limb, lists element-wise, else ==."""
    if isinstance(port, FrVec):
        return np.array_equal(convert.frvec_from_port(port), np.asarray(ref.data))
    if isinstance(port, list) and port and isinstance(port[0], FrVec):
        return len(port) == len(ref) and all(same(p, r) for p, r in zip(port, ref))
    return port == ref


def case_inputs(name, v):
    """(args for the JAX backend, args for the port) of one method."""
    if name in ("ntt", "intt", "to_ints", "any_nonzero", "batch_inverse"):
        r, p = v.pair(N)
        return (r,), (p,)
    if name == "coset_lde":
        r, p = v.pair(N)
        return (r, 4), (p, 4)
    if name == "coset_intt":
        r, p = v.pair(LDE)
        return (r,), (p,)
    if name == "scale":
        r, p = v.pair(N)
        return (r, 1234567), (p, 1234567)
    if name in ("scale_add",):
        (ra, rc), (pa, pc) = v.many(2, N)
        return (ra, R - 5, rc), (pa, R - 5, pc)
    if name in ("sub",):
        (ra, rb), (pa, pb) = v.many(2, N)
        return (ra, rb), (pa, pb)
    if name == "gate_residual":
        rs, ps = v.many(12, N)
        return (rs[:7], rs[7:11], rs[11]), (ps[:7], ps[7:11], ps[11])
    if name == "quotient_column":
        rs, ps = v.many(23, LDE)
        def split(xs):
            return (xs[:7], xs[7:11], xs[11], xs[12], xs[13], xs[14], xs[15],
                    xs[16:20], xs[20], xs[21], 11, 12, 13, K_COLS)
        return split(rs), split(ps)
    if name == "permutation_grand_product":
        rs, ps = v.many(9, N)
        return ((rs[0], rs[1:5], rs[5:9], 21, 22, K_COLS),
                (ps[0], ps[1:5], ps[5:9], 21, 22, K_COLS))
    if name == "powers":
        return (987654321, N), (987654321, N)
    if name == "perm_from_labels":
        idx = v.rng.permutation(4 * N).reshape(4, N).astype(np.int64)
        return (idx,), (idx,)
    if name == "poly_eval":
        r, p = v.pair(N)
        return (r, 31337), (p, 31337)
    if name == "poly_eval_many":
        rs, ps = v.many(3, N)
        return (rs, R - 3), (ps, R - 3)
    if name == "divide_by_linear":
        r, p = v.pair(N)
        return (r, 424242), (p, 424242)
    if name == "slice":
        r, p = v.pair(N)
        return (r, 3, 11), (p, 3, 11)
    if name == "rotate":
        r, p = v.pair(LDE)
        return (r, 4), (p, 4)
    if name == "tile_small":
        vals = v.ints(4)
        return (vals, LDE), (vals, LDE)
    if name == "from_ints":
        vals = v.ints(N - 3) + [R + 5]
        return (vals, N + 4), (vals, N + 4)
    raise KeyError(name)


METHODS = ["from_ints", "to_ints", "ntt", "intt", "coset_lde", "coset_intt",
           "scale", "scale_add", "sub", "gate_residual", "any_nonzero",
           "quotient_column", "permutation_grand_product", "batch_inverse",
           "powers", "perm_from_labels", "poly_eval", "poly_eval_many",
           "divide_by_linear", "slice", "rotate", "tile_small"]


@pytest.mark.parametrize("name", METHODS)
def test_method_matches_jax_backend(backends, name):
    ref_b, port_b = backends
    ref_args, port_args = case_inputs(name, Vecs(seed=len(name) * 7919 + 1))
    got = getattr(port_b, name)(*port_args)
    want = getattr(ref_b, name)(*ref_args)
    assert same(got, want)


def test_any_nonzero_on_zero_vector(backends):
    ref_b, port_b = backends
    assert port_b.any_nonzero(port_b.from_ints([0] * N)) is False
    assert ref_b.any_nonzero(ref_b.from_ints([0] * N)) is False


def test_from_raw_limbs_matches_jax_backend(backends):
    ref_b, port_b = backends
    v = Vecs(seed=5)
    raw = ref_mont.FR.to_limbs_np(v.ints(N))
    assert same(port_b.from_raw_limbs(convert.limbs16_to_rows(raw)), ref_b.from_raw_limbs(raw))


def test_commits_match_jax_backend(backends, srs_path):
    """msm_context_from_crs over the same SRS file (a CrsHandle carried
    across by convert.crs_handle) and commit / commit_many: same points."""
    ref_b, port_b = backends
    ref_h = RefCrsHandle(srs_path)
    port_h = convert.crs_handle(ref_h)
    size = 64
    ref_ctx = ref_b.msm_context_from_crs(ref_h, size)
    port_ctx = port_b.msm_context_from_crs(port_h, size)
    rs, ps = Vecs(seed=6).many(3, size)
    assert port_b.commit(port_ctx, ps[0]) == ref_b.commit(ref_ctx, rs[0])
    short_r, short_p = ref_b.slice(rs[1], 0, size - 1), port_b.slice(ps[1], 0, size - 1)
    assert port_b.commit_many(port_ctx, [short_p, ps[2]]) == \
        ref_b.commit_many(ref_ctx, [short_r, rs[2]])


def test_host_msm_threads_agree(srs_path):
    """Splitting an MSM over threads changes nothing: the chunk sums add
    up to the one-chunk result."""
    from plonkit_tpu_torch import backend
    from plonkit_tpu_torch.serialization import CrsHandle
    x, y, inf = CrsHandle(srs_path).g1_limbs(1024)
    one = backend.HostMSMContext.from_limbs(x, y, inf, threads=1)
    four = backend.HostMSMContext.from_limbs(x, y, inf, threads=4)
    old = backend._MIN_CHUNK
    backend._MIN_CHUNK = 64
    try:
        scalars = np.random.default_rng(7).integers(0, 256, size=(1000, 32), dtype=np.uint8)
        scalars[:, 31] &= 0x1F
        assert one.msm_rows(scalars) == four.msm_rows(scalars)
    finally:
        backend._MIN_CHUNK = old


def test_torch_backend_needs_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        TorchBackend()
    assert TorchBackend(device="cpu").device.type == "cpu"
