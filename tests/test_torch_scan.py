"""The field scans K12 field_scan and K13 field_inverse (csrc/scan.cu)
through their wrappers on the CPU, which take the plain versions, against
the JAX package's scans with its Pallas kernels in interpret mode and
against python ints: prefix and suffix products, suffix sums, batch
inverses over Fr and Fq, TorchBackend.grand_product and divide_by_linear,
at n in {1, 2, 3, 255, 1027} with zeros planted at the first row, the last
row and everywhere.  Integer arithmetic: every comparison is byte for byte.
The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import re
from functools import lru_cache, partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkit_tpu import backend_jax as bj
from plonkit_tpu.backend_jax import FrVec as RefVec, JaxBackend
from plonkit_tpu.tpu import mont as ref_mont
from plonkit_tpu.tpu import pallas_kernels as pk
from plonkit_tpu_torch import convert
from plonkit_tpu_torch.backend_torch import FrVec, TorchBackend
from plonkit_tpu_torch.gpu import field_kernels as fk
from plonkit_tpu_torch.gpu import mont

SIZES = [1, 2, 3, 255, 1027]
ZEROS = ["none", "first", "last", "all"]
FIELDS = {"fr": (mont.FR, ref_mont.FR), "fq": (mont.FQ, ref_mont.FQ)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def values(p: int, n: int, zeros: str, seed: int) -> list:
    """n seeded random values below p, with zeros planted as named."""
    rng = np.random.default_rng(seed + n)
    xs = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n)]
    if zeros == "all":
        return [0] * n
    if zeros == "first":
        xs[0] = 0
    if zeros == "last":
        xs[-1] = 0
    return xs


def both(spec, ref_spec, xs):
    """The same Montgomery values as (jax [16, N], torch [N, 8])."""
    planar = ref_spec.to_mont_np(xs)
    return jnp.asarray(planar), torch.from_numpy(convert.limbs16_to_rows(planar).view(np.int32))


def ints(spec, t) -> list:
    return spec.from_mont_np(mont.to_numpy(t))


def same(port_t, ref_arr) -> bool:
    return np.array_equal(convert.rows_to_limbs16(mont.to_numpy(port_t)), np.asarray(ref_arr))


def scanned(xs, p, combine, reverse=False, exclusive=False, identity=1) -> list:
    """The scan in python ints."""
    seq = list(reversed(xs)) if reverse else list(xs)
    out, acc = [], identity
    for x in seq:
        if exclusive:
            out.append(acc)
        acc = combine(acc, x) % p
        if not exclusive:
            out.append(acc)
    return list(reversed(out)) if reverse else out


@lru_cache(maxsize=None)
def ref_jit(name: str, n: int):
    """The JAX package's scan bodies, jitted once per length, interpret=True."""
    fn = {"prefix": bj._prefix_products_body, "suffix": bj._suffix_products_body,
          "batch_inverse": bj._batch_inverse_body}[name]
    return jax.jit(partial(fn, n=n, interpret=True))


@lru_cache(maxsize=None)
def ref_batch_inverse_fq():
    return jax.jit(partial(pk.batch_inverse, ref_mont.FQ, interpret=True))


@pytest.mark.parametrize("zeros", ZEROS)
@pytest.mark.parametrize("n", SIZES)
def test_prefix_and_suffix_products_match_jax(n, zeros):
    xs = values(mont.FR.p, n, zeros, seed=1)
    ja, ta = both(mont.FR, ref_mont.FR, xs)
    mul = lambda a, b: a * b
    for port, name, reverse in ((fk.prefix_products, "prefix", False),
                                (fk.suffix_products, "suffix", True)):
        got = port(mont.FR, ta)
        assert same(got, ref_jit(name, n)(ja)), name
        assert ints(mont.FR, got) == scanned(xs, mont.FR.p, mul, reverse), name


@pytest.mark.parametrize("zeros", ZEROS)
@pytest.mark.parametrize("n", SIZES)
def test_suffix_sums_match_jax(n, zeros):
    xs = values(mont.FR.p, n, zeros, seed=2)
    ja, ta = both(mont.FR, ref_mont.FR, xs)
    got = TorchBackend(device="cpu")._suffix_sums(ta)
    assert same(got, bj._suffix_sums_jit(n, True)(ja))
    assert ints(mont.FR, got) == scanned(xs, mont.FR.p, lambda a, b: a + b, True, identity=0)


@pytest.mark.parametrize("field", list(FIELDS))
@pytest.mark.parametrize("zeros", ZEROS)
@pytest.mark.parametrize("n", SIZES)
def test_batch_inverse_matches_jax(field, n, zeros):
    spec, ref_spec = FIELDS[field]
    xs = values(spec.p, n, zeros, seed=3)
    ja, ta = both(spec, ref_spec, xs)
    got = fk.batch_inverse(spec, ta)
    want = ref_jit("batch_inverse", n)(ja) if field == "fr" else ref_batch_inverse_fq()(ja)
    assert same(got, want)
    assert ints(spec, got) == [pow(x, -1, spec.p) if x else 0 for x in xs]


@pytest.mark.parametrize("zeros", ZEROS)
@pytest.mark.parametrize("n", SIZES)
def test_grand_product_matches_jax(n, zeros):
    xs = values(mont.FR.p, n, zeros, seed=4)
    ja, ta = both(mont.FR, ref_mont.FR, xs)
    got = TorchBackend(device="cpu").grand_product(FrVec(ta))
    assert same(got.data, JaxBackend(interpret=True).grand_product(RefVec(ja)).data)
    assert ints(mont.FR, got.data) == scanned(xs, mont.FR.p, lambda a, b: a * b,
                                              exclusive=True)


@pytest.mark.parametrize("zeros", ["none", "first", "last"])
@pytest.mark.parametrize("n", SIZES)
def test_divide_by_linear_matches_jax(n, zeros):
    xs = values(mont.FR.p, n, zeros, seed=5)
    ja, ta = both(mont.FR, ref_mont.FR, xs)
    z = 0x1234567 + n
    got = TorchBackend(device="cpu").divide_by_linear(FrVec(ta), z)
    assert same(got.data, JaxBackend(interpret=True).divide_by_linear(RefVec(ja), z).data)
    # q(X) (X - z) + p(z) = p(X)
    p = mont.FR.p
    q = ints(mont.FR, got.data)
    rem = sum(c * pow(z, k, p) for k, c in enumerate(xs)) % p
    back = [((q[k - 1] if k else 0) - z * (q[k] if k < n - 1 else 0)) % p for k in range(n)]
    back[0] = (back[0] + rem) % p
    assert back == xs


@pytest.mark.parametrize("reverse", [False, True], ids=["prefix", "suffix"])
@pytest.mark.parametrize("exclusive", [False, True], ids=["inclusive", "exclusive"])
@pytest.mark.parametrize("op", ["mul", "add"])
@pytest.mark.parametrize("field", list(FIELDS))
def test_scan_forms_match_python_ints(field, op, exclusive, reverse):
    spec = FIELDS[field][0]
    combine = (lambda a, b: a * b) if op == "mul" else (lambda a, b: a + b)
    for n in SIZES:
        for zeros in ("first", "last"):
            xs = values(spec.p, n, zeros, seed=6)
            got = fk.scan(spec, mont.to_tensor(spec.to_mont_np(xs), "cpu"), op, reverse,
                          exclusive)
            assert ints(spec, got) == scanned(xs, spec.p, combine, reverse, exclusive,
                                              1 if op == "mul" else 0), (n, zeros)


@pytest.mark.parametrize("field", list(FIELDS))
def test_inverse_plain_matches_python_ints(field):
    """K13's plain version (a^(p-2)) on the totals a batch inverse meets."""
    spec = FIELDS[field][0]
    xs = [1, 2, spec.p - 1] + values(spec.p, 5, "none", seed=7) + [0]
    got = fk.inverse(spec, mont.to_tensor(spec.to_mont_np(xs), "cpu"))
    assert ints(spec, got) == [pow(x, -1, spec.p) if x else 0 for x in xs]


def test_scans_take_plain_path_on_cpu_without_counting():
    before = dict(fk.launches)
    _, ta = both(mont.FR, ref_mont.FR, values(mont.FR.p, 9, "first", seed=8))
    fk.scan(mont.FR, ta, "add", reverse=True)
    fk.batch_inverse(mont.FR, ta)
    fk.inverse(mont.FR, ta[:1])
    assert fk.launches == before


def test_scan_rejects_bad_arguments():
    t = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        fk.scan(mont.FR, t, "sub")
    with pytest.raises(ValueError):
        fk.scan(mont.FR, torch.zeros((4, 16), dtype=torch.int32)[:, ::2])


def test_scan_constants_match_field_specs():
    """csrc/scan.cu hard-codes R mod p (the product's identity, Montgomery
    one) and R^3 mod p (K13's last product) for each field, and a tile of
    kThreads * kRows rows, which the wrapper's scratch size assumes."""
    src = (Path(mont.__file__).parents[1] / "csrc" / "scan.cu").read_text()
    blocks = re.findall(r"k(Fr|Fq) = \{\s*\{\{([^}]*)\}\},\s*\{\{([^}]*)\}\}\}", src)

    def limbs(text):
        return [int(x.strip().rstrip("u"), 16) for x in text.split(",")]
    got = {name: (limbs(one), limbs(r3)) for name, one, r3 in blocks}
    want = {name: (list(s.to_limbs_np([s.r_mod_p])[0]),
                   list(s.to_limbs_np([pow(s.r, 3, s.p)])[0]))
            for name, s in (("Fr", mont.FR), ("Fq", mont.FQ))}
    assert got == want
    threads = int(re.search(r"kThreads = (\d+);", src).group(1))
    rows = int(re.search(r"kRows = (\d+);", src).group(1))
    assert threads * rows == fk.SCAN_TILE
