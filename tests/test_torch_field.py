"""The port's field layer (plonkit_tpu_torch/gpu/mont.py and the K1/K2
wrappers of gpu/field_kernels.py) against the JAX package's tpu/mont.py and
its Pallas kernels in interpret mode, for Fr and Fq, on the edge values 0,
1, p-1, p-2 and seeded random values.  Everything is integer arithmetic:
the comparisons are exact.  The CUDA kernels themselves run only on the
card (tests/test_torch_cuda.py and chip_smoke.py)."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkit_tpu.fields import FQ_MODULUS, FR_MODULUS
from plonkit_tpu.tpu import mont as ref_mont
from plonkit_tpu.tpu import pallas_kernels as pk
from plonkit_tpu_torch import convert
from plonkit_tpu_torch.gpu import field_kernels as fk
from plonkit_tpu_torch.gpu import mont

FIELDS = [(mont.FR, ref_mont.FR, FR_MODULUS), (mont.FQ, ref_mont.FQ, FQ_MODULUS)]
IDS = ["fr", "fq"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def rand_elems(n, p, seed):
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % p for _ in range(n - 4)]
    return vals + [0, 1, p - 1, p - 2]


def both(ref_spec, xs):
    """The same Montgomery values in both layouts: (jax [16, N], torch [N, 8])."""
    planar = ref_spec.to_mont_np(xs)
    return jnp.asarray(planar), torch.from_numpy(convert.limbs16_to_rows(planar).view(np.int32))


def same(port_t, ref_arr):
    return np.array_equal(convert.rows_to_limbs16(mont.to_numpy(port_t)), np.asarray(ref_arr))


@pytest.mark.parametrize("spec,ref_spec,p", FIELDS, ids=IDS)
def test_limb_layouts_hold_the_same_values(spec, ref_spec, p):
    xs = rand_elems(64, p, seed=1)
    assert spec.from_mont_np(convert.limbs16_to_rows(ref_spec.to_mont_np(xs))) == xs
    assert spec.from_limbs_np(spec.to_limbs_np(xs)) == xs
    rows = spec.to_mont_np(xs)
    assert np.array_equal(convert.limbs16_to_rows(convert.rows_to_limbs16(rows)), rows)


@pytest.mark.parametrize("spec,ref_spec,p", FIELDS, ids=IDS)
@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg"])
def test_plain_ops_match_reference_mont(spec, ref_spec, p, op):
    xs = rand_elems(256, p, seed=2)
    ys = list(reversed(rand_elems(256, p, seed=3)))
    ja, ta = both(ref_spec, xs)
    jb, tb = both(ref_spec, ys)
    if op == "neg":
        got, want = mont.neg(spec, ta), ref_mont.neg(ref_spec, ja)
        host = [(-x) % p for x in xs]
    else:
        port_fn = {"add": mont.add, "sub": mont.sub, "mul": mont.mont_mul}[op]
        ref_fn = {"add": ref_mont.add, "sub": ref_mont.sub, "mul": ref_mont.mont_mul}[op]
        got, want = port_fn(spec, ta, tb), ref_fn(ref_spec, ja, jb)
        host = [{"add": x + y, "sub": x - y, "mul": x * y}[op] % p for x, y in zip(xs, ys)]
    assert same(got, want)
    assert spec.from_mont_np(mont.to_numpy(got)) == host


@pytest.mark.parametrize("spec,ref_spec,p", FIELDS, ids=IDS)
def test_plain_inverse_and_pow_match_reference(spec, ref_spec, p):
    xs = rand_elems(12, p, seed=4)
    ja, ta = both(ref_spec, xs)
    inv = mont.inverse(spec, ta)
    assert same(inv, ref_mont.inverse(ref_spec, ja))
    assert spec.from_mont_np(mont.to_numpy(inv)) == [pow(x, -1, p) if x else 0 for x in xs]
    e = 0x1234567890ABCDEF
    assert same(mont.mont_pow(spec, ta, e), ref_mont.mont_pow(ref_spec, ja, e))


@pytest.mark.parametrize("spec,ref_spec,p", FIELDS, ids=IDS)
def test_to_from_mont_match_reference(spec, ref_spec, p):
    xs = rand_elems(64, p, seed=5)
    raw_planar = ref_spec.to_limbs_np(xs)
    raw = torch.from_numpy(convert.limbs16_to_rows(raw_planar).view(np.int32))
    m = mont.to_mont(spec, raw)
    assert same(m, ref_mont.to_mont(ref_spec, jnp.asarray(raw_planar)))
    assert torch.equal(mont.from_mont(spec, m), raw)


@pytest.mark.parametrize("spec,ref_spec,p", FIELDS, ids=IDS)
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_kernel_wrappers_match_pallas_interpret(spec, ref_spec, p, op):
    """K1/K2 wrappers on CPU tensors (their plain versions) against the
    Pallas kernels they replace, run in interpret mode."""
    xs = rand_elems(64, p, seed=6)
    ys = list(reversed(rand_elems(64, p, seed=7)))
    ja, ta = both(ref_spec, xs)
    jb, tb = both(ref_spec, ys)
    got = getattr(fk, op)(spec, ta, tb)
    want = getattr(pk, op)(ref_spec, ja, jb, interpret=True)
    assert same(got, want)


def test_wrappers_take_plain_path_on_cpu_without_counting():
    before = dict(fk.launches)
    _, ta = both(ref_mont.FR, rand_elems(8, FR_MODULUS, seed=8))
    assert torch.equal(fk.mul(mont.FR, ta, ta), mont.mont_mul(mont.FR, ta, ta))
    assert fk.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "width", "contiguity", "mismatch"])
def test_wrappers_reject_bad_operands(bad):
    a = torch.zeros((8, 8), dtype=torch.int32)
    b = {
        "dtype": torch.zeros((8, 8), dtype=torch.int64),
        "shape": torch.zeros((4, 8), dtype=torch.int32),
        "width": torch.zeros((8, 16), dtype=torch.int32),
        "contiguity": torch.zeros((8, 16), dtype=torch.int32)[:, ::2],
        "mismatch": torch.zeros((8, 8, 1), dtype=torch.int32),
    }[bad]
    with pytest.raises(ValueError):
        fk.add(mont.FR, a, b)


def test_cuda_field_constants_match_field_specs():
    """csrc/field.cuh hard-codes each modulus and n0 = -p^-1 mod 2^32; they
    must be the limbs FieldSpec derives from fields.py."""
    src = (Path(mont.__file__).parents[1] / "csrc" / "field.cuh").read_text()
    blocks = re.findall(r"k(Fr|Fq) = \{\s*\{([^}]*)\},\s*(0x[0-9a-f]+)u\}", src)
    got = {name: ([int(x.strip().rstrip("u"), 16) for x in limbs.split(",")], int(n0, 16))
           for name, limbs, n0 in blocks}
    assert got == {"Fr": (mont.FR.p32, mont.FR.n0), "Fq": (mont.FQ.p32, mont.FQ.n0)}
    assert (mont.FR.kernel_id, mont.FQ.kernel_id) == (0, 1)

