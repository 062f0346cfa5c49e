"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the `cuda` marker and skips without a CUDA device
(the kernels have no CPU mode).  The file imports neither jax nor the JAX
package, so it runs on a machine that has neither; tests/conftest.py does
import jax, so on such a machine run it as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from plonkit_tpu_torch.backend_torch import FrVec, TorchBackend
from plonkit_tpu_torch.gpu import field_kernels as fk
from plonkit_tpu_torch.gpu import mont, ntt

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def rand_rows(spec, n, seed):
    """[n, 8] Montgomery rows of seeded random values, edges planted."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(n - 4)]
    return mont.to_tensor(spec.to_mont_np(vals + [0, 1, spec.p - 1, spec.p - 2]))


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_field_kernels_match_plain(card, op):
    plain = {"mul": mont.mont_mul, "add": mont.add, "sub": mont.sub}[op]
    for spec in (mont.FR, mont.FQ):
        a = rand_rows(spec, 4096, 1).to(card)
        b = rand_rows(spec, 4096, 2).flip(0).contiguous().to(card)
        before = fk.launches[op]
        assert torch.equal(getattr(fk, op)(spec, a, b), plain(spec, a, b))
        assert fk.launches[op] == before + 1


def test_butterfly_dif_matches_plain(card):
    lo, hi, w = (rand_rows(mont.FR, 2048, s).to(card) for s in (3, 4, 5))
    u, v = ntt.butterfly_dif(lo, hi, w)
    assert torch.equal(u, mont.add(mont.FR, lo, hi))
    assert torch.equal(v, mont.mont_mul(mont.FR, w, mont.sub(mont.FR, lo, hi)))


def test_transforms_on_the_card_match_the_cpu(card):
    x = rand_rows(mont.FR, 4096, 6)
    for fn in (ntt.ntt, ntt.intt, ntt.coset_ntt, ntt.coset_intt,
               lambda t: ntt.coset_lde(t, 4)):
        assert torch.equal(fn(x.to(card)).cpu(), fn(x))


def test_backend_rounds_on_the_card_match_the_cpu(card):
    cpu, gpu = TorchBackend("cpu"), TorchBackend("cuda")
    vs = [rand_rows(mont.FR, 1024, 10 + i) for i in range(9)]

    def run(b, dev):
        v = [FrVec(t.to(dev)) for t in vs]
        z = b.permutation_grand_product(v[0], v[1:5], v[5:9], 3, 5, (1, 5, 7, 10))
        return [z.data.cpu(), b.divide_by_linear(v[0], 77).data.cpu(),
                b.batch_inverse(v[1]).data.cpu()], b.poly_eval_many(v[:3], 99)

    (rows_c, ev_c), (rows_g, ev_g) = run(cpu, "cpu"), run(gpu, card)
    assert all(torch.equal(a, b) for a, b in zip(rows_c, rows_g)) and ev_c == ev_g
