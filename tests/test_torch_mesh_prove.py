"""The mesh prove of the port (parallel/backend_mesh.MeshBackend) on four
gloo ranks of the CPU:

- parallel/dryrun.dryrun_multichip(4, "cpu", "gloo"), the port's
  counterpart of __graft_entry__.dryrun_multichip: the domain-64 fixture
  scratch/recursive_r22 proved on the mesh gives its vk.bin and rescue
  proof_0.bin byte for byte, the distributed MSM equals the host
  Pippenger, the distributed NTT and iNTT equal gpu/ntt's, and a 2^10
  synthetic-chain mesh prove gives the single-device bytes;
- that mesh prove's vk.bin and proof.bin equal plonkit_tpu's HostBackend
  prove of the same circuit over the same key (the first 2^10 points of
  the repository's tau = 42 key, each package reading it with its own
  loader);
- without a card, MeshBackend(device="cuda"), the mesh helpers and the
  CLI's --backend mesh raise: no fallback to the CPU; with cards, a rank
  binds the card of its local rank."""

import os

import pytest
import torch

from plonkit_tpu_torch import cli
from plonkit_tpu_torch.frontend.synthetic import synth_circuit
from plonkit_tpu_torch.parallel import mesh as port_mesh
from plonkit_tpu_torch.parallel.backend_mesh import MeshBackend
from plonkit_tpu_torch.parallel.dryrun import FIXTURES, SIZES, dryrun_multichip

KEY = os.path.join(FIXTURES, "srs_2pow22.key")
CHAIN_LOG2 = SIZES["cpu"]["chain"]


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    return dryrun_multichip(4, "cpu", "gloo", key=KEY, timeout_s=120,
                            workdir=str(tmp_path_factory.mktemp("dryrun")))


CHECKS = [("fixture_64", "vk.bin = fixture vk.bin"),
          ("fixture_64", "rescue proof = fixture proof_0.bin"),
          ("msm", "uniform"), ("msm", "zero_one_padded"),
          ("ntt", "ntt"), ("ntt", "intt"), ("ntt", "round_trip"),
          ("chain", "vk.bin = one device"), ("chain", "proof.bin = one device")]


@pytest.mark.parametrize("check, item", CHECKS)
def test_dryrun_multichip_on_four_cpu_ranks(dryrun, check, item):
    got = dryrun[check][item]
    assert (got["equal"] if check == "msm" else got) is True, dryrun[check]


def test_dryrun_ran_the_mesh_paths(dryrun):
    """Four gloo ranks; the fixture at domain 64, the chain at 2^10; the
    chain prove took the distributed transforms, scans and evaluations,
    and padded the MSM's 2^10 - 6 points to a multiple of 8 * 4."""
    assert (dryrun["ranks"], dryrun["device"], dryrun["backend"]) == (4, "cpu", "gloo")
    assert dryrun["fixture_64"]["domain"] == 64
    assert dryrun["chain"]["domain"] == 1 << CHAIN_LOG2
    assert dryrun["msm"]["zero_one_padded"]["padded_to"] == 1 << SIZES["cpu"]["msm"]
    for op in ("intt", "coset_lde", "coset_intt", "grand_product", "rotate",
               "poly_eval_many", "divide_by_linear", "powers"):
        assert dryrun["chain"]["distributed"].get(op, 0) > 0, op
    assert dryrun["collectives"]["all_to_all"]["calls"] > 0


def _ref_crs(count):
    """The first `count` G1 points and the G2 pair, read with the JAX
    package's own loaders."""
    from plonkit_tpu.serialization import Crs as RefCrs
    from plonkit_tpu.serialization import CrsHandle as RefCrsHandle
    from plonkit_tpu.serialization import load_crs_g1_limbs as ref_load_crs_g1_limbs
    x, y, inf = ref_load_crs_g1_limbs(KEY, count)
    weights = [1 << (16 * k) for k in range(16)]

    def ints(planar):
        return [sum(int(v) * w for v, w in zip(col, weights)) for col in planar.T]
    points = [None if i else p for p, i in zip(zip(ints(x), ints(y)), inf)]
    return RefCrs(points, RefCrsHandle(KEY).g2_monomial_bases)


def test_mesh_prove_matches_jax_host_backend(dryrun):
    from plonkit_tpu.api import SetupForProver as RefSetupForProver
    from plonkit_tpu.backend import HostBackend
    from plonkit_tpu.frontend.circuit import CircomCircuit as RefCircuit
    from plonkit_tpu.frontend.r1cs import R1CS as RefR1CS
    circuit = synth_circuit(CHAIN_LOG2 - 1)
    r = circuit.r1cs
    ref_circuit = RefCircuit(r1cs=RefR1CS(num_inputs=r.num_inputs, num_aux=r.num_aux,
                                          num_variables=r.num_variables,
                                          constraints=r.constraints),
                             witness=list(circuit.witness))
    ref = RefSetupForProver(ref_circuit, _ref_crs(1 << CHAIN_LOG2), backend=HostBackend())
    assert bytes.fromhex(dryrun["chain"]["vk_hex"]) == ref.make_verification_key().to_bytes()
    assert bytes.fromhex(dryrun["chain"]["proof_hex"]) == ref.prove(ref_circuit).to_bytes()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_mesh_needs_a_card_when_asked_for_one(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MeshBackend(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.make_mesh("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.run_ranks(port_mesh.Mesh, 2, "cuda", "gloo")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.run_ranks(port_mesh.Mesh, 2)          # the card by default
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(4, "cuda", "gloo", KEY, workdir=str(tmp_path))


def test_a_rank_binds_the_card_of_its_local_rank(monkeypatch):
    """torchrun's LOCAL_RANK (or a spawned NCCL rank's own rank) picks the
    card, modulo the cards; a named card is kept."""
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert port_mesh._card(torch.device("cuda"), 8) == torch.device("cuda", 3)
    assert port_mesh._card(torch.device("cuda"), 2) == torch.device("cuda", 1)
    assert port_mesh._card(torch.device("cuda", 5), 8) == torch.device("cuda", 5)
    assert port_mesh._card(torch.device("cuda"), 4, 6) == torch.device("cuda", 2)
    assert port_mesh._card(torch.device("cuda"), 4, 0) == torch.device("cuda", 0)


def test_cli_backend_mesh_without_a_card_fails(no_card, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--backend", "mesh", "export-verification-key", "-m", KEY,
                  "-c", os.path.join(FIXTURES, "circuit.r1cs.json"),
                  "-v", str(tmp_path / "vk.bin")])
    assert not (tmp_path / "vk.bin").exists()
