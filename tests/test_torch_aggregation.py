"""The port's aggregate checks on the CPU, on the in-repo fixture
scratch/recursive_r5 (one rescue proof of the domain-64 circuit, and its
recursive_vk.bin, recursive_proof.bin and recursive_verifier.sol made by
the JAX package at 2^21): verify_aggregation and check_aggregation accept
the fixture's aggregate and reject tampered copies; AggregatedProof and
VerificationKey2 round-trip to the fixture's bytes; the recursive Solidity
verifier equals recursive_verifier.sol; and the recursive CLI subcommands
that need no SRS (recursive-verify, check-aggregation,
generate-recursive-verifier) give the reference's exit codes and files."""

import io
import os
from types import SimpleNamespace

import pytest
import torch

from plonkit_tpu_torch import cli, native
from plonkit_tpu_torch.fields import FR_MODULUS as R
from plonkit_tpu_torch.plonk.extended import VerificationKey2
from plonkit_tpu_torch.recursive import aggregation
from plonkit_tpu_torch.serialization import Proof, VerificationKey
from plonkit_tpu_torch.solidity import render_recursive_verification_key

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = os.path.join(REPO, "scratch", "recursive_r5")
R22 = os.path.join(REPO, "scratch", "recursive_r22")


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


@pytest.fixture(scope="module")
def fixture():
    return SimpleNamespace(
        vk=VerificationKey.load(os.path.join(R5, "vk.bin")),
        proofs=[Proof.load(os.path.join(R5, "proof_0.bin"))],
        rvk=VerificationKey2.load(os.path.join(R5, "recursive_vk.bin")),
        agg=aggregation.AggregatedProof.load(os.path.join(R5, "recursive_proof.bin")))


def _read(name):
    with open(os.path.join(R5, name), "rb") as f:
        return f.read()


def test_aggregated_proof_and_vk2_roundtrip(fixture):
    for obj, name in ((fixture.agg, "recursive_proof.bin"), (fixture.rvk, "recursive_vk.bin")):
        buf = io.BytesIO()
        obj.write(buf)
        assert buf.getvalue() == _read(name)
        again = type(obj).read(io.BytesIO(buf.getvalue()))
        assert again == obj


def _tampered(agg, what):
    out = aggregation.AggregatedProof.read(io.BytesIO(_aggregate_bytes(agg)))
    if what == "proof":
        out.proof.wire_values_at_z[0] = (out.proof.wire_values_at_z[0] + 1) % R
    elif what == "limbs":
        out.aggr_limbs[3] = (out.aggr_limbs[3] + 1) % R
    elif what == "inputs":
        out.individual_inputs[0] = (out.individual_inputs[0] + 1) % R
    else:
        out.vk_root = (out.vk_root + 1) % R
    return out


def _aggregate_bytes(agg):
    buf = io.BytesIO()
    agg.write(buf)
    return buf.getvalue()


def test_verify_aggregation_accepts_fixture(fixture):
    assert aggregation.verify_aggregation(fixture.rvk, fixture.agg)
    assert aggregation.verify_aggregation(fixture.rvk, fixture.agg, inner_vk=fixture.vk)


@pytest.mark.parametrize("what", ["proof", "limbs", "inputs", "root"])
def test_verify_aggregation_rejects_tampered(fixture, what):
    assert not aggregation.verify_aggregation(fixture.rvk, _tampered(fixture.agg, what))


def test_check_aggregation(fixture):
    assert aggregation.check_aggregation(fixture.vk, fixture.proofs, fixture.agg)
    assert not aggregation.check_aggregation(fixture.vk, fixture.proofs,
                                             _tampered(fixture.agg, "limbs"))
    other = [Proof.load(os.path.join(R22, "proof_1.bin"))]
    assert not aggregation.check_aggregation(fixture.vk, other, fixture.agg)


def test_recursive_verifier_contract_equals_fixture(fixture):
    sol = render_recursive_verification_key(fixture.vk, fixture.rvk, 2)
    assert sol == _read("recursive_verifier.sol").decode()


# -- the CLI subcommands that need no SRS ---------------------------------------

def port_cli(*args):
    cli.main(["--backend", "cpu", *args])


def test_cli_recursive_verify_and_check(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port_cli("recursive-verify", "-p", os.path.join(R5, "recursive_proof.bin"),
             "-v", os.path.join(R5, "recursive_vk.bin"))
    _tampered(aggregation.AggregatedProof.load(os.path.join(R5, "recursive_proof.bin")),
              "proof").save("tampered.bin")
    with pytest.raises(SystemExit) as exc:
        port_cli("recursive-verify", "-p", "tampered.bin", "-v",
                 os.path.join(R5, "recursive_vk.bin"))
    assert exc.value.code == 400
    (tmp_path / "list.txt").write_text(os.path.join(R5, "proof_0.bin") + "\n")
    port_cli("check-aggregation", "-o", "list.txt", "-v", os.path.join(R5, "vk.bin"),
             "-n", os.path.join(R5, "recursive_proof.bin"))
    _tampered(aggregation.AggregatedProof.load(os.path.join(R5, "recursive_proof.bin")),
              "limbs").save("tampered_limbs.bin")
    with pytest.raises(SystemExit) as exc:
        port_cli("check-aggregation", "-o", "list.txt", "-v", os.path.join(R5, "vk.bin"),
                 "-n", "tampered_limbs.bin")
    assert exc.value.code == 400


def test_cli_generate_recursive_verifier(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    port_cli("generate-recursive-verifier", "-o", os.path.join(R5, "vk.bin"), "-n",
             os.path.join(R5, "recursive_vk.bin"), "-i", "2", "-s", "verifier.sol")
    assert (tmp_path / "verifier.sol").read_bytes() == _read("recursive_verifier.sol")
    with pytest.raises(SystemExit):           # no clobber without --overwrite
        port_cli("generate-recursive-verifier", "-o", os.path.join(R5, "vk.bin"), "-n",
                 os.path.join(R5, "recursive_vk.bin"), "-i", "2", "-s", "verifier.sol")
