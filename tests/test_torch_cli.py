"""The port's CLI (`python -m plonkit_tpu_torch`, plonkit_tpu_torch/cli.py)
on the in-repo circuit scratch/recursive_r22 (27 variables, domain 64),
with `--backend cpu`, against the JAX package's CLI with `--backend host`
run in the same test: the same files, byte for byte.  Both CLIs run in
this process except where an exit code is the point; the SRS is the
port's `setup -p 10`, which must equal the first 2^10 points of the in-repo
tau = 42 key, and `dump-lagrange` must not read the key as python points
(Crs.load).  Also: the checks on user data that the port raises as
ValueError hold under `python -O`."""

import json
import os
import shutil
import struct
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from plonkit_tpu import cli as ref_cli
from plonkit_tpu.frontend.witness import load_witness_from_bin as ref_load_witness_from_bin
from plonkit_tpu_torch import cli, native
from plonkit_tpu_torch.api import SetupForProver
from plonkit_tpu_torch.frontend.r1cs import write_r1cs_bin
from plonkit_tpu_torch.frontend.synthetic import synth_circuit
from plonkit_tpu_torch.frontend.witness import load_witness_from_bin, write_witness_bin
from plonkit_tpu_torch.serialization import Crs, CrsHandle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "scratch", "recursive_r22")
CIRCUIT = os.path.join(FIXTURES, "circuit.r1cs.json")
WITNESS = os.path.join(FIXTURES, "witness_0.json")
KEY_2POW22 = os.path.join(FIXTURES, "srs_2pow22.key")


@pytest.fixture(autouse=True, scope="module")
def _env(tmp_path_factory):
    old_threads, old_build = torch.get_num_threads(), native.BUILD_DIR
    torch.set_num_threads(1)
    native.BUILD_DIR = str(tmp_path_factory.mktemp("native_build"))
    yield
    torch.set_num_threads(old_threads)
    native.BUILD_DIR = old_build


def port(*args):
    cli.main(["--backend", "cpu", *args])


def ref(*args):
    ref_cli.main(["--backend", "host", *args])


def run_port_cli(args, cwd, prelude=""):
    """The port's CLI in a fresh interpreter, as a user runs it."""
    env = dict(os.environ, PYTHONPATH=REPO)
    cmd = ([sys.executable, "-c", prelude + "import runpy, sys; sys.argv[0] = 'plonkit_tpu_torch'; "
            "runpy.run_module('plonkit_tpu_torch', run_name='__main__')", *args]
           if prelude else [sys.executable, "-m", "plonkit_tpu_torch", *args])
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_crs_load(*args, **kwargs):
    raise AssertionError("dump-lagrange read the key as python points (Crs.load)")


@pytest.fixture(scope="module")
def out(tmp_path_factory):
    """Every command once, each CLI writing its own files into one dir."""
    d = tmp_path_factory.mktemp("cli")

    def p(name):
        return str(d / name)
    port("setup", "-p", "10", "-m", p("setup.key"))
    key = p("setup.key")
    for run, tag in ((port, "port"), (ref, "jax")):
        run("analyse", "-c", CIRCUIT, "-o", p(f"{tag}_analyse.json"))
        run("export-verification-key", "-m", key, "-c", CIRCUIT, "-v", p(f"{tag}_vk.bin"))
        run("prove", "-m", key, "-c", CIRCUIT, "-w", WITNESS, "-p", p(f"{tag}_proof.bin"),
            "-j", p(f"{tag}_proof.json"), "-i", p(f"{tag}_public.json"))
        with pytest.MonkeyPatch.context() as mp:
            if run is port:             # the port reads the key as limb rows
                mp.setattr(Crs, "load", _no_crs_load)
            run("dump-lagrange", "-m", key, "-l", p(f"{tag}_lagrange.key"), "-c", CIRCUIT)
        run("generate-verifier", "-v", p(f"{tag}_vk.bin"), "-s", p(f"{tag}_verifier.sol"))
    with open(WITNESS) as f:
        write_witness_bin([int(v) for v in json.load(f)], p("witness.wtns"))
    port("prove", "-m", key, "-c", CIRCUIT, "-w", p("witness.wtns"), "-p", p("port_proof_wtns.bin"),
         "-j", p("wtns_proof.json"), "-i", p("wtns_public.json"))
    port("prove", "-m", key, "-l", p("port_lagrange.key"), "-c", CIRCUIT, "-w", WITNESS,
         "-p", p("port_proof_l.bin"), "-j", p("l_proof.json"), "-i", p("l_public.json"))
    return d


def read(d, name, mode="rb"):
    with open(d / name, mode) as f:
        return f.read()


def test_setup_equals_the_in_repo_key(out):
    """`setup -p 10` writes the G1 and G2 sections of the in-repo key's
    first 2^10 points."""
    got = read(out, "setup.key")
    n = 1 << 10
    assert struct.unpack(">Q", got[:8])[0] == n
    with open(KEY_2POW22, "rb") as f:
        total = struct.unpack(">Q", f.read(8))[0]
        g1 = f.read(64 * n)
        f.seek(8 + 64 * total)
        g2 = f.read()
    assert got[8:8 + 64 * n] == g1
    assert got[8 + 64 * n:] == g2


def test_export_verification_key_equals_jax_vk(out):
    vk = read(out, "port_vk.bin")
    assert vk == read(out, "jax_vk.bin")
    with open(os.path.join(FIXTURES, "vk.bin"), "rb") as f:
        assert vk == f.read()


@pytest.mark.parametrize("name", ["proof.bin", "proof.json", "public.json"])
def test_prove_equals_jax_cli(out, name):
    assert read(out, "port_" + name) == read(out, "jax_" + name)


def test_prove_from_wtns_gives_the_same_bytes(out):
    values = load_witness_from_bin(str(out / "witness.wtns"))
    assert values == ref_load_witness_from_bin(str(out / "witness.wtns"))
    with open(WITNESS) as f:
        assert values == [int(v) for v in json.load(f)]
    assert read(out, "port_proof_wtns.bin") == read(out, "port_proof.bin")


def test_dump_lagrange_equals_jax_and_prove_l_gives_the_same_bytes(out):
    """The port's `--backend cpu dump-lagrange` (the plain K14 and K15 over
    the key's limb rows: the fixture makes Crs.load raise while it runs)
    writes the JAX package's key, and `prove -l` with it the proof."""
    assert read(out, "port_lagrange.key") == read(out, "jax_lagrange.key")
    assert read(out, "port_proof_l.bin") == read(out, "port_proof.bin")


def test_analyse_json_equals_jax(out):
    port_json = json.loads(read(out, "port_analyse.json", "r"))
    assert port_json == json.loads(read(out, "jax_analyse.json", "r"))
    assert port_json["num_variables"] == 27


def test_generate_verifier_equals_jax(out):
    sol = read(out, "port_verifier.sol", "r")
    assert sol == read(out, "jax_verifier.sol", "r")
    assert "{{" not in sol and "verify_serialized_proof" in sol


def test_verify_accepts_and_a_tampered_proof_exits_400(out, tmp_path):
    port("verify", "-p", str(out / "port_proof.bin"), "-v", str(out / "port_vk.bin"))
    blob = bytearray(read(out, "port_proof.bin"))
    blob[17] ^= 1  # a bit of the public input
    (tmp_path / "bad.bin").write_bytes(bytes(blob))
    with pytest.raises(SystemExit) as e:
        port("verify", "-p", str(tmp_path / "bad.bin"), "-v", str(out / "port_vk.bin"))
    assert e.value.code == 400
    # as a process: exit(400) is seen as 400 & 0xFF
    proc = run_port_cli(["--backend", "cpu", "verify", "-p", "bad.bin",
                         "-v", str(out / "port_vk.bin")], tmp_path)
    assert proc.returncode == 144, proc.stderr[-2000:]


def test_no_clobber_guard(out, tmp_path):
    shutil.copy(out / "port_proof.bin", tmp_path / "proof.bin")
    with pytest.raises(SystemExit) as e:
        port("prove", "-m", str(out / "setup.key"), "-c", CIRCUIT, "-w", WITNESS,
             "-p", str(tmp_path / "proof.bin"), "-j", str(tmp_path / "proof.json"),
             "-i", str(tmp_path / "public.json"))
    assert "duplicate proof file" in str(e.value.code)
    with pytest.raises(SystemExit):
        port("setup", "-p", "10", "-m", str(out / "setup.key"))


def test_circuit_file_resolution(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli._resolve_circuit_file("x.r1cs") == "x.r1cs"
    assert cli._resolve_circuit_file(None) == "circuit.r1cs"
    (tmp_path / "circuit.json").write_text("{}")
    assert cli._resolve_circuit_file(None) == "circuit.json"
    (tmp_path / "circuit.r1cs").write_bytes(b"")
    assert cli._resolve_circuit_file(None) == "circuit.r1cs"


def test_rescue_transcript_fails(out, tmp_path):
    """The rescue transcript is ported: `prove -t rescue` writes the JAX
    package's rescue proof, which `verify -t rescue` accepts; verifying a
    proof under the other transcript fails with exit 400, and an unknown
    transcript raises and writes nothing."""
    key = str(out / "setup.key")
    port("prove", "-m", key, "-c", CIRCUIT, "-w", WITNESS, "-t", "rescue",
         "-p", str(tmp_path / "r.bin"), "-j", str(tmp_path / "r.json"),
         "-i", str(tmp_path / "r_pub.json"))
    assert read(tmp_path, "r.bin") == read(Path(FIXTURES), "proof_0.bin")
    port("verify", "-p", str(tmp_path / "r.bin"), "-v", str(out / "port_vk.bin"), "-t", "rescue")
    for proof, transcript in (("r.bin", "keccak"), ("port_proof.bin", "rescue")):
        path = tmp_path / proof if proof == "r.bin" else out / proof
        with pytest.raises(SystemExit) as exc:
            port("verify", "-p", str(path), "-v", str(out / "port_vk.bin"), "-t", transcript)
        assert exc.value.code == 400
    with pytest.raises(ValueError, match="unknown transcript"):
        port("prove", "-m", key, "-c", CIRCUIT, "-w", WITNESS, "-t", "blake2",
             "-p", str(tmp_path / "p.bin"))
    assert not (tmp_path / "p.bin").exists()


def test_cuda_backend_without_a_card_fails(out, tmp_path):
    """The default backend is the card; without one the CLI exits non-zero
    and writes nothing: no fallback to the CPU."""
    proc = run_port_cli(["export-verification-key", "-m", str(out / "setup.key"),
                         "-c", CIRCUIT, "-v", "vk.bin"], tmp_path,
                        prelude="import torch; torch.cuda.is_available = lambda: False; ")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "vk.bin").exists()


def test_binary_r1cs_and_wtns_give_the_api_bytes(out, tmp_path):
    """The smoke's full-width CLI phase at a small size: the synthetic chain
    written as .r1cs and .wtns, then export-verification-key and prove
    through the CLI, give the bytes of the API on the circuit object."""
    circuit = synth_circuit(5)
    write_r1cs_bin(circuit.r1cs, str(tmp_path / "chain.r1cs"))
    write_witness_bin(circuit.witness, str(tmp_path / "chain.wtns"))
    key = str(out / "setup.key")
    port("export-verification-key", "-m", key, "-c", str(tmp_path / "chain.r1cs"),
         "-v", str(tmp_path / "vk.bin"))
    port("prove", "-m", key, "-c", str(tmp_path / "chain.r1cs"), "-w", str(tmp_path / "chain.wtns"),
         "-p", str(tmp_path / "proof.bin"), "-j", str(tmp_path / "proof.json"),
         "-i", str(tmp_path / "public.json"))
    setup = SetupForProver(circuit, CrsHandle(key), device="cpu")
    assert setup.setup_polynomials.domain_size == 64
    assert (tmp_path / "vk.bin").read_bytes() == setup.make_verification_key().to_bytes()
    assert (tmp_path / "proof.bin").read_bytes() == setup.prove(circuit).to_bytes()


CHECKS_UNDER_O = r'''
import sys
from plonkit_tpu_torch.api import SetupForProver, analyse
from plonkit_tpu_torch.curve import G2_GEN
from plonkit_tpu_torch.frontend import CircomCircuit, load_r1cs
from plonkit_tpu_torch.frontend.r1cs import R1CS
from plonkit_tpu_torch.frontend.transpiler import build_witness_plan
from plonkit_tpu_torch.plonk.verifier import batch_evaluate_lagrange_polys
from plonkit_tpu_torch.serialization import Crs, VerificationKey
from plonkit_tpu_torch.srs import dev_srs_g1

assert not __debug__, "run with python -O"
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def one(constraint):
    r1cs = R1CS(num_inputs=1, num_aux=1, num_variables=2, constraints=[constraint])
    return CircomCircuit(r1cs=r1cs, witness=[1, 3])


circuit = CircomCircuit(r1cs=load_r1cs(sys.argv[1]))
checks = {
    # one side constant, the rest cancels: 1 * x = x + 5
    "unsatisfiable constant constraint":
        lambda: analyse(one(([(0, 1)], [(1, 1)], [(1, 1), (0, 5)]))),
    # constant * constant = constant: 1 * 1 = 2
    "inconsistent constant constraint":
        lambda: analyse(one(([(0, 1)], [(0, 1)], [(0, 2)]))),
    "(1, 2)": lambda: build_witness_plan(one(([(1, 1)], [(1, 1)], [(1, 1)])))._values([1]),
    "SRS too small for circuit":
        lambda: SetupForProver(circuit, Crs(dev_srs_g1(16, 42), [G2_GEN, G2_GEN]),
                               device="cpu").make_verification_key(),
    "evaluation point in domain": lambda: batch_evaluate_lagrange_polys([0], 8, 1, 1),
    "not a power of two": lambda: VerificationKey(6, 1, [], [], []).domain_size,
}
for message, fn in checks.items():
    try:
        fn()
    except ValueError as e:
        assert message in str(e), (message, str(e))
        print("RAISED", message)
    else:
        print("PASSED SILENTLY", message)
'''


def test_checks_on_user_data_hold_under_python_O(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-O", "-c", CHECKS_UNDER_O, CIRCUIT], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("RAISED") == 6, proc.stdout
