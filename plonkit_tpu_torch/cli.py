"""plonkit-compatible command line interface of the port, from
plonkit_tpu/cli.py: the 7 base subcommands with the reference's flags and
defaults,

  analyse, setup, dump-lagrange, prove, verify, generate-verifier,
  export-verification-key

Kept from the reference: circuit-file resolution, the no-clobber
--overwrite guards, proof.json/public.json on prove, and exit code 400 for
an invalid proof (seen as 144 by a POSIX shell).  The recursive
subcommands (generate-recursive-verifier, export-recursive-verification-key,
recursive-prove, recursive-verify, check-aggregation) come with the
recursive slice of the port and are not registered yet.

`--backend cuda` (the default) proves on the card and raises without one;
`--backend cpu` takes the kernels' plain versions on the CPU.  Nothing
falls back from one to the other.
"""

import argparse
import json
import logging
import os
import sys

from . import api
from .backend_torch import TorchBackend
from .frontend import CircomCircuit, load_r1cs, load_witness
from .serialization import Crs, CrsHandle, Proof, VerificationKey

log = logging.getLogger("plonkit_tpu_torch")


def _resolve_circuit_file(filename):
    if filename:
        return filename
    if os.path.exists("circuit.r1cs") or not os.path.exists("circuit.json"):
        return "circuit.r1cs"
    return "circuit.json"


def _no_clobber(path, overwrite, what):
    if not overwrite and os.path.exists(path):
        sys.exit(f"duplicate {what} file: {path}")


def _load_circuit(circuit_file, witness=None):
    log.info("Loading circuit from %s...", circuit_file)
    return CircomCircuit(
        r1cs=load_r1cs(circuit_file),
        witness=load_witness(witness) if witness else None,
    )


def cmd_analyse(args):
    circuit = _load_circuit(_resolve_circuit_file(args.circuit))
    result = api.analyse(circuit)
    with open(args.output, "w") as f:
        f.write(result.to_json(pretty=True))
    log.info("analyse result: %s", result.to_json(include_stats=False))
    log.info("output to %s", args.output)


def cmd_setup(args):
    _no_clobber(args.srs_monomial_form, args.overwrite, "srs_monomial_form")
    srs = api.gen_key_monomial_form(args.power)
    srs.save(args.srs_monomial_form)
    log.info("srs_monomial_form saved to %s", args.srs_monomial_form)


def cmd_dump_lagrange(args):
    circuit = _load_circuit(_resolve_circuit_file(args.circuit))
    setup = api.SetupForProver(circuit, Crs.load(args.srs_monomial_form),
                               backend=TorchBackend(args.backend))
    key_l = setup.get_srs_lagrange_form_from_monomial_form()
    _no_clobber(args.srs_lagrange_form, args.overwrite, "srs_lagrange_form")
    key_l.save(args.srs_lagrange_form)
    log.info("srs_lagrange_form saved to %s", args.srs_lagrange_form)


def cmd_prove(args):
    circuit = _load_circuit(_resolve_circuit_file(args.circuit), witness=args.witness)
    setup = api.SetupForProver(
        circuit, CrsHandle(args.srs_monomial_form),
        CrsHandle(args.srs_lagrange_form) if args.srs_lagrange_form else None,
        backend=TorchBackend(args.backend))
    log.info("Proving...")
    proof = setup.prove(circuit, args.transcript)
    _no_clobber(args.proof, args.overwrite, "proof")
    proof.save(args.proof)
    log.info("Proof saved to %s", args.proof)
    inputs, serialized = proof.serialize_for_solidity()
    _no_clobber(args.proofjson, args.overwrite, "proof json")
    _no_clobber(args.publicjson, args.overwrite, "input json")
    with open(args.proofjson, "w") as f:
        json.dump([str(w) for w in serialized], f, indent=1)
    log.info("Proof json saved to %s", args.proofjson)
    with open(args.publicjson, "w") as f:
        json.dump([str(x) for x in inputs], f, indent=1)
    log.info("Public input json saved to %s", args.publicjson)


def cmd_verify(args):
    vk = VerificationKey.load(args.vk)
    proof = Proof.load(args.proof)
    if api.verify(vk, proof, args.transcript):
        log.info("Proof is valid.")
    else:
        log.info("Proof is invalid!")
        sys.exit(400)


def cmd_generate_verifier(args):
    from .solidity import render_verification_key_to_file
    vk = VerificationKey.load(args.vk)
    _no_clobber(args.sol, args.overwrite, "solidity")
    render_verification_key_to_file(vk, args.sol, args.tpl)
    log.info("Contract saved to %s", args.sol)


def cmd_export_verification_key(args):
    circuit = _load_circuit(_resolve_circuit_file(args.circuit))
    setup = api.SetupForProver(circuit, CrsHandle(args.srs_monomial_form),
                               backend=TorchBackend(args.backend))
    vk = setup.make_verification_key()
    _no_clobber(args.vk, args.overwrite, "vk")
    vk.save(args.vk)
    log.info("Verification key saved to %s", args.vk)


def build_parser():
    p = argparse.ArgumentParser(
        prog="plonkit-tpu-torch",
        description="A zkSNARK toolkit to work with circom zkSNARKs DSL in plonk proof "
                    "system (PyTorch/CUDA)")
    p.add_argument("--backend", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): prove on the card, fail without one; "
                        "cpu: the kernels' plain versions")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("analyse", help="Analyse the circuit and output some stats")
    sp.add_argument("-c", "--circuit")
    sp.add_argument("-o", "--output", default="analyse.json")
    sp.set_defaults(func=cmd_analyse)

    sp = sub.add_parser("setup", help="Trusted locally set up Plonk universal srs in monomial "
                                      "form (the tau = 42 dev SRS, made on the host by serial "
                                      "python at every power, also above 2^16, until the "
                                      "device SRS is ported)")
    sp.add_argument("-p", "--power", type=int, required=True)
    sp.add_argument("-m", "--srs_monomial_form", required=True)
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(func=cmd_setup)

    sp = sub.add_parser("dump-lagrange", help='Dump "SRS in lagrange form" from a "SRS in '
                                              'monomial form" (a group NTT in host python)')
    sp.add_argument("-m", "--srs_monomial_form", required=True)
    sp.add_argument("-l", "--srs_lagrange_form", required=True)
    sp.add_argument("-c", "--circuit")
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(func=cmd_dump_lagrange)

    sp = sub.add_parser("prove", help="Generate a SNARK proof")
    sp.add_argument("-m", "--srs_monomial_form", required=True)
    sp.add_argument("-l", "--srs_lagrange_form")
    sp.add_argument("-c", "--circuit")
    sp.add_argument("-w", "--witness", default="witness.wtns")
    sp.add_argument("-p", "--proof", default="proof.bin")
    sp.add_argument("-j", "--proofjson", default="proof.json")
    sp.add_argument("-i", "--publicjson", default="public.json")
    sp.add_argument("-t", "--transcript", default="keccak",
                    help="keccak; rescue comes with the recursive slice")
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(func=cmd_prove)

    sp = sub.add_parser("verify", help="Verify a SNARK proof")
    sp.add_argument("-p", "--proof", default="proof.bin")
    sp.add_argument("-v", "--verification_key", dest="vk", default="vk.bin")
    sp.add_argument("-t", "--transcript", default="keccak")
    sp.set_defaults(func=cmd_verify)

    sp = sub.add_parser("generate-verifier", help="Generate verifier smart contract")
    sp.add_argument("-v", "--verification_key", dest="vk", default="vk.bin")
    sp.add_argument("-s", "--sol", default="verifier.sol")
    sp.add_argument("-t", "--template", dest="tpl")
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(func=cmd_generate_verifier)

    sp = sub.add_parser("export-verification-key", help="Export verifying key")
    sp.add_argument("-m", "--srs_monomial_form", required=True)
    sp.add_argument("-c", "--circuit")
    sp.add_argument("-v", "--vk", default="vk.bin")
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(func=cmd_export_verification_key)

    return p


def main(argv=None):
    logging.basicConfig(
        level=os.environ.get("RUST_LOG", os.environ.get("LOG_LEVEL", "INFO")).upper(),
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s")
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
