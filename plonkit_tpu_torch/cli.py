"""plonkit-compatible command line interface of the port, from
plonkit_tpu/cli.py: the reference's 12 subcommands with its flags and
defaults,

  analyse, setup, dump-lagrange, prove, verify, generate-verifier,
  export-verification-key, and the recursive aggregation suite:
  generate-recursive-verifier, export-recursive-verification-key,
  recursive-prove, recursive-verify, check-aggregation

Kept from the reference: circuit-file resolution, the no-clobber
--overwrite guards, proof.json/public.json on prove, and exit code 400 for
an invalid proof or aggregation (seen as 144 by a POSIX shell).

`--backend cuda` (the default) proves on the card and raises without one;
`--backend cpu` takes the kernels' plain versions on the CPU; `--backend
mesh` proves on parallel/backend_mesh.MeshBackend over the card(s): a
world of one NCCL rank, or the ranks of torchrun's environment, of which
rank 0 writes the files.  Nothing falls back from one to another.
`setup -p` makes the SRS on the card (gpu/fixed_base.py) and
`dump-lagrange` the Lagrange form on the card (gpu/group_ntt.py) with
`--backend cuda` or `mesh` (each rank computes it, rank 0 writes it);
`--backend cpu` takes srs.py and the plain versions.
"""

import argparse
import json
import logging
import os
import sys

from . import api
from .backend_torch import TorchBackend
from .frontend import CircomCircuit, load_r1cs, load_witness
from .serialization import CrsHandle, Proof, VerificationKey

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


def _backend(args):
    """The compute backend --backend names; a mesh needs a card, as cuda."""
    if args.backend == "mesh":
        from .parallel.backend_mesh import MeshBackend
        return MeshBackend(device="cuda")
    return TorchBackend(args.backend)


def _writes(backend) -> bool:
    """Whether this process writes the outputs (rank 0 of a mesh)."""
    return getattr(backend, "rank", 0) == 0


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
    if not (api.SETUP_MIN_POW2 <= args.power <= api.SETUP_MAX_POW2):
        raise ValueError("setup power of two is not in the correct range")
    if args.backend != "cpu":
        from .curve import G2_GEN, g2_mul
        from .gpu.fixed_base import gen_crs_g1_device
        from .serialization import save_crs_g1_limbs
        TorchBackend("cuda")                    # raises without a card
        save_crs_g1_limbs(args.srs_monomial_form, *gen_crs_g1_device(args.power, api.DEV_TAU),
                          [G2_GEN, g2_mul(G2_GEN, api.DEV_TAU)])
    else:
        api.gen_key_monomial_form(args.power).save(args.srs_monomial_form)
    log.info("srs_monomial_form saved to %s", args.srs_monomial_form)


def cmd_dump_lagrange(args):
    circuit = _load_circuit(_resolve_circuit_file(args.circuit))
    backend = _backend(args)
    setup = api.SetupForProver(circuit, CrsHandle(args.srs_monomial_form), backend=backend)
    key_l = setup.get_srs_lagrange_form_from_monomial_form()
    if not _writes(backend):
        return
    _no_clobber(args.srs_lagrange_form, args.overwrite, "srs_lagrange_form")
    key_l.save(args.srs_lagrange_form)
    log.info("srs_lagrange_form saved to %s", args.srs_lagrange_form)


def cmd_prove(args):
    circuit = _load_circuit(_resolve_circuit_file(args.circuit), witness=args.witness)
    setup = api.SetupForProver(
        circuit, CrsHandle(args.srs_monomial_form),
        CrsHandle(args.srs_lagrange_form) if args.srs_lagrange_form else None,
        backend=_backend(args))
    log.info("Proving...")
    proof = setup.prove(circuit, args.transcript)
    if not _writes(setup.backend):
        return
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
                               backend=_backend(args))
    vk = setup.make_verification_key()
    if not _writes(setup.backend):
        return
    _no_clobber(args.vk, args.overwrite, "vk")
    vk.save(args.vk)
    log.info("Verification key saved to %s", args.vk)


def _load_proof_list(path):
    proofs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                proofs.append(Proof.load(line))
    if not proofs:
        sys.exit(f"no proofs listed in {path}")
    n_inputs = len(proofs[0].input_values)
    for p in proofs:
        if len(p.input_values) != n_inputs:
            sys.exit("proofs have different num inputs")
    return proofs


def cmd_export_recursive_vk(args):
    from .recursive.aggregation import make_recursive_vk
    old_vk = VerificationKey.load(args.old_vk)
    if args.num_inputs != old_vk.num_inputs:
        sys.exit(f"--num_inputs {args.num_inputs} != old vk num_inputs {old_vk.num_inputs}")
    _no_clobber(args.vk, args.overwrite, "recursive vk")
    backend = _backend(args)
    rvk = make_recursive_vk(CrsHandle(args.srs_monomial_form), old_vk,
                            args.num_proofs_to_check, backend=backend)
    if not _writes(backend):
        return
    rvk.save(args.vk)
    log.info("Recursive verification key saved to %s", args.vk)


def cmd_recursive_prove(args):
    from .recursive.aggregation import prove_aggregation
    old_vk = VerificationKey.load(args.old_vk)
    proofs = _load_proof_list(args.old_proof_list)
    _no_clobber(args.new_proof, args.overwrite, "recursive proof")
    _no_clobber(args.proofjson, args.overwrite, "recursive proof json")
    backend = _backend(args)
    agg = prove_aggregation(CrsHandle(args.srs_monomial_form), proofs, old_vk, backend=backend)
    if not _writes(backend):
        return
    agg.save(args.new_proof)
    log.info("Recursive proof saved to %s", args.new_proof)
    with open(args.proofjson, "w") as f:
        json.dump(agg.solidity_json(), f, indent=1)
    log.info("Recursive proof json saved to %s", args.proofjson)


def cmd_recursive_verify(args):
    from .plonk.extended import VerificationKey2
    from .recursive.aggregation import AggregatedProof, verify_aggregation
    rvk = VerificationKey2.load(args.vk)
    agg = AggregatedProof.load(args.proof)
    if verify_aggregation(rvk, agg):
        log.info("Proof is valid.")
    else:
        log.info("Proof is invalid!")
        sys.exit(400)


def cmd_check_aggregation(args):
    from .recursive.aggregation import AggregatedProof, check_aggregation
    old_vk = VerificationKey.load(args.old_vk)
    proofs = _load_proof_list(args.old_proof_list)
    agg = AggregatedProof.load(args.new_proof)
    if check_aggregation(old_vk, proofs, agg):
        log.info("Aggregation is corresponding to the original proofs.")
    else:
        log.info("Aggregation does NOT correspond to the original proofs!")
        sys.exit(400)


def cmd_generate_recursive_verifier(args):
    from .plonk.extended import VerificationKey2
    from .solidity import render_recursive_verification_key_to_file
    old_vk = VerificationKey.load(args.old_vk)
    new_vk = VerificationKey2.load(args.new_vk)
    _no_clobber(args.sol, args.overwrite, "solidity")
    render_recursive_verification_key_to_file(old_vk, new_vk, args.num_inputs,
                                              args.sol, args.tpl)
    log.info("Contract saved to %s", args.sol)


def build_parser():
    p = argparse.ArgumentParser(
        prog="plonkit-tpu-torch",
        description="A zkSNARK toolkit to work with circom zkSNARKs DSL in plonk proof "
                    "system (PyTorch/CUDA)")
    p.add_argument("--backend", choices=["cuda", "cpu", "mesh"], default="cuda",
                   help="cuda (default): prove on the card, fail without one; "
                        "cpu: the kernels' plain versions; mesh: the mesh backend "
                        "over the card(s), one rank per process")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("analyse", help="Analyse the circuit and output some stats")
    sp.add_argument("-c", "--circuit")
    sp.add_argument("-o", "--output", default="analyse.json")
    sp.set_defaults(func=cmd_analyse)

    sp = sub.add_parser("setup", help="Trusted locally set up Plonk universal srs in monomial "
                                      "form (the tau = 42 dev SRS: on the card, or serial "
                                      "python on the host with --backend cpu)")
    sp.add_argument("-p", "--power", type=int, required=True)
    sp.add_argument("-m", "--srs_monomial_form", required=True)
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(func=cmd_setup)

    sp = sub.add_parser("dump-lagrange", help='Dump "SRS in lagrange form" from a "SRS in '
                                              'monomial form" (a group NTT on the card)')
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
                    help="keccak, or rescue for a proof that recursive-prove aggregates")
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(func=cmd_prove)

    sp = sub.add_parser("verify", help="Verify a SNARK proof")
    sp.add_argument("-p", "--proof", default="proof.bin")
    sp.add_argument("-v", "--verification_key", dest="vk", default="vk.bin")
    sp.add_argument("-t", "--transcript", default="keccak",
                    help="the proof's transcript: keccak or rescue")
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

    # recursive aggregation suite (flags mirror plonkit's src/bin/main.rs:154-256)
    sp = sub.add_parser("generate-recursive-verifier",
                        help="Generate recursive verifier smart contract")
    sp.add_argument("-o", "--old_vk", default="vk.bin")
    sp.add_argument("-n", "--new_vk", default="recursive_vk.bin")
    sp.add_argument("-i", "--num_inputs", type=int, required=True)
    sp.add_argument("-s", "--sol", default="verifier.sol")
    sp.add_argument("-t", "--template", dest="tpl")
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(func=cmd_generate_recursive_verifier)

    sp = sub.add_parser("export-recursive-verification-key",
                        help="Export Recursive verifying key")
    sp.add_argument("-c", "--num_proofs_to_check", type=int, required=True)
    sp.add_argument("-i", "--num_inputs", type=int, required=True)
    sp.add_argument("-m", "--srs_monomial_form", required=True)
    sp.add_argument("-o", "--old_vk", default="vk.bin",
                    help="inner verification key (the inner domain and selectors "
                         "are part of the aggregation circuit's structure)")
    sp.add_argument("-v", "--vk", default="recursive_vk.bin")
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(func=cmd_export_recursive_vk)

    sp = sub.add_parser("recursive-prove", help="Aggregate multiple proofs")
    sp.add_argument("-m", "--srs_monomial_form", required=True)
    sp.add_argument("-f", "--old_proof_list", required=True)
    sp.add_argument("-v", "--old_vk", default="vk.bin")
    sp.add_argument("-n", "--new_proof", default="recursive_proof.bin")
    sp.add_argument("-j", "--proofjson", default="recursive_proof.json")
    sp.add_argument("--overwrite", action="store_true")
    sp.set_defaults(func=cmd_recursive_prove)

    sp = sub.add_parser("recursive-verify", help="Verify recursive proof")
    sp.add_argument("-p", "--proof", default="recursive_proof.bin")
    sp.add_argument("-v", "--verification_key", dest="vk", default="recursive_vk.bin")
    sp.set_defaults(func=cmd_recursive_verify)

    sp = sub.add_parser("check-aggregation", help="Check proofs aggregation")
    sp.add_argument("-o", "--old_proof_list", required=True)
    sp.add_argument("-v", "--old_vk", default="vk.bin")
    sp.add_argument("-n", "--new_proof", default="recursive_proof.bin")
    sp.set_defaults(func=cmd_check_aggregation)

    return p


def main(argv=None):
    logging.basicConfig(
        level=os.environ.get("RUST_LOG", os.environ.get("LOG_LEVEL", "INFO")).upper(),
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s")
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
