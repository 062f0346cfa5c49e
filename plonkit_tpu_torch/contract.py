"""Run a rendered verifier contract on a proof: the port of
scripts/run_contract.py, which stands in for the reference's hardhat step
(test/contract/{single,recursive}) where there is no solc and no EVM.

    run_single(verifier.sol, proof.json, public.json)      # generate-verifier, prove
    run_recursive(recursive_verifier.sol, recursive_proof.json)

The contract text runs in solvm.Interpreter.  The valid proof must be
accepted (the call returns 1) and each tampered copy rejected, by a 0 or
a revert.  Each function returns what it found, and raises
ContractCheckFailed on a valid proof that is rejected or a tampered one
that is accepted.
"""

import json
from typing import Callable, Dict

from .solvm import Interpreter, SolRevert

FR_BITS_MASK = (1 << 253) - 1   # a tampered scalar word stays below r


class ContractCheckFailed(RuntimeError):
    pass


def _ints(values):
    return [int(v, 0) if isinstance(v, str) else int(v) for v in values]


def _outcome(call: Callable[[], int]) -> str:
    try:
        return f"returned {int(call())}"
    except SolRevert as e:
        return f"reverted: {e}"


def _check(call: Callable, valid: tuple, tampered: Dict[str, tuple]) -> dict:
    got = _outcome(lambda: call(*valid))
    if got != "returned 1":
        raise ContractCheckFailed(f"the contract rejected a valid proof ({got})")
    rejected = {}
    for name, args in tampered.items():
        out = _outcome(lambda: call(*args))
        if out == "returned 1":
            raise ContractCheckFailed(f"the contract accepted a tampered proof ({name})")
        rejected[name] = out
    return {"accepted": True, "rejected": rejected}


def run_single(sol_path: str, proof_json: str, public_json: str) -> dict:
    """verify_serialized_proof(inputs, words) of a generate-verifier
    contract on prove's proof.json and public.json, then on a copy with
    public input 0 + 1, scalar word 18 (a wire value at z) + 1 and
    commitment word 0 + 1."""
    with open(sol_path) as f:
        itp = Interpreter(f.read())
    with open(proof_json) as f:
        words = _ints(json.load(f))
    with open(public_json) as f:
        inputs = _ints(json.load(f))

    def with_word(i, v):
        out = list(words)
        out[i] = v
        return out

    return _check(lambda *a: itp.call("verify_serialized_proof", *a), (inputs, words), {
        "public input 0 + 1": ([inputs[0] + 1] + inputs[1:], words),
        "word 18 + 1": (inputs, with_word(18, (words[18] + 1) & FR_BITS_MASK)),
        "word 0 + 1": (inputs, with_word(0, words[0] + 1)),
    })


def recursive_arguments(blob: dict) -> tuple:
    """(aggr_limbs, vk_root, individual_inputs, proof): the arguments of
    verifyAggregatedProof, from the dict of recursive_proof.json."""
    (vk_root,) = _ints([blob["vk_root"]])
    return (_ints(blob["aggr_limbs"]), vk_root, _ints(blob["individual_inputs"]),
            _ints(blob["proof"]))


def run_recursive(sol_path: str, proof_json: str) -> dict:
    """verifyAggregatedProof(aggr_limbs, vk_root, individual_inputs, proof)
    of a generate-recursive-verifier contract on recursive-prove's
    recursive_proof.json, then on a copy with individual input 0 + 1,
    aggregate limb 0 + 1 and vk_root + 1."""
    with open(sol_path) as f:
        itp = Interpreter(f.read())
    with open(proof_json) as f:
        limbs, vk_root, inputs, words = recursive_arguments(json.load(f))
    return _check(lambda *a: itp.call("verifyAggregatedProof", *a),
                  (limbs, vk_root, inputs, words), {
        "individual input 0 + 1": (limbs, vk_root, [inputs[0] + 1] + inputs[1:], words),
        "aggregate limb 0 + 1": ([limbs[0] + 1] + limbs[1:], vk_root, inputs, words),
        "vk_root + 1": (limbs, vk_root + 1, inputs, words),
    })
