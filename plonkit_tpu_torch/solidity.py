"""Solidity verifier codegen, copied from plonkit_tpu/solidity.py: renders
the handlebars-style template (data/template.sol, a copy of the JAX
package's) with the verification-key constants.

Behavioral parity: bellman_vk_codegen::render_verification_key.  A custom
template path can be supplied just like `plonkit generate-verifier -t`.
The recursive verifier's renderer fills data/recursive_template.sol, a
copy of the JAX package's.
"""

import os
import re
from typing import Dict

from .fields import get_domain_omega
from .serialization import VerificationKey

_TEMPLATE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "template.sol")
_RECURSIVE_TEMPLATE_PATH = os.path.join(os.path.dirname(_TEMPLATE_PATH), "recursive_template.sol")


def _vk_placeholders(vk: VerificationKey) -> Dict[str, str]:
    def pt(p):
        if p is None:
            return ("0", "0")
        return (str(p[0]), str(p[1]))

    ph = {
        "domain_size": str(vk.domain_size),
        "num_inputs": str(vk.num_inputs),
        "omega": str(get_domain_omega(vk.domain_size)),
    }
    for name, points in (("selector_commitment", vk.selector_commitments),
                         ("next_step_selector_commitment", vk.next_step_selector_commitments),
                         ("permutation_commitment", vk.permutation_commitments)):
        for i, c in enumerate(points):
            ph[f"{name}_{i}_0"], ph[f"{name}_{i}_1"] = pt(c)
    for i, v in enumerate(vk.non_residues):
        ph[f"permutation_non_residue_{i}"] = str(v)
    (x0, x1), (y0, y1) = vk.g2_elements[1]
    ph["g2_x_x_c0"] = str(x0)
    ph["g2_x_x_c1"] = str(x1)
    ph["g2_x_y_c0"] = str(y0)
    ph["g2_x_y_c1"] = str(y1)
    return ph


def _render(template_path: str, ph: dict) -> str:
    with open(template_path) as f:
        template = f.read()

    def repl(m):
        key = m.group(1).strip()
        if key not in ph:
            raise KeyError(f"template placeholder {{{{{key}}}}} has no value")
        return ph[key]

    return re.sub(r"\{\{([^}]+)\}\}", repl, template)


def render_verification_key(vk: VerificationKey, template_path: str = None) -> str:
    return _render(template_path or _TEMPLATE_PATH, _vk_placeholders(vk))


def render_verification_key_to_file(vk: VerificationKey, out_path: str,
                                    template_path: str = None) -> None:
    with open(out_path, "w") as f:
        f.write(render_verification_key(vk, template_path))


def render_recursive_verification_key(old_vk, new_vk, num_individual_inputs: int,
                                      template_path: str = None) -> str:
    """Recursive (aggregated) verifier contract codegen -- the analogue of
    the reference's solidity_recursive_plonk_verifier crate
    (src/bin/main.rs:459-481).  Renders the extended-gate-system verifier
    (plonk/extended.py protocol) plus the on-chain aggregate reconstruction
    and rescue public-input recomputation (a mirror of
    recursive/aggregation.py::verify_aggregation).  `old_vk` is taken for
    the reference's signature; the contract does not depend on it."""
    from .recursive.rescue import ALPHA_INV, MDS, ROUND_CONSTANTS

    def pt(p):
        return ("0", "0") if p is None else (str(p[0]), str(p[1]))

    ph = {
        "domain_size": str(new_vk.domain_size),
        "omega": str(get_domain_omega(new_vk.domain_size)),
        "individual_inputs": str(num_individual_inputs),
        "rescue_alpha_inv": str(ALPHA_INV),
        "rescue_round_constants_body": "\n".join(
            f"        rc[{i}][{j}] = {ROUND_CONSTANTS[i][j]};"
            for i in range(len(ROUND_CONSTANTS)) for j in range(3)),
    }
    for name, points in (("selector_commitment", new_vk.selector_commitments),
                         ("next_step_selector_commitment",
                          new_vk.next_step_selector_commitments[:1]),
                         ("range_selector_commitment", new_vk.range_selector_commitments[:1]),
                         ("permutation_commitment", new_vk.permutation_commitments)):
        for i, c in enumerate(points):
            ph[f"{name}_{i}_0"], ph[f"{name}_{i}_1"] = pt(c)
    for i, v in enumerate(new_vk.non_residues):
        ph[f"permutation_non_residue_{i}"] = str(v)
    for i in range(3):
        for j in range(3):
            ph[f"mds_{i}_{j}"] = str(MDS[i][j])
    (x0, x1), (y0, y1) = new_vk.g2_elements[1]
    ph["g2_x_x_c0"], ph["g2_x_x_c1"] = str(x0), str(x1)
    ph["g2_x_y_c0"], ph["g2_x_y_c1"] = str(y0), str(y1)
    return _render(template_path or _RECURSIVE_TEMPLATE_PATH, ph)


def render_recursive_verification_key_to_file(old_vk, new_vk, num_inputs: int,
                                              out_path: str,
                                              template_path: str = None) -> None:
    with open(out_path, "w") as f:
        f.write(render_recursive_verification_key(old_vk, new_vk, num_inputs,
                                                  template_path))
