"""Solidity verifier codegen, copied from plonkit_tpu/solidity.py: renders
the handlebars-style template (data/template.sol, a copy of the JAX
package's) with the verification-key constants.

Behavioral parity: bellman_vk_codegen::render_verification_key.  A custom
template path can be supplied just like `plonkit generate-verifier -t`.
The recursive verifier's renderer and template come with the recursive
slice of the port.
"""

import os
import re
from typing import Dict

from .fields import get_domain_omega
from .serialization import VerificationKey

_TEMPLATE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "template.sol")


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


def render_verification_key(vk: VerificationKey, template_path: str = None) -> str:
    with open(template_path or _TEMPLATE_PATH) as f:
        template = f.read()
    ph = _vk_placeholders(vk)

    def repl(m):
        key = m.group(1).strip()
        if key not in ph:
            raise KeyError(f"template placeholder {{{{{key}}}}} has no value")
        return ph[key]

    return re.sub(r"\{\{([^}]+)\}\}", repl, template)


def render_verification_key_to_file(vk: VerificationKey, out_path: str,
                                    template_path: str = None) -> None:
    with open(out_path, "w") as f:
        f.write(render_verification_key(vk, template_path))
