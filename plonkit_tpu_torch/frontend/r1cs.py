"""circom R1CS ingestion: iden3 binary ``.r1cs`` format v1 and the snarkjs
JSON variant.

Behavioral parity with the reference parsers:
  binary: plonkit src/r1cs_file.rs:100-154 (magic, section table,
          BN254-only prime check, wire->label map with wire0 -> 0)
  json:   plonkit src/reader.rs:188-218
          (num_inputs = nPubInputs + nOutputs + 1)
"""

import json
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..fields import FR_MODULUS, FR_MODULUS_LE_BYTES

# A linear combination: list of (wire_index, coefficient)
LC = List[Tuple[int, int]]
# A constraint A * B = C
Constraint = Tuple[LC, LC, LC]


@dataclass
class R1CS:
    num_inputs: int     # 1 (the ONE wire) + nPubOut + nPubIn
    num_aux: int
    num_variables: int
    constraints: List[Constraint]
    wire_mapping: Optional[List[int]] = None


def load_r1cs(filename: str) -> R1CS:
    """Autodetect encoding by extension, mirroring reader.rs:178-185.
    NOTE: the reference discards the wire mapping for the binary path
    (reader.rs:182); we preserve that behavior by returning it but callers
    pass wire_mapping=None to the circuit just as src/bin/main.rs does."""
    if filename.endswith("json"):
        return load_r1cs_from_json(filename)
    return load_r1cs_from_bin(filename)


def load_r1cs_from_json(filename: str) -> R1CS:
    with open(filename) as f:
        data = json.load(f)
    num_inputs = data["nPubInputs"] + data["nOutputs"] + 1
    num_variables = data["nVars"]
    num_aux = num_variables - num_inputs

    def convert_lc(lc: Dict[str, str]) -> LC:
        return [(int(idx), int(coeff) % FR_MODULUS) for idx, coeff in lc.items()]

    constraints = [
        (convert_lc(c[0]), convert_lc(c[1]), convert_lc(c[2]))
        for c in data["constraints"]
    ]
    return R1CS(num_inputs, num_aux, num_variables, constraints)


def load_r1cs_from_bin(filename: str) -> R1CS:
    with open(filename, "rb") as f:
        data = f.read()
    if data[:4] != b"r1cs":
        raise ValueError("Invalid magic number")
    version, num_sections = struct.unpack_from("<II", data, 4)
    if version != 1:
        raise ValueError("Unsupported version")

    pos = 12
    section_offsets: Dict[int, int] = {}
    section_sizes: Dict[int, int] = {}
    for _ in range(num_sections):
        sec_type, sec_size = struct.unpack_from("<IQ", data, pos)
        pos += 12
        section_offsets[sec_type] = pos
        section_sizes[sec_type] = sec_size
        pos += sec_size

    # header (section 1)
    pos = section_offsets[1]
    field_size = struct.unpack_from("<I", data, pos)[0]
    if field_size != 32:
        raise ValueError("This parser only supports 32-byte fields")
    prime = data[pos + 4:pos + 4 + field_size]
    if prime != FR_MODULUS_LE_BYTES:
        raise ValueError("This parser only supports bn256")
    if section_sizes[1] != 32 + field_size:
        raise ValueError("Invalid header section size")
    pos += 4 + field_size
    n_wires, n_pub_out, n_pub_in, n_prv_in = struct.unpack_from("<IIII", data, pos)
    pos += 16
    n_labels = struct.unpack_from("<Q", data, pos)[0]
    pos += 8
    n_constraints = struct.unpack_from("<I", data, pos)[0]

    # constraints (section 2)
    pos = section_offsets[2]

    def read_lc() -> LC:
        nonlocal pos
        n_vec = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        out = []
        for _ in range(n_vec):
            wire = struct.unpack_from("<I", data, pos)[0]
            coeff = int.from_bytes(data[pos + 4:pos + 36], "little")
            if coeff >= FR_MODULUS:
                raise ValueError("coefficient out of field range")
            pos += 36
            out.append((wire, coeff))
        return out

    constraints = [(read_lc(), read_lc(), read_lc()) for _ in range(n_constraints)]

    # wire -> label map (section 3)
    pos = section_offsets[3]
    if section_sizes[3] != n_wires * 8:
        raise ValueError("Invalid map section size")
    wire_mapping = list(struct.unpack_from(f"<{n_wires}Q", data, pos))
    if wire_mapping and wire_mapping[0] != 0:
        raise ValueError("Wire 0 should always be mapped to 0")

    num_inputs = 1 + n_pub_in + n_pub_out
    return R1CS(
        num_inputs=num_inputs,
        num_aux=n_wires - num_inputs,
        num_variables=n_wires,
        constraints=constraints,
        wire_mapping=wire_mapping,
    )


def write_r1cs_bin(r1cs: R1CS, filename: str) -> None:
    """Emit the iden3 binary .r1cs v1 format (inverse of load_r1cs_from_bin;
    used for fixture generation and format round-trip tests)."""
    import io
    buf = io.BytesIO()

    def lc_bytes(lc: LC) -> bytes:
        out = struct.pack("<I", len(lc))
        for wire, coeff in lc:
            out += struct.pack("<I", wire) + (coeff % FR_MODULUS).to_bytes(32, "little")
        return out

    # header section (1)
    header = struct.pack("<I", 32) + FR_MODULUS_LE_BYTES
    wire_mapping = r1cs.wire_mapping or list(range(r1cs.num_variables))
    n_pub_out = 0
    n_pub_in = r1cs.num_inputs - 1
    header += struct.pack("<IIII", r1cs.num_variables, n_pub_out, n_pub_in, 0)
    header += struct.pack("<Q", r1cs.num_variables)
    header += struct.pack("<I", len(r1cs.constraints))

    constraints = b"".join(
        lc_bytes(a) + lc_bytes(b) + lc_bytes(c) for a, b, c in r1cs.constraints)
    wmap = struct.pack(f"<{len(wire_mapping)}Q", *wire_mapping)

    buf.write(b"r1cs")
    buf.write(struct.pack("<II", 1, 3))
    for sec_type, payload in ((1, header), (2, constraints), (3, wmap)):
        buf.write(struct.pack("<IQ", sec_type, len(payload)))
        buf.write(payload)
    with open(filename, "wb") as f:
        f.write(buf.getvalue())
