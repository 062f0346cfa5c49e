"""Witness ingestion: circom ``.wtns`` binary format and JSON decimal-string
arrays, copied from plonkit_tpu/frontend/witness.py (plonkit's
src/reader.rs:92-175)."""

import json
import struct
from typing import List

from ..fields import FR_MODULUS, FR_MODULUS_LE_BYTES


def load_witness(filename: str) -> List[int]:
    if filename.endswith("json"):
        return load_witness_from_json(filename)
    return load_witness_from_bin(filename)


def load_witness_from_json(filename: str) -> List[int]:
    with open(filename) as f:
        values = json.load(f)
    return [int(v) % FR_MODULUS for v in values]


def load_witness_from_bin(filename: str) -> List[int]:
    with open(filename, "rb") as f:
        data = f.read()
    if data[:4] != b"wtns":
        raise ValueError("invalid file header")
    version, num_sections = struct.unpack_from("<II", data, 4)
    if version > 2:
        raise ValueError("unsupported file version")
    if num_sections != 2:
        raise ValueError("invalid num sections")
    pos = 12
    sec_type, sec_size = struct.unpack_from("<IQ", data, pos)
    pos += 12
    if sec_type != 1:
        raise ValueError("invalid section type")
    if sec_size != 4 + 32 + 4:
        raise ValueError("invalid section len")
    field_size = struct.unpack_from("<I", data, pos)[0]
    pos += 4
    if field_size != 32:
        raise ValueError("invalid field byte size")
    if data[pos:pos + 32] != FR_MODULUS_LE_BYTES:
        raise ValueError("invalid curve prime")
    pos += 32
    witness_len = struct.unpack_from("<I", data, pos)[0]
    pos += 4
    sec_type, sec_size = struct.unpack_from("<IQ", data, pos)
    pos += 12
    if sec_type != 2:
        raise ValueError("invalid section type")
    if sec_size != witness_len * field_size:
        raise ValueError(f"invalid witness section size {sec_size}")
    out = []
    for i in range(witness_len):
        v = int.from_bytes(data[pos:pos + 32], "little")
        if v >= FR_MODULUS:
            raise ValueError("witness value out of field range")
        pos += 32
        out.append(v)
    return out


def write_witness_bin(values: List[int], filename: str) -> None:
    """Emit the circom .wtns v2 binary format (inverse of
    load_witness_from_bin; used for fixture generation)."""
    import io
    buf = io.BytesIO()
    buf.write(b"wtns")
    buf.write(struct.pack("<II", 2, 2))
    buf.write(struct.pack("<IQ", 1, 4 + 32 + 4))
    buf.write(struct.pack("<I", 32))
    buf.write(FR_MODULUS_LE_BYTES)
    buf.write(struct.pack("<I", len(values)))
    buf.write(struct.pack("<IQ", 2, 32 * len(values)))
    for v in values:
        buf.write((v % FR_MODULUS).to_bytes(32, "little"))
    with open(filename, "wb") as f:
        f.write(buf.getvalue())
