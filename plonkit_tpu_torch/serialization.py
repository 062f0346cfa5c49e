"""Binary encodings for all plonkit artifacts, byte-compatible with the
reference toolchain.

Formats verified byte-for-byte against the committed reference artifacts:
  - SRS (.key):   plonkit's keys/setup/setup_2^10.key
  - vk.bin / proof.bin: plonkit's test/circuits/simple/
Reference behavior: bellman_ce kate_commitment Crs::read/write (SURVEY D1b),
better_cs keys.rs Proof/VerificationKey read/write (SURVEY D1g),
reader.rs (SURVEY C5).

Encodings:
  Fr:  32-byte big-endian canonical integer.
  G1:  64 bytes, x||y big-endian; infinity = flag byte 0x40 then zeros.
  G2:  128 bytes, x.c1||x.c0||y.c1||y.c0 big-endian; same infinity flag.
  Vec: u64 big-endian length prefix then elements.
"""

import io
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .curve import g1_is_on_curve, g2_is_on_curve
from .fields import FQ_MODULUS, FR_MODULUS

G1Point = Optional[Tuple[int, int]]
G2Point = Optional[Tuple[Tuple[int, int], Tuple[int, int]]]

_INFINITY_FLAG = 0x40


# ---------------------------------------------------------------------------
# primitive encoders
# ---------------------------------------------------------------------------

def write_u64(w, v: int):
    w.write(struct.pack(">Q", v))


def read_u64(r) -> int:
    return struct.unpack(">Q", r.read(8))[0]


def write_fr(w, v: int):
    w.write((v % FR_MODULUS).to_bytes(32, "big"))


def read_fr(r) -> int:
    v = int.from_bytes(r.read(32), "big")
    if v >= FR_MODULUS:
        raise ValueError("Fr value out of range")
    return v


def write_g1(w, p: G1Point):
    if p is None:
        w.write(bytes([_INFINITY_FLAG]) + b"\x00" * 63)
        return
    x, y = p
    w.write(x.to_bytes(32, "big") + y.to_bytes(32, "big"))


def read_g1(r, check: bool = True) -> G1Point:
    buf = r.read(64)
    if len(buf) != 64:
        raise ValueError("truncated G1 point")
    if buf[0] & _INFINITY_FLAG:
        if any(buf[1:]) or (buf[0] & ~_INFINITY_FLAG):
            raise ValueError("malformed infinity encoding")
        return None
    x = int.from_bytes(buf[:32], "big")
    y = int.from_bytes(buf[32:], "big")
    if x >= FQ_MODULUS or y >= FQ_MODULUS:
        raise ValueError("G1 coordinate out of range")
    p = (x, y)
    if check and not g1_is_on_curve(p):
        raise ValueError("G1 point not on curve")
    return p


def write_g2(w, p: G2Point):
    if p is None:
        w.write(bytes([_INFINITY_FLAG]) + b"\x00" * 127)
        return
    (x0, x1), (y0, y1) = p
    w.write(x1.to_bytes(32, "big") + x0.to_bytes(32, "big") + y1.to_bytes(32, "big") + y0.to_bytes(32, "big"))


def read_g2(r, check: bool = True) -> G2Point:
    buf = r.read(128)
    if len(buf) != 128:
        raise ValueError("truncated G2 point")
    if buf[0] & _INFINITY_FLAG:
        if any(buf[1:]) or (buf[0] & ~_INFINITY_FLAG):
            raise ValueError("malformed infinity encoding")
        return None
    x1, x0, y1, y0 = (int.from_bytes(buf[i:i + 32], "big") for i in range(0, 128, 32))
    for c in (x0, x1, y0, y1):
        if c >= FQ_MODULUS:
            raise ValueError("G2 coordinate out of range")
    p = ((x0, x1), (y0, y1))
    if check and not g2_is_on_curve(p):
        raise ValueError("G2 point not on curve")
    return p


# ---------------------------------------------------------------------------
# SRS (Crs) -- monomial or lagrange form share the same container
# ---------------------------------------------------------------------------

@dataclass
class Crs:
    """Universal setup: g1_bases[i] = tau^i * G1 (monomial form) or the
    Lagrange-basis commitments L_i(tau) * G1 (lagrange form);
    g2_monomial_bases = [G2, tau * G2]."""
    g1_bases: List[Tuple[int, int]]
    g2_monomial_bases: List[Tuple]

    def write(self, w):
        write_u64(w, len(self.g1_bases))
        for p in self.g1_bases:
            write_g1(w, p)
        write_u64(w, len(self.g2_monomial_bases))
        for p in self.g2_monomial_bases:
            write_g2(w, p)

    @classmethod
    def read(cls, r, check: bool = False):
        n = read_u64(r)
        g1_bases = [read_g1(r, check) for _ in range(n)]
        n2 = read_u64(r)
        g2_bases = [read_g2(r, check) for _ in range(n2)]
        return cls(g1_bases, g2_bases)

    @classmethod
    def load(cls, filename: str, check: bool = False):
        with open(filename, "rb") as f:
            return cls.read(io.BytesIO(f.read()), check)

    def save(self, filename: str):
        with open(filename, "wb") as f:
            self.write(f)


# ---------------------------------------------------------------------------
# VerificationKey (width-4 + D-next system)
# ---------------------------------------------------------------------------

@dataclass
class VerificationKey:
    n: int                               # usable rows = domain_size - 1
    num_inputs: int
    selector_commitments: List[G1Point]          # [q_a q_b q_c q_d q_m q_const]
    next_step_selector_commitments: List[G1Point]  # [q_d_next]
    permutation_commitments: List[G1Point]         # [sigma_0..sigma_3]
    non_residues: List[int] = field(default_factory=lambda: [5, 7, 10])
    g2_elements: List[G2Point] = field(default_factory=list)   # [G2, tau*G2]

    @property
    def domain_size(self) -> int:
        size = self.n + 1
        if size & (size - 1):
            raise ValueError(f"vk domain size {size} is not a power of two")
        return size

    def write(self, w):
        write_u64(w, self.n)
        write_u64(w, self.num_inputs)
        write_u64(w, len(self.selector_commitments))
        for p in self.selector_commitments:
            write_g1(w, p)
        write_u64(w, len(self.next_step_selector_commitments))
        for p in self.next_step_selector_commitments:
            write_g1(w, p)
        write_u64(w, len(self.permutation_commitments))
        for p in self.permutation_commitments:
            write_g1(w, p)
        write_u64(w, len(self.non_residues))
        for v in self.non_residues:
            write_fr(w, v)
        for p in self.g2_elements:
            write_g2(w, p)

    @classmethod
    def read(cls, r):
        n = read_u64(r)
        num_inputs = read_u64(r)
        sels = [read_g1(r) for _ in range(read_u64(r))]
        nexts = [read_g1(r) for _ in range(read_u64(r))]
        perms = [read_g1(r) for _ in range(read_u64(r))]
        residues = [read_fr(r) for _ in range(read_u64(r))]
        g2s = [read_g2(r) for _ in range(2)]
        return cls(n, num_inputs, sels, nexts, perms, residues, g2s)

    @classmethod
    def load(cls, filename: str):
        with open(filename, "rb") as f:
            return cls.read(f)

    def save(self, filename: str):
        with open(filename, "wb") as f:
            self.write(f)

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.write(buf)
        return buf.getvalue()


# ---------------------------------------------------------------------------
# Proof (width-4 + D-next system)
# ---------------------------------------------------------------------------

@dataclass
class Proof:
    n: int
    num_inputs: int
    input_values: List[int]
    wire_commitments: List[G1Point]          # 4
    grand_product_commitment: G1Point
    quotient_poly_commitments: List[G1Point]  # 4
    wire_values_at_z: List[int]               # 4
    wire_values_at_z_omega: List[int]         # 1
    grand_product_at_z_omega: int
    quotient_polynomial_at_z: int
    linearization_polynomial_at_z: int
    permutation_polynomials_at_z: List[int]   # 3
    opening_at_z_proof: G1Point
    opening_at_z_omega_proof: G1Point

    def write(self, w):
        write_u64(w, self.n)
        write_u64(w, self.num_inputs)
        for v in self.input_values:
            write_fr(w, v)
        write_u64(w, len(self.wire_commitments))
        for p in self.wire_commitments:
            write_g1(w, p)
        write_g1(w, self.grand_product_commitment)
        write_u64(w, len(self.quotient_poly_commitments))
        for p in self.quotient_poly_commitments:
            write_g1(w, p)
        write_u64(w, len(self.wire_values_at_z))
        for v in self.wire_values_at_z:
            write_fr(w, v)
        write_u64(w, len(self.wire_values_at_z_omega))
        for v in self.wire_values_at_z_omega:
            write_fr(w, v)
        write_fr(w, self.grand_product_at_z_omega)
        write_fr(w, self.quotient_polynomial_at_z)
        write_fr(w, self.linearization_polynomial_at_z)
        write_u64(w, len(self.permutation_polynomials_at_z))
        for v in self.permutation_polynomials_at_z:
            write_fr(w, v)
        write_g1(w, self.opening_at_z_proof)
        write_g1(w, self.opening_at_z_omega_proof)

    @classmethod
    def read(cls, r):
        n = read_u64(r)
        num_inputs = read_u64(r)
        input_values = [read_fr(r) for _ in range(num_inputs)]
        wires = [read_g1(r) for _ in range(read_u64(r))]
        grand_product = read_g1(r)
        quotients = [read_g1(r) for _ in range(read_u64(r))]
        wz = [read_fr(r) for _ in range(read_u64(r))]
        wzo = [read_fr(r) for _ in range(read_u64(r))]
        gpzo = read_fr(r)
        tz = read_fr(r)
        rz = read_fr(r)
        permz = [read_fr(r) for _ in range(read_u64(r))]
        op_z = read_g1(r)
        op_zo = read_g1(r)
        return cls(n, num_inputs, input_values, wires, grand_product, quotients,
                   wz, wzo, gpzo, tz, rz, permz, op_z, op_zo)

    @classmethod
    def load(cls, filename: str):
        with open(filename, "rb") as f:
            return cls.read(f)

    def save(self, filename: str):
        with open(filename, "wb") as f:
            self.write(f)

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        self.write(buf)
        return buf.getvalue()

    def serialize_for_solidity(self) -> Tuple[List[int], List[int]]:
        """(public_inputs, 33-word serialized proof) exactly as
        bellman_vk_codegen::serialize_proof / template.sol:864-951 expect."""
        def pt(p):
            return [0, 0] if p is None else [p[0], p[1]]
        words: List[int] = []
        for p in self.wire_commitments:
            words += pt(p)
        words += pt(self.grand_product_commitment)
        for p in self.quotient_poly_commitments:
            words += pt(p)
        words += self.wire_values_at_z
        words += self.wire_values_at_z_omega
        words.append(self.grand_product_at_z_omega)
        words.append(self.quotient_polynomial_at_z)
        words.append(self.linearization_polynomial_at_z)
        words += self.permutation_polynomials_at_z
        words += pt(self.opening_at_z_proof)
        words += pt(self.opening_at_z_omega_proof)
        assert len(words) == 33
        return list(self.input_values), words


# ---------------------------------------------------------------------------
# bulk numpy fast paths (no per-element python ints)
# ---------------------------------------------------------------------------

def load_crs_g1_limbs(filename: str, count: int = None):
    """Parse the SRS G1 section directly into raw little-endian 32-bit limb
    arrays with numpy: returns (x_raw [N, 8] uint32, y_raw [N, 8] uint32,
    inf [N] bool), one row per point (the port's limb layout,
    gpu/mont.py).  No per-point python ints: the host MSM context packs
    its bases straight from these rows."""
    import numpy as np
    with open(filename, "rb") as f:
        n = struct.unpack(">Q", f.read(8))[0]
        if count is not None:
            n = min(n, count)
        raw = np.frombuffer(f.read(64 * n), dtype=np.uint8).reshape(n, 64)
    inf = (raw[:, 0] & _INFINITY_FLAG) != 0

    # big-endian 32-byte coords -> little-endian u32 limbs
    def to_limbs(be_bytes):
        le = np.ascontiguousarray(be_bytes[:, ::-1])  # [N, 32] little-endian
        return le.view("<u4").astype(np.uint32)        # [N, 8]
    x = to_limbs(raw[:, :32])
    y = to_limbs(raw[:, 32:])
    x[inf] = 0
    y[inf] = 0
    return x, y, inf


def load_witness_limbs(filename: str):
    """Parse a binary .wtns straight into [N, 8] int32 rows of raw 32-bit
    limbs (the port's layout, ready for torch.from_numpy;
    plonkit_tpu/serialization.py's load_witness_limbs gives [16, N] 16-bit
    limbs).  The values section is the file's last 32 * N bytes,
    little-endian, as frontend/witness.load_witness_from_bin reads it."""
    import numpy as np
    with open(filename, "rb") as f:
        data = f.read()
    n = struct.unpack_from("<I", data, 4 + 4 + 4 + 12 + 4 + 32)[0]
    values = np.frombuffer(data, dtype="<i4", count=8 * n, offset=len(data) - 32 * n)
    return values.astype(np.int32).reshape(n, 8)


def save_crs_g1_limbs(filename: str, x, y, inf, g2_points) -> None:
    """Write an SRS key (the layout of Crs.write) from canonical limb rows,
    the inverse of load_crs_g1_limbs: x, y [N, 8] uint32, inf [N] bool,
    and the G2 points.  No per-point python ints."""
    import numpy as np
    inf = np.asarray(inf, dtype=bool)

    def to_be(limbs):
        le = np.ascontiguousarray(limbs, dtype="<u4").view(np.uint8)   # [N, 32]
        return le[:, ::-1]
    rows = np.concatenate([to_be(x), to_be(y)], axis=1)
    rows[inf] = 0
    rows[inf, 0] = _INFINITY_FLAG
    with open(filename, "wb") as f:
        write_u64(f, rows.shape[0])
        f.write(np.ascontiguousarray(rows).tobytes())
        write_u64(f, len(g2_points))
        for p in g2_points:
            write_g2(f, p)


class CrsLimbs:
    """An SRS held as canonical limb rows (x, y [N, 8] uint32, inf [N]
    bool: load_crs_g1_limbs's layout) and its G2 points: what
    api.crs_lagrange_form makes.  It reads like a CrsHandle (num_g1,
    g1_limbs, g2_monomial_bases) and writes itself with
    save_crs_g1_limbs; no python int per point is made."""

    def __init__(self, x, y, inf, g2_monomial_bases):
        self.x, self.y, self.inf = x, y, inf
        self.num_g1 = x.shape[0]
        self.g2_monomial_bases = g2_monomial_bases

    def g1_limbs(self, count: int = None):
        return self.x[:count], self.y[:count], self.inf[:count]

    def save(self, filename: str):
        save_crs_g1_limbs(filename, self.x, self.y, self.inf, self.g2_monomial_bases)


class CrsHandle:
    """Lazy SRS accessor: parses the header/G2 eagerly (tiny) and exposes the
    G1 section either as numpy limb arrays (fast path, for the MSM bases)
    or as host points (slow, only for tiny sizes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.num_g1 = struct.unpack(">Q", f.read(8))[0]
            f.seek(8 + 64 * self.num_g1)
            n2 = struct.unpack(">Q", f.read(8))[0]
            self.g2_monomial_bases = [read_g2(io.BytesIO(f.read(128))) for _ in range(n2)]
        self._host_points = None

    def g1_limbs(self, count: int = None):
        return load_crs_g1_limbs(self.path, count)

    @property
    def g1_bases(self):
        if self._host_points is None:
            self._host_points = Crs.load(self.path).g1_bases
        return self._host_points
