"""ctypes bindings for the native BN254 host library (native/bn254.cpp).

At first use the port compiles native/bn254.cpp with the flags of
native/Makefile (`g++ -O2 -fPIC -shared -std=c++17`) into
plonkit_tpu_torch/build/, under a name carrying a hash of the source, and
loads it.  It raises if the build or the load fails: there is no
pure-python stand-in on this path.

All values cross the boundary as 32-byte little-endian canonical integers.
The MSM takes its inputs as numpy byte rows, so callers pack bases and
scalars straight from limb arrays without per-element python ints.
"""

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "bn254.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ["-O2", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libbn254-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is missing; returns its path."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = path + f".tmp{os.getpid()}"
        proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed:\n{proc.stderr}")
        os.replace(tmp, path)
    return path


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            if lib.bn254_abi_version() != 1:
                raise RuntimeError("unexpected bn254 native ABI version")
            vp, i64 = ctypes.c_void_p, ctypes.c_longlong
            lib.bn254_g1_msm.argtypes = [vp, vp, ctypes.c_long, vp, ctypes.POINTER(ctypes.c_int)]
            lib.bn254_pairing_check.argtypes = [vp, vp, ctypes.c_long, ctypes.POINTER(ctypes.c_int)]
            lib.bn254_keccak256.argtypes = [vp, ctypes.c_long, vp]
            lib.bn254_witness_eval.argtypes = [vp, i64, vp, vp, vp, vp, i64, vp, i64, i64, vp]
            for fn in (lib.bn254_g1_msm, lib.bn254_pairing_check, lib.bn254_keccak256,
                       lib.bn254_witness_eval):
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _ptr(arr: np.ndarray) -> int:
    assert arr.flags.c_contiguous
    return arr.ctypes.data


def bn254_g1_msm(points: np.ndarray, scalars: np.ndarray):
    """sum_i scalars[i] * points[i] over G1.  points: [n, 64] uint8 rows
    (x || y, little-endian; all zero = infinity); scalars: [n, 32] uint8
    rows, canonical little-endian.  Returns the affine point, None for
    infinity.  The call releases the interpreter lock, so threads overlap."""
    n = points.shape[0]
    if scalars.shape != (n, 32) or points.shape != (n, 64):
        raise ValueError("msm: points [n, 64] and scalars [n, 32] uint8")
    points = np.ascontiguousarray(points, dtype=np.uint8)
    scalars = np.ascontiguousarray(scalars, dtype=np.uint8)
    out = np.zeros(64, dtype=np.uint8)
    inf = ctypes.c_int(0)
    rc = get_lib().bn254_g1_msm(_ptr(points), _ptr(scalars), n, _ptr(out), ctypes.byref(inf))
    if rc != 0:
        raise RuntimeError(f"bn254_g1_msm failed ({rc})")
    if inf.value:
        return None
    raw = out.tobytes()
    return int.from_bytes(raw[:32], "little"), int.from_bytes(raw[32:], "little")


def _g1_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 64
    return p[0].to_bytes(32, "little") + p[1].to_bytes(32, "little")


def _g2_bytes(p) -> bytes:
    if p is None:
        return b"\x00" * 128
    (x0, x1), (y0, y1) = p
    return (x0.to_bytes(32, "little") + x1.to_bytes(32, "little")
            + y0.to_bytes(32, "little") + y1.to_bytes(32, "little"))


def bn254_pairing_check(pairs) -> bool:
    """True iff prod e(P_i, Q_i) == 1 (EVM 0x08 precompile semantics)."""
    g1 = np.frombuffer(b"".join(_g1_bytes(p1) for p1, _ in pairs), dtype=np.uint8).copy()
    g2 = np.frombuffer(b"".join(_g2_bytes(p2) for _, p2 in pairs), dtype=np.uint8).copy()
    res = ctypes.c_int(0)
    rc = get_lib().bn254_pairing_check(_ptr(g1), _ptr(g2), len(pairs), ctypes.byref(res))
    if rc != 0:
        raise RuntimeError(f"bn254_pairing_check failed ({rc})")
    return bool(res.value)


def bn254_keccak256(data: bytes) -> bytes:
    buf = np.frombuffer(bytes(data) + b"\x00", dtype=np.uint8).copy()
    out = np.zeros(32, dtype=np.uint8)
    get_lib().bn254_keccak256(_ptr(buf), len(data), _ptr(out))
    return out.tobytes()


def bn254_witness_eval(witness_bytes: bytes, n_wit: int, term_src, term_coeff: bytes,
                       prog_off, prog_const: bytes, n_extras: int, wire_idx,
                       n_cols: int, n_rows: int) -> np.ndarray:
    """Native witness-plan evaluation and column gather
    (frontend/transpiler.WitnessPlan).  Returns the wire columns as
    [n_cols, n_rows, 8] uint32 raw limb rows (the port's layout)."""
    def u8(b: bytes):
        return np.frombuffer(bytes(b) + b"\x00", dtype=np.uint8).copy()

    def i64(a):
        return np.ascontiguousarray(a, dtype=np.int64)
    w, tc, pc = u8(witness_bytes), u8(term_coeff), u8(prog_const)
    ts, po, wi = i64(term_src), i64(prog_off), i64(wire_idx)
    out = np.empty(n_cols * n_rows * 32, dtype=np.uint8)
    rc = get_lib().bn254_witness_eval(
        _ptr(w), n_wit, _ptr(ts), _ptr(tc), _ptr(po), _ptr(pc), n_extras,
        _ptr(wi), n_cols, n_rows, _ptr(out))
    if rc != 0:
        raise RuntimeError(f"bn254_witness_eval failed ({rc})")
    # the library writes [n_cols][16][n_rows] u16 limb planes
    planes = out.view("<u2").reshape(n_cols, 16, n_rows)
    rows = np.ascontiguousarray(planes.transpose(0, 2, 1))   # [cols, rows, 16]
    return rows.view("<u4").astype(np.uint32)
