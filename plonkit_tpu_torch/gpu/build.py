"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under csrc/ becomes one shared library with a plain C interface
(`nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC`), written to plonkit_tpu_torch/build/ under a name that
carries a hash of its sources and flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.  `build_all` starts one nvcc per
source, all together, and waits for them; `load` builds on first use.
Nothing is built when a module is imported, and nothing here runs on a
machine without nvcc: the CPU path never asks for a library.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

SOURCES = ("field", "ntt", "msm", "ntt_mxu", "scan", "group_ntt")
_HEADERS = ("field.cuh", "ec.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_ARGTYPES = {
    "field": dict({name: [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]
                   for name in ("plonkit_field_mul", "plonkit_field_add",
                                "plonkit_field_sub")},
                  plonkit_field_mul_add=[_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
                  plonkit_field_powers=[_P, _P, ctypes.c_longlong, ctypes.c_int, _P, _P]),
    "ntt": {"plonkit_butterfly_dif":
            [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P],
            "plonkit_butterfly":
            [_P, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, _P]},
    "msm": {"plonkit_bucket_sweep": [_P] * 7 + [ctypes.c_longlong, ctypes.c_longlong, _P],
            "plonkit_padd": [_P] * 9 + [ctypes.c_longlong, _P],
            "plonkit_segment_fold": [_P] * 9 + [ctypes.c_longlong, _P],
            "plonkit_window_sums": [_P] * 18 + [ctypes.c_longlong, ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_int, _P],
            "plonkit_combine": [_P] * 3 + [ctypes.c_int] * 3 + [_P] * 4},
    "ntt_mxu": {"plonkit_balanced_digits": [_P, _P] + [ctypes.c_longlong] * 3 + [_P],
                "plonkit_dft_product": [_P] * 3 + [ctypes.c_longlong] * 3 + [_P],
                "plonkit_fold_redc": [_P, _P] + [ctypes.c_longlong] * 2 + [_P]},
    "scan": {"plonkit_field_scan": [_P] * 5 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3 + [_P],
             "plonkit_field_inverse": [_P] * 3 + [ctypes.c_longlong, ctypes.c_int, _P]},
    "group_ntt": {"plonkit_g1_butterfly": [_P] * 13 + [ctypes.c_longlong] * 2
                  + [ctypes.c_int] * 2 + [_P],
                  "plonkit_g1_scale": [_P] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [_P],
                  "plonkit_fq_split_mul": [_P] * 3 + [ctypes.c_longlong, _P],
                  "plonkit_g1_points_in": [_P] * 4 + [ctypes.c_longlong] + [_P] * 3},
}

_libs = {}
# per source: {"seconds": wall seconds of its nvcc, "ptxas": ptxas report}
build_log = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (name + ".cu",) + _HEADERS:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every source in `names` whose library is missing, one nvcc
    each, all started together.  Raises with nvcc's output if any fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [n for n in names if not os.path.exists(library_path(n))]
    if not todo:
        return build_log
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = library_path(name) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": out}
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{out}")
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return build_log


def load(name: str) -> ctypes.CDLL:
    """The ctypes library of csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not os.path.exists(path):
            build_all((name,))
        lib = ctypes.CDLL(path)
        for fn, argtypes in _ARGTYPES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
