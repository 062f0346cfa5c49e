"""The port stands alone: every module of plonkit_tpu_torch, and
chip_smoke.py, import with `jax` and the JAX package blocked, in a fresh
interpreter.  The card is the default: TorchBackend() raises where CUDA is
not available, and chip_smoke.py fails without a card or outside the
repository, printing no result line."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

BLOCKED_IMPORTS = r'''
import importlib, importlib.abc, pkgutil, sys

class BlockJaxPackage(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        # "plonkit_tpu_torch" shares the prefix: block only the package
        # itself and its submodules
        if name == "plonkit_tpu" or name.startswith("plonkit_tpu."):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJaxPackage())
sys.modules["jax"] = None

import plonkit_tpu_torch
names = [m.name for m in pkgutil.walk_packages(plonkit_tpu_torch.__path__,
                                               "plonkit_tpu_torch.")]
for name in names:
    importlib.import_module(name)
missing = {"plonkit_tpu_torch." + m for m in (
    "cli", "__main__", "solidity", "solvm", "contract", "trace_summary", "frontend.witness",
    "gpu.fixed_base", "gpu.group_ntt", "gpu.plain_forms",
    "gpu.ntt_mxu", "plonk.extended",
    "recursive", "recursive.aggregation", "recursive.batch", "recursive.cs",
    "recursive.ec_gadget", "recursive.franklin", "recursive.nonnative", "recursive.rescue",
    "recursive.rescue_gadget", "recursive.rns", "recursive.verifier_gadget",
    "recursive.vk_tree", "frontend.poseidon", "parallel", "parallel.mesh", "parallel.ntt",
    "parallel.msm", "parallel.backend_mesh", "parallel.prove_step", "parallel.dryrun")} - set(names)
assert not missing, missing
import chip_smoke
assert sys.modules["jax"] is None
leaked = [k for k in sys.modules if k == "plonkit_tpu" or k.startswith("plonkit_tpu.")]
assert not leaked, leaked

import torch
torch.cuda.is_available = lambda: False
from plonkit_tpu_torch.backend_torch import TorchBackend
try:
    TorchBackend()
except RuntimeError:
    pass
else:
    raise SystemExit("TorchBackend() did not raise without CUDA")
print("IMPORTED", len(names))
'''


def _run(args, cwd, extra_env=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(extra_env or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax_or_the_jax_package():
    proc = _run(["-c", BLOCKED_IMPORTS], REPO, {"PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    count = int(proc.stdout.split("IMPORTED")[1])
    assert count >= 40, proc.stdout


def test_chip_smoke_fails_without_a_card():
    proc = _run(["-c", "import runpy, torch; torch.cuda.is_available = lambda: False; "
                       "runpy.run_path('chip_smoke.py', run_name='__main__')"], REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    """With a card (faked here), a directory holding chip_smoke.py alone has
    nothing to build or import: the script must fail."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["-c", "import runpy, torch; torch.cuda.is_available = lambda: True; "
                       "runpy.run_path('chip_smoke.py', run_name='__main__')"], tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "plonkit_tpu_torch" in proc.stderr
