"""No module of the benchmark imports JAX or the JAX package, by whole
top-level name (plonkit_tpu_torch is the port and allowed; plonkit_tpu is
not), and the plain reference and the yardstick import nothing of the
program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "plonkit_tpu"}


def _modules():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_top_levels(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_names_compare_whole():
    assert "plonkit_tpu_torch".split(".")[0] not in FORBIDDEN
    assert imported_top_levels(__file__) >= {"ast", "os", "pytest"}


@pytest.mark.parametrize("path", sorted(_modules()), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_nor_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    [p for p in _modules() if os.sep + "reference" + os.sep in p or os.sep + "circuits" + os.sep in p]
    + [os.path.join(HERE, "yardstick.py")]),
    ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert "plonkit_tpu_torch" not in imported_top_levels(path)


def test_probes_name_the_port():
    """Every probe of a metric reader wraps a function of the port."""
    import importlib.util
    for f in os.listdir(os.path.join(HERE, "metrics")):
        spec = importlib.util.spec_from_file_location("m", os.path.join(HERE, "metrics", f))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        for module, _, _ in getattr(mod, "PROBES", []):
            assert module.split(".")[0] == "plonkit_tpu_torch"
