"""The port's coverage of the JAX package, name by name.

For every module of ``sdrpp_tpu`` with a counterpart of the same path in
``sdrpp_tpu_torch``, the JAX module's public top-level functions and
classes, its classes' public methods and class constants, and its
UPPER_CASE constants (read from its source, not imported) must each be
an attribute of the port's module or class (inherited ones count). What
is left is the list of deliberate exceptions: ``cli bench``, which
belongs to the benchmark, ``calibrate_sync`` (a TPU-sync workaround) and
the JAX package's lowering switches (the port has one lowering per op).
The JAX modules without a counterpart file are the four Pallas modules,
ported as the ``*_kernels.py`` wrappers of hand-written CUDA kernels, and
the three JAX/TPU host workarounds.
"""

import ast
import importlib
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
JAX, PORT = REPO / "sdrpp_tpu", REPO / "sdrpp_tpu_torch"

EXCEPTIONS = {
    "cli.py": {"cmd_bench"},
    "utils/speed_tester.py": {"calibrate_sync"},
    "ops/fir.py": {"FIR_MODE", "DECIM_MODE"},
    "ops/mix.py": {"MIX_MODE"},
    "ops/resample.py": {"DECIM_PALLAS", "POLYPHASE_MODE",
                        "GROUPED_MAX_UNROLL"},
}
NO_COUNTERPART = {"ops/scans_pallas.py", "ops/fec_pallas.py",
                  "ops/fir_pallas.py", "ops/clock_recovery_pallas.py",
                  "utils/compile_cache.py", "utils/iq.py", "utils/native.py"}


def _public(name: str) -> bool:
    return not name.startswith("_")


def _constants(body):
    for node in body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        for t in targets:
            if isinstance(t, ast.Name) and t.id.isupper() and _public(t.id):
                yield t.id


def _jax_names(path: Path) -> set:
    """Public top-level functions, classes, UPPER_CASE constants, and each
    public class's public methods and constants as "Class.name"."""
    tree = ast.parse(path.read_text())
    names = set(_constants(tree.body))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _public(node.name):
            names.add(node.name)
        if isinstance(node, ast.ClassDef) and _public(node.name):
            names.update(f"{node.name}.{m.name}" for m in node.body
                         if isinstance(m, (ast.FunctionDef,
                                           ast.AsyncFunctionDef))
                         and _public(m.name))
            names.update(f"{node.name}.{c}" for c in _constants(node.body))
    return names


def _missing(rel: str) -> set:
    mod = importlib.import_module(
        ".".join(("sdrpp_tpu_torch",) + Path(rel).with_suffix("").parts)
        .removesuffix(".__init__"))
    missing = set()
    for name in _jax_names(JAX / rel):
        obj = mod
        for part in name.split("."):
            obj = getattr(obj, part, None)
            if obj is None:
                missing.add(name)
                break
    return missing


def _modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py")
                  if p.name != "__main__.py")


def test_jax_modules_without_a_counterpart():
    assert {m for m in _modules() if not (PORT / m).exists()} \
        == NO_COUNTERPART


def test_name_level_diff_leaves_only_the_exceptions():
    got = {m: _missing(m) for m in _modules() if (PORT / m).exists()}
    assert {m: s for m, s in got.items() if s} == EXCEPTIONS
