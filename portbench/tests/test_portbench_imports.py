"""Nothing under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names compared
whole (``parmgmc_tpu_torch`` begins with ``parmgmc_tpu``)."""

import ast
import os
import subprocess
import sys

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "parmgmc_tpu"}


def _sources(sub=""):
    base = os.path.join(harness.PKG, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path) -> set:
    tree = ast.parse(open(path).read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, harness.PKG))
def test_no_jax_anywhere(path):
    assert not (_imported(path) & FORBIDDEN)


@pytest.mark.parametrize("path", sorted(_sources("reference")), ids=os.path.basename)
def test_reference_imports_no_program(path):
    assert not (_imported(path) & (FORBIDDEN | {"parmgmc_tpu_torch"}))


def test_whole_name_comparison(monkeypatch):
    import types

    import parmgmc_tpu_torch  # noqa: F401

    assert "parmgmc_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "parmgmc_tpu.kernels", types.ModuleType("parmgmc_tpu.kernels"))
    assert "parmgmc_tpu" in harness.forbidden_modules()


def test_reference_loads_alone():
    """The reference, imported in a fresh process, loads no program module."""
    code = ("import sys; sys.path.insert(0, %r); import portbench.reference.gmrf; "
            "bad = {m.split('.')[0] for m in sys.modules} & %r; print(sorted(bad)); "
            "sys.exit(1 if bad else 0)") % (os.path.dirname(harness.PKG), FORBIDDEN | {"parmgmc_tpu_torch"})
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
