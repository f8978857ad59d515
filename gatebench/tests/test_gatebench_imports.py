"""What the benchmark's modules import: never JAX or the JAX package, and
the reference nothing of the program."""

import ast
import os
import subprocess
import sys

from gatebench import run

HERE = os.path.join(run.ROOT, "gatebench")
JAX = {"jax", "jaxlib", "flax", "optax", "orbax", "mlis_tpu"}


def _top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".", 1)[0])
    return names


def _sources(sub=""):
    for dirpath, _dirs, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        # the top-level name is compared whole: mlis_tpu_torch is not mlis_tpu
        assert not _top_level_imports(path) & JAX, path


def test_reference_imports_nothing_of_the_program():
    for path in list(_sources("reference")) + [os.path.join(HERE, "check.py")]:
        assert "mlis_tpu_torch" not in _top_level_imports(path), path


def test_only_system_module_imports_the_program():
    users = {os.path.relpath(p, HERE) for p in _sources("") if "tests" not in p
             and "mlis_tpu_torch" in _top_level_imports(p)}
    assert users == {"system.py"}


def test_reference_loads_without_the_program():
    code = ("import sys, gatebench.check, gatebench.reference.cricavpr, gatebench.reference.mixvpr;"
            "bad=[m for m in sys.modules if m.split('.')[0] in "
            "('mlis_tpu_torch','mlis_tpu','jax','flax')]; print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
