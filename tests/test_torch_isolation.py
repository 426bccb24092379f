"""The port stands alone: ``src/repro_torch/`` and ``chip_smoke.py`` import
neither ``jax`` nor anything of the JAX package ``repro``, not even its
numpy-only modules (they reach JAX through ``core/power.py``).

Checked twice: statically, per file, on the import statements; and live,
in a subprocess where ``import jax`` and ``import repro`` fail.
"""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "src", "repro_torch")
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _port_files():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out) + [SMOKE]


def _modules():
    mods = []
    for path in _port_files()[:-1]:
        rel = os.path.relpath(path, os.path.join(REPO, "src"))[:-3].split(os.sep)
        if rel[-1] == "__init__":
            rel = rel[:-1]
        mods.append(".".join(rel))
    return mods


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_every_module_imports_with_jax_and_repro_blocked():
    code = "\n".join([
        "import importlib, importlib.util, sys",
        "sys.modules['jax'] = None",
        "sys.modules['repro'] = None",
        f"for m in {_modules()!r}:",
        "    importlib.import_module(m)",
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {SMOKE!r})",
        "smoke = importlib.util.module_from_spec(spec)",
        "spec.loader.exec_module(smoke)",
        "assert callable(smoke.main)",
        "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " if sys.modules[m] is not None]",
        "print('IMPORTED', len(" + repr(_modules()) + "))",
    ])
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED" in proc.stdout
    assert proc.stdout.count("\n") == 1  # importing chip_smoke runs nothing


def test_chip_smoke_fails_without_a_card_or_outside_a_checkout(tmp_path):
    """No CUDA device: a non-zero exit and no result line. Alone in an empty
    directory: the same."""
    import shutil

    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, alone)
    for script in (SMOKE, str(alone)):
        proc = subprocess.run(
            [sys.executable, script], capture_output=True, text=True, timeout=120,
            cwd=os.path.dirname(script),
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
