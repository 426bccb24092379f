"""The benchmark runs the port alone: nothing it runs imports JAX or the JAX
package (compared by whole top-level names: the port's name begins with
the JAX package's), nothing reads ``benchmarks/``, and the reference
imports nothing of the port. ``run.py`` prints no result without a card or
outside a checkout that holds the port."""

import ast
import os
import shutil
import subprocess
import sys

from chipbench.tests import smoke

BENCH_DIR = os.path.join(smoke.ROOT, "chipbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _sources(tests=True):
    for base, _, files in os.walk(BENCH_DIR):
        if not tests and base.startswith(os.path.join(BENCH_DIR, "tests")):
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_imports_jax_the_jax_package_or_the_old_benchmarks():
    for path in _sources():
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    for path in _sources(tests=False):
        text = open(path).read()
        assert "benchmarks/" not in text and "experiments/bench" not in text, path


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources():
        if os.sep + "reference" + os.sep in path:
            assert not any(n.split(".")[0] == "repro_torch" for n in _imports(path)), path


def test_a_run_loads_no_jax_module():
    code = "\n".join([
        "import sys",
        f"sys.path[:0] = [{smoke.ROOT!r}]",
        "from chipbench.tests import smoke",
        "from chipbench import run",
        "for w in ('starcoder2-3b.train_4k', 'mamba2-130m.train_4k', 'starcoder2-3b.prefill_mix'):",
        "    assert smoke.run(w)['correct']",
        "print('FOUND', run.forbidden_modules())",
    ])
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=smoke.ROOT,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "FOUND []" in proc.stdout


def test_run_prints_no_result_without_a_card():
    proc = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                           "starcoder2-3b.train_4k", "--seed", "4294967311", "--seconds", "1",
                           "--trace", "0"], capture_output=True, text=True, timeout=120,
                          cwd=smoke.ROOT)
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_checkout_without_the_port_prints_no_result(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(smoke.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    code = "\n".join([
        "import sys",
        f"sys.path[:0] = [{str(tmp_path)!r}]",
        "from chipbench import harness",
        "harness.run_cell('starcoder2-3b.train_4k', 3, 0.0, False, device='cpu')",
        "print('RESULT')",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode != 0 and "RESULT" not in proc.stdout
    assert "repro_torch" in proc.stderr
    proc = subprocess.run([sys.executable, "chipbench/run.py", "--workload",
                           "starcoder2-3b.train_4k", "--seed", "3", "--seconds", "1"],
                          capture_output=True, text=True, timeout=120, cwd=tmp_path, env=env)
    assert proc.returncode != 0 and proc.stdout == ""
