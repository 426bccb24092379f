"""The port's repro-lint (``repro_torch.analysis``) against the reference's
fixtures, and the port's tree against the port's own baseline.

Each rule of the port but ``jit-purity`` (dropped: eager PyTorch jits
nothing) fires on the reference's bad fixture, as many times as the
reference's own test expects, and stays quiet on its good one. Fixtures
are read from ``tests/fixtures/analysis/`` as they are; a rule whose
scope is the port's library is given the fixture under a
``repro_torch/`` path. Stdlib only: nothing here imports torch or jax.
"""

import json
import os

import pytest

from repro_torch.analysis import RULES, Baseline, analyze_paths, analyze_source
from repro_torch.analysis.__main__ import DEFAULT_BASELINE, DEFAULT_PATHS
from repro_torch.analysis.__main__ import main as cli_main

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "analysis")
BASELINE = os.path.join(REPO, DEFAULT_BASELINE)

# (rule, bad fixture, the path it is analyzed at, fires, good fixture,
# its path): the reference's rows of tests/test_analysis.py but jit-purity
RULE_FIXTURES = [
    ("argmin-ownership", "core/argmin_bad.py", "core/argmin_bad.py", 1,
     "core/engine.py", "core/engine.py"),
    ("epsilon-discipline", "fleet/epsilon_bad.py", "fleet/epsilon_bad.py", 2,
     "fleet/epsilon_good.py", "fleet/epsilon_good.py"),
    ("batched-hot-path", "fleet/hotpath_bad.py", "fleet/hotpath_bad.py", 2,
     "fleet/hotpath_good.py", "fleet/hotpath_good.py"),
    ("vectorize-enumeration", "fleet/enumeration_bad.py", "fleet/enumeration_bad.py", 2,
     "fleet/enumeration_good.py", "fleet/enumeration_good.py"),
    ("cache-key-frozen", "cachekey_bad.py", "cachekey_bad.py", 4,
     "cachekey_good.py", "cachekey_good.py"),
    ("unit-suffix", "units_bad.py", "units_bad.py", 3, "units_good.py", "units_good.py"),
    ("no-bare-print", "repro/print_bad.py", "repro_torch/print_bad.py", 2,
     "repro/print_good.py", "repro_torch/print_good.py"),
    ("sim-clock-purity", "fleet/wallclock_bad.py", "fleet/wallclock_bad.py", 3,
     "fleet/wallclock_good.py", "fleet/wallclock_good.py"),
]


def _run(fixture, at, rule_id):
    with open(os.path.join(FIXTURES, fixture.replace("/", os.sep))) as f:
        return analyze_source(f.read(), at, [RULES[rule_id]])


def test_every_rule_but_jit_purity_has_a_fixture_row():
    assert {row[0] for row in RULE_FIXTURES} == set(RULES)
    assert "jit-purity" not in RULES


@pytest.mark.parametrize("rule_id,bad,bad_at,n_expected,good,good_at", RULE_FIXTURES)
def test_rule_fires_on_bad_and_stays_quiet_on_good(rule_id, bad, bad_at, n_expected, good,
                                                   good_at):
    findings, _ = _run(bad, bad_at, rule_id)
    assert len(findings) == n_expected, [f.render() for f in findings]
    assert all(f.rule == rule_id and f.path == bad_at and f.line > 0 for f in findings)
    quiet, _ = _run(good, good_at, rule_id)
    assert quiet == [], [f.render() for f in quiet]


def test_no_bare_print_scope_is_the_port():
    """The library scope is ``repro_torch``: the reference's own path is
    outside it, and a CLI driver or ``obs`` is exempt."""
    assert not RULES["no-bare-print"].applies("src/repro/core/x.py")
    assert RULES["no-bare-print"].applies("src/repro_torch/core/x.py")
    assert not RULES["no-bare-print"].applies("src/repro_torch/fleet/__main__.py")
    assert not RULES["no-bare-print"].applies("src/repro_torch/obs/log.py")
    findings, _ = _run("repro/print_bad.py", "repro_torch/print_bad.py", "no-bare-print")
    assert all("repro_torch.obs.log" in f.message for f in findings)


def test_the_port_tree_is_clean_against_its_baseline(capsys):
    """``python -m repro_torch.analysis`` (its default paths and
    baseline) exits 0; no baseline entry is stale, and each carries a
    justification."""
    assert DEFAULT_PATHS == ("src/repro_torch",)
    result = analyze_paths(list(DEFAULT_PATHS), root=REPO)
    assert result.parse_errors == [] and result.n_files > 80
    baseline = Baseline.load(BASELINE)
    new, _ = baseline.split(result.findings)
    assert new == [], "\n".join(f.render() for f in new)
    assert baseline.stale_entries(result.findings) == []
    assert all(e.get("justification", "").strip() for e in baseline.entries)
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        assert cli_main([]) == 0
    finally:
        os.chdir(cwd)
    assert capsys.readouterr().out.startswith("ok: ")


def test_a_bad_file_fails_the_port_gate(tmp_path, capsys):
    """A bare print dropped into the port's tree is a new finding: the
    CLI exits 1 (the reference's gate, on the port's scope)."""
    pkg = tmp_path / "src" / "repro_torch" / "core"
    pkg.mkdir(parents=True)
    (pkg / "noisy.py").write_text("def f():\n    print('x')\n")
    (tmp_path / DEFAULT_BASELINE).write_text(json.dumps({"version": 1, "findings": []}))
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        assert cli_main([]) == 1
    finally:
        os.chdir(cwd)
    assert "no-bare-print" in capsys.readouterr().out
