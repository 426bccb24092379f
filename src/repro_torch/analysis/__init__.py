"""repro-lint for the port: the repo's contracts, checked mechanically
over ``src/repro_torch``, the reference's ``analysis/``.

The load-bearing invariants — "engine.py owns the argmin", the frozen
``AppTerms``/``TermsFamily`` cache-key contract, the relative
``time_eps`` discipline, the one-batched-call-per-round hot-path rule,
sim-clock purity and the unit-suffix naming convention — are the
reference's, and so is this pass: pure stdlib (``ast``-based, importable
without torch), with

* a rule registry (``rules.RULES``; the reference's rules but
  ``jit-purity``, which eager PyTorch gives no meaning),
* a CLI — ``python -m repro_torch.analysis [paths] [--json] [--baseline
  FILE]`` — that exits non-zero on any non-baselined finding,
* inline suppressions (``# repro: allow(<rule-id>)`` on the finding's
  line or the line above, with a justification comment), and
* a committed baseline of its own (``analysis_baseline_torch.json``, the
  CLI's default) for findings that are intended, each carrying a
  one-line justification.

``tests/test_torch_analysis.py`` holds each rule to the reference's
fixtures and the port's tree clean against its baseline.
"""

from repro_torch.analysis.core import (
    AnalysisResult,
    Baseline,
    Finding,
    Rule,
    analyze_paths,
    analyze_source,
    iter_python_files,
)
from repro_torch.analysis.rules import RULES

__all__ = [
    "AnalysisResult",
    "Baseline",
    "Finding",
    "Rule",
    "RULES",
    "analyze_paths",
    "analyze_source",
    "iter_python_files",
]
