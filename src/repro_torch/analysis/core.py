"""repro-lint machinery: findings, rule registry, suppressions, baseline.

Everything here is pure stdlib (``ast``, ``json``, ``os``, ``re``) — the
pass must be importable and sub-second without jax so it can run at the
top of ``scripts/verify.sh`` and inside the fast test loop.

The moving parts:

* ``Rule`` — one enforced contract: an id, the prose contract it pins, a
  path scope (rules fire only where the contract applies) and a checker
  over the parsed AST.
* ``Finding`` — one violation. Its *baseline key* is ``(rule, path,
  message)`` — deliberately line-number-free, so grandfathered findings
  survive unrelated edits above them.
* suppressions — ``# repro: allow(<rule-id>)`` on the finding's line or
  the line directly above silences that rule there (comma-separated ids
  for several). Suppressions are for violations that are *correct in
  place* and justified by a neighboring comment; the baseline is for
  grandfathered debt tracked centrally.
* ``Baseline`` — a committed JSON file of intended findings, each with a
  one-line ``justification``. Matching is count-aware: two identical
  violations in one file need two baseline entries, so a fresh copy of a
  baselined sin is still a NEW finding.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

SUPPRESS_RE = re.compile(r"#\s*repro:\s*allow\(([^)]*)\)")

# baseline / json-report schema version: bump on any key change and keep
# the loader tolerant (tests pin the schema)
SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Finding:
    """One contract violation at a specific site."""

    rule: str  # rule id (kebab-case, registry key)
    path: str  # repo-relative posix path
    line: int  # 1-indexed source line
    col: int  # 0-indexed column
    message: str  # stable, line-number-free statement of the violation
    symbol: str = ""  # enclosing function/class, for human navigation

    @property
    def key(self) -> Tuple[str, str, str]:
        """The baseline-matching key — no line/col, so grandfathered
        findings survive edits elsewhere in the file."""
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        where = f"{self.path}:{self.line}:{self.col + 1}"
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{where}: {self.rule}: {self.message}{sym}"


@dataclasses.dataclass(frozen=True)
class Rule:
    """One enforced contract."""

    id: str
    description: str  # one line, shown by --list-rules and in reports
    contract: str  # the docs/architecture.md contract this rule pins
    scope: Callable[[Sequence[str]], bool]  # parts of the posix path
    check: Callable[[ast.Module, str, str], Iterable[Finding]]

    def applies(self, path: str) -> bool:
        return self.scope(tuple(path.split("/")))


def parse_suppressions(src: str) -> Dict[int, set]:
    """line number -> rule ids allowed there (``# repro: allow(a, b)``)."""
    out: Dict[int, set] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = SUPPRESS_RE.search(line)
        if m:
            out[i] = {tok.strip() for tok in m.group(1).split(",") if tok.strip()}
    return out


def is_suppressed(finding: Finding, suppressions: Dict[int, set]) -> bool:
    """Suppressed by an allow-comment on the finding's line or the line
    directly above (the conventional place for the justification)."""
    for line in (finding.line, finding.line - 1):
        allowed = suppressions.get(line)
        if allowed and (finding.rule in allowed or "*" in allowed):
            return True
    return False


@dataclasses.dataclass
class AnalysisResult:
    """One pass over a file set: what fired, what was silenced."""

    findings: List[Finding]
    n_suppressed: int
    n_files: int
    parse_errors: List[str] = dataclasses.field(default_factory=list)


def analyze_source(
    src: str, path: str, rules: Sequence[Rule]
) -> Tuple[List[Finding], int]:
    """Run every in-scope rule over one file's source.

    Returns (unsuppressed findings, number suppressed). ``path`` must be
    the repo-relative posix path — rule scoping and baseline keys both
    key on it.
    """
    tree = ast.parse(src, filename=path)
    suppressions = parse_suppressions(src)
    kept: List[Finding] = []
    n_suppressed = 0
    for rule in rules:
        if not rule.applies(path):
            continue
        for finding in rule.check(tree, src, path):
            if is_suppressed(finding, suppressions):
                n_suppressed += 1
            else:
                kept.append(finding)
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept, n_suppressed


def iter_python_files(paths: Sequence[str], root: str) -> Iterator[str]:
    """Every .py file under ``paths`` (files or directories), as posix
    paths relative to ``root``, deterministically ordered. Hidden
    directories and ``__pycache__`` are skipped."""
    seen = set()
    for p in paths:
        absolute = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.isfile(absolute):
            if absolute.endswith(".py"):
                seen.add(os.path.relpath(absolute, root))
            continue
        for dirpath, dirnames, filenames in os.walk(absolute):
            dirnames[:] = sorted(
                d
                for d in dirnames
                if not d.startswith(".") and d != "__pycache__"
            )
            for name in sorted(filenames):
                if name.endswith(".py"):
                    seen.add(
                        os.path.relpath(os.path.join(dirpath, name), root)
                    )
    for rel in sorted(seen):
        yield rel.replace(os.sep, "/")


def analyze_paths(
    paths: Sequence[str],
    *,
    root: Optional[str] = None,
    rules: Optional[Sequence[Rule]] = None,
) -> AnalysisResult:
    """Run the pass over files/directories. ``root`` anchors the
    repo-relative finding paths (defaults to the current directory — the
    CLI is run from the repo root, e.g. by ``scripts/verify.sh``)."""
    if rules is None:
        from repro_torch.analysis.rules import RULES

        rules = list(RULES.values())
    root = os.path.abspath(root or os.getcwd())
    findings: List[Finding] = []
    n_suppressed = 0
    n_files = 0
    errors: List[str] = []
    for rel in iter_python_files(paths, root):
        n_files += 1
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            src = f.read()
        try:
            found, sup = analyze_source(src, rel, rules)
        except SyntaxError as e:  # a broken file is itself a finding
            errors.append(f"{rel}: {e.msg} (line {e.lineno})")
            continue
        findings.extend(found)
        n_suppressed += sup
    return AnalysisResult(
        findings=findings,
        n_suppressed=n_suppressed,
        n_files=n_files,
        parse_errors=errors,
    )


# ---------------------------------------------------------------------------
# baseline: committed, justified, count-aware
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Baseline:
    """The committed grandfather list: ``{rule, path, message,
    justification}`` entries. Count-aware matching — N identical entries
    absorb exactly N identical findings, never N+1."""

    entries: List[dict] = dataclasses.field(default_factory=list)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as f:
            payload = json.load(f)
        if not isinstance(payload, dict) or "findings" not in payload:
            raise ValueError(
                f"{path}: baseline must be a JSON object with a 'findings' list"
            )
        entries = []
        for e in payload["findings"]:
            missing = {"rule", "path", "message"} - set(e)
            if missing:
                raise ValueError(
                    f"{path}: baseline entry missing {sorted(missing)}: {e}"
                )
            entries.append(dict(e))
        return cls(entries=entries)

    def save(self, path: str) -> None:
        payload = {"version": SCHEMA_VERSION, "findings": self.entries}
        with open(path, "w", encoding="utf-8") as f:
            json.dump(payload, f, indent=1, sort_keys=False)
            f.write("\n")

    @classmethod
    def from_findings(
        cls, findings: Sequence[Finding], justification: str
    ) -> "Baseline":
        """Grandfather the current findings (``--write-baseline``). Each
        entry gets the same placeholder justification — replace it with a
        real one-line reason before committing."""
        return cls(
            entries=[
                {
                    "rule": f.rule,
                    "path": f.path,
                    "message": f.message,
                    "justification": justification,
                }
                for f in findings
            ]
        )

    def split(
        self, findings: Sequence[Finding]
    ) -> Tuple[List[Finding], List[Finding]]:
        """(new, baselined). Per key, the first ``count`` findings match
        the baseline's entries; any surplus is new."""
        budget: Dict[Tuple[str, str, str], int] = {}
        for e in self.entries:
            k = (e["rule"], e["path"], e["message"])
            budget[k] = budget.get(k, 0) + 1
        new, old = [], []
        for f in findings:
            if budget.get(f.key, 0) > 0:
                budget[f.key] -= 1
                old.append(f)
            else:
                new.append(f)
        return new, old

    def stale_entries(self, findings: Sequence[Finding]) -> List[dict]:
        """Baseline entries no finding matched — fixed debt that should be
        deleted from the file (reported, not fatal)."""
        counts: Dict[Tuple[str, str, str], int] = {}
        for f in findings:
            counts[f.key] = counts.get(f.key, 0) + 1
        stale = []
        for e in self.entries:
            k = (e["rule"], e["path"], e["message"])
            if counts.get(k, 0) > 0:
                counts[k] -= 1
            else:
                stale.append(e)
        return stale


def report_json(
    result: AnalysisResult,
    new: Sequence[Finding],
    baselined: Sequence[Finding],
    *,
    paths: Sequence[str],
    rules: Sequence[Rule],
) -> dict:
    """The ``--json`` payload. Schema is pinned by tests — additive
    changes only, bump ``SCHEMA_VERSION`` on anything else."""
    new_keys: Dict[Tuple[str, str, str], int] = {}
    for f in new:
        new_keys[f.key] = new_keys.get(f.key, 0) + 1

    def as_dict(f: Finding) -> dict:
        d = dataclasses.asdict(f)
        if new_keys.get(f.key, 0) > 0:
            new_keys[f.key] -= 1
            d["baselined"] = False
        else:
            d["baselined"] = True
        return d

    return {
        "version": SCHEMA_VERSION,
        "paths": list(paths),
        "rules": [
            {"id": r.id, "description": r.description, "contract": r.contract}
            for r in rules
        ],
        "counts": {
            "files": result.n_files,
            "findings": len(result.findings),
            "new": len(new),
            "baselined": len(baselined),
            "suppressed": result.n_suppressed,
            "parse_errors": len(result.parse_errors),
        },
        "findings": [as_dict(f) for f in result.findings],
        "parse_errors": list(result.parse_errors),
    }
