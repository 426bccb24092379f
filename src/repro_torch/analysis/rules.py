"""The enforced contracts, as AST checks: the reference's rules but
``jit-purity``, which has no meaning in eager PyTorch (nothing is traced
or jitted), with their scopes on the port's tree (``src/repro_torch``).

Each rule pins one documented invariant whose violation was (or would
be) the root cause of a shipped bug or a perf cliff:

* ``argmin-ownership``   — engine.py owns the grid argmin; shims stay thin.
* ``epsilon-discipline`` — sim-clock comparisons route through
  ``time_eps``; absolute float tolerances underflow the float64 ulp past
  t ~ 1e6 s (the PR-5 bug class).
* ``batched-hot-path``   — one ``plan_many``/``pareto_many`` call per
  scheduling round; per-item ``.plan()``/``.pareto()`` in a loop is the
  N× dispatch cliff.
* ``cache-key-frozen``   — terms objects (anything with ``step_time``)
  are engine cache keys: frozen dataclasses, hashable fields only.
* ``vectorize-enumeration`` — option enumeration evaluates the whole
  (frontier × pool) grid in one vectorized pass; per-pair
  ``project_point`` calls in a loop are the K·M dispatch cliff at
  10⁴–10⁵ jobs (the PR-7 perf class).
* ``unit-suffix``        — physical quantities carry ``_j``/``_s``/
  ``_ghz``/``_w`` suffixes, and +,-,comparison never mix suffixes
  (× and ÷ legitimately change dimension: J = W·s).
* ``no-bare-print``      — library code emits diagnostics through
  ``repro_torch.obs.log`` (stdout plus the flight recorder), never bare
  ``print()``; ``__main__.py`` CLI drivers are exempt.
* ``sim-clock-purity``   — scheduler/service code paths never read the
  wall clock (``time.time``/``monotonic``/``perf_counter``,
  ``datetime.now``): the fleet is deterministic sim-time, and one host
  timestamp on a decision path breaks bitwise replay and journal
  recovery.

Heuristics are deliberately syntactic — this is a contract linter, not a
type system. Anything it cannot see (aliasing, dynamic dispatch) is out
of scope; anything it flags wrongly gets an inline
``# repro: allow(...)`` with the justification next to the code.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

from repro_torch.analysis.core import Finding, Rule

RULES: Dict[str, Rule] = {}


def register(id: str, description: str, contract: str, scope) -> "callable":
    def deco(check):
        RULES[id] = Rule(
            id=id,
            description=description,
            contract=contract,
            scope=scope,
            check=check,
        )
        return check

    return deco


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)
_LOOP_NODES = (
    ast.For,
    ast.AsyncFor,
    ast.While,
    ast.ListComp,
    ast.SetComp,
    ast.DictComp,
    ast.GeneratorExp,
)


def _annotate_parents(tree: ast.Module) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._repro_parent = node  # type: ignore[attr-defined]


def _parents(node: ast.AST) -> Iterator[ast.AST]:
    cur = getattr(node, "_repro_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_repro_parent", None)


def _symbol(node: ast.AST) -> str:
    """Dotted enclosing function/class path, for human navigation."""
    names = [
        p.name
        for p in _parents(node)
        if isinstance(p, _FUNC_NODES + (ast.ClassDef,))
    ]
    return ".".join(reversed(names))


def _in_loop(node: ast.AST) -> bool:
    """Lexically inside a loop/comprehension within the same function."""
    for p in _parents(node):
        if isinstance(p, _LOOP_NODES):
            return True
        if isinstance(p, _FUNC_NODES + (ast.ClassDef,)):
            return False
    return False


def _root_name(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _called_name(call: ast.Call) -> Optional[str]:
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted rendering of a Name/Attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts)) or "<expr>"


def _find(rule: str, path: str, node: ast.AST, message: str) -> Finding:
    return Finding(
        rule=rule,
        path=path,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0),
        message=message,
        symbol=_symbol(node),
    )


# ---------------------------------------------------------------------------
# scopes
# ---------------------------------------------------------------------------


def _scope_all(parts: Sequence[str]) -> bool:
    return True


def _scope_planning(parts: Sequence[str]) -> bool:
    """Planning-layer code: core/fleet/runtime plus the driver trees.

    apps/, models/ and kernels/ are exempt — a geometric ``argmin`` over
    ray-hit distances is not a grid minimization."""
    if tuple(parts[-2:]) == ("core", "engine.py"):
        return False  # the one file allowed to argmin
    return any(
        p in ("core", "fleet", "runtime", "benchmarks", "examples")
        for p in parts
    )


def _scope_sim_clock(parts: Sequence[str]) -> bool:
    """Where sim-clock times are compared: fleet/, core/evaluate.py and
    any report.py."""
    return (
        "fleet" in parts
        or tuple(parts[-2:]) == ("core", "evaluate.py")
        or parts[-1] == "report.py"
    )


def _scope_hot_path(parts: Sequence[str]) -> bool:
    return any(p in ("fleet", "benchmarks", "examples") for p in parts)


# ---------------------------------------------------------------------------
# 1 · argmin-ownership
# ---------------------------------------------------------------------------


@register(
    "argmin-ownership",
    "grid argmin/nanargmin outside core/engine.py",
    "engine.py owns the argmin; shims stay thin",
    _scope_planning,
)
def check_argmin_ownership(
    tree: ast.Module, src: str, path: str
) -> Iterable[Finding]:
    _annotate_parents(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = _called_name(node)
        if name in ("argmin", "nanargmin"):
            yield _find(
                "argmin-ownership",
                path,
                node,
                f"call to {_dotted(node.func)} outside core/engine.py — "
                "the engine owns the grid argmin; route through "
                "engine.plan_many/pareto_many",
            )


# ---------------------------------------------------------------------------
# 2 · epsilon-discipline
# ---------------------------------------------------------------------------

_TIME_NAMES = {
    "now",
    "t",
    "start",
    "end",
    "finish",
    "deadline",
    "arrival",
    "time",
    "makespan",
    "horizon",
}


def _terminal_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_timeish(node: ast.AST) -> bool:
    name = _terminal_name(node)
    return name is not None and (name in _TIME_NAMES or name.endswith("_s"))


def _mentions_timeish(node: ast.AST) -> bool:
    return any(_is_timeish(n) for n in ast.walk(node))


def _small_float_literals(node: ast.AST) -> Iterator[float]:
    for n in ast.walk(node):
        if (
            isinstance(n, ast.Constant)
            and isinstance(n.value, float)
            and 0.0 < abs(n.value) < 1.0
        ):
            yield n.value


@register(
    "epsilon-discipline",
    "sim-clock comparison bypassing time_eps",
    "relative time_eps(t) tolerance on every sim-clock comparison — "
    "absolute epsilons underflow float64 past t ~ 1e6 s",
    _scope_sim_clock,
)
def check_epsilon_discipline(
    tree: ast.Module, src: str, path: str
) -> Iterable[Finding]:
    _annotate_parents(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        for i, op in enumerate(node.ops):
            lhs, rhs = sides[i], sides[i + 1]
            if isinstance(op, (ast.Eq, ast.NotEq)):
                if _is_timeish(lhs) and _is_timeish(rhs):
                    yield _find(
                        "epsilon-discipline",
                        path,
                        node,
                        f"exact {'==' if isinstance(op, ast.Eq) else '!='} "
                        f"between sim-clock times "
                        f"({_dotted(lhs)} vs {_dotted(rhs)}) — compare "
                        "within time_eps(...)",
                    )
                    continue
            lits = list(_small_float_literals(lhs)) + list(
                _small_float_literals(rhs)
            )
            if lits and (_mentions_timeish(lhs) or _mentions_timeish(rhs)):
                yield _find(
                    "epsilon-discipline",
                    path,
                    node,
                    f"absolute float tolerance {min(lits, key=abs):g} in a "
                    "sim-clock comparison — use the relative time_eps(t)",
                )


# ---------------------------------------------------------------------------
# 3 · batched-hot-path
# ---------------------------------------------------------------------------


@register(
    "batched-hot-path",
    "per-item engine.plan()/pareto() inside a loop",
    "one batched plan_many/pareto_many call per scheduling round",
    _scope_hot_path,
)
def check_batched_hot_path(
    tree: ast.Module, src: str, path: str
) -> Iterable[Finding]:
    _annotate_parents(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if not isinstance(node.func, ast.Attribute):
            continue
        if node.func.attr not in ("plan", "pareto"):
            continue
        if _in_loop(node):
            yield _find(
                "batched-hot-path",
                path,
                node,
                f"per-item {_dotted(node.func)}() inside a loop — batch "
                f"the round with {node.func.attr}_many",
            )


# ---------------------------------------------------------------------------
# 3b · vectorize-enumeration
# ---------------------------------------------------------------------------


@register(
    "vectorize-enumeration",
    "per-pair project_point() inside an enumeration loop",
    "hot-path enumeration projects the whole (frontier × pool) grid in "
    "one vectorized pass (Negotiator._project_grid); a project_point "
    "call per pair is the K·M dispatch cliff",
    _scope_hot_path,
)
def check_vectorize_enumeration(
    tree: ast.Module, src: str, path: str
) -> Iterable[Finding]:
    _annotate_parents(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _called_name(node) != "project_point":
            continue
        if _in_loop(node):
            yield _find(
                "vectorize-enumeration",
                path,
                node,
                f"per-pair {_dotted(node.func)}() inside a loop — project "
                "the whole grid in one vectorized pass "
                "(Negotiator._project_grid), or justify the scalar call",
            )


# ---------------------------------------------------------------------------
# 4 · cache-key-frozen
# ---------------------------------------------------------------------------

_UNHASHABLE_TYPE_NAMES = {"list", "dict", "set", "List", "Dict", "Set"}


def _is_dataclass_decorator(dec: ast.AST) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    name = _terminal_name(target)
    return name == "dataclass"


def _dataclass_frozen(dec: ast.AST) -> bool:
    if not isinstance(dec, ast.Call):
        return False  # bare @dataclass defaults to frozen=False
    for kw in dec.keywords:
        if kw.arg == "frozen":
            return isinstance(kw.value, ast.Constant) and kw.value.value is True
    return False


def _annotation_base(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        # string annotation, e.g. "List[float]" — take the head token
        return node.value.split("[", 1)[0].strip().rsplit(".", 1)[-1]
    name = _terminal_name(node)
    return name


@register(
    "cache-key-frozen",
    "terms dataclass (engine cache key) not frozen/hashable",
    "terms objects with step_time(f, cores) are engine cache keys: "
    "frozen dataclasses with hashable fields",
    _scope_all,
)
def check_cache_key_frozen(
    tree: ast.Module, src: str, path: str
) -> Iterable[Finding]:
    _annotate_parents(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        dc_decorators = [
            d for d in node.decorator_list if _is_dataclass_decorator(d)
        ]
        if not dc_decorators:
            continue
        is_terms = any(
            isinstance(stmt, _FUNC_NODES) and stmt.name == "step_time"
            for stmt in node.body
        )
        if not is_terms:
            continue
        if not any(_dataclass_frozen(d) for d in dc_decorators):
            yield _find(
                "cache-key-frozen",
                path,
                node,
                f"terms dataclass {node.name} defines step_time but is "
                "not frozen=True — mutation after caching corrupts the "
                "engine's memo table",
            )
        for stmt in node.body:
            if not isinstance(stmt, ast.AnnAssign) or not isinstance(
                stmt.target, ast.Name
            ):
                continue
            base = _annotation_base(stmt.annotation)
            if base in _UNHASHABLE_TYPE_NAMES:
                yield _find(
                    "cache-key-frozen",
                    path,
                    stmt,
                    f"terms dataclass {node.name} field "
                    f"{stmt.target.id} has unhashable type {base} — "
                    "cache keys need hashable fields (use tuple)",
                )
            value = stmt.value
            if isinstance(value, (ast.List, ast.Dict, ast.Set)):
                yield _find(
                    "cache-key-frozen",
                    path,
                    stmt,
                    f"terms dataclass {node.name} field "
                    f"{stmt.target.id} has a mutable literal default",
                )
            if (
                isinstance(value, ast.Call)
                and _called_name(value) == "field"
            ):
                for kw in value.keywords:
                    if kw.arg == "default_factory" and _terminal_name(
                        kw.value
                    ) in ("list", "dict", "set"):
                        yield _find(
                            "cache-key-frozen",
                            path,
                            stmt,
                            f"terms dataclass {node.name} field "
                            f"{stmt.target.id} has a mutable "
                            "default_factory",
                        )


# ---------------------------------------------------------------------------
# 6 · unit-suffix
# ---------------------------------------------------------------------------

_UNIT_SUFFIXES = {
    "j", "kj", "mj",  # energy
    "s", "ms", "us", "ns",  # time
    "ghz", "mhz", "hz",  # frequency
    "w", "kw", "mw",  # power
}

# identifiers whose final word names a physical quantity and therefore
# must instead end in a unit suffix
_QUANTITY_WORDS = {
    "energy",
    "power",
    "frequency",
    "freq",
    "deadline",
    "makespan",
    "horizon",
    "duration",
    "slack",
    "runtime",
}


def _unit_suffix(name: str) -> Optional[str]:
    if "_" not in name:
        return None
    tail = name.rsplit("_", 1)[1]
    return tail if tail in _UNIT_SUFFIXES else None


def _names_quantity(name: str) -> Optional[str]:
    word = name.rsplit("_", 1)[-1].lower()
    return word if word in _QUANTITY_WORDS else None


def _suffixed_operand(node: ast.AST) -> Optional[Tuple[str, str]]:
    name = _terminal_name(node)
    if name is None:
        return None
    suffix = _unit_suffix(name)
    return (name, suffix) if suffix else None


def _missing_suffix_finding(
    name: str,
    node: ast.AST,
    kind: str,
    path: str,
    annotation: Optional[ast.AST] = None,
) -> Optional[Finding]:
    if name.startswith("_") or name in ("self", "cls"):
        return None
    if annotation is not None and _annotation_base(annotation) == "bool":
        return None  # meets_deadline: bool is a predicate, not a quantity
    word = _names_quantity(name)
    if word is None:
        return None
    return _find(
        "unit-suffix",
        path,
        node,
        f"{kind} '{name}' names a physical quantity ({word}) without a "
        "unit suffix — append _j/_s/_ghz/_w per the naming convention",
    )


@register(
    "unit-suffix",
    "physical quantity without unit suffix, or mixed-suffix arithmetic",
    "energy/time/frequency/power identifiers carry _j/_s/_ghz/_w; "
    "+,-,comparison never mix suffixes",
    _scope_all,
)
def check_unit_suffix(
    tree: ast.Module, src: str, path: str
) -> Iterable[Finding]:
    _annotate_parents(tree)
    for node in ast.walk(tree):
        # mixed-suffix + and - (× and ÷ legitimately change dimension)
        if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Add, ast.Sub)
        ):
            left = _suffixed_operand(node.left)
            right = _suffixed_operand(node.right)
            if left and right and left[1] != right[1]:
                op = "+" if isinstance(node.op, ast.Add) else "-"
                yield _find(
                    "unit-suffix",
                    path,
                    node,
                    f"'{left[0]}' ({left[1]}) {op} '{right[0]}' "
                    f"({right[1]}) mixes unit suffixes — convert first",
                )
        elif isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            for i in range(len(node.ops)):
                left = _suffixed_operand(sides[i])
                right = _suffixed_operand(sides[i + 1])
                if left and right and left[1] != right[1]:
                    yield _find(
                        "unit-suffix",
                        path,
                        node,
                        f"comparing '{left[0]}' ({left[1]}) with "
                        f"'{right[0]}' ({right[1]}) mixes unit suffixes",
                    )
        # missing suffixes on the places names are introduced
        elif isinstance(node, _FUNC_NODES):
            args = node.args
            for arg in (
                list(args.posonlyargs)
                + list(args.args)
                + list(args.kwonlyargs)
            ):
                f = _missing_suffix_finding(
                    arg.arg, arg, "parameter", path, arg.annotation
                )
                if f:
                    yield f
        elif isinstance(node, ast.AnnAssign) and isinstance(
            node.target, ast.Name
        ):
            f = _missing_suffix_finding(
                node.target.id, node, "field/variable", path, node.annotation
            )
            if f:
                yield f
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    f = _missing_suffix_finding(
                        target.id, node, "variable", path
                    )
                    if f:
                        yield f


# ---------------------------------------------------------------------------
# 8 · sim-clock-purity
# ---------------------------------------------------------------------------

# time-module readers of the host clock (attribute form: time.<attr>())
_WALL_CLOCK_ATTRS = {
    "time",
    "time_ns",
    "monotonic",
    "monotonic_ns",
    "perf_counter",
    "perf_counter_ns",
    "process_time",
    "process_time_ns",
}
# datetime readers (datetime.now() / datetime.datetime.utcnow() / ...)
_DATETIME_ATTRS = {"now", "utcnow", "today"}
# bare-name forms unambiguous enough to flag (``from time import
# monotonic``); plain ``time()``/``now()`` are too generic to attribute
_WALL_CLOCK_NAMES = (_WALL_CLOCK_ATTRS - {"time"}) | {"utcnow"}


@register(
    "sim-clock-purity",
    "wall-clock read on a sim-clock code path",
    "fleet scheduling/service code is deterministic sim-time: a host "
    "timestamp (time.time/monotonic/perf_counter, datetime.now) on a "
    "decision path breaks bitwise replay and journal recovery",
    _scope_sim_clock,
)
def check_sim_clock_purity(
    tree: ast.Module, src: str, path: str
) -> Iterable[Finding]:
    _annotate_parents(tree)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if isinstance(func, ast.Attribute):
            root = _root_name(func)
            wall = root == "time" and func.attr in _WALL_CLOCK_ATTRS
            dt = root == "datetime" and func.attr in _DATETIME_ATTRS
            if wall or dt:
                yield _find(
                    "sim-clock-purity",
                    path,
                    node,
                    f"wall-clock read {_dotted(func)}() on a sim-clock "
                    "code path — schedule on the sim clock (event/batch "
                    "times); host time breaks bitwise replay",
                )
        elif isinstance(func, ast.Name) and func.id in _WALL_CLOCK_NAMES:
            yield _find(
                "sim-clock-purity",
                path,
                node,
                f"wall-clock read {func.id}() on a sim-clock code path — "
                "schedule on the sim clock (event/batch times); host "
                "time breaks bitwise replay",
            )


# ---------------------------------------------------------------------------
# 9 · no-bare-print
# ---------------------------------------------------------------------------


def _scope_library(parts: Sequence[str]) -> bool:
    """Library code under src/repro_torch — ``__main__.py`` CLI drivers
    are exempt (their stdout IS the interface), as is ``repro_torch/obs``
    itself (its ``log`` hosts the one sanctioned ``print``)."""
    if "repro_torch" not in parts:
        return False
    if parts[-1] == "__main__.py":
        return False
    return "obs" not in parts


@register(
    "no-bare-print",
    "bare print() in library code",
    "library diagnostics route through repro_torch.obs.log (stdout AND the "
    "flight recorder); __main__.py CLI drivers are exempt",
    _scope_library,
)
def check_no_bare_print(
    tree: ast.Module, src: str, path: str
) -> Iterable[Finding]:
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Name)
            and node.func.id == "print"
        ):
            yield _find(
                "no-bare-print",
                path,
                node,
                "bare print() in library code — route diagnostics through "
                "repro_torch.obs.log so recorded runs keep their console story",
            )
