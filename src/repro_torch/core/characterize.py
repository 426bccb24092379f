"""Application characterization harness (paper §3.4).

Samples execution time over the (frequency × active-cores × input-size)
grid and assembles the SVR training set. The sampler is a protocol: the
node simulator here, a shell-command runner on real hardware — the
methodology downstream is identical.

``CharacterizationSet`` collects the grids of many applications and fits
them all in ONE ``svr.fit_many`` call (one stacked Gram build on the
device, batched KKT solves on the host). ``terms_from_artifacts`` reads
``launch/dryrun.py`` artifact records, and ``workloads_from_artifacts``
turns them into engine workloads over the zoo's shape cells
(``configs.base.SHAPES``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, Iterable, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from repro_torch.core import svr as svr_mod
from repro_torch.core.node_sim import FREQ_GRID, INPUT_SIZES, MAX_CORES, Node


class Sampler(Protocol):
    def sample(self, f: float, p: int, n: float) -> float:
        """Return one measured execution time (seconds) at (f, p, N)."""
        ...


@dataclasses.dataclass
class NodeSampler:
    """Paper setup: run the app pinned at (f, p) on the (simulated) node."""

    node: Node
    app: str

    def sample(self, f: float, p: int, n: float) -> float:
        return self.node.run_fixed(self.app, f, p, n).time_s


@dataclasses.dataclass
class Characterization:
    """The (features, times) training set for one application."""

    app: str
    features: np.ndarray  # (n, 3): f, p, N
    times: np.ndarray  # (n,)

    def fit_svr(self, **kw) -> svr_mod.SVRParams:
        return svr_mod.fit(self.features, self.times, **kw)

    def cross_validate(self, k: int = 10, **kw):
        """10-fold CV — paper Table 1 metrics (MAE, PAE)."""
        return svr_mod.kfold_cv(self.features, self.times, k=k, **kw)


def characterize(
    sampler: Sampler,
    app: str,
    *,
    freqs: Sequence[float] = tuple(FREQ_GRID),
    cores: Iterable[int] = tuple(range(1, MAX_CORES + 1)),
    input_sizes: Sequence[float] = INPUT_SIZES,
    repeats: int = 1,
) -> Characterization:
    """Run the full §3.4 sweep: all frequencies × all core counts × all
    input sizes (×repeats). This is the step that took the paper 1-2 days of
    machine time per application."""
    feats, times = [], []
    for n in input_sizes:
        for p in cores:
            for f in freqs:
                for _ in range(repeats):
                    feats.append((float(f), float(p), float(n)))
                    times.append(sampler.sample(float(f), int(p), float(n)))
    return Characterization(
        app=app,
        features=np.asarray(feats, np.float32),
        times=np.asarray(times, np.float32),
    )


def subsample(ch: Characterization, fraction: float, seed: int = 0) -> Characterization:
    """Uniformly subsample a characterization (for cheaper CI/test fits)."""
    rng = np.random.default_rng(seed)
    n = ch.features.shape[0]
    idx = rng.choice(n, size=max(8, int(n * fraction)), replace=False)
    return Characterization(app=ch.app, features=ch.features[idx], times=ch.times[idx])


# ---------------------------------------------------------------------------
# batched characterization: many apps -> one fit_many call
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CharacterizationSet:
    """Training sets for many applications, fitted as one batch.

    The §3.4 sweep is per-application, but nothing downstream is: the grids
    share a shape, so the SVR fits stack. ``fit_all`` routes the whole set
    through ``svr.fit_many`` — one batched Gram build + batched KKT solves —
    and returns models aligned with ``items``.
    """

    items: List[Characterization]

    def __len__(self) -> int:
        return len(self.items)

    def __iter__(self):
        return iter(self.items)

    def __getitem__(self, i) -> Characterization:
        return self.items[i]

    @property
    def apps(self) -> List[str]:
        return [c.app for c in self.items]

    def fit_all(self, **kw) -> List[svr_mod.SVRParams]:
        """One ``svr.fit_many`` call over every application's training set."""
        return svr_mod.fit_many(self.items, **kw)

    def models_by_app(self, **kw) -> Dict[str, svr_mod.SVRParams]:
        return dict(zip(self.apps, self.fit_all(**kw)))

    @classmethod
    def from_node(
        cls,
        node: Node,
        apps: Sequence[str],
        *,
        freqs: Sequence[float] = tuple(FREQ_GRID),
        cores: Iterable[int] = tuple(range(1, MAX_CORES + 1)),
        input_sizes: Sequence[float] = INPUT_SIZES,
        repeats: int = 1,
    ) -> "CharacterizationSet":
        """Run the §3.4 sweep for every app on one (simulated) node."""
        cores = tuple(cores)
        return cls(
            [
                characterize(
                    NodeSampler(node, app),
                    app,
                    freqs=freqs,
                    cores=cores,
                    input_sizes=input_sizes,
                    repeats=repeats,
                )
                for app in apps
            ]
        )


# ---------------------------------------------------------------------------
# dry-run artifact ingestion: real lowered-HLO rooflines -> engine workloads
# ---------------------------------------------------------------------------

_ARTIFACT_RE = re.compile(r"^(?P<arch>.+)__(?P<shape>.+)__(?P<mesh>.+)\.json$")


def terms_from_artifacts(
    dryrun_dir: Optional[str] = None, *, mesh: str = "pod"
) -> Dict[Tuple[str, str], "object"]:
    """Scan a ``launch/dryrun.py`` artifact directory.

    Returns {(arch_id, shape_name): RooflineTerms} for every successful
    dry-run record on the given mesh — the measured-HLO counterpart of the
    engine's analytic fallback. Missing directory -> empty dict.
    """
    from repro_torch.core import engine as engine_mod  # lazy: avoid import cycle

    dryrun_dir = dryrun_dir or engine_mod.DRYRUN_DIR
    out: Dict[Tuple[str, str], object] = {}
    if not os.path.isdir(dryrun_dir):
        return out
    for fname in sorted(os.listdir(dryrun_dir)):
        m = _ARTIFACT_RE.match(fname)
        if m is None or m.group("mesh") != mesh:
            continue
        terms = engine_mod.terms_from_dryrun(
            m.group("arch"), m.group("shape"), dryrun_dir, mesh=mesh
        )
        if terms is not None:
            out[(m.group("arch"), m.group("shape"))] = terms
    return out


def workloads_from_artifacts(
    dryrun_dir: Optional[str] = None,
    *,
    mesh: str = "pod",
    n_steps: int = 1,
    objective: Optional[str] = None,
) -> List["object"]:
    """Every dry-run artifact as an engine ``Workload`` (fleet-scale intake).

    The returned list goes to ``PlanningEngine.plan_many`` in one call: one
    batched ``svr.fit_many`` characterization for all families, one batched
    grid prediction, one objective tensor.
    """
    from repro_torch.configs.base import SHAPES, ShapeCell
    from repro_torch.core.engine import Workload  # lazy: avoid import cycle

    return [
        Workload(
            arch,
            # keep the artifact's shape label even when the shape is no
            # longer in SHAPES (stale/renamed sweeps must stay tellable
            # apart in fleet reports, not collapse into "custom")
            cell=SHAPES.get(shape) or ShapeCell(shape, 0, 0, "unknown"),
            n_steps=n_steps,
            objective=objective,
            terms=terms,
        )
        for (arch, shape), terms in terms_from_artifacts(
            dryrun_dir, mesh=mesh
        ).items()
    ]
