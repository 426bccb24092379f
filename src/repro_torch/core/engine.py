"""PlanningEngine: the canonical, batched planning path (paper Eq. 8).

The paper's deliverable is one argmin over the (frequency, cores) grid:

    argmin_{f,p}  P(f, p, s(p)) · T(f, p, N)

This module is that search for every entry point, on PyTorch:

  * **Memoized, batched characterization** — SVR fits are keyed by the
    workload's terms, so the Gram-matrix hotspot is paid once per workload
    *family*; all families missing from the cache are fitted in ONE
    ``svr.fit_many`` call.
  * **Batched grid evaluation** — ``svr.predict_many`` pushes the grid
    points of every pending workload through ONE ``rbf_gram`` call on the
    engine's device.
  * **Selectable objective** — ``energy`` (paper Eq. 8), ``edp`` and
    ``ed2p``: metric = E · T^k with k = 0, 1, 2, where T^k is
    ``kernels.ref.tpow`` (exact 1, T and T·T), never ``torch.pow``.
  * **One constraint semantics** — ``solve_grid`` is the single masked
    argmin used by every entry point, with configurable
    ``on_infeasible="raise" | "fastest"`` and one ``TIME_FLOOR``.
  * **Fused sweep** — ``plan_many`` / ``pareto_many`` run the metric, mask
    and argmin (or frontier keep-set) of the whole (workload × grid) batch
    as one kernel launch (``kernels/plan_grid.py``), bitwise identical to
    the exact per-workload path.

The engine runs on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import svr as svr_mod
from repro_torch.core.power import PowerModel
from repro_torch.core.tpu_power import (
    DCN_POD_PENALTY,
    F_GRID,
    F_NOM,
    HBM_BW,
    ICI_BW,
    PEAK_FLOPS_BF16,
    FleetTelemetry,
    fit_fleet_power,
)
from repro_torch.device import DeviceLike, resolve_device, to_host
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import tpow

# One step-time floor for every path: SVR extrapolation may dip non-physical.
TIME_FLOOR = 1e-6

# metric = E · T^k  — energy (paper Eq. 8), energy-delay, energy-delay².
OBJECTIVES: Dict[str, float] = {"energy": 0.0, "edp": 1.0, "ed2p": 2.0}

DRYRUN_DIR = os.path.join(
    os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun"
)
CHIP_GRID = (16, 32, 64, 128, 256, 512)

# The engine's SVR hyper-parameters (beyond-paper mode: planner-scale
# features span orders of magnitude). One definition — ``characterize`` and
# the batched ``_fits_for`` path must fit identically or the cache would
# hold different models for the same family depending on the entry point.
ENGINE_FIT_KW = dict(gamma=0.5, standardize=True, log_target=True, eps=1e-4)


# ---------------------------------------------------------------------------
# the planning axis: a device-generic ConfigSpace
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConfigSpace:
    """The device-generic planning axis: one named, ordered grid bundle.

    The paper's methodology — an application-agnostic power surface times
    an architecture-aware performance model, minimized over a
    configuration grid — is not CPU-specific. ``ConfigSpace`` names the
    axis so every layer (engine, fused kernels, fleet placement) can stay
    generic over it:

    * CPU node:  ``axes = ("f_ghz", "cores")`` — the paper's
      (frequency, active cores) grid; ``chips_per_pod`` is the socket
      size, so the derived third coordinate is the active-socket count
      feeding the static term of Eq. 7.
    * TPU slice: ``axes = ("f_ghz", "chips", "pods")`` — chips is the
      parallelism axis and pods is DERIVED (``ceil(chips /
      chips_per_pod)``), feeding the per-pod static power of the v5e
      refit (``core.tpu_power``).

    The grid is always the outer product ``freq_grid × chip_grid`` with
    the pod/socket coordinate derived — the axis tuple is identity (it
    keys the grid-callable memo so two engines with different axis
    semantics never share a sweep), not extra dimensionality.
    ``device`` is the fleet-placement compatibility tag: a job planned in
    a space only places on nodes of that device type.
    """

    name: str
    device: str  # "cpu" | "tpu" — fleet placement compatibility tag
    axes: Tuple[str, ...]
    freq_grid: Tuple[float, ...]
    chip_grid: Tuple[int, ...]
    chips_per_pod: int

    def __post_init__(self):
        if not self.axes or self.axes[0] != "f_ghz":
            raise ValueError(
                f"space {self.name!r}: axes must lead with 'f_ghz', "
                f"got {self.axes!r}"
            )
        if not self.freq_grid or not self.chip_grid:
            raise ValueError(f"space {self.name!r}: empty grid")
        if self.chips_per_pod < 1:
            raise ValueError(f"space {self.name!r}: chips_per_pod < 1")

    def meshes(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The (frequency, parallelism, derived pods/sockets) grid meshes,
        ``indexing="ij"`` — exactly the arrays ``solve_grid`` minimizes
        over, for any space."""
        F, C = np.meshgrid(self.freq_grid, self.chip_grid, indexing="ij")
        return F, C, np.ceil(C / self.chips_per_pod)

    def pods_for(self, chips: int) -> int:
        """The derived pod (TPU) / socket (CPU) count for a parallelism
        value."""
        return int(np.ceil(chips / self.chips_per_pod))

    def snap_cap(self, available: int) -> Optional[int]:
        """The largest grid parallelism value that fits an ``available``
        pool (None when the pool sits below the grid floor) — elastic
        re-planning snaps fallback choices to a real grid configuration
        with this."""
        ok = [c for c in self.chip_grid if c <= available]
        return max(ok) if ok else None


def tpu_space(
    freq_grid: Sequence[float] = tuple(F_GRID),
    chip_grid: Sequence[int] = CHIP_GRID,
    chips_per_pod: int = 256,
    name: str = "tpu-v5e",
) -> ConfigSpace:
    """The TPU-pod planning axis: (f_ghz, chips) grid with pods derived at
    ``chips_per_pod`` (v5e: 256 chips/pod), Eq. 7 refit power surface."""
    return ConfigSpace(
        name=name,
        device="tpu",
        axes=("f_ghz", "chips", "pods"),
        freq_grid=tuple(float(f) for f in freq_grid),
        chip_grid=tuple(int(c) for c in chip_grid),
        chips_per_pod=int(chips_per_pod),
    )


def cpu_space(
    freq_grid: Optional[Sequence[float]] = None,
    chip_grid: Optional[Sequence[int]] = None,
    cores_per_socket: Optional[int] = None,
    name: str = "cpu-node",
) -> ConfigSpace:
    """The paper's CPU planning axis: (f_ghz, cores) with active sockets
    derived at ``cores_per_socket``. Defaults come from the simulated
    2×16-core node (``core.node_sim``)."""
    from repro_torch.core import node_sim  # lazy: keep the TPU-only path light

    if freq_grid is None:
        freq_grid = tuple(node_sim.FREQ_GRID)
    if chip_grid is None:
        chip_grid = tuple(range(1, node_sim.MAX_CORES + 1))
    if cores_per_socket is None:
        cores_per_socket = node_sim.CORES_PER_SOCKET
    return ConfigSpace(
        name=name,
        device="cpu",
        axes=("f_ghz", "cores"),
        freq_grid=tuple(float(f) for f in freq_grid),
        chip_grid=tuple(int(c) for c in chip_grid),
        chips_per_pod=int(cores_per_socket),
    )


# ---------------------------------------------------------------------------
# shared constraint semantics (the single masked argmin)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Constraints:
    """Optional limits on the (frequency × cores) grid search.

    One class for every planning path — the node argmin, the TPU planner,
    the fleet scheduler and the pareto frontier all mask the grid with the
    same semantics (``constraint_mask``). ``None`` means unconstrained.

    Fields (units):
        max_time_s: upper bound on the *predicted* step/run time, in
            seconds. The fleet scheduler passes deadline slack here.
        max_cores: upper bound on the parallelism axis — cores on the node
            grid, chips on the TPU grid (dimensionless count).
        min_frequency_ghz / max_frequency_ghz: clock bounds in GHz,
            inclusive.

    Example — plan under a 600 s deadline on at most 16 cores::

        from repro_torch.core.engine import Constraints, Workload
        w = Workload(arch="app", terms=my_terms,
                     constraints=Constraints(max_time_s=600.0, max_cores=16))

    An over-tight combination can mask out the whole grid; what happens
    then is the entry point's ``on_infeasible`` choice (``"raise"`` or
    ``"fastest"``).
    """

    max_time_s: Optional[float] = None
    max_cores: Optional[int] = None  # cores on the node, chips on the fleet
    min_frequency_ghz: Optional[float] = None
    max_frequency_ghz: Optional[float] = None


def constraint_mask(
    F: np.ndarray, P: np.ndarray, T: np.ndarray, constraints: Optional[Constraints]
) -> np.ndarray:
    mask = np.ones(np.shape(T), bool)
    if constraints is not None:
        if constraints.max_time_s is not None:
            mask &= T <= constraints.max_time_s
        if constraints.max_cores is not None:
            mask &= P <= constraints.max_cores
        if constraints.min_frequency_ghz is not None:
            mask &= F >= constraints.min_frequency_ghz
        if constraints.max_frequency_ghz is not None:
            mask &= F <= constraints.max_frequency_ghz
    return mask


def solve_grid(
    F: np.ndarray,
    P: np.ndarray,
    T: np.ndarray,
    W: np.ndarray,
    *,
    objective: str = "energy",
    constraints: Optional[Constraints] = None,
    on_infeasible: str = "raise",
    metric: Optional[np.ndarray] = None,
) -> Tuple[int, ...]:
    """Masked argmin of E·T^k over the grid — the one shared semantics.

    Space-generic by construction: F/P/T/W are whatever meshes the
    caller's ``ConfigSpace`` produced (cores on the CPU axis, chips on
    the TPU axis), and the ``TIME_FLOOR`` clamp and ``on_infeasible``
    behaviour are identical in every space. ``on_infeasible`` decides the
    empty-mask case: ``"raise"`` (ValueError) or ``"fastest"`` (fall back
    to the minimum-time configuration). ``metric`` may carry a
    precomputed objective tensor (the batched path); otherwise it is
    derived from ``objective``.
    """
    if objective not in OBJECTIVES:
        raise ValueError(f"unknown objective {objective!r}; want {sorted(OBJECTIVES)}")
    if on_infeasible not in ("raise", "fastest"):
        raise ValueError(f"unknown on_infeasible {on_infeasible!r}")
    T = np.maximum(np.asarray(T), TIME_FLOOR)
    if metric is None:
        metric = np.asarray(W) * T * T ** OBJECTIVES[objective]
    metric = np.asarray(metric)
    mask = constraint_mask(np.asarray(F), np.asarray(P), T, constraints)
    if not mask.any():
        if on_infeasible == "raise":
            raise ValueError("constraints admit no configuration on the grid")
        mask = fastest_feasible_mask(
            np.asarray(F), np.asarray(P), T, constraints
        )
    return np.unravel_index(np.argmin(np.where(mask, metric, np.inf)), metric.shape)


def fastest_feasible_mask(
    F: np.ndarray, P: np.ndarray, T: np.ndarray, constraints: Optional[Constraints]
) -> np.ndarray:
    """The ``on_infeasible="fastest"`` fallback mask: the (near-)fastest
    grid points that still honor every NON-time constraint.

    When a deadline masks out the whole grid, "run as fast as possible" is
    the right answer — but only the time bound is negotiable; a core or
    frequency cap is physical capacity and must survive the fallback (the
    seed fell back to the globally fastest point, which could exceed
    ``max_cores`` and hand the scheduler an unplaceable plan). Only when
    the non-time constraints themselves admit nothing does the fallback
    relax to the whole grid.
    """
    relaxed = constraint_mask(
        F,
        P,
        T,
        None
        if constraints is None
        else dataclasses.replace(constraints, max_time_s=None),
    )
    if not relaxed.any():
        relaxed = np.ones(np.shape(T), bool)
    t_min = np.min(np.where(relaxed, T, np.inf))
    return relaxed & (T <= t_min * (1.0 + 1e-3))


def pareto_frontier(T: np.ndarray, E: np.ndarray) -> List[Tuple[int, ...]]:
    """Indices of the non-dominated (time, energy) grid points, fastest first.

    The energy/time frontier is what deadline negotiation trades along: each
    successive point is slower but strictly cheaper in energy.

    Deterministic ordering contract (the fleet scheduler's deadline
    fallback walks this list, so selection must be reproducible): candidates
    are sorted by time ascending, ties broken on energy then on flat grid
    index, and the returned frontier is strictly increasing in time and
    strictly decreasing in energy. Non-finite points (masked-out grid
    entries carrying ``inf``) never appear.
    """
    T = np.asarray(T)
    E = np.asarray(E)
    t_flat = T.ravel()
    e_flat = E.ravel()
    # lexsort: last key is primary -> time, then energy, then flat index.
    order = np.lexsort((np.arange(t_flat.size), e_flat, t_flat))
    # vectorized frontier sweep (the per-point Python loop dominated the
    # batched pareto_many round): a sorted point is on the frontier iff it
    # is finite and strictly cheaper than every finite point before it,
    # i.e. than the running energy minimum.
    e_sorted = e_flat[order]
    finite = np.isfinite(t_flat[order]) & np.isfinite(e_sorted)
    cummin = np.minimum.accumulate(np.where(finite, e_sorted, np.inf))
    prev_best = np.concatenate(([np.inf], cummin[:-1]))
    keep = finite & (e_sorted < prev_best)
    return [
        tuple(idx) for idx in zip(*np.unravel_index(order[keep], T.shape))
    ]



# ---------------------------------------------------------------------------
# grid callables, memoized on (B, nf, nc) batch geometry + space axes
# ---------------------------------------------------------------------------
#
# PyTorch runs eagerly, so there is nothing to compile; the memo still
# makes the contract explicit and countable: one closure per (kind, batch
# geometry, impl, space axes), built once for the life of the process, and
# TRACE_COUNTS[kind] increments only when a closure is built. The axes
# tuple keeps two spaces whose grids collide in shape apart.

_GRID_CALLABLE_CACHE: Dict[Tuple, object] = {}
TRACE_COUNTS: Dict[str, int] = {"objective": 0, "plan_argmin": 0, "pareto": 0}


def _count_callable_lookup(fn: object) -> None:
    """Flight-recorder hook: every memo lookup is a hit or a miss."""
    if fn is None:
        obs.counter("engine.grid_callable_cache.miss").inc()
    else:
        obs.counter("engine.grid_callable_cache.hit").inc()


def _export_trace_counts() -> None:
    """Mirror ``TRACE_COUNTS`` into the registry (gauges)."""
    for name, n in TRACE_COUNTS.items():
        obs.gauge(f"engine.trace_counts.{name}").set(n)


def _objective_callable(
    shape: Tuple[int, int, int], axes: Tuple[str, ...] = ()
):
    """``fn(T, W, k) -> (W·T)·T^k`` for one batch geometry within one config
    space: T (B, nf, nc) step times, W (nf, nc) shared power grid, k (B,)
    per-workload objective exponent. The expression order is the fused
    kernel's, so the exact and fused paths agree bit for bit."""
    key = ("objective", shape, axes)
    fn = _GRID_CALLABLE_CACHE.get(key)
    _count_callable_lookup(fn)
    if fn is None:
        TRACE_COUNTS["objective"] += 1

        def fn(T: torch.Tensor, W: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
            T = torch.clamp_min(T, TIME_FLOOR)
            E = W[None, :, :] * T
            return E * tpow(T, k[:, None, None])

        _GRID_CALLABLE_CACHE[key] = fn
    return fn


def _plan_argmin_callable(
    shape: Tuple[int, int, int], impl: Optional[str], axes: Tuple[str, ...] = ()
):
    """The fused metric+mask+argmin sweep (``kernels/plan_grid.py``) for one
    batch geometry within one config space: ``fn(T2, W2, k, mask2) -> (B,)
    int32`` flat indices, with T2/mask2 flattened to (B, nf·nc) C-order."""
    key = ("plan_argmin", shape, impl, axes)
    fn = _GRID_CALLABLE_CACHE.get(key)
    _count_callable_lookup(fn)
    if fn is None:
        TRACE_COUNTS["plan_argmin"] += 1

        def fn(T2, W2, k, mask2):
            return kernel_ops.plan_argmin(
                T2, W2, k, mask2, time_floor=TIME_FLOOR, impl=impl
            )

        _GRID_CALLABLE_CACHE[key] = fn
    return fn


def _pareto_callable(
    shape: Tuple[int, int, int], impl: Optional[str], axes: Tuple[str, ...] = ()
):
    """The fused energy-tensor + frontier keep-set sweep for one batch
    geometry within one config space: ``fn(T2, W2, mask2) -> (E2, kept)``
    with E2 (B, G) f32 and kept (B, G) bool. E2 = W·max(T, floor) is
    bitwise the k = 0 objective tensor (tpow(T, 0) is an exact 1.0)."""
    key = ("pareto", shape, impl, axes)
    fn = _GRID_CALLABLE_CACHE.get(key)
    _count_callable_lookup(fn)
    if fn is None:
        TRACE_COUNTS["pareto"] += 1

        def fn(T2, W2, mask2):
            T2 = torch.clamp_min(T2, TIME_FLOOR)
            E2 = W2 * T2
            kept = kernel_ops.pareto_mask(T2, E2, mask2, impl=impl)
            return E2, kept

        _GRID_CALLABLE_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# workload characterization (roofline terms -> ε-SVR step-time surface)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RooflineTerms:
    """Per-device seconds at 256 chips / f_nom (from the dry-run)."""

    compute_s: float
    memory_s: float
    collective_s: float
    source: str  # "dryrun" | "analytic" | "synthetic"

    def step_time(self, f_ghz: float, chips: int) -> float:
        scale = 256.0 / chips
        comp = self.compute_s * scale * (F_NOM / f_ghz)
        mem = self.memory_s * scale
        coll = self.collective_s * (DCN_POD_PENALTY if chips > 256 else 1.0)
        return max(comp, mem, coll)


def terms_from_dryrun(
    arch_id: str, shape: str, dryrun_dir: str = DRYRUN_DIR, mesh: str = "pod"
) -> Optional[RooflineTerms]:
    path = os.path.join(dryrun_dir, f"{arch_id}__{shape}__{mesh}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    if not rec.get("ok"):
        return None
    # Optional fields default to zero cost: partial dry-run records (e.g. a
    # single-device run with no collectives section) still characterize.
    h = rec.get("hlo") or {}
    return RooflineTerms(
        compute_s=h.get("flops_per_device", 0.0) / PEAK_FLOPS_BF16,
        memory_s=h.get("memory_bytes_per_device", 0.0) / HBM_BW,
        collective_s=h.get("collective_bytes_per_device", 0.0) / ICI_BW,
        source="dryrun",
    )



# terms_analytic is pure in (arch_id, cell) but builds the arch's module
# tree on the meta device per call. Memoized process-wide; ShapeCell is
# frozen/hashable so the cell itself is the key.
_ANALYTIC_TERMS_CACHE: Dict[Tuple[str, Hashable], RooflineTerms] = {}


def _count_params(arch_id: str) -> float:
    """The arch's FULL parameter count, from its modules built on the meta
    device (nothing is allocated; ``encdec.init`` for an encoder-decoder);
    1e8 for an id the zoo does not know, as the reference."""
    from repro_torch.configs import ARCHS  # lazy: keeps the node-only path light
    from repro_torch.models import common

    arch = ARCHS.get(arch_id)
    if arch is None:
        return 1e8
    return common.count_params(arch.init(None, arch.full, device="meta"))


def terms_analytic(arch_id: str, cell) -> RooflineTerms:
    """6·N·D fallback when no dry-run artifact exists (memoized)."""
    key = (arch_id, cell)
    cached = _ANALYTIC_TERMS_CACHE.get(key)
    if cached is not None:
        return cached
    n_params = _count_params(arch_id)
    tokens = cell.seq * cell.batch
    mult = 3.0 if cell.kind == "train" else 0.33  # fwd+bwd(+remat) vs fwd
    flops = 2.0 * n_params * tokens * mult
    per_dev = flops / 256
    terms = RooflineTerms(
        compute_s=per_dev / PEAK_FLOPS_BF16,
        memory_s=2 * n_params * 2 / 256 / HBM_BW,
        collective_s=per_dev / PEAK_FLOPS_BF16 * 0.3,
        source="analytic",
    )
    _ANALYTIC_TERMS_CACHE[key] = terms
    return terms


# ---------------------------------------------------------------------------
# workloads and plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Workload:
    """One planning request. Hashable: identical requests share a fit.

    ``earliest_start_s`` is the horizon-aware scheduler's hook: a known
    FUTURE job cannot start before its arrival, so its usable slack is
    ``max_time_s - earliest_start_s``, not the full ``max_time_s`` the
    caller measured from *now*. The engine shifts the time constraint by
    this delay (``effective_constraints``) so a future job's frontier is
    masked by the slack it will actually have at launch — planning it
    from ``now`` would admit leisurely configurations that miss the
    deadline once the start delay elapses.
    """

    arch: str
    cell: Optional[object] = None  # configs.base.ShapeCell
    n_steps: int = 1
    constraints: Optional[Constraints] = None
    objective: Optional[str] = None  # None -> engine default
    terms: Optional[RooflineTerms] = None  # explicit characterization override
    earliest_start_s: float = 0.0  # delay before the job can start (s)

    # cached_property (not property): schedulers re-present the same
    # Workload objects round after round, and at 10k pending jobs the
    # per-call key/name rebuilds were a measurable slice of the fused
    # plan_many round. cached_property writes the instance __dict__
    # directly, so it composes with frozen=True; equality/hash still read
    # only the declared fields.
    @functools.cached_property
    def shape_name(self) -> str:
        return self.cell.name if self.cell is not None else "custom"

    @functools.cached_property
    def key(self) -> Hashable:
        """Characterization-cache key: one SVR fit per workload family."""
        return self.terms if self.terms is not None else (self.arch, self.shape_name)

    def effective_constraints(self) -> Optional[Constraints]:
        """The constraints as seen from the job's earliest start: the time
        bound shrinks by the start delay (clamped at 0 — an already-blown
        window leaves an empty mask for ``on_infeasible`` to resolve)."""
        c = self.constraints
        delay = float(self.earliest_start_s)
        if delay <= 0.0 or c is None or c.max_time_s is None:
            return c
        return dataclasses.replace(
            c, max_time_s=max(c.max_time_s - delay, 0.0)
        )


@dataclasses.dataclass
class EnergyPlan:
    arch: str
    shape: str
    chips: int
    pods: int
    mesh: tuple
    frequency_ghz: float
    step_time_s: float
    power_w: float
    energy_per_step_j: float
    baseline_energy_j: float  # race-to-idle full-slice baseline
    terms_source: str
    svr_pae: float
    objective: str = "energy"
    n_steps: int = 1
    total_energy_j: float = 0.0  # energy_per_step_j · n_steps

    def summary(self) -> str:
        save = 100 * (self.baseline_energy_j - self.energy_per_step_j) / max(
            self.baseline_energy_j, 1e-12
        )
        return (
            f"{self.arch}/{self.shape}: {self.chips} chips ({self.pods} pod(s), "
            f"mesh {self.mesh}) @ {self.frequency_ghz:.2f} GHz -> "
            f"{self.step_time_s*1e3:.1f} ms/step, {self.power_w/1e3:.1f} kW, "
            f"{self.energy_per_step_j:.1f} J/step "
            f"({save:+.1f}% vs max-slice race-to-idle; perf model: "
            f"{self.terms_source}, SVR PAE {self.svr_pae:.2%})"
        )


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One point on the energy/time frontier (for deadline negotiation)."""

    frequency_ghz: float
    chips: int
    pods: int
    step_time_s: float
    power_w: float
    energy_per_step_j: float


def _mesh_for_chips(chips: int) -> tuple:
    if chips > 256:
        return (chips // 256, 16, 16)
    data = chips // 16 if chips >= 16 else 1
    return (max(data, 1), min(chips, 16))


@dataclasses.dataclass(eq=False)
class _Fit:
    """Cached characterization: fitted SVR + its predicted step-time grid."""

    model: svr_mod.SVRParams
    pae: float
    terms: RooflineTerms
    T: Optional[np.ndarray] = None  # (nf, nc), filled by the batched predict
    t_base: Optional[float] = None  # race-to-idle step time, memoized



# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class PlanningEngine:
    """Batched, cache-aware argmin over one ``ConfigSpace`` grid.

    Pass ``space`` (``cpu_space()`` / ``tpu_space()``) to pick the axis
    bundle, or the legacy ``freq_grid``/``chip_grid``/``chips_per_pod``
    kwargs, which build the TPU-pod space. The ``PowerModel`` must match
    the space. ``device`` is where the Gram builds, the grid predictions
    and the fused sweeps run: ``None`` is the CUDA device (raises without
    one); the plan values and frontiers are read back to the host."""

    def __init__(
        self,
        power_model: PowerModel,
        *,
        space: Optional[ConfigSpace] = None,
        freq_grid: Sequence[float] = tuple(F_GRID),
        chip_grid: Sequence[int] = CHIP_GRID,
        chips_per_pod: int = 256,
        dryrun_dir: str = DRYRUN_DIR,
        noise: float = 0.02,
        seed: int = 0,
        objective: str = "energy",
        on_infeasible: str = "fastest",
        fused: bool = True,
        rff_threshold: Optional[int] = None,
        device: DeviceLike = None,
    ):
        if objective not in OBJECTIVES:
            raise ValueError(f"unknown objective {objective!r}")
        self.device = resolve_device(device)
        self.power = power_model
        # fused=True routes plan_many/pareto_many through the
        # kernels/plan_grid.py sweep; False replays the per-workload
        # solve_grid path (the parity oracle).
        self.fused = bool(fused)
        self.rff_threshold = rff_threshold
        if space is None:
            space = tpu_space(freq_grid, chip_grid, chips_per_pod)
        self.space = space
        self.freq_grid = space.freq_grid
        self.chip_grid = space.chip_grid
        self.chips_per_pod = space.chips_per_pod
        self.dryrun_dir = dryrun_dir
        self.noise = noise
        self.seed = seed
        self.objective = objective
        self.on_infeasible = on_infeasible
        F, C, pods = space.meshes()
        self._F, self._C = F, C
        self._pods = pods
        self._grid_feats = np.stack([F.ravel(), C.ravel()], 1).astype(np.float32)
        # power is application-agnostic: one grid shared by every workload,
        # kept on the device for the sweeps and on the host for the plans
        dev = self.device
        self._W_dev = self.power(
            torch.from_numpy(F).to(dev),
            torch.from_numpy(C).to(dev),
            torch.from_numpy(pods).to(dev),
        )
        self._W = to_host(self._W_dev)
        # race-to-idle baseline power (max f, max chips): one host-path
        # scalar call per engine
        cmax = self.chip_grid[-1]
        self._w_base = float(
            self.power(self.freq_grid[-1], cmax, space.pods_for(cmax))
        )
        self._fits: Dict[Hashable, _Fit] = {}

    @classmethod
    def default(cls, **kw) -> "PlanningEngine":
        return cls(fit_fleet_power(FleetTelemetry()), **kw)

    def clear_cache(self, *, analytic: bool = True) -> None:
        """Drop every cached characterization.

        By default clears both memo layers: this engine's fit cache and
        the module-level ``terms_analytic`` (arch_id, cell) memo, which is
        process-wide (shared by every engine); ``analytic=False`` drops
        only this engine's fits.
        """
        self._fits.clear()
        if analytic:
            _ANALYTIC_TERMS_CACHE.clear()

    def install_fit(self, key: Hashable, model, pae: float, terms) -> None:
        """Install (or refresh) a characterization fitted outside the engine.

        Args:
            key: the family's cache key — must equal the ``Workload.key``
                future plans will present.
            model: a fitted ``svr.SVRParams`` step-time surface mapping raw
                (GHz, cores) features to seconds, on this engine's device.
            pae: the model's percentage absolute error on its training set.
            terms: the believed terms object behind the fit.
        """
        self._fits[key] = _Fit(model=model, pae=float(pae), terms=terms)

    def cached_terms(self, key: Hashable):
        """The terms behind the cached fit for ``key`` (None if unfitted)."""
        fit = self._fits.get(key)
        return fit.terms if fit is not None else None

    # -- characterization ---------------------------------------------------

    def _training_set(self, terms: RooflineTerms):
        """The (f, chips) → noisy step-time sweep for one roofline.
        Deterministic: the measurement-noise stream restarts from ``seed``
        per set, so a cached fit and a fresh fit of the same terms are
        identical."""
        rng = np.random.default_rng(self.seed)
        feats, times = [], []
        for f in self.freq_grid:
            for c in self.chip_grid:
                t = terms.step_time(float(f), int(c))
                t *= 1.0 + float(rng.normal(0, self.noise))
                feats.append((float(f), float(c)))
                times.append(max(t, TIME_FLOOR))
        return np.asarray(feats, np.float32), np.asarray(times, np.float32)

    def characterize(self, terms: RooflineTerms):
        """Fit the ε-SVR step-time surface for one roofline."""
        x, y = self._training_set(terms)
        model = svr_mod.fit(x, y, device=self.device, **ENGINE_FIT_KW)
        return model, svr_mod.pae(model, x, y)

    def _terms_for(self, w: Workload) -> RooflineTerms:
        if w.terms is not None:
            return w.terms
        if w.cell is None:
            raise ValueError("workload needs either explicit terms or a shape cell")
        terms = terms_from_dryrun(w.arch, w.cell.name, self.dryrun_dir)
        return terms if terms is not None else terms_analytic(w.arch, w.cell)

    def _fits_for(self, workloads: Sequence[Workload]) -> List[_Fit]:
        """Every workload family not yet in the cache is fitted in ONE
        ``svr.fit_many`` call and scored in one ``predict_each`` pass."""
        keys = [w.key for w in workloads]
        missing: Dict[Hashable, RooflineTerms] = {}
        for key, w in zip(keys, workloads):
            if key not in self._fits and key not in missing:
                missing[key] = self._terms_for(w)
        if obs.enabled():
            obs.counter("engine.fit_cache.miss").inc(len(missing))
            obs.counter("engine.fit_cache.hit").inc(
                len(set(keys)) - len(missing)
            )
        if missing:
            sets = [self._training_set(t) for t in missing.values()]
            with obs.span(
                "engine.fit_many", cat="engine", n_families=len(missing)
            ):
                models = svr_mod.fit_many(
                    sets,
                    method="auto",
                    rff_threshold=self.rff_threshold,
                    device=self.device,
                    **ENGINE_FIT_KW,
                )
                preds = svr_mod.predict_each(models, [x for x, _ in sets])
            for (key, terms), model, (x, y), pred in zip(
                missing.items(), models, sets, preds
            ):
                self._fits[key] = _Fit(
                    model=model, pae=svr_mod.pae_from_pred(pred, y), terms=terms
                )
        return [self._fits[key] for key in keys]

    def _ensure_predictions(self, fits: Sequence[_Fit]) -> None:
        """Evaluate the step-time grid of every not-yet-predicted fit in one
        batched ``rbf_gram`` call (``svr.predict_many``), read back once."""
        pending, seen = [], set()
        for f in fits:
            if f.T is None and id(f) not in seen:
                seen.add(id(f))
                pending.append(f)
        if not pending:
            return
        preds = svr_mod.predict_many([f.model for f in pending], self._grid_feats)
        if all(isinstance(t, torch.Tensor) for t in preds):
            preds = to_host(torch.stack(preds))
        for f, t in zip(pending, preds):
            f.T = np.maximum(
                to_host(t).astype(np.float64).reshape(self._F.shape), TIME_FLOOR
            )

    # -- planning -----------------------------------------------------------

    @staticmethod
    def _t_stack(fits: Sequence[_Fit]) -> np.ndarray:
        """The (B, nf, nc) float64 step-time stack, built by stacking the
        UNIQUE fits and gathering."""
        uniq: Dict[int, int] = {}
        rows = []
        inv = np.empty(len(fits), np.intp)
        for i, f in enumerate(fits):
            j = uniq.get(id(f))
            if j is None:
                j = uniq[id(f)] = len(rows)
                rows.append(f.T)
            inv[i] = j
        stacked = np.stack(rows)
        return stacked[inv] if len(rows) < len(fits) else stacked

    def _mask_stack(
        self, workloads: Sequence[Workload], T_stack: np.ndarray
    ) -> np.ndarray:
        """Every workload's ``constraint_mask`` in one vectorized pass
        (unset fields become infinite bounds)."""
        b = len(workloads)
        max_t = np.full(b, np.inf)
        max_c = np.full(b, np.inf)
        min_f = np.full(b, -np.inf)
        max_f = np.full(b, np.inf)
        for i, w in enumerate(workloads):
            c = w.effective_constraints()
            if c is None:
                continue
            if c.max_time_s is not None:
                max_t[i] = c.max_time_s
            if c.max_cores is not None:
                max_c[i] = c.max_cores
            if c.min_frequency_ghz is not None:
                min_f[i] = c.min_frequency_ghz
            if c.max_frequency_ghz is not None:
                max_f[i] = c.max_frequency_ghz
        mask = T_stack <= max_t[:, None, None]
        mask &= self._C[None, :, :] <= max_c[:, None, None]
        mask &= self._F[None, :, :] >= min_f[:, None, None]
        mask &= self._F[None, :, :] <= max_f[:, None, None]
        return mask

    def _device_stack(self, T64: np.ndarray) -> torch.Tensor:
        """The float32 step-time stack on the device (rounded on the host)."""
        return torch.from_numpy(T64.astype(np.float32)).to(self.device)

    def _exact_metric(self, T_stack: torch.Tensor, k_np: np.ndarray) -> np.ndarray:
        b, nf, nc = T_stack.shape
        fn = _objective_callable((b, nf, nc), self.space.axes)
        k = torch.from_numpy(k_np).to(self.device)
        return to_host(fn(T_stack, self._W_dev, k)).astype(np.float64)

    def plan_many(
        self,
        workloads: Sequence[Workload],
        *,
        fused: Optional[bool] = None,
        impl: Optional[str] = None,
    ) -> List[EnergyPlan]:
        """Plan every workload in one batched pass (paper Eq. 8, batched).

        One ``svr.fit_many`` over the cache-missing families, one batched
        grid prediction, then ONE fused metric+mask+argmin sweep over the
        (workload × frequency × cores) tensor. ``fused=False`` replays the
        per-workload ``solve_grid`` path; both pick bitwise-identical
        configs. ``impl="ref"`` runs the fused sweep's plain version.

        Returns:
            ``EnergyPlan`` per workload, aligned with the input order.
            Units: ``frequency_ghz`` GHz, ``step_time_s`` s, ``power_w``
            W, ``energy_per_step_j``/``total_energy_j`` J.
        """
        workloads = list(workloads)
        if not workloads:
            return []
        use_fused = bool(self.fused if fused is None else fused)
        obs.histogram("engine.plan_many.batch_size").observe(len(workloads))
        obs.counter(
            "engine.plan_many.fused" if use_fused else "engine.plan_many.exact"
        ).inc()
        with obs.span(
            "engine.plan_many", cat="engine",
            batch=len(workloads), fused=use_fused,
        ):
            plans = self._plan_many_impl(workloads, use_fused, impl)
        if obs.enabled():
            _export_trace_counts()
        return plans

    def _plan_many_impl(
        self, workloads: List[Workload], use_fused: bool, impl: Optional[str]
    ) -> List[EnergyPlan]:
        objectives = [w.objective or self.objective for w in workloads]
        for obj in objectives:
            if obj not in OBJECTIVES:
                raise ValueError(
                    f"unknown objective {obj!r}; want {sorted(OBJECTIVES)}"
                )
        fits = self._fits_for(workloads)
        self._ensure_predictions(fits)
        T64 = self._t_stack(fits)  # (B, nf, nc) float64
        b, nf, nc = T64.shape
        T_stack = self._device_stack(T64)
        k_np = np.asarray([OBJECTIVES[obj] for obj in objectives], np.float32)
        if not use_fused:
            # exact arm: one objective tensor, one host argmin per workload
            metric = self._exact_metric(T_stack, k_np)
            return [
                self._plan_one(w, f, metric[i])
                for i, (w, f) in enumerate(zip(workloads, fits))
            ]
        mask = self._mask_stack(workloads, T64)
        feasible = mask.any(axis=(1, 2))
        sweep = _plan_argmin_callable((b, nf, nc), impl, self.space.axes)
        flat = to_host(
            sweep(
                T_stack.reshape(b, nf * nc),
                self._W_dev.reshape(1, nf * nc),
                torch.from_numpy(k_np).to(self.device),
                torch.from_numpy(mask.reshape(b, nf * nc)).to(self.device),
            )
        ).astype(np.int64)
        if not feasible.all():
            # empty mask: rare — route through solve_grid's on_infeasible
            # semantics with the exact arm's metric slice, then patch the
            # chosen flat index so the finish pass below stays unified
            obs.counter("engine.plan_many.infeasible_patched").inc(
                int((~feasible).sum())
            )
            metric = self._exact_metric(T_stack, k_np)
            for i in np.flatnonzero(~feasible):
                w, fit = workloads[i], fits[i]
                idx = solve_grid(
                    self._F,
                    self._C,
                    fit.T,
                    self._W,
                    objective=objectives[i],
                    constraints=w.effective_constraints(),
                    on_infeasible=self.on_infeasible,
                    metric=metric[i],
                )
                flat[i] = idx[0] * nc + idx[1]
        return self._finish_plans(workloads, fits, objectives, flat, T64)

    def plan(self, workload: Workload) -> EnergyPlan:
        """Plan one workload — the B = 1 view of ``plan_many``."""
        return self.plan_many([workload])[0]

    def _plan_one(self, w: Workload, fit: _Fit, metric: np.ndarray) -> EnergyPlan:
        obj = w.objective or self.objective
        idx = solve_grid(
            self._F,
            self._C,
            fit.T,
            self._W,
            objective=obj,
            constraints=w.effective_constraints(),
            on_infeasible=self.on_infeasible,
            metric=metric,
        )
        return self._finish_plan(w, fit, idx, obj)

    def _finish_plan(
        self, w: Workload, fit: _Fit, idx: Tuple[int, int], obj: str
    ) -> EnergyPlan:
        """Materialize the ``EnergyPlan`` for one chosen grid index."""
        chips = int(self._C[idx])
        step_t = float(fit.T[idx])
        watts = float(self._W[idx])
        if fit.t_base is None:
            fit.t_base = fit.terms.step_time(self.freq_grid[-1], self.chip_grid[-1])
        return EnergyPlan(
            arch=w.arch,
            shape=w.shape_name,
            chips=chips,
            pods=int(self._pods[idx]),
            mesh=_mesh_for_chips(chips),
            frequency_ghz=float(self._F[idx]),
            step_time_s=step_t,
            power_w=watts,
            energy_per_step_j=watts * step_t,
            baseline_energy_j=fit.t_base * self._w_base,
            terms_source=fit.terms.source,
            svr_pae=fit.pae,
            objective=obj,
            n_steps=w.n_steps,
            total_energy_j=watts * step_t * w.n_steps,
        )

    def _finish_plans(
        self,
        workloads: Sequence[Workload],
        fits: Sequence[_Fit],
        objectives: Sequence[str],
        flat: np.ndarray,
        T64: np.ndarray,
    ) -> List[EnergyPlan]:
        """Materialize every ``EnergyPlan`` from the flat chosen indices —
        the batched twin of ``_finish_plan``, with the per-value arithmetic
        in the same order so the plans are bitwise identical."""
        b = len(workloads)
        freq_l = self._F.ravel()[flat].tolist()
        chips_l = self._C.ravel()[flat].astype(np.int64).tolist()
        pods_l = self._pods.ravel()[flat].astype(np.int64).tolist()
        watts_l = self._W.ravel()[flat].tolist()
        step_l = T64.reshape(b, -1)[np.arange(b), flat].tolist()
        mesh_memo: Dict[int, tuple] = {}
        fit_memo: Dict[int, Tuple[float, str, float]] = {}
        plans = []
        for i, (w, fit) in enumerate(zip(workloads, fits)):
            chips = chips_l[i]
            mesh = mesh_memo.get(chips)
            if mesh is None:
                mesh = mesh_memo[chips] = _mesh_for_chips(chips)
            hoisted = fit_memo.get(id(fit))
            if hoisted is None:
                if fit.t_base is None:
                    fit.t_base = fit.terms.step_time(
                        self.freq_grid[-1], self.chip_grid[-1]
                    )
                hoisted = fit_memo[id(fit)] = (
                    fit.t_base * self._w_base,
                    fit.terms.source,
                    fit.pae,
                )
            base_e, source, pae = hoisted
            step_t = step_l[i]
            watts = watts_l[i]
            e = watts * step_t
            # fast-path construction of the plain dataclass: the keys must
            # stay in lockstep with the EnergyPlan fields
            p = EnergyPlan.__new__(EnergyPlan)
            p.__dict__ = {
                "arch": w.arch,
                "shape": w.shape_name,
                "chips": chips,
                "pods": pods_l[i],
                "mesh": mesh,
                "frequency_ghz": freq_l[i],
                "step_time_s": step_t,
                "power_w": watts,
                "energy_per_step_j": e,
                "baseline_energy_j": base_e,
                "terms_source": source,
                "svr_pae": pae,
                "objective": objectives[i],
                "n_steps": w.n_steps,
                "total_energy_j": e * w.n_steps,
            }
            plans.append(p)
        return plans

    def pareto_many(
        self,
        workloads: Sequence[Workload],
        *,
        fused: Optional[bool] = None,
        impl: Optional[str] = None,
    ) -> List[List[ParetoPoint]]:
        """The energy/time frontier of EVERY workload, one batched pass.

        The same machinery as ``plan_many``, then ONE fused energy-tensor +
        keep-set sweep (``kernels/plan_grid.py``); ``fused=False`` replays
        the host ``pareto_frontier`` sweep (bitwise-identical frontiers),
        ``impl="ref"`` runs the keep-set's plain version.

        Returns:
            One ``List[ParetoPoint]`` per workload, aligned with the input:
            fastest point first, strictly increasing ``step_time_s`` (s) and
            strictly decreasing ``energy_per_step_j`` (J) along the list.
        """
        workloads = list(workloads)
        if not workloads:
            return []
        use_fused = bool(self.fused if fused is None else fused)
        obs.histogram("engine.pareto_many.batch_size").observe(len(workloads))
        obs.counter(
            "engine.pareto_many.fused" if use_fused
            else "engine.pareto_many.exact"
        ).inc()
        with obs.span(
            "engine.pareto_many", cat="engine",
            batch=len(workloads), fused=use_fused,
        ):
            frontiers = self._pareto_many_impl(workloads, use_fused, impl)
        if obs.enabled():
            _export_trace_counts()
        return frontiers

    def _pareto_many_impl(
        self, workloads: List[Workload], use_fused: bool, impl: Optional[str]
    ) -> List[List[ParetoPoint]]:
        fits = self._fits_for(workloads)
        self._ensure_predictions(fits)
        T64 = self._t_stack(fits)  # (B, nf, nc) float64
        b, nf, nc = T64.shape
        T_stack = self._device_stack(T64)
        if not use_fused:
            # E·T^0, i.e. the plain energy tensor
            E_stack = self._exact_metric(T_stack, np.zeros(b, np.float32))
            return [
                self._frontier_for(w, f, E_stack[i])
                for i, (w, f) in enumerate(zip(workloads, fits))
            ]
        mask = self._mask_stack(workloads, T64)
        feasible = mask.any(axis=(1, 2))
        if not feasible.all():
            obs.counter("engine.pareto_many.infeasible_fallback").inc(
                int((~feasible).sum())
            )
        sweep = _pareto_callable((b, nf, nc), impl, self.space.axes)
        E2, kept = sweep(
            T_stack.reshape(b, nf * nc),
            self._W_dev.reshape(1, nf * nc),
            torch.from_numpy(mask.reshape(b, nf * nc)).to(self.device),
        )
        E_stack = to_host(E2).astype(np.float64).reshape(b, nf, nc)
        kept = to_host(kept)
        out = []
        for i, (w, fit) in enumerate(zip(workloads, fits)):
            if feasible[i]:
                out.append(self._frontier_from_kept(fit, E_stack[i], kept[i]))
            else:
                # empty mask: exact fallback (on_infeasible semantics)
                out.append(self._frontier_for(w, fit, E_stack[i]))
        return out

    def _frontier_from_kept(
        self, fit: _Fit, E: np.ndarray, kept_row: np.ndarray
    ) -> List[ParetoPoint]:
        """Materialize one frontier from the fused keep-set, in the same
        fastest-first order as ``pareto_frontier``."""
        flat_idx = np.flatnonzero(kept_row)
        t_flat = fit.T.reshape(-1)[flat_idx]
        order = np.argsort(t_flat, kind="stable")
        nc = fit.T.shape[1]
        return [
            ParetoPoint(
                frequency_ghz=float(self._F[r, c]),
                chips=int(self._C[r, c]),
                pods=int(self._pods[r, c]),
                step_time_s=float(fit.T[r, c]),
                power_w=float(self._W[r, c]),
                energy_per_step_j=float(E[r, c]),
            )
            for r, c in ((int(f) // nc, int(f) % nc) for f in flat_idx[order])
        ]

    def pareto(self, workload: Workload) -> List[ParetoPoint]:
        """One workload's energy/time frontier, fastest point first — the
        B = 1 view of ``pareto_many``."""
        return self.pareto_many([workload])[0]

    def _frontier_for(
        self, w: Workload, fit: _Fit, E: np.ndarray
    ) -> List[ParetoPoint]:
        """Extract one workload's frontier from its slice of the shared
        energy tensor (constraint mask + deterministic ``pareto_frontier``)."""
        constraints = w.effective_constraints()
        mask = constraint_mask(self._F, self._C, fit.T, constraints)
        if not mask.any():
            if self.on_infeasible == "raise":
                raise ValueError("constraints admit no configuration on the grid")
            mask = fastest_feasible_mask(self._F, self._C, fit.T, constraints)
        return [
            ParetoPoint(
                frequency_ghz=float(self._F[idx]),
                chips=int(self._C[idx]),
                pods=int(self._pods[idx]),
                step_time_s=float(fit.T[idx]),
                power_w=float(self._W[idx]),
                energy_per_step_j=float(E[idx]),
            )
            for idx in pareto_frontier(
                np.where(mask, fit.T, np.inf), np.where(mask, E, np.inf)
            )
        ]
