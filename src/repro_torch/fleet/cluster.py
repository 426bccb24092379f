"""Heterogeneous node pool: the cluster-scale measurement substrate.

The paper characterizes ONE node (2× Xeon E5-2698v3); a fleet is many such
nodes that are *almost* alike — different steppings ship different frequency
tables, chassis variants change the static-power floor, the silicon lottery
skews the dynamic parcel, and binned parts run a few percent slower. This
module models that spread:

* ``NodeSpec`` — the admin-known facts about one node: core count,
  frequency table, static/dynamic power skews (multipliers on the paper
  Eq. 7 coefficient groups) and a speed skew (>1 = slower silicon). The
  scheduler may use these (they are inventory data, not measurements) to
  project a reference-node plan onto a specific node:
  ``expected_*`` below is exactly the "plan energy × node skew" bin-pack
  score.
* ``FleetNode`` — a live node: wraps a ``node_sim.Node`` whose ground-truth
  power coefficients are skewed per spec, applies the speed skew and any
  injected *drift* (unannounced slowdown of one application family — the
  thing online re-characterization must catch) to every run, and keeps the
  reservation ledger used for free-core accounting and utilization.
* ``CapacityProfile`` / the reservation ledger — time-indexed free-core
  accounting over half-open ``[start, end)`` segments: interval capacity
  queries (``free_cores(start, end)``), earliest-gap start-slot search,
  and *tentative* reservations (lookahead holds that a later round
  confirms or releases). All sim-clock comparisons share one relative
  tolerance (``time_eps``).
* ``NodePool`` — the fleet: free-core queries at a sim time, reservation
  bookkeeping, next-completion lookup, per-node utilization.
* ``AppTerms`` — the bridge into ``core.engine``: a duck-typed
  ``RooflineTerms`` whose ``step_time(f, cores)`` is the *believed*
  execution-time surface of one (app, input) family on the reference node.
  It is frozen/hashable, so it doubles as the engine's characterization
  cache key: one SVR fit per family, shared by every job in the family.

Everything downstream (the engine argmin, SVR fits, governor baselines)
treats these nodes exactly like the single-node path treats ``Node`` —
swap in real hosts and the fleet methodology is unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import tpu_power
from repro_torch.core.node_sim import (
    CORES_PER_SOCKET,
    FREQ_GRID,
    MAX_CORES,
    Node,
    PROFILES,
    RunResult,
)
from repro_torch.core.power import PAPER_COEFFS, PowerModel

REFERENCE_FREQS: Tuple[float, ...] = tuple(float(f) for f in FREQ_GRID)
TPU_FREQS: Tuple[float, ...] = tuple(float(f) for f in tpu_power.F_GRID)

# ground-truth Eq. 7 coefficient groups per device family — the CPU node
# is the paper's Xeon (Eq. 9), the TPU slice the v5e refit; both are FIT
# from stress telemetry downstream, never consumed as truth
DEVICE_COEFFS = {"cpu": PAPER_COEFFS, "tpu": tpu_power.TRUE_COEFFS}
# fleet-level sensors are noisier than one node's IPMI (tpu_power doc)
DEVICE_POWER_NOISE_W = {"cpu": 2.4, "tpu": tpu_power.FleetTelemetry.noise_w}

# ---------------------------------------------------------------------------
# time tolerance: ONE relative epsilon for every sim-clock comparison
# ---------------------------------------------------------------------------

# The seed code compared sim times with absolute epsilons (now + 1e-12 in
# the ledger, now + 1e-6 in the event clamp). Absolute tolerances lose all
# meaning at large clocks: the float64 ulp at t = 1e6 s is ~1e-10, so
# t + 1e-12 == t and every "strictly later" test silently degenerates to
# ">". One RELATIVE tolerance, shared by cluster.py and scheduler.py,
# keeps the comparisons honest at any clock magnitude.
TIME_EPS_REL = 1e-9


def time_eps(t: float) -> float:
    """The comparison tolerance at sim time ``t`` (seconds).

    Relative (1e-9 of the clock magnitude, floored at 1e-9 s near zero):
    always representable — strictly above the float64 ulp of ``t`` — so
    ``t + time_eps(t) > t`` holds for any reachable sim time, which the
    absolute epsilons of the seed code could not guarantee past t ~ 1e6 s.
    """
    return TIME_EPS_REL * max(abs(float(t)), 1.0)


def segment_active_at(s: float, e: float, t: float, eps: float) -> bool:
    """THE occupancy rule: does the half-open segment ``[s, e)`` occupy
    instant ``t`` under tolerance ``eps`` (= ``time_eps(t)``)?

    A segment starting at ``t`` counts, one ending at ``t`` does not, and
    the tolerance is capped at HALF the segment's own duration so the
    query tolerance (which grows with the sim clock) can never swallow a
    whole short reservation. One definition — every occupancy test in the
    ledger (``busy_at``, ``has_capacity``, the ``free_cores`` fast path)
    must agree or the capacity views drift apart.
    """
    tol = 0.5 * (e - s)
    if tol > eps:
        tol = eps
    return s <= t + tol and e > t + tol


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """Admin-known per-node hardware facts (inventory, not measurements)."""

    name: str
    max_cores: int = MAX_CORES
    freq_table: Tuple[float, ...] = REFERENCE_FREQS
    static_power_skew: float = 1.0  # scales c3 (chassis) + c4 (per socket)
    dynamic_power_skew: float = 1.0  # scales c1 f^3 + c2 f (silicon lottery)
    speed_skew: float = 1.0  # >1: the same work takes longer here
    # the planning axis this node belongs to: "cpu" (f, cores) or "tpu"
    # (f, chips, pods). Jobs only ever place on nodes of their own device.
    device: str = "cpu"
    # Eq. 7 s(p) granularity: cores/socket on the Xeon, chips/pod on a
    # TPU slice — ``max_cores`` counts cores or chips in the same unit.
    cores_per_socket: int = CORES_PER_SOCKET

    def truth_coeffs(self, base=PAPER_COEFFS) -> Tuple[float, float, float, float]:
        c1, c2, c3, c4 = base
        return (
            c1 * self.dynamic_power_skew,
            c2 * self.dynamic_power_skew,
            c3 * self.static_power_skew,
            c4 * self.static_power_skew,
        )

    def snap_frequency(self, f: float) -> float:
        """Lowest table frequency >= f (kernel relation_l); table max if none.

        A plain scan of the (ascending, ~dozen-entry) table: this runs
        hundreds of times per scheduling round in option projection, where
        the numpy array build + searchsorted dispatch dominated the math.
        """
        f = f - 1e-9
        for v in self.freq_table:
            if v >= f:
                return v
        return self.freq_table[-1]

    def sockets(self, cores: int) -> int:
        return int(np.ceil(cores / self.cores_per_socket))

    # -- plan projection: "plan energy × node skew" ------------------------

    def expected_time(self, reference_time_s: float) -> float:
        return reference_time_s * self.speed_skew

    def expected_power(self, power_model: PowerModel, f: float, p: int) -> float:
        """Project the *fitted reference* power model onto this node by the
        known coefficient-group skews (the model itself stays one fit)."""
        f = self.snap_frequency(f)
        dyn = p * (power_model.c1 * f**3 + power_model.c2 * f)
        stat = power_model.c3 + power_model.c4 * self.sockets(p)
        return self.dynamic_power_skew * dyn + self.static_power_skew * stat

    def expected_energy(
        self, power_model: PowerModel, f: float, p: int, reference_time_s: float
    ) -> float:
        return self.expected_power(power_model, f, p) * self.expected_time(
            reference_time_s
        )


def project_point(
    spec: NodeSpec,
    power_model: PowerModel,
    terms,
    cores: int,
    f: float,
    ref_time_s: float,
) -> Tuple[float, float, float]:
    """Project one reference-grid configuration onto one node.

    The single projection used by the bin-pack candidates, the pareto
    negotiation and the migration re-plan — one definition, or the three
    would score the same (point, node) differently. A node whose frequency
    table cannot reach the planned ``f`` (GHz) runs at its snapped (usually
    lower) frequency; the believed surface ``terms`` supplies the time
    ratio between the two, so the returned projection describes the run
    the node will actually execute.

    Returns ``(f_snap GHz, expected time s, expected energy J)`` — the
    "plan energy × node skew" score.
    """
    f_snap = spec.snap_frequency(f)
    t_ref = ref_time_s
    if f_snap != f:
        believed = terms.step_time(f, cores)
        t_ref *= terms.step_time(f_snap, cores) / max(believed, 1e-12)
    t_exp = spec.expected_time(t_ref)
    e_exp = spec.expected_energy(power_model, f_snap, cores, t_ref)
    return f_snap, t_exp, e_exp


@dataclasses.dataclass
class Reservation:
    """One ledger entry over the half-open interval ``[start_s, end_s)``.

    ``tentative`` marks a capacity hold made by the lookahead pass for a
    job that has not launched yet (a known-future arrival, or a ready job
    granted a later start slot). Tentative holds shape placement — they
    keep other jobs from stranding the capacity — but they are not
    executions: they never count as completions, never accrue utilization,
    and each scheduling round either confirms them (the job launches) or
    releases them (the round re-plans with fresh information).
    """

    start_s: float
    end_s: float
    cores: int
    job_id: int
    tentative: bool = False


class CapacityProfile:
    """Time-indexed free-core profile of one node.

    The capacity query the horizon-aware scheduler actually needs is not
    "how many cores are free *now*" but "how many cores are free over the
    whole half-open interval ``[start, end)``" — a reservation that begins
    inside the interval must count against it, and (the latent bug this
    class fixes) a reservation that begins *after* ``now`` must NOT count
    against an instantaneous query at ``now``.

    Segments are half-open ``[start_s, end_s)``: a reservation ending at
    ``t`` and one starting at ``t`` never overlap. All boundary
    comparisons use the shared relative tolerance ``time_eps``.
    """

    def __init__(self, max_cores: int, segments: Optional[List[Tuple[float, float, int]]] = None):
        self.max_cores = int(max_cores)
        # (start_s, end_s, cores) triples; order is irrelevant
        self.segments: List[Tuple[float, float, int]] = list(segments or [])
        # memo for has_capacity on the CURRENT segment set — the slot
        # negotiation re-probes identical windows across scan restarts;
        # any mutation invalidates it
        self._probe_cache: Dict[Tuple[float, float, int], bool] = {}

    def copy(self) -> "CapacityProfile":
        dup = CapacityProfile(self.max_cores, list(self.segments))
        dup._probe_cache = dict(self._probe_cache)  # same segments: valid
        return dup

    def add(self, start_s: float, end_s: float, cores: int) -> None:
        self.segments.append((float(start_s), float(end_s), int(cores)))
        self._probe_cache.clear()

    def remove(self, start_s: float, end_s: float, cores: int) -> None:
        """Remove one matching segment (ValueError if absent)."""
        self.segments.remove((float(start_s), float(end_s), int(cores)))
        self._probe_cache.clear()

    def busy_at(self, t: float) -> int:
        """Cores reserved at instant ``t`` (half-open: a segment starting
        at ``t`` counts, a segment ending at ``t`` does not).

        One rule for every occupancy test: ``segment_active_at``.
        """
        eps = time_eps(t)
        return sum(
            c
            for s, e, c in self.segments
            if segment_active_at(s, e, t, eps)
        )

    def free_at(self, t: float) -> int:
        return self.max_cores - self.busy_at(t)

    def _sample_points(self, start_s: float, end_s: float) -> List[float]:
        """THE interval sample rule: usage is piecewise constant, changing
        only at segment starts, so any extremum over ``[start_s, end_s)``
        is attained at ``start_s`` or a segment start strictly inside the
        window. One definition — ``free_over`` and ``has_capacity`` must
        sample identically or the exact minima and the yes/no probes
        disagree about the same window."""
        eps = time_eps(start_s)
        eps_end = time_eps(end_s)
        return [start_s] + [
            s
            for s, e, _ in self.segments
            if s > start_s + eps and s < end_s - eps_end
        ]

    def free_over(self, start_s: float, end_s: Optional[float] = None) -> int:
        """Minimum free cores over ``[start_s, end_s)`` (instantaneous
        query at ``start_s`` when ``end_s`` is None)."""
        if end_s is None:
            return self.free_at(start_s)
        return min(self.free_at(p) for p in self._sample_points(start_s, end_s))

    def has_capacity(self, start_s: float, end_s: float, cores: int) -> bool:
        """``free_over(start_s, end_s) >= cores`` with an early exit at the
        first violating instant and a per-segment-set memo — the
        negotiation hot path asks this yes/no question thousands of times
        per round, often about the same window, and rarely needs the
        exact minimum."""
        key = (start_s, end_s, int(cores))
        hit = self._probe_cache.get(key)
        if hit is not None:
            return hit
        out = self._has_capacity(start_s, end_s, cores)
        self._probe_cache[key] = out
        return out

    def _has_capacity(self, start_s: float, end_s: float, cores: int) -> bool:
        # free_over's sampling + busy_at's occupancy rule, with an early
        # exit at the first violating instant
        budget = self.max_cores - int(cores)
        if budget < 0:
            return False
        segs = self.segments
        for t in self._sample_points(start_s, end_s):
            t_eps = time_eps(t)
            busy = 0
            for s, e, c in segs:
                if segment_active_at(s, e, t, t_eps):
                    busy += c
                    if busy > budget:
                        return False
        return True

    def gap_candidates(self, start_min_s: float) -> List[float]:
        """The only instants a new window could first fit: ``start_min_s``
        plus every segment end after it (free cores only ever increase at
        segment ends). One definition — ``earliest_gap`` and the
        negotiator's slot enumeration must agree on slot semantics. The
        same segment-duration-capped tolerance as ``busy_at``: a segment
        shorter than the clock tolerance still contributes its end."""
        eps = time_eps(start_min_s)
        return sorted(
            {start_min_s}
            | {
                e
                for s, e, _ in self.segments
                # 0.5 caps the tolerance at HALF the segment duration — a
                # fraction of (e - s), not an absolute epsilon; the absolute
                # part still routes through time_eps above.
                # repro: allow(epsilon-discipline)
                if e > start_min_s + min(eps, 0.5 * (e - s))
            }
        )

    def earliest_gap(
        self, start_min_s: float, duration_s: float, cores: int
    ) -> Optional[float]:
        """Earliest ``t >= start_min_s`` with ``cores`` free over the whole
        ``[t, t + duration_s)`` window, or None when ``cores`` exceeds the
        node."""
        if cores > self.max_cores:
            return None
        for t in self.gap_candidates(start_min_s):
            if self.free_over(t, t + duration_s) >= cores:
                return float(t)
        return None  # unreachable: the last candidate is after every segment

    def valid(self) -> bool:
        """True when no instant oversubscribes the node."""
        return all(self.free_at(s) >= 0 for s, _, _ in self.segments)


class FleetNode:
    """One live node: skewed ground truth + drift + reservation ledger."""

    def __init__(self, spec: NodeSpec, seed: int = 0, base_coeffs=None):
        self.spec = spec
        if base_coeffs is None:  # device family picks the truth model
            base_coeffs = DEVICE_COEFFS[spec.device]
        self.node = Node(
            seed=seed,
            power_coeffs=spec.truth_coeffs(base_coeffs),
            power_noise_w=DEVICE_POWER_NOISE_W[spec.device],
            cores_per_socket=spec.cores_per_socket,
        )
        self._drift: Dict[str, float] = {}
        self.reservations: List[Reservation] = []
        # service-layer availability: a node the fleet service declared
        # down (crash / heartbeat loss) offers ZERO capacity until a
        # node-up event restores it. Always True in lockstep simulations.
        self.available: bool = True

    @property
    def name(self) -> str:
        return self.spec.name

    # -- drift (the unannounced part of the truth) -------------------------

    def apply_drift(self, app: str, factor: float) -> None:
        """Multiply the true runtime of one application family (dataset
        growth, thermal throttling, a library regression — the scheduler is
        NOT told; telemetry has to notice)."""
        self._drift[app] = self._drift.get(app, 1.0) * float(factor)

    def time_scale(self, app: str) -> float:
        """speed skew × accumulated drift — the true (hidden) slowdown."""
        return self.spec.speed_skew * self._drift.get(app, 1.0)

    # -- measurement substrate --------------------------------------------

    def rescale(self, r: RunResult, scale: float) -> RunResult:
        """Scale a run's duration (power unchanged, energy follows).

        Public contract: the node's hidden time effects (``run_fixed``,
        ``run_governor``, ``run_terms``) and the scheduler's preemption
        relaunch (the ``work_frac`` remainder of a preempted job) both
        rescale measurements through here.
        """
        t = r.time_s * scale
        return RunResult(
            time_s=t,
            energy_j=r.mean_power_w * t,  # power unchanged, duration scaled
            mean_freq_ghz=r.mean_freq_ghz,
            mean_power_w=r.mean_power_w,
            freq_trace=r.freq_trace,
            power_trace=r.power_trace,
        )

    def run_fixed(self, app: str, f: float, p: int, n: float) -> RunResult:
        f = self.spec.snap_frequency(f)
        p = min(int(p), self.spec.max_cores)
        return self.rescale(self.node.run_fixed(app, f, p, n), self.time_scale(app))

    def run_governor(self, app: str, governor, p: int, n: float) -> RunResult:
        p = min(int(p), self.spec.max_cores)
        return self.rescale(
            self.node.run_governor(app, governor, p, n), self.time_scale(app)
        )

    def run_terms(self, app: str, terms, f: float, p: int) -> RunResult:
        """Execute one terms-backed job (the dry-run artifact intake path).

        Applications outside the node profile table have no work/span
        ground truth to simulate, so the truth of a terms-backed run is the
        believed base surface itself under this node's *hidden* effects:
        speed skew × accumulated drift × measurement noise, with power
        drawn from the node's skewed true coefficients. The scheduler still
        plans on the un-skewed reference surface, so the model-vs-truth gap
        telemetry watches is exactly the node heterogeneity + drift, as it
        is for profiled apps.
        """
        f = self.spec.snap_frequency(f)
        p = min(int(p), self.spec.max_cores)
        t = terms.step_time(f, p) * self.time_scale(app)
        t *= 1.0 + float(self.node.rng.normal(0.0, self.node.time_noise))
        t = max(t, 1e-3)
        # cap the 1 Hz IPMI-like trace: artifact runs may be hours long
        n_samples = int(np.clip(round(t), 2, 600))
        power_w = self.node.measure_power(f, p, n_samples=n_samples)
        return RunResult(
            time_s=t,
            energy_j=float(np.mean(power_w)) * t,
            mean_freq_ghz=f,
            mean_power_w=float(np.mean(power_w)),
            freq_trace=np.full(n_samples, f),
            power_trace=power_w,
        )

    def stress_grid(self, freqs=None, cores=None):
        freqs = self.spec.freq_table if freqs is None else freqs
        cores = range(1, self.spec.max_cores + 1) if cores is None else cores
        return self.node.stress_grid(freqs, cores)

    # -- reservation ledger: the time-indexed capacity profile --------------

    def capacity_profile(
        self,
        *,
        exclude_job: Optional[int] = None,
        include_tentative: bool = True,
    ) -> CapacityProfile:
        """The node's free-core profile as a ``CapacityProfile``.

        ``exclude_job`` drops one job's own reservations from the profile —
        the migration re-plan asks "where could this job go if it left its
        current slot?". ``include_tentative=False`` sees only confirmed
        (executing) reservations.
        """
        return CapacityProfile(
            self.spec.max_cores if self.available else 0,
            [
                (r.start_s, r.end_s, r.cores)
                for r in self.reservations
                if r.job_id != exclude_job
                and (include_tentative or not r.tentative)
            ],
        )

    def free_cores(
        self,
        start_s: float,
        end_s: Optional[float] = None,
        *,
        exclude_job: Optional[int] = None,
        include_tentative: bool = True,
    ) -> int:
        """Cores free over the half-open interval ``[start_s, end_s)``
        (instantaneous at ``start_s`` when ``end_s`` is None).

        The interval form fixes the seed ledger's latent bug: a
        reservation with ``start_s`` in the future used to count as busy
        *now*; half-open interval accounting only charges a query for
        reservations it actually overlaps.
        """
        if not self.available:  # a down node offers no capacity at all
            return 0
        if end_s is None:
            # instantaneous fast path: this runs per node per job per
            # round in every placement/migration/FIFO loop — a direct sum
            # with CapacityProfile.busy_at's exact tolerance rule, no
            # profile materialization
            t = float(start_s)
            eps = time_eps(t)
            busy = sum(
                r.cores
                for r in self.reservations
                if r.job_id != exclude_job
                and (include_tentative or not r.tentative)
                and segment_active_at(r.start_s, r.end_s, t, eps)
            )
            return self.spec.max_cores - busy
        return self.capacity_profile(
            exclude_job=exclude_job, include_tentative=include_tentative
        ).free_over(start_s, end_s)

    def earliest_gap(
        self,
        start_min_s: float,
        duration_s: float,
        cores: int,
        *,
        exclude_job: Optional[int] = None,
    ) -> Optional[float]:
        """Earliest start ``>= start_min_s`` with ``cores`` free for the
        whole ``duration_s`` window — the lookahead start-slot query."""
        return self.capacity_profile(exclude_job=exclude_job).earliest_gap(
            start_min_s, duration_s, cores
        )

    def reserve(
        self,
        start_s: float,
        end_s: float,
        cores: int,
        job_id: int,
        *,
        tentative: bool = False,
    ) -> None:
        """Reserve ``cores`` over ``[start_s, end_s)``. ``tentative=True``
        is the lookahead hold: a future round either confirms it
        (``confirm_reservations``, when the job launches) or releases it
        (``release_tentative``, when the round re-plans)."""
        self.reservations.append(
            Reservation(start_s, end_s, cores, job_id, tentative=tentative)
        )

    def confirm_reservations(self, job_id: int) -> int:
        """Promote ``job_id``'s tentative holds to confirmed reservations.
        Returns the number of reservations confirmed."""
        n = 0
        for r in self.reservations:
            if r.job_id == job_id and r.tentative:
                r.tentative = False
                n += 1
        return n

    def release_tentative(self, job_id: Optional[int] = None) -> int:
        """Drop tentative holds (all of them, or one job's). Returns the
        number released. Confirmed reservations are never touched."""
        kept = [
            r
            for r in self.reservations
            if not (r.tentative and (job_id is None or r.job_id == job_id))
        ]
        released = len(self.reservations) - len(kept)
        self.reservations = kept
        return released

    def truncate_reservation(self, job_id: int, now: float) -> int:
        """Preemption hook: end ``job_id``'s active reservation at ``now``.

        The ledger stays honest — the cores were genuinely busy until the
        preemption instant (utilization counts them) and are free after it.
        Returns the number of cores released (0 if no active reservation).
        """
        freed = 0
        for r in self.reservations:
            if r.job_id == job_id and r.end_s > now + time_eps(now):
                r.end_s = now
                freed += r.cores
        return freed

    def utilization(self, horizon_s: float) -> float:
        """Busy core-seconds / capacity core-seconds over [0, horizon].
        Tentative holds are plans, not executions — only confirmed
        reservations accrue utilization."""
        if horizon_s <= 0:
            return 0.0
        busy = sum(
            (min(r.end_s, horizon_s) - min(r.start_s, horizon_s)) * r.cores
            for r in self.reservations
            if not r.tentative
        )
        return busy / (self.spec.max_cores * horizon_s)


class NodePool:
    """The fleet: heterogeneous nodes plus the shared capacity queries."""

    def __init__(self, nodes: Sequence[FleetNode]):
        if not nodes:
            raise ValueError("a fleet needs at least one node")
        self.nodes = list(nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self):
        return iter(self.nodes)

    def __getitem__(self, i) -> FleetNode:
        return self.nodes[i]

    @property
    def reference(self) -> FleetNode:
        """The characterization host: plans are made on its scale, then
        projected per node via the spec skews."""
        return self.nodes[0]

    def devices(self) -> Tuple[str, ...]:
        """The device families present, in first-appearance order."""
        seen: List[str] = []
        for n in self.nodes:
            if n.spec.device not in seen:
                seen.append(n.spec.device)
        return tuple(seen)

    def nodes_for(self, device: Optional[str]) -> List[FleetNode]:
        """The nodes of one device family (all nodes when ``device`` is
        None — the homogeneous-pool degenerate case)."""
        if device is None:
            return self.nodes
        return [n for n in self.nodes if n.spec.device == device]

    def reference_for(self, device: Optional[str]) -> FleetNode:
        """The characterization host of one device family: its first node,
        mirroring ``reference`` (= ``nodes[0]``) per family."""
        nodes = self.nodes_for(device)
        if not nodes:
            raise ValueError(f"pool has no {device!r} nodes")
        return nodes[0]

    def max_free_cores(self, now: float, device: Optional[str] = None) -> int:
        nodes = self.nodes_for(device)
        return max(n.free_cores(now) for n in nodes) if nodes else 0

    def next_completion(self, now: float) -> Optional[float]:
        """The next CONFIRMED reservation end after ``now`` — tentative
        holds are plans, not executions, so they are never completions."""
        ends = [
            r.end_s
            for n in self.nodes
            for r in n.reservations
            if not r.tentative and r.end_s > now + time_eps(now)
        ]
        return min(ends) if ends else None

    def release_tentative(self, job_id: Optional[int] = None) -> int:
        """Drop tentative holds fleet-wide (the start of every lookahead
        round: last round's provisional future placements are re-planned
        with fresh information). Returns the number released."""
        return sum(n.release_tentative(job_id) for n in self.nodes)

    def apply_drift(self, app: str, factor: float) -> None:
        """Fleet-wide drift of one application family (e.g. its dataset
        grew): every node's truth shifts; the scheduler's model does not."""
        for n in self.nodes:
            n.apply_drift(app, factor)

    def utilization(self, horizon_s: float) -> Dict[str, float]:
        return {n.name: n.utilization(horizon_s) for n in self.nodes}


# ---------------------------------------------------------------------------
# believed performance surfaces: the engine-facing characterization bridge
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AppTerms:
    """Duck-typed ``RooflineTerms`` for node applications.

    ``step_time(f, cores)`` is the scheduler's *believed* reference-node
    execution-time surface for one (app, input) workload family —
    ``time_scale`` carries what re-characterization has learned about drift
    (1.0 until telemetry says otherwise). Frozen/hashable: the instance
    with ``time_scale == 1.0`` is the family's engine cache key, so every
    job in a family shares one SVR fit.
    """

    app: str
    input_size: float
    time_scale: float = 1.0
    source: str = "profile"

    def step_time(self, f_ghz: float, cores) -> float:
        return (
            PROFILES[self.app].time(float(f_ghz), int(cores), self.input_size)
            * self.time_scale
        )

    @property
    def family(self) -> Tuple[str, float]:
        return (self.app, self.input_size)


def family_key(app: str, input_size: float) -> AppTerms:
    """The canonical engine cache key of one workload family."""
    return AppTerms(app=app, input_size=float(input_size))


@dataclasses.dataclass(frozen=True)
class TermsFamily:
    """A believed surface over ANY engine terms object (artifact intake).

    ``AppTerms`` is bound to the node profile table; dry-run artifacts
    arrive as ``RooflineTerms`` instead. This wrapper gives such a family
    the same contract the scheduler relies on — frozen/hashable (the
    ``time_scale == 1.0`` instance is the engine cache key), a
    ``step_time(f, cores)`` believed surface in seconds, a ``time_scale``
    that re-characterization can ``dataclasses.replace`` when telemetry
    measures drift, and a ``(app, input_size)`` telemetry family.
    """

    base: object  # hashable terms with step_time(f, cores) — RooflineTerms
    app: str
    input_size: float = 1.0
    time_scale: float = 1.0
    source: str = "artifact"

    def step_time(self, f_ghz: float, cores) -> float:
        return self.base.step_time(float(f_ghz), int(cores)) * self.time_scale

    @property
    def family(self) -> Tuple[str, float]:
        return (self.app, self.input_size)


# ---------------------------------------------------------------------------
# default heterogeneous pools
# ---------------------------------------------------------------------------

DEFAULT_SPECS: Tuple[NodeSpec, ...] = (
    # the paper's reference node: full table, nominal power, nominal speed
    NodeSpec("ref-0"),
    # low-power chassis: fewer cores, capped table, cheaper static floor
    NodeSpec(
        "eco-1",
        max_cores=24,
        freq_table=REFERENCE_FREQS[:8],
        static_power_skew=0.85,
        dynamic_power_skew=0.92,
        speed_skew=1.12,
    ),
    # newer stepping: slightly faster, hungrier chassis
    NodeSpec(
        "turbo-2",
        static_power_skew=1.08,
        dynamic_power_skew=1.05,
        speed_skew=0.94,
    ),
    # previous-gen part: half the cores, coarse table, slow and leaky
    NodeSpec(
        "legacy-3",
        max_cores=16,
        freq_table=REFERENCE_FREQS[::2],
        static_power_skew=1.22,
        dynamic_power_skew=1.10,
        speed_skew=1.28,
    ),
)


def make_pool(
    n_nodes: int = 4, seed: int = 0, specs: Sequence[NodeSpec] = DEFAULT_SPECS
) -> NodePool:
    """A deterministic heterogeneous pool: specs cycle, seeds stay distinct."""
    nodes = []
    for i in range(n_nodes):
        spec = specs[i % len(specs)]
        if i >= len(specs):
            spec = dataclasses.replace(spec, name=f"{spec.name}-{i}")
        nodes.append(FleetNode(spec, seed=seed + 101 * i))
    return NodePool(nodes)


# TPU slices: ``max_cores`` counts CHIPS, ``cores_per_socket`` chips/pod,
# the frequency table is the v5e DVFS range. The same spec-skew story as
# the CPU specs — a reference slice, a cross-pod monster with a hungrier
# shared fabric, and a power-binned slice of slower silicon.
TPU_SPECS: Tuple[NodeSpec, ...] = (
    NodeSpec("v5e-ref-0", max_cores=256, freq_table=TPU_FREQS,
             device="tpu", cores_per_socket=256),
    NodeSpec("v5e-pod2-1", max_cores=512, freq_table=TPU_FREQS,
             static_power_skew=1.10, speed_skew=0.97,
             device="tpu", cores_per_socket=256),
    NodeSpec("v5e-bin-2", max_cores=256, freq_table=TPU_FREQS[:8],
             dynamic_power_skew=0.94, speed_skew=1.08,
             device="tpu", cores_per_socket=256),
)


def make_mixed_pool(
    n_cpu: int = 2,
    n_tpu: int = 2,
    seed: int = 0,
    cpu_specs: Sequence[NodeSpec] = DEFAULT_SPECS,
    tpu_specs: Sequence[NodeSpec] = TPU_SPECS,
) -> NodePool:
    """A heterogeneous CPU + TPU pool, CPU nodes first (so ``reference``
    stays the paper's Xeon). Seeds stay distinct across the whole pool."""
    specs = [cpu_specs[i % len(cpu_specs)] for i in range(n_cpu)]
    specs += [tpu_specs[i % len(tpu_specs)] for i in range(n_tpu)]
    nodes = []
    seen: Dict[str, int] = {}
    for i, spec in enumerate(specs):
        if spec.name in seen:
            spec = dataclasses.replace(spec, name=f"{spec.name}-{i}")
        seen[spec.name] = i
        nodes.append(FleetNode(spec, seed=seed + 101 * i))
    return NodePool(nodes)
