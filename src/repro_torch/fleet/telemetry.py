"""Fleet telemetry: measured runs stream back, drift gets caught.

The closed loop's sensing half. Every completed job yields an
``Observation`` — the plan's node-projected predictions next to the
measured ``RunResult``. A per-family sliding window of relative time-model
errors feeds the ``DriftDetector``: when the windowed mean error of a
family crosses the threshold, the family is *stale* and the scheduler's
next round refreshes it (one ``svr.fit_many`` batch over ALL stale
families — see ``scheduler.FleetScheduler._refresh_stale``). After a
refresh the family's window is cleared so one drift event triggers one
re-characterization, not one per subsequent round.

Relative (not absolute) error is the right signal here: the node model's
multiplicative skews and measurement noise are both proportional effects,
so a family that drifted 1.5× slower shows a ~0.5 windowed relative error
regardless of whether the job ran 30 s or 3000 s.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Tuple

Family = Tuple[str, float]  # (app, input_size): one characterization family


@dataclasses.dataclass(frozen=True)
class Observation:
    """One completed job: plan-projected prediction vs measurement."""

    family: Family
    node: str
    frequency_ghz: float
    cores: int
    input_size: float
    predicted_time_s: float
    measured_time_s: float
    predicted_energy_j: float
    measured_energy_j: float
    finish_s: float

    @property
    def rel_time_error(self) -> float:
        return abs(self.measured_time_s - self.predicted_time_s) / max(
            self.predicted_time_s, 1e-12
        )


@dataclasses.dataclass(frozen=True)
class TentativeRecord:
    """One lookahead capacity hold, as placed (times in sim seconds).

    The horizon-aware round reserves ``[start_s, end_s)`` on ``node`` for
    a job that has not launched yet (a known future arrival, or a ready
    job granted a later start slot). Logged so reports can audit how much
    of the round's placement was shaped by the horizon rather than by the
    jobs physically present.
    """

    time_s: float  # the round's sim time
    family: Family
    job_id: int
    node: str
    start_s: float  # the held window, half-open [start_s, end_s)
    end_s: float
    cores: int


@dataclasses.dataclass(frozen=True)
class PreemptionRecord:
    """One preemptive migration, as accounted (all energies in joules).

    The rebalancing pass must not be able to hide its costs: the joules
    burned on the abandoned segment, the charged migration cost and the
    believed saving that justified the move are all logged, so reports can
    show migration as a net-win *including* what it threw away.
    """

    time_s: float
    family: Family
    job_id: int
    from_node: str
    to_node: str
    burned_j: float  # measured joules spent on the abandoned segment
    migration_cost_j: float  # checkpoint/transfer/restart charge
    projected_saving_j: float  # believed net saving that cleared the bar
    # abandoned-segment geometry (defaults keep old call sites valid):
    # where the segment started and how wide it was, so the flight
    # recorder's timeline can draw the thrown-away work, not just count it
    start_s: float = 0.0
    cores: int = 0


class DriftDetector:
    """Sliding-window relative-error watchdog, one window per family."""

    def __init__(
        self, window: int = 4, threshold: float = 0.15, min_samples: int = 2
    ):
        if window < 1:
            raise ValueError("window must be >= 1")
        self.window = window
        self.threshold = threshold
        self.min_samples = min(min_samples, window)
        self._errors: Dict[Family, Deque[float]] = {}

    def record(self, family: Family, rel_error: float) -> None:
        self._errors.setdefault(
            family, collections.deque(maxlen=self.window)
        ).append(float(rel_error))

    def mean_error(self, family: Family) -> float:
        errs = self._errors.get(family)
        return sum(errs) / len(errs) if errs else 0.0

    def stale(self) -> List[Family]:
        """Families whose windowed mean error crossed the threshold, in a
        deterministic (sorted) order — the refit batch is reproducible."""
        return sorted(
            fam
            for fam, errs in self._errors.items()
            if len(errs) >= self.min_samples
            and sum(errs) / len(errs) > self.threshold
        )

    def occupancy(self, family: Family) -> float:
        """Window fill fraction in [0, 1]: how much evidence the watchdog
        actually holds for this family. The drift threshold can only trip
        once ``min_samples`` arrive — a family at low occupancy is not
        "healthy", it is *unwatched*, which is what the flight recorder's
        staleness gauges make visible."""
        errs = self._errors.get(family)
        return len(errs) / self.window if errs else 0.0

    def reset(self, family: Family) -> None:
        self._errors.pop(family, None)


class TelemetryHub:
    """The fleet's observation log + drift watchdog, one per scheduler."""

    def __init__(
        self, window: int = 4, threshold: float = 0.15, min_samples: int = 2
    ):
        self.observations: List[Observation] = []
        self.detector = DriftDetector(
            window=window, threshold=threshold, min_samples=min_samples
        )
        self.refreshes: List[Tuple[float, Family]] = []  # (sim time, family)
        self.preemptions: List[PreemptionRecord] = []
        self.tentatives: List[TentativeRecord] = []
        # last observation sim-time per family: the drift detector can
        # only see families that keep reporting — this is the side channel
        # that catches the ones that went quiet (see ``silent_families``)
        self._last_obs_s: Dict[Family, float] = {}

    def record(self, obs: Observation) -> None:
        self.observations.append(obs)
        self.detector.record(obs.family, obs.rel_time_error)
        prev = self._last_obs_s.get(obs.family, float("-inf"))
        if obs.finish_s > prev:
            self._last_obs_s[obs.family] = obs.finish_s

    def record_preemption(self, rec: PreemptionRecord) -> None:
        """Log one preemptive migration (the scheduler's rebalancing pass)."""
        self.preemptions.append(rec)

    def record_tentative(self, rec: TentativeRecord) -> None:
        """Log one lookahead capacity hold (the horizon-aware round)."""
        self.tentatives.append(rec)

    def stale_families(self) -> List[Family]:
        return self.detector.stale()

    def mark_refreshed(self, family: Family, now: float) -> None:
        self.detector.reset(family)
        self.refreshes.append((now, family))

    def last_refresh_s(self, family: Family) -> float:
        """Sim time of the family's most recent refresh (-inf if never)."""
        times = [t for t, fam in self.refreshes if fam == family]
        return max(times) if times else float("-inf")

    # -- staleness visibility (the silent-family gap) --------------------
    #
    # Drift detection is *reactive*: a family that keeps completing jobs
    # with bad predictions trips the threshold, but a family that simply
    # STOPS reporting (starved, stuck behind holds, node loss) never
    # feeds the detector and quietly never refits. These views surface
    # that second failure mode as data instead of silence.

    def families(self) -> List[Family]:
        """Every family ever observed, deterministically sorted."""
        return sorted(self._last_obs_s)

    def last_observation_s(self, family: Family) -> float:
        """Sim time of the family's newest observation (-inf if never)."""
        return self._last_obs_s.get(family, float("-inf"))

    def observation_age_s(self, family: Family, now: float) -> float:
        """Seconds of sim time since the family last reported (inf if it
        never has)."""
        return now - self._last_obs_s.get(family, float("-inf"))

    def silent_families(self, now: float, max_age_s: float) -> List[Family]:
        """Observed families whose newest observation is older than
        ``max_age_s`` — the ones the drift watchdog cannot see anymore."""
        return sorted(
            fam
            for fam, last_s in self._last_obs_s.items()
            if now - last_s > max_age_s
        )

    def export_staleness_gauges(self, registry, now: float) -> None:
        """Publish per-family window occupancy and observation age into a
        metrics registry (``repro_torch.obs``-compatible: any object exposing
        ``gauge(name).set(value)``)."""
        for fam in self.families():
            app, size = fam
            suffix = f"{app}:{size:g}"
            registry.gauge(
                f"telemetry.window_occupancy.{suffix}"
            ).set(self.detector.occupancy(fam))
            registry.gauge(
                f"telemetry.observation_age_s.{suffix}"
            ).set(self.observation_age_s(fam, now))

    def family_observations(
        self, family: Family, *, since_s: float = float("-inf")
    ) -> List[Observation]:
        return [
            o
            for o in self.observations
            if o.family == family and o.finish_s > since_s
        ]

    @property
    def n_recharacterizations(self) -> int:
        return len(self.refreshes)

    @property
    def n_preemptions(self) -> int:
        return len(self.preemptions)

    @property
    def n_tentative_reservations(self) -> int:
        return len(self.tentatives)

    @property
    def migration_energy_j(self) -> float:
        """Total joules charged to migrations: abandoned partial segments
        plus the per-move checkpoint/transfer/restart cost."""
        return float(
            sum(p.burned_j + p.migration_cost_j for p in self.preemptions)
        )

    # -- durable state (the fleet service's journal) ----------------------
    #
    # The service-layer journal snapshots the WHOLE hub — including the
    # drift detector's sliding windows. A recovered service that rebuilt
    # its windows empty would silently forget drift it had already half
    # detected (the first post-restart rounds would plan on a surface the
    # evidence had already condemned), so the windows are first-class
    # durable state, not a cache.

    def to_json(self) -> dict:
        """The hub's full state as a JSON-serializable dict (families are
        encoded as ``[app, input_size]`` pairs)."""
        det = self.detector
        return {
            "window": det.window,
            "threshold": det.threshold,
            "min_samples": det.min_samples,
            "observations": [dataclasses.asdict(o) for o in self.observations],
            "errors": [
                [list(fam), list(errs)]
                for fam, errs in sorted(det._errors.items())
            ],
            "refreshes": [[t, list(fam)] for t, fam in self.refreshes],
            "preemptions": [dataclasses.asdict(p) for p in self.preemptions],
            "tentatives": [dataclasses.asdict(t) for t in self.tentatives],
            "last_obs_s": [
                [list(fam), t] for fam, t in sorted(self._last_obs_s.items())
            ],
        }

    @classmethod
    def from_json(cls, payload: dict) -> "TelemetryHub":
        """Rebuild a hub bit-for-bit from ``to_json`` output.

        State is restored by direct assignment, NOT by replaying
        ``record``: a replay would re-derive the detector windows from the
        full observation log, but the real windows are bounded deques that
        ``mark_refreshed`` resets — only the journaled deques themselves
        reproduce the detector's exact post-refresh state.
        """

        def _fam(pair) -> Family:
            return (str(pair[0]), float(pair[1]))

        hub = cls(
            window=int(payload["window"]),
            threshold=float(payload["threshold"]),
            min_samples=int(payload["min_samples"]),
        )
        hub.observations = [
            Observation(**{**o, "family": _fam(o["family"])})
            for o in payload["observations"]
        ]
        for fam, errs in payload["errors"]:
            hub.detector._errors[_fam(fam)] = collections.deque(
                (float(e) for e in errs), maxlen=hub.detector.window
            )
        hub.refreshes = [(float(t), _fam(fam)) for t, fam in payload["refreshes"]]
        hub.preemptions = [
            PreemptionRecord(**{**p, "family": _fam(p["family"])})
            for p in payload["preemptions"]
        ]
        hub.tentatives = [
            TentativeRecord(**{**t, "family": _fam(t["family"])})
            for t in payload["tentatives"]
        ]
        hub._last_obs_s = {
            _fam(fam): float(t) for fam, t in payload["last_obs_s"]
        }
        return hub
