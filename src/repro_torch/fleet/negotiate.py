"""Fleet-scale pareto negotiation: trade slack ACROSS jobs, not per job.

The plain deadline fallback is per-job greedy: when a job's energy optimum
cannot meet its deadline on any node with capacity, the scheduler walks
that job's own energy/time frontier cheapest-first and buys feasibility
with the fewest extra joules — *for that job, in isolation*. But the
fleet-level optimum lives on the JOINT trade-off: one job's unused
deadline slack can be spent (move it to a slower/cheaper frontier point,
or to fewer cores) to free capacity that lets another job take a faster
point it could not otherwise afford, and the joules saved by the second
job can exceed the joules spent by the first. The ``Negotiator`` searches
that joint space.

The protocol per scheduling round:

1. **Options** — every pending job's deterministic frontier (ONE batched
   ``PlanningEngine.pareto_many`` pass) is projected onto every node with
   individual capacity, giving each job a finite option set
   (frontier point × node) with projected time (s) and energy (J). The
   projection semantics are ``cluster.project_point`` ("plan energy ×
   node skew"); the whole (frontier × pool) grid is evaluated
   in one vectorized NumPy pass (``_project_grid``) that is
   bitwise-identical to the per-pair scalar calls.
2. **Seed** — the cheapest-first greedy (deadline order, frontier
   walked cheapest → fastest, first deadline-feasible node, second pass
   without the deadline) is replayed on the option sets. The seed IS the
   fallback assignment, so the negotiated result can only improve on it.
3. **Negotiate** — deterministic local search over the lexicographic
   objective ``(jobs deferred, deadline misses, total projected joules)``:

   * *single reassignments*: move one job to a cheaper (point, node)
     that fits the remaining capacity;
   * *slack exchanges*: for a deferred or deadline-missing job, pick a
     deadline-feasible target option and free the missing cores on its
     node by relocating other jobs — helpers are chosen greedily by
     marginal joules per core freed, and helper moves may spend a
     feasible job's slack (slower point, other node) but never create a
     new miss or deferral. The exchange's total Δjoules is the price of
     the slack it buys.

   Every accepted move strictly improves the objective (energy-only moves
   must clear ``energy_margin`` — projected-joule churn below the model's
   own noise floor is not worth placement thrash), so the search
   terminates and the invariants hold by construction:

   * node capacity is never exceeded at any step;
   * the negotiated ``(deferred, misses, energy)`` is never lexically
     worse than the cheapest-first seed.

``NegotiationResult`` keeps both the seed and the final assignment so the
round log (and the tests) can audit exactly what negotiation bought.

**The horizon-aware slot mode** (``negotiate(..., profiles=...)``): when
the scheduler plans a lookahead round, per-node capacity is a TIME
profile (``cluster.CapacityProfile``, confirmed reservations over
half-open intervals) and the option space grows a start-slot axis —
options become (frontier point × node × start slot), each slot an
earliest feasible gap on the node's profile. The seed and local search
mirror the scalar protocol: the search never worsens the seed's
(deferred, misses, joules), and a round with no future jobs seeds
exactly the myopic greedy — pure-ready rounds cannot be worse than
myopic. Mixed rounds are deliberately EDF-flavored (a tighter-deadline
future arrival may claim contested capacity before a looser ready job;
the fleet-level lookahead <= myopic ordering is enforced empirically by
the report's ``engine-myopic`` gate and the stranding-trace tests).
Every capacity check is an interval query against the working profiles.
An assigned option with a future ``start_s`` is a *tentative*
placement: the scheduler holds the window on the ledger without
launching.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.fleet.cluster import CapacityProfile, NodePool, time_eps


@dataclasses.dataclass(frozen=True)
class Option:
    """One candidate assignment: a frontier point projected onto a node.

    In the horizon-aware (slot) mode an option also carries ``start_s`` —
    the absolute sim time the job would begin — so the option space is
    (frontier point × node × start slot). The myopic mode leaves
    ``start_s`` at the round time implicitly (every option starts now).
    """

    point_idx: int  # index into the job's frontier (fastest point first)
    node_idx: int
    cores: int
    frequency_ghz: float  # node-snapped, GHz
    time_s: float  # node-projected run time, s
    energy_j: float  # node-projected energy, J
    meets_deadline: bool
    start_s: float = 0.0  # absolute start slot (slot mode), sim seconds

    @property
    def end_s(self) -> float:
        return self.start_s + self.time_s


@dataclasses.dataclass
class NegotiationResult:
    """The negotiated assignment plus the seed it had to beat."""

    assignments: List[Optional[Option]]  # None = deferred to a later round
    seed: List[Optional[Option]]
    n_moves: int  # single reassignments applied
    n_exchanges: int  # multi-job slack exchanges applied

    @staticmethod
    def projected(assignments: Sequence[Optional[Option]]) -> Tuple[int, int, float]:
        """The lexicographic objective of an assignment:
        (jobs deferred, deadline misses, total projected joules)."""
        deferred = sum(a is None for a in assignments)
        misses = sum(a is not None and not a.meets_deadline for a in assignments)
        energy_j = float(sum(a.energy_j for a in assignments if a is not None))
        return deferred, misses, energy_j

    @property
    def improved(self) -> bool:
        return self.projected(self.assignments) < self.projected(self.seed)


class Negotiator:
    """Joint (frontier point × node) assignment over one scheduling round.

    Args:
        pool: the fleet (node specs supply the projection skews).
        power_model: the engine's fitted reference power model (W).
        energy_margin: relative improvement an energy-only move must clear
            (fraction of the moved job's current projected energy);
            deferred/miss improvements are always taken.
        max_moves: hard cap on accepted moves per round (the objective is
            strictly decreasing, so this is a backstop, not a tuning knob).
        max_slots: in the horizon-aware mode, how many start slots each
            (frontier point, node) pair contributes to the option set —
            the earliest feasible slots on the node's capacity profile.
        max_exchange_targets: in the slot mode, how many (cheapest) target
            windows a stressed job tries per exchange scan — every failed
            target costs a full helper search over interval queries, and
            targets past the first few cheapest windows almost never win.
    """

    def __init__(
        self,
        pool: NodePool,
        power_model,
        *,
        energy_margin: float = 0.02,
        max_moves: int = 500,
        max_slots: int = 3,
        max_exchange_targets: int = 4,
    ):
        self.pool = pool
        self.power = power_model
        self.energy_margin = float(energy_margin)
        self.max_moves = int(max_moves)
        self.max_slots = int(max_slots)
        self.max_exchange_targets = int(max_exchange_targets)

    # -- option enumeration -------------------------------------------------

    def _project_grid(self, terms, frontier):
        """Vectorized ``project_point`` over the whole (frontier × pool)
        grid: returns ``(f_snap, t_exp, e_exp)`` as (K, M) float64 arrays.

        The per-pair ``project_point`` calls were the enumeration hotspot
        at fleet scale (K·M function calls, each with a frequency-table
        scan, roofline evaluations and an ``np.ceil`` dispatch). Here the
        scalar-irregular pieces — frequency snap, believed step-time
        ratio, the pow-bearing dynamic-power-per-core term, socket counts
        — are memoized as PYTHON floats computed by the exact expressions
        ``NodeSpec.expected_power`` / ``project_point`` use (libm pow vs
        numpy's repeated-squaring fast path can differ by an ulp, so pow
        never moves into array space), and only the remaining +,*,/
        arithmetic runs as one NumPy pass in the same IEEE evaluation
        order. Result: bitwise-identical options (locked by the parity
        test in ``tests/test_negotiate.py``)."""
        specs = [node.spec for node in self.pool]
        kn, mn = len(frontier), len(specs)
        f_snap = np.empty((kn, mn))
        ratio = np.ones((kn, mn))  # exact 1.0 where no snap: multiplying
        dpc = np.empty((kn, mn))  # by it reproduces the untouched t_ref
        stat = np.empty((kn, mn))
        c1, c2, c3, c4 = self.power.c1, self.power.c2, self.power.c3, self.power.c4
        snap_m: Dict = {}
        ratio_m: Dict = {}
        dpc_m: Dict = {}
        sock_m: Dict = {}
        for k, pt in enumerate(frontier):
            f, c = pt.frequency_ghz, pt.chips
            for m, spec in enumerate(specs):
                # sockets are per spec, not global: a mixed pool counts
                # cores/socket on CPU nodes and chips/pod on TPU slices
                # (identical values — hence identical floats — on a
                # homogeneous pool)
                skey = (spec.cores_per_socket, c)
                s = sock_m.get(skey)
                if s is None:
                    s = sock_m[skey] = spec.sockets(c)
                stat[k, m] = c3 + c4 * s
                key = (spec.freq_table, f)
                fs = snap_m.get(key)
                if fs is None:
                    fs = snap_m[key] = spec.snap_frequency(f)
                f_snap[k, m] = fs
                if fs != f:
                    rkey = (f, fs, c)
                    r = ratio_m.get(rkey)
                    if r is None:
                        r = ratio_m[rkey] = terms.step_time(fs, c) / max(
                            terms.step_time(f, c), 1e-12
                        )
                    ratio[k, m] = r
                d = dpc_m.get(fs)
                if d is None:
                    d = dpc_m[fs] = c1 * fs**3 + c2 * fs
                dpc[k, m] = d
        chips = np.array([float(pt.chips) for pt in frontier])
        t_ref = np.array([pt.step_time_s for pt in frontier])[:, None] * ratio
        dyn = chips[:, None] * dpc
        d_skew = np.array([s.dynamic_power_skew for s in specs])
        s_skew = np.array([s.static_power_skew for s in specs])
        pw = d_skew[None, :] * dyn + s_skew[None, :] * stat
        t_exp = t_ref * np.array([s.speed_skew for s in specs])[None, :]
        return f_snap, t_exp, pw * t_exp

    def _options(
        self, terms, frontier, free: Sequence[int], slack_s: float
    ) -> List[Option]:
        """Every (frontier point, node) pair with individual capacity —
        projections from the one vectorized ``_project_grid`` pass, emitted
        in the same deterministic (point-major, node-minor) order as the
        scalar enumeration."""
        if not frontier:
            return []
        f_snap, t_exp, e_exp = self._project_grid(terms, frontier)
        out: List[Option] = []
        for k, pt in enumerate(frontier):
            for m in range(len(self.pool)):
                if pt.chips > free[m]:
                    continue
                t = float(t_exp[k, m])
                out.append(
                    Option(
                        point_idx=k,
                        node_idx=m,
                        cores=pt.chips,
                        frequency_ghz=float(f_snap[k, m]),
                        time_s=t,
                        energy_j=float(e_exp[k, m]),
                        meets_deadline=slack_s > 0 and t <= slack_s,
                    )
                )
        return out

    # -- the cheapest-first fallback, replayed on the option sets ----------

    def _seed(
        self,
        jobs,
        options: List[List[Option]],
        frontiers,
        free: Sequence[int],
        slacks: Sequence[float],
    ) -> List[Optional[Option]]:
        """Cheapest-first greedy in deadline order — the per-job fallback
        the negotiation must never be worse than. Walks each job's frontier
        cheapest → fastest, takes the cheapest deadline-feasible node, then
        retries without the deadline (better a late cheap job than a
        starved queue); leaves the job deferred when nothing fits."""
        n = len(jobs)
        assign: List[Optional[Option]] = [None] * n
        remaining = list(free)
        order = sorted(range(n), key=lambda i: (jobs[i].deadline_s, jobs[i].job_id))
        for i in order:
            chosen = None
            passes = (True, False) if slacks[i] > 0 else (False,)
            for require_deadline in passes:
                # frontier is fastest-first: reversed = cheapest-first walk
                for k in reversed(range(len(frontiers[i]))):
                    cand = [
                        (o.energy_j, o.node_idx, o)
                        for o in options[i]
                        if o.point_idx == k
                        and o.cores <= remaining[o.node_idx]
                        and (not require_deadline or o.meets_deadline)
                    ]
                    if cand:
                        chosen = min(cand)[2]
                        break
                if chosen is not None:
                    break
            assign[i] = chosen
            if chosen is not None:
                remaining[chosen.node_idx] -= chosen.cores
        return assign

    # -- local search -------------------------------------------------------

    @staticmethod
    def _remaining(
        assignments: Sequence[Optional[Option]], free: Sequence[int]
    ) -> List[int]:
        rem = list(free)
        for a in assignments:
            if a is not None:
                rem[a.node_idx] -= a.cores
        return rem

    def _try_single_moves(
        self, jobs, options, assign, remaining
    ) -> Optional[Tuple[int, Option]]:
        """First single reassignment that improves (deferred, misses,
        energy) — deterministic scan in job-id order, options cheapest
        first."""
        order = sorted(range(len(jobs)), key=lambda i: jobs[i].job_id)
        for i in order:
            cur = assign[i]
            for o in sorted(
                options[i],
                key=lambda o: (o.energy_j, o.node_idx, o.point_idx),
            ):
                if o == cur:
                    continue
                headroom = remaining[o.node_idx] + (
                    cur.cores if cur is not None and cur.node_idx == o.node_idx
                    else 0
                )
                if o.cores > headroom:
                    continue
                if cur is None:
                    return (i, o)  # un-deferring always improves the lexkey
                miss_delta = int(not o.meets_deadline) - int(not cur.meets_deadline)
                if miss_delta < 0:
                    return (i, o)
                if miss_delta > 0:
                    continue
                if o.energy_j < cur.energy_j * (1.0 - self.energy_margin):
                    return (i, o)
        return None

    def _try_exchange(
        self, jobs, options, assign, remaining
    ) -> Optional[List[Tuple[int, Option]]]:
        """One slack exchange: place a deferred/missing job at a
        deadline-feasible option by relocating other jobs off its node.

        Helper moves are ranked by marginal joules per core freed and may
        spend a feasible job's slack, but never create a new miss or
        deferral — the exchange's net effect on the lexicographic objective
        is therefore always an improvement (one fewer deferral or miss)."""
        stressed = [
            i
            for i in range(len(jobs))
            if assign[i] is None or not assign[i].meets_deadline
        ]
        stressed.sort(key=lambda i: (jobs[i].deadline_s, jobs[i].job_id))
        for i in stressed:
            cur = assign[i]
            targets = [o for o in options[i] if o.meets_deadline]
            # fewest extra joules that buy the missing feasibility first
            targets.sort(key=lambda o: (o.energy_j, o.node_idx, o.point_idx))
            for o in targets:
                m = o.node_idx
                own = cur.cores if cur is not None and cur.node_idx == m else 0
                need = o.cores - own - remaining[m]
                if need <= 0:
                    continue  # a plain single move covers this case
                helpers = self._free_cores_on(
                    jobs, options, assign, remaining, m, need, skip=i
                )
                if helpers is not None:
                    return helpers + [(i, o)]
        return None

    def _free_cores_on(
        self, jobs, options, assign, remaining, node_idx, need, *, skip
    ) -> Optional[List[Tuple[int, Option]]]:
        """Greedy helper selection: relocate jobs off ``node_idx`` until
        ``need`` cores are free, cheapest Δjoules per freed core first.
        Returns the move list, or None when the node cannot be drained."""
        rem = list(remaining)
        moved = {}
        freed_total = 0
        while freed_total < need:
            best = None
            for j in range(len(jobs)):
                if (
                    j == skip
                    or j in moved
                    or assign[j] is None
                    or assign[j].node_idx != node_idx
                ):
                    continue
                cur = assign[j]
                for alt in options[j]:
                    freed = cur.cores - (
                        alt.cores if alt.node_idx == node_idx else 0
                    )
                    if freed <= 0:
                        continue
                    headroom = rem[alt.node_idx] + (
                        cur.cores if alt.node_idx == node_idx else 0
                    )
                    if alt.cores > headroom:
                        continue
                    if cur.meets_deadline and not alt.meets_deadline:
                        continue  # helpers never create a new miss
                    cost = alt.energy_j - cur.energy_j
                    score = (
                        cost / freed, jobs[j].job_id,
                        alt.energy_j, alt.node_idx, alt.point_idx,
                    )
                    if best is None or score < best[0]:
                        best = (score, j, freed, alt)
            if best is None:
                return None
            _, j, freed, alt = best
            cur = assign[j]
            rem[cur.node_idx] += cur.cores
            rem[alt.node_idx] -= alt.cores
            moved[j] = alt
            freed_total += freed
        return list(moved.items())

    # -- the horizon-aware (slot) mode --------------------------------------
    #
    # When the scheduler plans a lookahead round, capacity is no longer one
    # scalar per node: future reservations make it a time profile, and the
    # option space grows a start-slot axis. The slotted methods below mirror
    # the scalar seed/search — a round with NO future jobs seeds exactly the
    # myopic greedy, and the search never worsens the seed's lexkey; in a
    # MIXED round the deadline-ordered seed is deliberately EDF-flavored
    # (a tighter-deadline future job may claim contested capacity before a
    # looser ready job) — with all capacity checks going through per-node
    # ``CapacityProfile``s (half-open intervals) instead of core counters.

    @staticmethod
    def _occupy(profiles: List[CapacityProfile], o: Option) -> None:
        profiles[o.node_idx].add(o.start_s, o.end_s, o.cores)

    @staticmethod
    def _vacate(profiles: List[CapacityProfile], o: Option) -> None:
        profiles[o.node_idx].remove(o.start_s, o.end_s, o.cores)

    @staticmethod
    def _fits(profiles: List[CapacityProfile], o: Option) -> bool:
        return profiles[o.node_idx].has_capacity(o.start_s, o.end_s, o.cores)

    def _fits_without(
        self,
        profiles: List[CapacityProfile],
        o: Option,
        vacated: Optional[Option],
    ) -> bool:
        """Does ``o`` fit once ``vacated`` (the assignment being moved
        away) is off the books? Only touches the profile when the two
        share a node — a vacate/occupy pair invalidates the profile's
        probe memo, and the scans below ask mostly cross-node questions."""
        if vacated is not None and vacated.node_idx == o.node_idx:
            self._vacate(profiles, vacated)
            ok = self._fits(profiles, o)
            self._occupy(profiles, vacated)
            return ok
        return self._fits(profiles, o)

    def _slotted_options(
        self,
        terms,
        frontier,
        profiles: Sequence[CapacityProfile],
        start_min: float,
        slack_s: float,
        now: float,
    ) -> List[Option]:
        """(frontier point × node × start slot): each pair contributes its
        ``max_slots`` earliest feasible slots on the node's BASE profile
        (confirmed reservations only — working feasibility is re-checked
        against the round's evolving assignment during seed/search).

        Known single-round limitation: slots created by the round's OWN
        holds are not enumerated, so two future jobs competing for the
        same idle window cannot stack within one round — the loser defers
        and stacks on the NEXT round, when the winner's hold has become a
        confirmed reservation whose end is a gap candidate. Dynamic
        re-enumeration against the working profiles is the ROADMAP's
        multi-horizon candidate."""
        if not frontier:
            return []
        f_snap_g, t_exp_g, e_exp_g = self._project_grid(terms, frontier)
        out: List[Option] = []
        for k, pt in enumerate(frontier):
            for m, prof in enumerate(profiles):
                if pt.chips > prof.max_cores:
                    continue
                f_snap = float(f_snap_g[k, m])
                t_exp = float(t_exp_g[k, m])
                e_exp = float(e_exp_g[k, m])
                n_slots = 0
                for t in prof.gap_candidates(start_min):
                    # has_capacity, not free_over: memoized on the (never
                    # mutated) base profile and shared across jobs whose
                    # frontier points ask about the same window
                    if not prof.has_capacity(t, t + t_exp, pt.chips):
                        continue
                    out.append(
                        Option(
                            point_idx=k,
                            node_idx=m,
                            cores=pt.chips,
                            frequency_ghz=f_snap,
                            time_s=t_exp,
                            energy_j=e_exp,
                            meets_deadline=(
                                slack_s > 0 and (t - now) + t_exp <= slack_s
                            ),
                            start_s=float(t),
                        )
                    )
                    n_slots += 1
                    if n_slots >= self.max_slots:
                        break
        return out

    def _seed_slotted(
        self,
        jobs,
        options: List[List[Option]],
        frontiers,
        profiles: Sequence[CapacityProfile],
        slacks: Sequence[float],
        arrivals: Sequence[float],
        now: float,
    ) -> List[Optional[Option]]:
        """Deadline-order greedy over the slotted options.

        Ready jobs walk three passes: (1) launch-now options meeting the
        deadline — the myopic cheapest-first walk (verbatim myopic when
        the round has no future jobs; in a mixed round an
        earlier-deadline future job's hold may already occupy contested
        capacity — EDF semantics, deliberate); (2) a later start slot
        that still meets the deadline (a tentative hold beats locking in
        a miss); (3) launch now and eat the miss. Future jobs get pass
        (2) only — a job that cannot be made feasible yet simply stays
        deferred and is re-planned when it arrives.
        """
        n = len(jobs)
        assign: List[Optional[Option]] = [None] * n
        work = [p.copy() for p in profiles]
        eps = time_eps(now)
        # options arrive pre-sorted by (energy, start, node, point): within
        # one frontier point the first option passing the filters IS the
        # minimum the scalar seed's min() would pick — group once, then
        # every per-point walk is an early-exit scan
        by_point: List[Dict[int, List[Option]]] = []
        for opts in options:
            groups: Dict[int, List[Option]] = {}
            for o in opts:
                groups.setdefault(o.point_idx, []).append(o)
            by_point.append(groups)
        order = sorted(range(n), key=lambda i: (jobs[i].deadline_s, jobs[i].job_id))
        for i in order:
            ready = arrivals[i] <= now + eps
            if ready:
                passes = (
                    [("now", True), ("any", True), ("now", False)]
                    if slacks[i] > 0
                    else [("now", False)]
                )
            else:
                passes = [("any", True)] if slacks[i] > 0 else []
            chosen = None
            for mode, require_deadline in passes:
                # frontier is fastest-first: reversed = cheapest-first walk
                for k in reversed(range(len(frontiers[i]))):
                    for o in by_point[i].get(k, ()):
                        if require_deadline and not o.meets_deadline:
                            continue
                        if mode == "now" and o.start_s > now + eps:
                            continue
                        if self._fits(work, o):
                            chosen = o
                            break
                    if chosen is not None:
                        break
                if chosen is not None:
                    break
            assign[i] = chosen
            if chosen is not None:
                self._occupy(work, chosen)
        return assign

    def _try_single_moves_slotted(
        self, jobs, options, assign, work: List[CapacityProfile]
    ) -> Optional[Tuple[int, Option]]:
        """Slot-mode single reassignment: same improvement rules as the
        scalar scan, feasibility checked on the working profiles with the
        job's own hold vacated first. ``options`` lists arrive pre-sorted
        cheapest-first, and the (cheap) improvement test runs BEFORE the
        (interval-query) capacity probe — the scan is the round's hot
        loop."""
        order = sorted(range(len(jobs)), key=lambda i: jobs[i].job_id)
        for i in order:
            cur = assign[i]
            for o in options[i]:
                if o == cur:
                    continue
                if cur is not None:
                    miss_delta = (
                        int(not o.meets_deadline) - int(not cur.meets_deadline)
                    )
                    if miss_delta > 0:
                        continue
                    if miss_delta == 0 and not (
                        o.energy_j < cur.energy_j * (1.0 - self.energy_margin)
                    ):
                        continue
                if self._fits_without(work, o, cur):
                    return (i, o)
        return None

    def _try_exchange_slotted(
        self, jobs, options, assign, work: List[CapacityProfile]
    ) -> Optional[List[Tuple[int, Option]]]:
        """Slot-mode slack exchange: free the target window's missing cores
        by relocating jobs whose holds overlap it (possibly to other slots
        or nodes), helpers ranked by Δjoules per core of relief."""
        stressed = [
            i
            for i in range(len(jobs))
            if assign[i] is None or not assign[i].meets_deadline
        ]
        stressed.sort(key=lambda i: (jobs[i].deadline_s, jobs[i].job_id))
        for i in stressed:
            cur = assign[i]
            # options are pre-sorted cheapest-first; each failed target
            # costs a full helper search, so the scan is capped at the
            # cheapest few deadline-meeting windows
            targets = [o for o in options[i] if o.meets_deadline][
                : self.max_exchange_targets
            ]
            for o in targets:
                # cheap pre-check on the working profiles (vacate/restore,
                # no copies): targets a plain single move covers are
                # skipped before paying for a probe copy
                if self._fits_without(work, o, cur):
                    continue  # a plain single move covers this case
                if cur is not None and cur.node_idx == o.node_idx:
                    self._vacate(work, cur)
                    free_window = work[o.node_idx].free_over(o.start_s, o.end_s)
                    self._occupy(work, cur)
                else:
                    free_window = work[o.node_idx].free_over(o.start_s, o.end_s)
                # drainability bound: if relocating EVERY movable hold
                # overlapping the window still cannot free enough cores,
                # the full helper search is guaranteed to fail — skip it
                drainable = sum(
                    a.cores
                    for j, a in enumerate(assign)
                    if j != i
                    and a is not None
                    and a.node_idx == o.node_idx
                    and a.start_s < o.end_s
                    and a.end_s > o.start_s
                )
                if free_window + drainable < o.cores:
                    continue
                probe = [p.copy() for p in work]
                if cur is not None:
                    self._vacate(probe, cur)
                helpers = self._free_window_slotted(
                    jobs, options, assign, probe, o, skip=i
                )
                if helpers is not None:
                    return helpers + [(i, o)]
        return None

    def _free_window_slotted(
        self, jobs, options, assign, probe: List[CapacityProfile], target: Option, *, skip
    ) -> Optional[List[Tuple[int, Option]]]:
        """Relocate jobs off the target window until it fits, cheapest
        Δjoules per relieved core first. ``probe`` already has the stressed
        job's own hold vacated; it is mutated as helpers move. Returns the
        move list, or None when the window cannot be drained.

        Candidates are collected with CHEAP tests only (relief, miss
        rule), sorted by score, and capacity-probed in that order — the
        first feasible candidate IS the min-score feasible one, so the
        expensive interval queries stop as soon as a helper is found."""
        moved: Dict[int, Option] = {}
        while not self._fits(probe, target):
            cands = []
            for j in range(len(jobs)):
                cur = assign[j]
                if (
                    j == skip
                    or j in moved
                    or cur is None
                    or cur.node_idx != target.node_idx
                    or cur.start_s >= target.end_s
                    or cur.end_s <= target.start_s
                ):
                    continue  # only holds overlapping the target window help
                for alt in options[j]:
                    overlaps_alt = (
                        alt.node_idx == target.node_idx
                        and alt.start_s < target.end_s
                        and alt.end_s > target.start_s
                    )
                    relief = cur.cores - (alt.cores if overlaps_alt else 0)
                    if relief <= 0:
                        continue
                    if cur.meets_deadline and not alt.meets_deadline:
                        continue  # helpers never create a new miss
                    cost = alt.energy_j - cur.energy_j
                    score = (
                        cost / relief, jobs[j].job_id,
                        alt.energy_j, alt.start_s, alt.node_idx, alt.point_idx,
                    )
                    cands.append((score, j, alt))
            cands.sort(key=lambda c: c[0])
            chosen = None
            for _, j, alt in cands:
                cur = assign[j]
                if self._fits_without(probe, alt, cur):
                    self._vacate(probe, cur)
                    self._occupy(probe, alt)
                    chosen = (j, alt)
                    break
            if chosen is None:
                return None
            moved[chosen[0]] = chosen[1]
        return list(moved.items())

    def _negotiate_slotted(
        self,
        jobs,
        terms_list,
        frontiers,
        profiles: Sequence[CapacityProfile],
        slacks,
        arrivals,
        now: float,
        search: bool,
    ) -> NegotiationResult:
        options = [
            self._slotted_options(t, fr, profiles, max(now, arr), s, now)
            for t, fr, arr, s in zip(terms_list, frontiers, arrivals, slacks)
        ]
        # one deterministic cheapest-first order, shared by every scan
        # (the seed takes explicit minima, so sorting is order-safe)
        for opts in options:
            opts.sort(
                key=lambda o: (o.energy_j, o.start_s, o.node_idx, o.point_idx)
            )
        seed = self._seed_slotted(
            jobs, options, frontiers, profiles, slacks, arrivals, now
        )
        assign = list(seed)
        work = [p.copy() for p in profiles]
        for a in assign:
            if a is not None:
                self._occupy(work, a)
        n_moves = n_exchanges = n_iters = 0
        while search and n_moves + n_exchanges < self.max_moves:
            n_iters += 1
            single = self._try_single_moves_slotted(jobs, options, assign, work)
            if single is not None:
                i, o = single
                if assign[i] is not None:
                    self._vacate(work, assign[i])
                self._occupy(work, o)
                assign[i] = o
                n_moves += 1
                continue
            exchange = self._try_exchange_slotted(jobs, options, assign, work)
            if exchange is not None:
                before = NegotiationResult.projected(assign)
                rollback = {i: assign[i] for i, _ in exchange}
                for i, o in exchange:
                    if assign[i] is not None:
                        self._vacate(work, assign[i])
                    self._occupy(work, o)
                    assign[i] = o
                after = NegotiationResult.projected(assign)
                if after >= before or not all(p.valid() for p in work):
                    # defensive: a helper chain that failed to improve (or
                    # oversubscribed a window) is undone; the scan is done
                    for i, prev in rollback.items():
                        self._vacate(work, assign[i])
                        if prev is not None:
                            self._occupy(work, prev)
                        assign[i] = prev
                    break
                n_exchanges += 1
                continue
            break
        # a hard raise, not an assert: the never-oversubscribe invariant
        # must survive `python -O` (the scheduler reserves real windows
        # from this assignment)
        if not all(p.valid() for p in work):
            raise RuntimeError(
                "slot negotiation oversubscribed a capacity window"
            )
        obs.counter("fleet.negotiate.search_iterations").inc(n_iters)
        obs.counter("fleet.negotiate.moves_accepted").inc(n_moves)
        obs.counter("fleet.negotiate.exchanges_accepted").inc(n_exchanges)
        return NegotiationResult(
            assignments=assign, seed=seed, n_moves=n_moves, n_exchanges=n_exchanges
        )

    # -- entry point --------------------------------------------------------

    def negotiate(
        self,
        jobs,
        terms_list: Sequence,
        frontiers: Sequence[Sequence],
        free_cores: Sequence[int],
        slacks: Sequence[float],
        *,
        now: float = 0.0,
        arrivals: Optional[Sequence[float]] = None,
        profiles: Optional[Sequence[CapacityProfile]] = None,
        search: bool = True,
    ) -> NegotiationResult:
        """Negotiate one round's joint assignment.

        Args:
            jobs: the round's jobs (deadline_s in sim seconds) — pending
                now and, in the horizon-aware mode, known future arrivals.
            terms_list: per-job believed surfaces (for frequency snapping).
            frontiers: per-job deterministic frontiers from ``pareto_many``.
            free_cores: per-node free cores at the round's sim time
                (ignored when ``profiles`` is given).
            slacks: per-job remaining deadline slack in seconds from
                ``now`` (a future job's own start delay is re-derived from
                its arrival).
            now: the round's sim time (slot mode), seconds.
            arrivals: per-job arrival times (slot mode), absolute seconds.
            profiles: per-node ``CapacityProfile``s of CONFIRMED
                reservations. When given, the negotiation runs in the
                horizon-aware slot mode: options are (frontier point ×
                node × start slot) and all capacity checks are interval
                queries on the profiles.
            search: False replays only the greedy seed (the scheduler's
                non-negotiated lookahead path); True runs the local search.

        Returns:
            ``NegotiationResult`` aligned with ``jobs``; ``None`` entries
            stay pending and are re-planned in a later round. In slot mode
            an assigned option with ``start_s > now`` is a *tentative*
            placement — the scheduler reserves the window without
            launching.
        """
        if profiles is not None:
            arrivals = (
                [getattr(j, "arrival_s", 0.0) for j in jobs]
                if arrivals is None
                else list(arrivals)
            )
            return self._negotiate_slotted(
                jobs, terms_list, frontiers, profiles, slacks, arrivals,
                now, search,
            )
        options = [
            self._options(t, fr, free_cores, s)
            for t, fr, s in zip(terms_list, frontiers, slacks)
        ]
        seed = self._seed(jobs, options, frontiers, free_cores, slacks)
        assign = list(seed)
        remaining = self._remaining(assign, free_cores)
        n_moves = n_exchanges = n_iters = 0
        while search and n_moves + n_exchanges < self.max_moves:
            n_iters += 1
            single = self._try_single_moves(jobs, options, assign, remaining)
            if single is not None:
                i, o = single
                assign[i] = o
                n_moves += 1
                remaining = self._remaining(assign, free_cores)
                continue
            exchange = self._try_exchange(jobs, options, assign, remaining)
            if exchange is not None:
                before = NegotiationResult.projected(assign)
                rollback = {i: assign[i] for i, _ in exchange}
                for i, o in exchange:
                    assign[i] = o
                remaining = self._remaining(assign, free_cores)
                after = NegotiationResult.projected(assign)
                if after >= before or min(remaining) < 0:
                    # defensive: a helper chain that failed to improve (or
                    # oversubscribed) is undone; the scan is then done
                    for i, prev in rollback.items():
                        assign[i] = prev
                    remaining = self._remaining(assign, free_cores)
                    break
                n_exchanges += 1
                continue
            break
        # same hard invariant as the slotted path: must survive python -O
        if min(self._remaining(assign, free_cores), default=0) < 0:
            raise RuntimeError("negotiation oversubscribed a node's cores")
        obs.counter("fleet.negotiate.search_iterations").inc(n_iters)
        obs.counter("fleet.negotiate.moves_accepted").inc(n_moves)
        obs.counter("fleet.negotiate.exchanges_accepted").inc(n_exchanges)
        return NegotiationResult(
            assignments=assign, seed=seed, n_moves=n_moves, n_exchanges=n_exchanges
        )
