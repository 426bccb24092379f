"""Cluster-scale energy-optimal scheduling (beyond-paper fleet subsystem).

The paper plans one energy-optimal (f, p) configuration for one node; this
package serves a *fleet* of such nodes from one batched planning path. The
scheduling round is:

    plan_many → place → run → telemetry → re-fit

1. **plan_many** — every pending (app, input, deadline) job becomes one
   engine ``Workload`` (the family's hashable ``AppTerms`` as its SVR cache
   key, ``Constraints(max_cores=free cores, max_time_s=deadline slack)``)
   and the whole queue is planned in ONE batched engine call —
   ``plan_many`` on the fallback path, ``pareto_many`` when negotiating
   (the frontier's cheapest feasible point is the energy argmin).
2. **place** — energy-aware bin-pack: the reference-node plan is projected
   onto each node via admin-known spec skews (plan energy × node skew) and
   the cheapest feasible node wins; when the energy optimum cannot make the
   deadline anywhere, the scheduler walks the job's ``pareto()`` frontier
   cheapest-first and buys feasibility with the fewest extra joules. With a
   ``negotiate.Negotiator`` configured, placement is instead the
   *fleet-wide pareto negotiation*: every pending job's frontier comes from
   ONE batched ``PlanningEngine.pareto_many`` pass and the round's joint
   (frontier point × node) assignment is searched directly — one job's
   slack traded for another's joules — never worse than the cheapest-first
   seed on (deferred, misses, energy).
3. **run** — the placed jobs execute on the simulated heterogeneous nodes
   (``cluster.FleetNode``: skewed power truth, speed skew, injected drift).
4. **telemetry** — measured ``RunResult``s stream into the
   ``TelemetryHub``; a sliding-window relative-error drift detector marks
   stale workload families.
5. **re-fit** — ALL stale families are re-characterized from telemetry
   (the believed surface rescaled by the measured drift ratio, anchored by
   the windowed real observations — no extra measurement runs) in ONE
   ``svr.fit_many`` batch and installed back into the engine cache
   (``PlanningEngine.install_fit``) — the ROADMAP's "online
   re-characterization". With a ``MigrationPolicy`` configured, a refresh
   that materially moves a family's surface triggers *preemptive
   rebalancing*: the family's in-flight jobs are re-planned in one
   ``pareto_many`` batch and preempted + relaunched wherever the believed
   remaining-energy saving clears the migration cost — with the abandoned
   joules and the migration charge honestly kept on the job's bill.

With a ``scheduler.LookaheadPolicy`` configured, every planning round is
*horizon-aware*: known future arrivals inside the horizon join the same
batched ``pareto_many`` pass (their slack measured from their arrival via
``Workload.earliest_start_s``), the joint assignment runs over (frontier
point × node × start slot) options, and future placements are held as
*tentative* reservations on the time-indexed capacity ledger — confirmed
when the job launches, released and re-planned otherwise.

``python -m repro_torch.fleet [--quick]`` runs the full comparison: the
engine-scheduled fleet (negotiation + migration on by default) vs the
cheapest-first ``engine-fallback`` vs the same fleet under each
stock governor with naive FIFO placement (joules + makespan + per-node
utilization), with a mid-simulation drift event exercising the
re-characterization loop. ``--artifacts DIR`` feeds dry-run JSON records
through ``characterize.workloads_from_artifacts`` into the same loop.
"""

from repro_torch.fleet.cluster import (  # noqa: F401
    AppTerms,
    CapacityProfile,
    FleetNode,
    NodePool,
    NodeSpec,
    TermsFamily,
    family_key,
    make_pool,
    project_point,
    time_eps,
)
from repro_torch.fleet.negotiate import (  # noqa: F401
    NegotiationResult,
    Negotiator,
)
from repro_torch.fleet.report import (  # noqa: F401
    FleetReport,
    ScenarioStats,
    run_engine_fleet,
    run_fleet_comparison,
)
from repro_torch.fleet.scheduler import (  # noqa: F401
    CompletedJob,
    FleetScheduler,
    Job,
    LookaheadPolicy,
    MigrationPolicy,
    Placement,
    fleet_engine,
)
from repro_torch.fleet.telemetry import (  # noqa: F401
    DriftDetector,
    Observation,
    PreemptionRecord,
    TelemetryHub,
    TentativeRecord,
)
