"""Durable state: snapshot encoding, the atomic journal, recovery.

The service's crash-safety contract is *replay to a bitwise-identical
schedule*: a killed service restarted from its journal must complete the
exact schedule the uninterrupted run would have produced — same joules,
same misses, same per-job (node, f, cores). That forces the snapshot to
capture, exactly:

* the **job queues** (``JobStore``): pending jobs and in-flight segments
  in their *list order* (the scheduler iterates them; order is
  semantics), the completed ledger, round logs, and the carried priors of
  crash-killed segments;
* the **ledger** (``LedgerStore``): per-node reservations (confirmed and
  tentative holds alike), availability, drift truth, and — crucially —
  each node's RNG bit-generator state, because run-time noise and power
  samples draw from it in sequence;
* the **believed surfaces**: the engine's base-family fits are *derived*
  state (``fit_many`` restarts its RNG per training set, so a fresh
  engine re-fits them bit-for-bit on demand) and are NOT journaled; the
  telemetry-installed refits are not derivable, so their training sets
  ``(X, y)`` + rescaled ``AppTerms`` are journaled and re-fitted in ONE
  ``svr.fit_many`` batch at recovery, on the scheduler's engine device
  (``fit`` is the B=1 wrapper with bitwise parity, so batch composition
  cannot perturb the models);
* the **telemetry hub** including the drift detector's sliding windows
  (``TelemetryHub.to_json`` — a recovered service must not forget drift
  it already half-detected).

The wire format is the JAX package's, key for key: a journal written by
either package loads in the other.

The journal itself (``Journal``) is one JSON document per commit,
written to a temp file and atomically ``os.replace``d: a crash leaves
either the previous commit or the new one, never a torn file. The
fault-injection hooks (``fail_next_commit``, ``tear_at_s``) simulate the
kill *between snapshot and commit* — the temp file is written, the
rename never happens, and recovery proceeds from the previous commit.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import svr as svr_mod
from repro_torch.core.engine import ENGINE_FIT_KW, RooflineTerms
from repro_torch.core.node_sim import RunResult
from repro_torch.device import to_host
from repro_torch.fleet.cluster import Reservation, TermsFamily, family_key
from repro_torch.fleet.scheduler import CompletedJob, Job, Placement, RoundLog
from repro_torch.fleet.service.events import SERVICE_SCHEMA_VERSION
from repro_torch.fleet.telemetry import TelemetryHub


# -- wire helpers -----------------------------------------------------------


def _array_to_json(arr) -> dict:
    a = to_host(arr)
    return {"dtype": str(a.dtype), "data": a.tolist()}


def _array_from_json(payload: dict) -> np.ndarray:
    return np.asarray(payload["data"], dtype=payload["dtype"])


def _family_terms_to_json(t: TermsFamily) -> dict:
    return {
        "app": t.app,
        "input_size": t.input_size,
        "time_scale": t.time_scale,
        "source": t.source,
        "base": {
            "compute_s": t.base.compute_s,
            "memory_s": t.base.memory_s,
            "collective_s": t.base.collective_s,
            "source": t.base.source,
        },
    }


def _family_terms_from_json(p: dict) -> TermsFamily:
    return TermsFamily(
        base=RooflineTerms(
            compute_s=float(p["base"]["compute_s"]),
            memory_s=float(p["base"]["memory_s"]),
            collective_s=float(p["base"]["collective_s"]),
            source=str(p["base"]["source"]),
        ),
        app=str(p["app"]),
        input_size=float(p["input_size"]),
        time_scale=float(p["time_scale"]),
        source=str(p["source"]),
    )


def _terms_to_json(job: Job) -> dict:
    t = job.terms
    if not (
        isinstance(t, TermsFamily) and isinstance(t.base, RooflineTerms)
    ):
        # arbitrary believed-surface objects have no fixed wire schema; a
        # lossy restore would silently break bitwise replay
        raise ValueError(
            f"job {job.job_id}: only TermsFamily(base=RooflineTerms) "
            "artifact jobs are journalable — run other terms on the "
            "lockstep driver or without a journal"
        )
    return _family_terms_to_json(t)


def _job_to_json(job: Job) -> dict:
    d = {
        "job_id": job.job_id,
        "app": job.app,
        "input_size": job.input_size,
        "deadline_s": job.deadline_s,
        "arrival_s": job.arrival_s,
    }
    # heterogeneous-pool fields ride only when non-default, keeping the
    # CPU-only wire format (and its golden journals) byte-stable
    if job.device != "cpu":
        d["device"] = job.device
    if job.terms is not None:
        d["terms"] = _terms_to_json(job)
    return d


def _job_from_json(p: dict) -> Job:
    terms = p.get("terms")
    return Job(
        job_id=int(p["job_id"]),
        app=str(p["app"]),
        input_size=float(p["input_size"]),
        deadline_s=float(p["deadline_s"]),
        arrival_s=float(p["arrival_s"]),
        terms=_family_terms_from_json(terms) if terms is not None else None,
        device=str(p.get("device", "cpu")),
    )


def _placement_to_json(p: Placement) -> dict:
    d = dataclasses.asdict(p)
    d["job"] = _job_to_json(p.job)
    return d


def _placement_from_json(p: dict) -> Placement:
    return Placement(**{**p, "job": _job_from_json(p["job"])})


def _result_to_json(r: RunResult) -> dict:
    d = dataclasses.asdict(r)
    d["freq_trace"] = _array_to_json(r.freq_trace)
    d["power_trace"] = _array_to_json(r.power_trace)
    return d


def _result_from_json(p: dict) -> RunResult:
    return RunResult(
        **{
            **p,
            "freq_trace": _array_from_json(p["freq_trace"]),
            "power_trace": _array_from_json(p["power_trace"]),
        }
    )


def _completed_to_json(c: CompletedJob) -> dict:
    return {
        "placement": _placement_to_json(c.placement),
        "result": _result_to_json(c.result),
        "finish_s": c.finish_s,
        "met_deadline": c.met_deadline,
        "prior_energy_j": c.prior_energy_j,
        "prior_time_s": c.prior_time_s,
        "migrations": c.migrations,
        "restarts": c.restarts,
    }


def _completed_from_json(p: dict) -> CompletedJob:
    return CompletedJob(
        **{
            **p,
            "placement": _placement_from_json(p["placement"]),
            "result": _result_from_json(p["result"]),
        }
    )


def _roundlog_to_json(log: RoundLog) -> dict:
    d = dataclasses.asdict(log)
    d["refit_families"] = [list(f) for f in log.refit_families]
    return d


def _roundlog_from_json(p: dict) -> RoundLog:
    return RoundLog(
        **{
            **p,
            "refit_families": [
                (str(a), float(s)) for a, s in p["refit_families"]
            ],
        }
    )


# -- the two stores ---------------------------------------------------------


class JobStore:
    """Queue-side durable state: pending, in-flight, completed, rounds.

    List ORDER is preserved verbatim — ``_pending`` order is the
    scheduler's planning order and ``_finish_queue`` order decides
    tie-broken ingest; sorting on restore would be a silent schedule
    change.
    """

    @staticmethod
    def snapshot(sched) -> dict:
        return {
            "pending": [_job_to_json(j) for j in sched._pending],
            "in_flight": [_completed_to_json(c) for c in sched._finish_queue],
            "completed": [_completed_to_json(c) for c in sched.completed],
            "rounds": [_roundlog_to_json(r) for r in sched.rounds],
            "carry": [
                [jid, list(v)] for jid, v in sorted(sched._carry.items())
            ],
        }

    @staticmethod
    def restore(sched, payload: dict) -> None:
        sched._pending = [_job_from_json(p) for p in payload["pending"]]
        sched._finish_queue = [
            _completed_from_json(p) for p in payload["in_flight"]
        ]
        sched.completed = [_completed_from_json(p) for p in payload["completed"]]
        sched.rounds = [_roundlog_from_json(p) for p in payload["rounds"]]
        sched._carry = {
            int(jid): (float(v[0]), float(v[1]), int(v[2]), int(v[3]))
            for jid, v in payload["carry"]
        }


class LedgerStore:
    """Node + belief durable state: reservations, RNGs, drift truth,
    telemetry windows, and the telemetry-installed characterizations."""

    @staticmethod
    def snapshot(sched) -> dict:
        nodes = []
        for node in sched.pool:
            nodes.append(
                {
                    "name": node.name,
                    "available": node.available,
                    "drift": dict(node._drift),
                    # the node model draws time noise + power samples from
                    # this generator in sequence; bit-exact restore is what
                    # makes post-recovery runs reproduce the golden ones
                    "rng_state": node.node.rng.bit_generator.state,
                    "reservations": [
                        dataclasses.asdict(r) for r in node.reservations
                    ],
                }
            )
        beliefs = []
        for fam, (terms, x, y) in sorted(sched._installed_sets.items()):
            rec = {
                "family": list(fam),
                "time_scale": terms.time_scale,
                "source": terms.source,
                "x": _array_to_json(x),
                "y": _array_to_json(y),
            }
            # mixed pools fit per-device engines; the refit must reinstall
            # into the same one (absent key = legacy single-engine journal)
            dev = sched._family_device.get(fam)
            if dev is not None:
                rec["device"] = dev
            # artifact families cache under the time_scale==1.0
            # TermsFamily instance, not an AppTerms key — journal it so
            # recovery re-installs under the exact same key
            key = sched._family_keys.get(fam)
            if isinstance(key, TermsFamily):
                rec["key_terms"] = _family_terms_to_json(key)
            beliefs.append(rec)
        return {
            "nodes": nodes,
            "beliefs": beliefs,
            "telemetry": sched.telemetry.to_json(),
        }

    @staticmethod
    def restore(sched, payload: dict) -> None:
        by_name = {n.name: n for n in sched.pool}
        for p in payload["nodes"]:
            node = by_name[p["name"]]
            node.available = bool(p["available"])
            node._drift = {a: float(v) for a, v in p["drift"].items()}
            node.node.rng.bit_generator.state = p["rng_state"]
            node.reservations = [
                Reservation(**r) for r in p["reservations"]
            ]
        sched.telemetry = TelemetryHub.from_json(payload["telemetry"])
        _reinstall_beliefs(sched, payload["beliefs"])


def _reinstall_beliefs(sched, beliefs: List[dict]) -> None:
    """Re-fit every telemetry-installed characterization from its
    journaled training set and install the models — ONE ``svr.fit_many``
    batch on the scheduler's engine device, exactly the refresh path's
    fit (``_refresh_stale``), so the rebuilt engine cache is bitwise what
    the killed service carried."""
    sched._installed_sets = {}
    if not beliefs:
        return
    sets = [
        (_array_from_json(b["x"]), _array_from_json(b["y"])) for b in beliefs
    ]
    models = svr_mod.fit_many(
        sets, method="auto", device=sched.engine.device, **ENGINE_FIT_KW
    )
    preds = svr_mod.predict_each(models, [x for x, _ in sets])
    for b, model, (x, y), pred in zip(beliefs, models, sets, preds):
        fam = (str(b["family"][0]), float(b["family"][1]))
        kt = b.get("key_terms")
        key = (
            _family_terms_from_json(kt) if kt is not None else family_key(*fam)
        )
        terms = dataclasses.replace(
            key, time_scale=float(b["time_scale"]), source=str(b["source"])
        )
        dev = b.get("device")
        sched._engine_for(dev).install_fit(
            key, model, svr_mod.pae_from_pred(pred, y), terms
        )
        sched._family_keys[fam] = key
        sched._family_device[fam] = dev
        sched._installed_sets[fam] = (terms, x, y)


# -- the journal ------------------------------------------------------------


class JournalTorn(RuntimeError):
    """The injected crash between snapshot and commit: the temp file was
    written but the atomic rename never ran. The journal on disk still
    holds the previous commit — recovery resumes from there."""


class Journal:
    """One-document snapshot journal with atomic commits.

    Each ``commit`` serializes the full service snapshot to
    ``<path>.tmp`` and ``os.replace``s it over ``<path>``: POSIX rename
    atomicity guarantees a reader (or a restarted service) sees either
    the previous snapshot or the new one, never a torn write.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self.commits = 0
        # fault-injection hooks (tests/helpers/torch_faults.py): tear the next
        # commit, or the first commit at/after a sim time
        self.fail_next_commit = False
        self.tear_at_s = None

    def commit(self, payload: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        now_s = float(payload.get("now_s", 0.0))
        torn = self.fail_next_commit or (
            self.tear_at_s is not None and now_s >= self.tear_at_s
        )
        if torn:
            self.fail_next_commit = False
            self.tear_at_s = None
            raise JournalTorn(
                f"journal commit torn at sim t={now_s:g}s ({self.path}.tmp "
                "written, rename skipped)"
            )
        os.replace(tmp, self.path)
        self.commits += 1

    @staticmethod
    def load(path: str) -> dict:
        with open(path) as f:
            payload = json.load(f)
        version = payload.get("schema_version")
        if version != SERVICE_SCHEMA_VERSION:
            raise ValueError(
                f"journal {path}: schema version {version!r} != "
                f"{SERVICE_SCHEMA_VERSION} — refusing to mis-replay"
            )
        return payload
