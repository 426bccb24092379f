#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases (every failure raises; nothing is caught):

1. device: the card's name and power limit; TF32 off.
2. build: nvcc builds the Hopper kernels from src/repro_torch/kernels/csrc/.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes (exact for plan_argmin / pareto_mask, within
   RBF_ATOL for rbf_gram), timed beside its bound: many calls captured in
   one CUDA graph and replayed between CUDA events, so the host's dispatch
   is not in the time (eager back-to-back calls are printed beside it).
4. paper loop: evaluate.compare_governors at full characterization
   (11 f x 32 cores x 5 inputs, 4 apps: a (4, 1760, 1760) Gram), all 20
   plans, governors at the --quick settings; the plans are held against
   tests/data/torch_port_eval_golden.json (written by the JAX package).
5. fleet-scale planning: plan_many / pareto_many over B = 10,000 workloads
   of 20 families; the fused kernel path, its plain version and the exact
   path must agree exactly. The kernel and plain rounds run twice in the
   order kernel, plain, plain, kernel, so that run order shows in their
   times; each round's time is printed with the seconds the garbage
   collector ran inside it.
6. launches: one JSON line with every kernel's launch count over phases
   4-5 (the main path), its error against the plain version and its times.
7. the last line: {"ok": true, "device": {...}}.

It exits non-zero without a CUDA device, and when the package is missing.
"""

import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SEED = 42
RBF_ATOL = 2e-6  # kernel vs plain rbf_gram: same expression and order
B_FLEET = 10_000
GOLDEN = os.path.join(HERE, "tests", "data", "torch_port_eval_golden.json")
NEAR_TIE_REL = 1e-3
DEVICE = "cuda"

# H100 SXM peaks (NVIDIA data sheet): HBM rate and fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def _stage(name: str, t0: float) -> float:
    now = time.perf_counter()
    print(f"[stage] {name}: {now - t0:.3f} s", flush=True)
    return now


def _eager_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of back-to-back eager calls between CUDA events:
    where a call is short, this is the host's dispatch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _time_ms(torch, fn, reps: int, replays: int = 3) -> float:
    """Mean ms per call on the card: ``reps`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events. The wrappers'
    host work (checks, ctypes, allocation) runs once, at capture."""
    fn()  # loads the kernel module and warms the allocator before capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * reps)
    del graph
    torch.cuda.empty_cache()
    return ms


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] torch: {kind}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return kind, smi


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    print(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s", flush=True)
    for out in _build.BUILD_LOG:
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[ptxas] {line.strip()}", flush=True)


def _rbf_inputs(np, rng, b, n, m, d):
    if d == 3:  # the paper's raw (f GHz, cores, input size) features
        def feats(k):
            return np.stack([rng.uniform(1.2, 2.2, (b, k)),
                             rng.integers(1, 33, (b, k)).astype(float),
                             rng.integers(1, 6, (b, k)).astype(float)], -1)
        return feats(n).astype(np.float32), feats(m).astype(np.float32)
    return (rng.standard_normal((b, n, d)).astype(np.float32),
            rng.standard_normal((b, m, d)).astype(np.float32))


def _plan_inputs(np, rng, b, g):
    t = rng.lognormal(3.0, 1.0, (b, g)).astype(np.float32)
    w = rng.uniform(50.0, 600.0, (1, g)).astype(np.float32)
    k = rng.choice([0.0, 1.0, 2.0], b).astype(np.float32)
    mask = rng.random((b, g)) < 0.7
    t[:, 1::8] = t[:, 0::8][:, : t[:, 1::8].shape[1]]  # exact metric ties
    w[:, 1::8] = w[:, 0::8][:, : w[:, 1::8].shape[1]]
    mask[::97] = False  # all-masked rows
    t[5::89, 100] = np.nan  # NaN step times: the first feasible NaN wins
    t[6::89, :] = np.nan
    return t, w, k, mask


def _pareto_inputs(np, rng, b, g):
    t = rng.lognormal(3.0, 1.0, (b, g)).astype(np.float32)
    e = rng.lognormal(8.0, 0.5, (b, g)).astype(np.float32)
    mask = rng.random((b, g)) < 0.8
    t[:, 5::11] = t[:, 4::11][:, : t[:, 5::11].shape[1]]  # exact (t, e) ties
    e[:, 5::11] = e[:, 4::11][:, : e[:, 5::11].shape[1]]
    t[::13, 3] = np.inf
    e[::17, 7] = -np.inf
    t[::19, 9] = -np.inf
    return t, e, mask


def phase_kernels(torch, np, kind):
    from repro_torch.core.engine import TIME_FLOOR
    from repro_torch.kernels import ops

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    results = {}

    # rbf_gram: the fit (4, 1760, 1760, 3), the engine predict (20, 352, 352, 2)
    # and one evaluate plan's predict (352, 1760, 3)
    rbf = []
    for (b, n, m, d) in ((4, 1760, 1760, 3), (20, 352, 352, 2), (1, 352, 1760, 3)):
        xn, yn = _rbf_inputs(np, rng, b, n, m, d)
        x = torch.from_numpy(xn).to(dev)
        y = torch.from_numpy(yn).to(dev)
        if b == 1:
            x, y = x[0], y[0]
        gamma = 0.5
        got = ops.rbf_gram(x, y, gamma)
        want = ops.rbf_gram(x, y, gamma, impl="ref")
        torch.cuda.synchronize()
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"rbf_gram {(b, n, m, d)}: bad output")
        err = float((got - want).abs().max())
        if err > RBF_ATOL:
            raise AssertionError(f"rbf_gram {(b, n, m, d)}: max |err| {err} > {RBF_ATOL}")
        ms = _time_ms(torch, lambda: ops.rbf_gram(x, y, gamma), 50)
        eager = _eager_ms(torch, lambda: ops.rbf_gram(x, y, gamma), 50)
        plain_ms = _time_ms(torch, lambda: ops.rbf_gram(x, y, gamma, impl="ref"), 10)
        bound, by = _bound_ms(4.0 * (b * n * d + b * m * d + b * n * m),
                              b * n * m * (2 * d + 5))
        print(f"[kernel] rbf_gram b={b} n={n} m={m} d={d}: {ms:.4f} ms "
              f"(eager calls {eager:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound * 1e3:.2f} us by {by}, max |err| {err:.3g}) on {kind}",
              flush=True)
        rbf.append(dict(shape=(b, n, m, d), ms=ms, plain_ms=plain_ms,
                        bound_ms=bound, bound_by=by, max_abs_err=err))
    # the JSON line carries the fit shape, the largest on the path
    results["rbf_gram"] = dict(rbf[0], max_abs_err=max(r["max_abs_err"] for r in rbf))

    # plan_argmin at B = 10^4, G = 352: identical indices
    b, g = B_FLEET, 352
    tn, wn, kn, mn = _plan_inputs(np, rng, b, g)
    t = torch.from_numpy(tn).to(dev)
    w = torch.from_numpy(wn).to(dev)
    k = torch.from_numpy(kn).to(dev)
    mask = torch.from_numpy(mn).to(dev)
    got = ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR)
    want = ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR, impl="ref")
    mism = int((got != want).sum())
    err = float((got.long() - want.long()).abs().max())
    if mism:
        raise AssertionError(f"plan_argmin: {mism} of {b} rows differ")
    def kernel():
        return ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR)

    ms = _time_ms(torch, kernel, 200)
    eager = _eager_ms(torch, kernel, 200)
    plain_ms = _time_ms(
        torch, lambda: ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR, impl="ref"), 20)
    bound, by = _bound_ms(4.0 * b * g + b * g + 4.0 * g + 4.0 * b + 4.0 * b, 5.0 * b * g)
    print(f"[kernel] plan_argmin B={b} G={g}: {ms:.4f} ms (eager calls {eager:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound * 1e3:.2f} us by {by}, {mism} rows "
          f"differ, {int(np.isnan(tn).any(1).sum())} rows with NaN) on {kind}", flush=True)
    results["plan_argmin"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, max_abs_err=err)

    # pareto_mask at B = 10^4, G = 352: identical keep-sets
    tn, en, mn = _pareto_inputs(np, rng, b, g)
    t = torch.from_numpy(tn).to(dev)
    e = torch.from_numpy(en).to(dev)
    mask = torch.from_numpy(mn).to(dev)
    got = ops.pareto_mask(t, e, mask)
    want = ops.pareto_mask(t, e, mask, impl="ref")
    mism = int((got != want).sum())
    err = float((got.int() - want.int()).abs().max())
    if mism:
        raise AssertionError(f"pareto_mask: {mism} of {b * g} points differ")
    ms = _time_ms(torch, lambda: ops.pareto_mask(t, e, mask), 50)
    eager = _eager_ms(torch, lambda: ops.pareto_mask(t, e, mask), 50)
    plain_ms = _time_ms(torch, lambda: ops.pareto_mask(t, e, mask, impl="ref"), 2)
    # the least work for this function is a per-row lexsort on (t, e, index)
    # and a running minimum, as engine.pareto_frontier does on the host:
    # about 3 log2(G) comparisons and 2 operations a point, far below the
    # 10 bytes a point (t, e, mask in, keep-set out) it must move
    bound, by = _bound_ms(10.0 * b * g, b * g * (3.0 * math.log2(g) + 2.0))
    print(f"[kernel] pareto_mask B={b} G={g}: {ms:.4f} ms (eager calls {eager:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound * 1e3:.2f} us by {by}, {mism} "
          f"points differ) on {kind}", flush=True)
    results["pareto_mask"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, max_abs_err=err)
    return results


def _port_energy_grid(np, torch, node_seed, app, n):
    """The port's predicted (F, P, E) grid of one (app, input), rebuilt from
    a fresh node of the same seed (deterministic: the same fit)."""
    from repro_torch.core import energy, power
    from repro_torch.core.characterize import CharacterizationSet
    from repro_torch.core.node_sim import FREQ_GRID, MAX_CORES, Node, PROFILES

    node = Node(seed=node_seed)
    pm = power.fit_power_model(*node.stress_grid())
    models = CharacterizationSet.from_node(node, sorted(PROFILES)).models_by_app(
        device=DEVICE)
    F, P, _, _, E = energy.energy_grid(
        pm, models[app], frequencies=tuple(FREQ_GRID),
        cores=range(1, MAX_CORES + 1), input_size=n)
    return F, P, E


def phase_paper_loop(torch, np):
    from repro_torch import obs
    from repro_torch.core import evaluate, power
    from repro_torch.core.node_sim import Node

    t0 = time.perf_counter()
    node = Node(seed=SEED)
    pm = power.fit_power_model(*node.stress_grid())
    t0 = _stage("paper loop: stress grid + power fit (host)", t0)
    with obs.recording() as rec:
        report = evaluate.compare_governors(
            node, power_model=pm, governor_cores=(1, 8, 32), repeats=1,
            device=DEVICE)
    t0 = _stage("paper loop: compare_governors (characterize, fit, 20 plans, "
                "240 governor runs)", t0)
    for ev in rec.trace.events():
        if ev["name"] == "svr.fit_exact":
            print(f"[stage] paper loop: svr.fit_exact span (Gram on the card + "
                  f"host KKT): {ev['dur'] / 1e6:.3f} s", flush=True)
    print(report.table(), flush=True)

    with open(GOLDEN) as f:
        gold_report = json.load(f)
    golden = gold_report["plans"]
    if len(report.plans) != len(golden) or len(golden) != 20:
        raise AssertionError(f"{len(report.plans)} plans vs {len(golden)} golden")
    near_ties = []
    for p, g in zip(report.plans, golden):
        if (p.app, p.input_size) != (g["app"], g["input_size"]):
            raise AssertionError(f"plan order differs: {p.app} vs {g['app']}")
        if not np.isfinite(p.predicted_energy_j) or p.predicted_energy_j <= 0:
            raise AssertionError(f"bad predicted energy {p}")
        if (p.frequency_ghz, p.cores) == (g["frequency_ghz"], g["cores"]):
            continue
        F, P, E = _port_energy_grid(np, torch, SEED, p.app, p.input_size)
        pick = E[(F == p.frequency_ghz) & (P == p.cores)][0]
        gold = E[(F == g["frequency_ghz"]) & (P == g["cores"])][0]
        rel = abs(gold - pick) / pick
        row = (f"{p.app} N={p.input_size:g}: port ({p.frequency_ghz}, {p.cores}) "
               f"vs golden ({g['frequency_ghz']}, {g['cores']}), port energies "
               f"{pick!r} vs {gold!r}, rel {rel:.3g}")
        if rel > NEAR_TIE_REL:
            raise AssertionError("plan differs from the golden: " + row)
        near_ties.append(row)
        print(f"[near-tie] {row}", flush=True)
    print(f"[paper loop] {20 - len(near_ties)} of 20 plans equal the JAX golden, "
          f"{len(near_ties)} near-ties; worst-case ratio "
          f"{report.worst_case_ratio!r}, best {report.best_case_ratio!r}, mean "
          f"{report.mean_ratio!r}", flush=True)
    if not near_ties:
        # same configs and the same simulator draws: the same measurements
        for key in ("worst_case_ratio", "best_case_ratio", "mean_ratio"):
            if getattr(report, key) != gold_report[key]:
                raise AssertionError(
                    f"{key} {getattr(report, key)!r} != golden {gold_report[key]!r}")
    # one repeat leaves a few % of simulated measurement noise on each run:
    # the tolerance of the reference's own full-grid ordering check
    if not report.plan_beats_all(tol=0.05):
        raise AssertionError(
            f"plan_beats_all(0.05) is False (best ratio {report.best_case_ratio!r})")
    return report


def _fleet_workloads(np):
    from repro_torch.core.engine import Constraints, Workload
    from repro_torch.core.node_sim import INPUT_SIZES, PROFILES
    from repro_torch.fleet.cluster import family_key

    rng = np.random.default_rng(SEED)
    apps = sorted(PROFILES)
    families = [(a, n) for a in apps for n in INPUT_SIZES]  # 20 families
    objectives = ("energy", "edp", "ed2p")
    ws = []
    for i in range(B_FLEET):
        app, n = families[i % len(families)]
        kind = int(rng.integers(5))
        if kind == 0:
            c = None
        elif kind == 1:
            c = Constraints(max_cores=16)
        elif kind == 2:  # deadline
            c = Constraints(max_time_s=float(rng.uniform(20.0, 3000.0)))
        elif kind == 3:
            c = Constraints(max_time_s=float(rng.uniform(50.0, 3000.0)),
                            max_cores=16, max_frequency_ghz=2.0)
        else:  # no grid point meets it: the on_infeasible fallback
            c = Constraints(max_time_s=1e-3, max_cores=16)
        ws.append(Workload(arch=app, terms=family_key(app, n),
                           objective=objectives[int(rng.integers(3))],
                           constraints=c))
    return ws


# the fused rounds' order: kernel, plain, plain, kernel, twice
ABBA = (None, "ref", "ref", None) * 2
ARM = {None: "kernel", "ref": "plain version"}


class _GcClock:
    """Seconds the cyclic garbage collector has run (a gc callback)."""

    def __init__(self):
        self.total_s = 0.0
        self._start_s = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._start_s = time.perf_counter()
        else:
            self.total_s += time.perf_counter() - self._start_s


def _timed_round(label: str, fn, gc_clock: _GcClock):
    gc0, t0 = gc_clock.total_s, time.perf_counter()
    out = fn()
    print(f"[stage] {label}: {time.perf_counter() - t0:.3f} s (garbage collector "
          f"{gc_clock.total_s - gc0:.3f} s of it)", flush=True)
    return out


def phase_fleet(torch, np):
    from repro_torch.core import power
    from repro_torch.core.engine import PlanningEngine, cpu_space
    from repro_torch.core.node_sim import Node

    pm = power.fit_power_model(*Node(seed=7).stress_grid())
    eng = PlanningEngine(pm, space=cpu_space(), noise=0.01, seed=0, device=DEVICE)
    ws = _fleet_workloads(np)
    gc_clock = _GcClock()
    gc.callbacks.append(gc_clock)
    try:
        _fleet_rounds(np, eng, ws, gc_clock)
    finally:
        gc.callbacks.remove(gc_clock)


def _fleet_rounds(np, eng, ws, gc_clock):
    b = len(ws)
    fused = _timed_round(f"fleet: plan_many B={b} fused, cold (20 family fits)",
                         lambda: eng.plan_many(ws), gc_clock)
    runs = [_timed_round(f"fleet: plan_many B={b} fused {ARM[impl]}, warm",
                         lambda: eng.plan_many(ws, impl=impl), gc_clock)
            for impl in ABBA]
    exact = _timed_round(f"fleet: plan_many B={b} exact path",
                         lambda: eng.plan_many(ws, fused=False), gc_clock)
    bad = sum(any(r[i] != exact[i] for r in [fused, *runs]) for i in range(len(ws)))
    if bad:
        raise AssertionError(f"plan_many: {bad} of {len(ws)} plans differ across arms")
    if not all(np.isfinite(p.energy_per_step_j) and p.energy_per_step_j > 0
               for p in fused):
        raise AssertionError("plan_many: non-finite or non-positive energy")
    runs = [_timed_round(f"fleet: pareto_many B={b} fused {ARM[impl]}",
                         lambda: eng.pareto_many(ws, impl=impl), gc_clock)
            for impl in ABBA]
    fr = runs[0]
    fr_exact = _timed_round(f"fleet: pareto_many B={b} exact path",
                            lambda: eng.pareto_many(ws, fused=False), gc_clock)
    bad = sum(any(r[i] != fr_exact[i] for r in runs) for i in range(len(ws)))
    if bad:
        raise AssertionError(f"pareto_many: {bad} of {len(ws)} frontiers differ")
    if not all(fr_i for fr_i in fr):
        raise AssertionError("pareto_many: an empty frontier")
    n_pts = sum(len(f) for f in fr)
    print(f"[fleet] {len(ws)} plans and {n_pts} frontier points agree across "
          f"the kernel, plain and exact arms", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(HERE, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout (src/repro_torch is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    from repro_torch.kernels import ops

    t_start = time.perf_counter()
    kind, smi = phase_device(torch)
    t0 = _stage("device", t_start)
    phase_build()
    t0 = _stage("build", t0)
    results = phase_kernels(torch, np, kind)
    t0 = _stage("kernels against their plain versions", t0)

    ops.reset_launches()  # the main path's launches are counted from here
    phase_paper_loop(torch, np)
    t0 = _stage("paper loop", t0)
    phase_fleet(torch, np)
    t0 = _stage("fleet-scale planning", t0)
    launches = dict(ops.LAUNCHES)

    sources = {
        "rbf_gram": ("src/repro_torch/kernels/csrc/rbf_gram.cu",
                     "src/repro/kernels/rbf_gram.py:42"),
        "plan_argmin": ("src/repro_torch/kernels/csrc/plan_grid.cu",
                        "src/repro/kernels/plan_grid.py:49"),
        "pareto_mask": ("src/repro_torch/kernels/csrc/plan_grid.cu",
                        "src/repro/kernels/plan_grid.py:110"),
    }
    line = []
    for name, (source, replaces) in sources.items():
        r = results[name]
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the main path")
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
        })
    print(f"[total] {time.perf_counter() - t_start:.1f} s on {smi}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
