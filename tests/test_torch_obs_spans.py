"""The flight recorder on the model path, on the host: spans stamped on
the profiler's clock, each with its id and its parent, around one step of
``launch.train.make_compressed_dp_step`` and the backwards of
``kernels/ops.py`` (one-rank gloo group, SMOKE width). Recording changes
no number of the step, and the null recorder allocates nothing a span.

This file imports no ``jax``.
"""

import threading
import tracemalloc

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.launch import mesh, steps, train
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.__main__ import main as obs_main
from repro_torch.optim import adamw, compress

CPU = torch.device("cpu")
STEP_SPANS = ("train.step", "train.loss_and_grads", "train.compress", "train.adamw")
# (arch, the backward's span): a dense attention stack and a Mamba2 stack
ARCHS = [("starcoder2-3b", "attention.bwd"), ("mamba2-130m", "ssd.bwd")]


def _host_interval_ns(payload, event):
    t0 = payload["meta"]["epoch_ns"] + round(event["ts"] * 1e3)
    return t0, t0 + round(event["dur"] * 1e3)


def test_span_holds_its_operators_profiler_event_on_one_clock():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(64)
    with obs.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("probe", cat="test"):
                x.add_(1)
    payload = obs.export_run(rec)
    (span,) = [e for e in payload["traceEvents"] if e["name"] == "probe"]
    lo, hi = _host_interval_ns(payload, span)
    (add,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add_"]
    assert lo <= add.start_ns() <= add.end_ns() <= hi


def test_parent_is_the_innermost_open_span_of_the_thread_else_of_any():
    with obs.recording() as rec:
        with obs.span("outer", cat="test", step=7):
            with obs.span("inner", cat="test"):
                obs.event("mark", cat="test")
                # a worker thread with no span of its own works for the span
                # that waits on it, as autograd's device thread does
                worker = threading.Thread(target=lambda: obs.span("worker", cat="test").close())
                worker.start()
                worker.join(timeout=10)
                assert not worker.is_alive()
            with obs.span("sibling", cat="test", step=8):
                pass
        with obs.span("root", cat="test"):
            pass
    by_name = {e["name"]: e["args"] for e in rec.trace.events()}
    outer = by_name["outer"]
    assert outer["parent"] is None and by_name["root"]["parent"] is None
    assert by_name["inner"]["parent"] == outer["id"]
    assert by_name["worker"]["parent"] == by_name["inner"]["id"]
    assert by_name["mark"]["parent"] == by_name["inner"]["id"]
    assert by_name["sibling"]["parent"] == outer["id"]
    # a child takes its parent's step unless it sets its own
    assert by_name["inner"]["step"] == by_name["worker"]["step"] == 7
    assert by_name["sibling"]["step"] == 8 and "step" not in by_name["root"]
    ids = [a["id"] for n, a in by_name.items() if n != "mark"]
    assert len(set(ids)) == len(ids)
    assert not rec.trace._open


def _step_state(arch_id: str):
    arch = get_arch(arch_id)
    cfg = arch.smoke
    model = arch.init(torch.Generator().manual_seed(0), cfg, device=CPU)
    params = steps.trainable(model)
    opt = adamw.AdamWConfig(peak_lr=1e-3, warmup_steps=1, total_steps=4)
    step = train.make_compressed_dp_step(arch, cfg, opt, mesh.make_data_group(CPU))
    x = torch.randint(0, cfg.vocab, (2, 17), generator=torch.Generator().manual_seed(1))
    batch = {"tokens": x[:, :-1], "labels": x[:, 1:]}
    return step, model, adamw.init(params), compress.init_residuals(params), batch


def _numbers(model, opt_state, resid, met):
    return {"params": dict(model.named_parameters()), "m": opt_state["m"], "v": opt_state["v"],
            "residuals": resid, "metrics": met}


def _assert_bitwise(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_bitwise(a[k], b[k])
    else:
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("arch_id,bwd", ARCHS)
def test_step_records_its_spans_and_changes_no_number(arch_id, bwd, tmp_path):
    step, *state, batch = _step_state(arch_id)
    state = step(*step(*state, batch)[:3], batch)
    plain = _numbers(*state)

    step, *state, batch = _step_state(arch_id)
    state = step(*state, batch)  # step 0 unrecorded: the count goes on
    with obs.recording() as rec:
        recorded = _numbers(*step(*state[:3], batch))
    _assert_bitwise(plain, recorded)

    events = rec.trace.events()
    assert all(tuple(e) == obs.TRACE_EVENT_KEYS for e in events)
    spans = {}
    for e in events:
        spans.setdefault(e["name"], []).append(e["args"])
    n_layers = get_arch(arch_id).smoke.n_layers
    assert {n: len(a) for n, a in spans.items()} == {**{n: 1 for n in STEP_SPANS}, bwd: n_layers}
    (top,) = spans["train.step"]
    assert top["parent"] is None and top["step"] == 1
    for name in STEP_SPANS[1:]:
        assert spans[name][0]["parent"] == top["id"]
    grads_id = spans["train.loss_and_grads"][0]["id"]
    assert all(a["parent"] == grads_id for a in spans[bwd])
    assert {a["step"] for s in spans.values() for a in s} == {1}

    path = str(tmp_path / "train_trace.json")
    obs.write_trace(path, rec)
    assert obs_main([path]) == 0


@pytest.mark.parametrize("arch_id,bwd", ARCHS)
def test_null_recorder_allocates_nothing_a_span(arch_id, bwd):
    step, model, opt_state, resid, batch = _step_state(arch_id)
    assert obs.tracer() is obs_trace.NULL_TRACER
    state = [model, opt_state, resid]

    def steps_taken(n):
        for _ in range(n):
            state[0], state[1], state[2], _ = step(*state, batch)

    steps_taken(1)  # warm any lazy module state
    obs_files = tracemalloc.Filter(True, "*repro_torch/obs/*")

    def grown_obs_bytes(n):
        tracemalloc.start()
        before = tracemalloc.take_snapshot()
        steps_taken(n)
        after = tracemalloc.take_snapshot()
        tracemalloc.stop()
        return sum(d.size_diff for d in after.filter_traces([obs_files]).compare_to(
            before.filter_traces([obs_files]), "lineno") if d.size_diff > 0)

    # bytes still live after the steps, attributed to an obs source line. A
    # few blocks that CPython's dict free list hands on keep the line of
    # their first allocation whatever the count of steps; an allocation a
    # span grows with the spans taken, on every attempt
    sizes = []
    for _ in range(3):
        sizes.append((grown_obs_bytes(2), grown_obs_bytes(6)))
        if sizes[-1][1] <= sizes[-1][0]:
            break
    assert sizes[-1][1] <= sizes[-1][0], sizes
