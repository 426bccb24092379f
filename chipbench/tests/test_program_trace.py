"""``chipbench/program_trace.py`` on hand-built traces: device time by the
launching runtime call's correlation id, idle time by the span's host
interval, both inclusive, over the spans inside the profiled stretch."""

import pytest

from chipbench import program_trace as pt

E, S = pt.Event, pt.Span

# the stretch runs from 100 to 600 ns; the device is busy 120-170, 300-400
# and 520-540, so idle 100-120, 170-300, 400-520 and 540-600 (330 ns)
EVENTS = [
    E("launch", 100, 110, 1), E("device", 120, 170, 1),
    E("launch", 200, 205, 2), E("device", 300, 400, 2),
    E("launch", 500, 505, 3), E("device", 520, 540, 3),
    E("host", 250, 260, 3),  # an operator whose id is a launch's: no launcher
    E("launch", 540, 600, 99),  # a synchronise: launches nothing
]
SPANS = [
    S("train.step", 100, 560),
    S("train.loss_and_grads", 195, 260),
    S("attention.bwd", 198, 210),
    S("attention.bwd", 500, 502),
    S("train.adamw", 480, 560),
    S("before", 50, 80),  # outside the stretch unless the profiler opened before it
    S("after", 550, 700),  # outside: ends after the last event
]


def _ms(ns):
    return pytest.approx(ns / 1e6, abs=1e-12)


def test_device_and_idle_time_of_nested_spans():
    got = pt.reduce_events(EVENTS, SPANS)
    assert got["device_ms"] == _ms(170) and got["idle_ms"] == _ms(330)
    want = {  # name: (n, host, device, idle) in ns
        "train.step": (1, 460, 170, 20 + 130 + 120 + 20),
        "train.loss_and_grads": (1, 65, 100, 65),
        "attention.bwd": (2, 12 + 2, 100 + 20, 12 + 2),
        "train.adamw": (1, 80, 20, 40 + 20),
    }
    assert set(got["spans"]) == set(want)
    for name, (n, host, device, idle) in want.items():
        row = got["spans"][name]
        assert row["n"] == n, name
        assert (row["host_ms"], row["device_ms"], row["idle_ms"]) == (
            _ms(host), _ms(device), _ms(idle)), name


def test_a_span_counts_from_when_the_profiler_opened():
    got = pt.reduce_events(EVENTS, SPANS, opened_ns=40)["spans"]
    assert got["before"] == {"n": 1, "host_ms": _ms(30), "device_ms": 0.0, "idle_ms": 0.0}
    assert "after" not in got


def test_no_device_event_leaves_the_stretch_idle():
    got = pt.reduce_events([E("launch", 0, 10, 1), E("host", 90, 100, 0)], [S("x", 5, 50)])
    assert got["idle_ms"] == _ms(100)
    assert got["spans"]["x"] == {"n": 1, "host_ms": _ms(45), "device_ms": 0.0, "idle_ms": _ms(45)}
    assert pt.reduce_events([], [S("x", 5, 50)]) == {}


def test_recorded_spans_on_the_profilers_clock():
    program = {"epoch_ns": 10**18, "events": [
        {"name": "train.step", "ph": "X", "ts": 1.5, "dur": 2.25, "pid": 1},
        {"name": "mark", "ph": "i", "ts": 2.0, "dur": 0, "pid": 1},
        {"name": "node0", "ph": "X", "ts": 0.0, "dur": 9.0, "pid": 2},
    ]}
    assert pt.recorded_spans(program) == [S("train.step", 10**18 + 1500, 10**18 + 3750)]
    # a recorder that gives no epoch on the profiler's clock, or none at all
    assert pt.recorded_spans({"epoch_ns": None, "events": program["events"]}) == []
    assert pt.recorded_spans(None) == []
    assert pt.reduce(None, program) == {}
    assert pt.reduce(object(), None) == {}


def test_host_operators_of_a_cpu_profile_launch_nothing():
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(8).add_(1)
    events = pt.profiler_events(prof)
    assert events and {e.kind for e in events} == {"host"}
