"""The plain reference against the port at SMOKE width on the CPU, both in
float32: the numbers the check compares come out at round-off, far under
any limit, so the reference computes what the port computes."""

import pytest

from chipbench.tests import smoke

TRAIN = ["starcoder2-3b.train_4k", "mamba2-130m.train_4k"]


@pytest.mark.parametrize("workload", TRAIN)
def test_training_agrees_with_the_reference(workload):
    result = smoke.run(workload)
    gaps = {k: v["value"] for k, v in result["checks"].items()}
    assert set(gaps) == {"loss_gap", "grad_gap", "update_gap"}
    assert gaps["loss_gap"] < 1e-6 and gaps["grad_gap"] < 1e-5 and gaps["update_gap"] < 1e-4, gaps
    assert result["correct"] and result["attempted"] >= 1 and result["failed"] == 0


def test_prefill_agrees_with_the_reference():
    result = smoke.run("starcoder2-3b.prefill_mix")
    gaps = {k: v["value"] for k, v in result["checks"].items()}
    assert gaps["token_gap"] == 0.0 and gaps["kv_gap"] < 1e-5, gaps
    assert result["correct"] and result["attempted"] >= 1


@pytest.mark.parametrize("workload", TRAIN + ["starcoder2-3b.prefill_mix"])
def test_traced_run_reads_its_metrics(workload):
    """A traced run reports per-layer metrics and the trace's keys; on the
    host only those that need no device are there."""
    result = smoke.run(workload, trace=True)
    assert result["correct"]
    assert set(result["device"]) >= {"busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    mfu = "step_mfu.prefill" if "prefill" in workload else "step_mfu.train"
    assert 0 < result["metrics"][mfu]["value"] < 100
    assert list(result)[-1] == "checks"
