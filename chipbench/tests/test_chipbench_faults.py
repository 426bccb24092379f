"""The check catches what it is there to catch, run after run at SMOKE width
on the host, against each cell's own limits: a sound run comes out
correct; the control (the plain reference in the program's place, its
products in fp8) and each fault the cell can have come out not correct.
The faults are planted underneath the timed path, in the port's modules
that the step or the prefill calls: a step that leaves its state
unchanged, half of the batch left out (the mean taken over the rest), and
a served token altered where it is produced. On one rank the exchange
between ranks is the identity, so no cell here can leave it out."""

import pytest
import torch

from chipbench import calibrate, spec
from chipbench.tests import smoke

BENCH = spec.Spec(smoke.ROOT)
TRAIN = ["starcoder2-3b.train_4k", "mamba2-130m.train_4k"]


def _fails(result):
    over = {k: v for k, v in result["checks"].items() if not v["value"] <= v["limit"]}
    return not result["correct"] and bool(over)


@pytest.mark.parametrize("workload", TRAIN + ["starcoder2-3b.prefill_mix"])
def test_a_sound_run_is_correct(workload):
    assert smoke.run(workload)["correct"]


@pytest.mark.parametrize("workload", TRAIN)
def test_a_step_that_leaves_its_state_unchanged(workload, monkeypatch):
    from repro_torch.optim import adamw

    def unchanged(cfg, params, grads, state):
        zero = torch.zeros(())
        return {"lr": zero, "grad_norm": zero}

    monkeypatch.setattr(adamw, "update", unchanged)
    result = smoke.run(workload)
    assert _fails(result) and result["checks"]["update_gap"]["value"] == 1.0


@pytest.mark.parametrize("workload", TRAIN)
def test_half_of_the_batch_left_out(workload, monkeypatch):
    from repro_torch.launch import steps

    whole = steps.loss_and_grads

    def half(arch, cfg, model, batch, **kw):
        return whole(arch, cfg, model, {k: v[:v.shape[0] // 2] for k, v in batch.items()}, **kw)

    monkeypatch.setattr(steps, "loss_and_grads", half)
    assert _fails(smoke.run(workload))


def test_a_served_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.launch import steps

    right = steps.greedy
    monkeypatch.setattr(steps, "greedy", lambda logits: (right(logits) + 1) % logits.shape[-1])
    assert _fails(smoke.run("starcoder2-3b.prefill_mix"))


@pytest.mark.parametrize("workload", TRAIN + ["starcoder2-3b.prefill_mix"])
def test_the_control_is_not_correct(workload):
    """The cell's configuration states bf16, so its control computes in fp8;
    it has to fail one of the cell's numbers (a training cell's other
    numbers are caught by the faults above)."""
    cell = BENCH.workload(workload)
    cfg = smoke.config(cell["config"], **smoke.CONTROL_SIZES[cell["config"]])
    traffic = smoke.traffic(BENCH, cell["traffic"])
    limits = BENCH.limits(workload)
    control = calibrate.readings(BENCH, workload, 11, "cpu", 12, cfg=cfg,
                                 traffic=traffic)["control"]
    assert any(value > limits[name] for name, value in control.items()), (control, limits)


def test_a_number_that_is_not_finite_fails():
    """A NaN loss or leaf norm reads inf, never a gap a max would skip."""
    from chipbench import check

    ref = {"losses": [11.0, 11.0], "grad_norms": {"a": 1.0, "b": 2.0},
           "change_norms": {"a": 0.1, "b": 0.2}}
    nan = float("nan")
    for prog in ({**ref, "losses": [11.0, nan]},
                 {**ref, "grad_norms": {"a": nan, "b": 2.0}},
                 {**ref, "change_norms": {"a": 0.1, "b": nan}}):
        result = check.verdict(check.train_gaps(prog, ref), {"loss_gap": 1.0, "grad_gap": 1.0,
                                                             "update_gap": 1.0})
        assert not result["correct"]
