"""The training entry: the port's compressed data-parallel step
(``launch.train.make_compressed_dp_step``), closed loop, one step after
another on batches drawn from the seed.

Set-up builds the step and its state once, from the benchmark's weights,
and drives it through the traffic's ``setup_steps`` (which also compile,
build and warm up every shape), keeping what the check compares: each
step's loss, each leaf's first gradient as AdamW took it, each leaf's
change over those steps. The same object then trains through the window.
After the window the program's state is freed and the plain reference
trains the same weights on the same batches for as many steps.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

from chipbench import check, inputs, port
from chipbench.reference import lm as ref_lm
from chipbench.reference import precision
from chipbench.reference import train as ref_train


def feeds(cfg: dict, tr: dict, seed: int, dev):
    """(weights(), batch(i) -> (tokens, labels)) of the seed: the inputs
    both sides get."""
    specs, dtype = ref_lm.param_specs(cfg), port.dtype_of(cfg)
    vocab = ref_lm.dims(cfg)["vocab"]

    def weights():
        return inputs.draw_weights(specs, cfg, seed, dev, dtype)

    def batch(i):
        x = inputs.tokens(seed, i, tr["batch"], tr["seq"] + 1, vocab, dev)
        return x[:, :-1].contiguous(), x[:, 1:].contiguous()

    return weights, batch


def run(ctx) -> dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    arch, lm_cfg = port.arch_and_config(cfg)
    b, s, n_setup = tr["batch"], tr["seq"], tr["setup_steps"]
    weights, batch = feeds(cfg, tr, ctx.seed, dev)
    step, model, opt_state, resid = port.train_state(arch, lm_cfg, weights(), dev,
                                                     tr["optimizer"])
    prog = {"losses": []}
    for i in range(n_setup):
        toks, labels = batch(i)
        model, opt_state, resid, met = step(model, opt_state, resid,
                                            {"tokens": toks, "labels": labels})
        prog["losses"].append(float(met["loss"]))
        if i == 0:
            prog["grad_norms"] = port.first_grad_norms(opt_state, tr["optimizer"]["b1"])
    prog["change_norms"] = port.change_norms(model, weights())
    ctx.warm_profiler()
    ctx.sync()
    ctx.mark_window_start()

    steps_rec, spans = [], {}
    losses_ok, ends = 0, []
    i, k = n_setup, 0
    t0 = time.perf_counter()
    with port.step_spans(dev, spans) if ctx.trace else contextlib.nullcontext():
        while True:
            toks, labels = batch(i)
            ctx.before_step(k)
            before = port.launches() if ctx.trace else None
            start = port.Stamp(dev).record() if ctx.trace else None
            model, opt_state, resid, met = step(model, opt_state, resid,
                                                {"tokens": toks, "labels": labels})
            end = port.Stamp(dev).record() if ctx.trace else None
            loss = float(met["loss"])
            ctx.sync()
            ends.append(time.perf_counter())
            losses_ok += math.isfinite(loss)
            if ctx.trace:
                after = port.launches()
                steps_rec.append({"b": b, "s": s, "stamps": (start, end), "profiled": ctx.traced(k),
                                  "launches": {n: after[n] - before[n] for n in after}})
            ctx.after_step(k)
            i, k = i + 1, k + 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
    elapsed = ends[-1] - t0
    ctx.window_closed()
    print(f"chipbench: window steps ends_s {[round(t - t0, 4) for t in ends]}", file=sys.stderr)
    if ctx.trace:
        for n, rec in enumerate(steps_rec):
            rec["ms"] = rec["stamps"][0].ms_to(rec["stamps"][1])
            rec["spans"] = {name: pairs[n][0].ms_to(pairs[n][1]) for name, pairs in spans.items()
                            if len(pairs) == len(steps_rec)}
            del rec["stamps"]
    del model, opt_state, resid, met, step
    ctx.free()

    precision.strict_float32()
    ref = ref_train.run(cfg, weights, [lambda j=j: batch(j) for j in range(n_setup)],
                        tr["optimizer"], precision.Precision("float32"))
    print(f"chipbench: losses of the first steps {prog['losses']}, the reference's "
          f"{ref['losses']}; worst leaves {check.worst_leaves(prog, ref)}", file=sys.stderr)
    return {"e2e": {"train_tokens_per_s": k * b * s / elapsed},
            "attempted": k, "failed": k - losses_ok,
            "numbers": check.train_gaps(prog, ref), "steps": steps_rec}

