"""The prefill entry: a prefill instance of a disaggregated deployment, in a
closed loop of batches. Each batch is one prompt length of the mix, its
requests drawn from the seed; the port's prefill (``steps.make_prefill``)
builds their caches and ``steps.greedy`` picks each request's first token,
which the host reads after a synchronise.

A request's time to first token runs from the start of its batch to that
read. The last attention cache of every batch (``port.last_kv``) is kept
until the check, which samples the finished requests (the longest among
them) and runs the plain reference over each prompt: the served token's
logit gap, and the cache it hands on against the reference's
``last_kv_layer``, are compared.
"""

from __future__ import annotations

import math
import random
import time

import numpy as np
import torch

from chipbench import check, inputs, port
from chipbench.reference import lm as ref_lm
from chipbench.reference import precision


def block_of(tr: dict):
    """One block of the mix: each bucket's (rows, prompt length) ``share``
    times."""
    return [(bk["batch"], bk["prompt"]) for bk in tr["buckets"] for _ in range(bk["share"])]


def schedule(tr: dict, seed: int, n: int):
    """The first ``n`` batches' (rows, prompt length): blocks of the mix,
    each shuffled by the seed, so every seed runs the same work in another
    order. The window ends on a block's last batch."""
    block = block_of(tr)
    rng = random.Random(inputs.stream_seed(seed, inputs.ORDER))
    out = []
    while len(out) < n:
        rng.shuffle(block)
        out += block
    return out[:n]


def sample(tr: dict, seed: int, finished):
    """(batch index, row) of the requests the check compares: per prompt
    length, the traffic's count, drawn from the seed among the finished
    requests of that length."""
    rng = random.Random(inputs.stream_seed(seed, inputs.SAMPLE))
    picked = []
    for length, count in sorted(tr["check_requests"].items(), key=lambda kv: int(kv[0])):
        pool = [(i, r) for i, (rows, s) in enumerate(finished) if s == int(length)
                for r in range(rows)]
        picked += rng.sample(pool, min(count, len(pool)))
    return sorted(picked)


def feeds(cfg: dict, seed: int, dev):
    """(weights(), prompts(batch index, rows, length)) of the seed: the
    inputs both sides get."""
    specs, dtype = ref_lm.param_specs(cfg), port.dtype_of(cfg)
    vocab = ref_lm.dims(cfg)["vocab"]

    def weights():
        return inputs.draw_weights(specs, cfg, seed, dev, dtype)

    def prompts(i, rows, s):
        return inputs.tokens(seed, i, rows, s, vocab, dev)

    return weights, prompts


def run(ctx) -> dict:
    cfg, tr, dev = ctx.cfg, ctx.traffic, ctx.device
    arch, lm_cfg = port.arch_and_config(cfg)
    kv_layer = ref_lm.last_kv_layer(cfg)
    weights, prompts = feeds(cfg, ctx.seed, dev)
    model = port.build_model(arch, lm_cfg, weights())
    fns = {bk["prompt"]: port.prefill_fn(arch, lm_cfg, bk["prompt"]) for bk in tr["buckets"]}
    plan = schedule(tr, ctx.seed, tr["max_batches"])
    block = block_of(tr)
    with torch.inference_mode():
        for j, bk in enumerate(tr["buckets"]):  # every shape once, on batches of their own
            caches, first = fns[bk["prompt"]](model, prompts(-1 - j, bk["batch"], bk["prompt"]))
            first.cpu()
            if port.last_kv(caches) is None:  # no cache to compare: stop before the window
                raise ValueError(f"{cfg['arch']}: no prefill cache of the port holds keys, so "
                                 f"port.last_kv finds no attention cache to compare")
            del caches, first
        ctx.warm_profiler()
        ctx.sync()
        ctx.mark_window_start()
        ttft, served, kept, steps_rec = [], [], [], []
        t0 = time.perf_counter()
        for i, (rows, s) in enumerate(plan):
            toks = prompts(i, rows, s)
            ctx.before_step(i)
            before = port.launches() if ctx.trace else None
            start = port.Stamp(dev).record() if ctx.trace else None
            t_start = time.perf_counter()
            caches, first = fns[s](model, toks)
            end = port.Stamp(dev).record() if ctx.trace else None
            first = first.cpu()
            ttft += [time.perf_counter() - t_start] * rows
            served.append(first[:, 0])
            kept.append(port.last_kv(caches))
            del caches
            if ctx.trace:
                after = port.launches()
                steps_rec.append({"b": rows, "s": s, "stamps": (start, end),
                                  "profiled": ctx.traced(i),
                                  "launches": {n: after[n] - before[n] for n in after}})
            ctx.after_step(i)
            if time.perf_counter() - t0 >= ctx.seconds and (i + 1) % len(block) == 0:
                break
        else:
            raise RuntimeError(f"the window outlasted max_batches ({tr['max_batches']})")
        elapsed = time.perf_counter() - t0
    ctx.window_closed()
    for rec in steps_rec:
        rec["ms"] = rec["stamps"][0].ms_to(rec["stamps"][1])
        del rec["stamps"]
    finished = plan[:len(served)]
    picked = sample(tr, ctx.seed, finished)
    mine = {(i, r): (int(served[i][r]), kept[i][0][r].clone(), kept[i][1][r].clone())
            for i, r in picked}
    del model, kept, served, fns
    ctx.free()
    numbers = judge(cfg, weights, prompts, finished, mine, kv_layer, precision.Precision("float32"))
    return {"e2e": {"prefill_tokens_per_s": sum(r * s for r, s in finished) / elapsed,
                    "ttft_p95_ms": 1e3 * float(np.percentile(ttft, 95))},
            "attempted": len(ttft), "failed": 0, "numbers": numbers, "steps": steps_rec}


@torch.no_grad()
def reference_outputs(cfg, params, toks, kv_layer, prec):
    """The reference's last-position logits (vocab,) and [k, v] (hk, s, dh)
    of ``kv_layer`` for one prompt (1, s)."""
    h, kv = ref_lm.hidden(cfg, params, toks, prec, kv_layer=kv_layer)
    return ref_lm.logits(cfg, params, h[0, -1:], prec)[0], [t[0] for t in kv]


def judge(cfg, weights, prompts, finished, served, kv_layer, prec) -> dict:
    """token_gap and kv_gap of ``served`` {(batch, row): (token, k, v)}
    against the float32 reference (computed with ``prec``'s products for
    the control)."""
    precision.strict_float32()
    judge_prec = precision.Precision("float32")
    params = {k: w.float() for k, w in weights().items()}
    token_gap, kv_gap = 0.0, 0.0
    for (i, r), (token, k, v) in sorted(served.items()):
        rows, s = finished[i]
        toks = prompts(i, rows, s)[r:r + 1]
        z, (k_ref, v_ref) = reference_outputs(cfg, params, toks, kv_layer, judge_prec)
        if prec.name != judge_prec.name:  # the control puts its own answer in the program's place
            z_c, (k, v) = reference_outputs(cfg, params, toks, kv_layer, prec)
            token = int(torch.argmax(z_c))
        token_gap = _worse(token_gap, float(z.max() - z[token]))
        for got, want in ((k, k_ref), (v, v_ref)):
            kv_gap = _worse(kv_gap, float(torch.linalg.vector_norm(got.float() - want)
                                          / torch.linalg.vector_norm(want)))
    return {"token_gap": token_gap, "kv_gap": kv_gap}


def _worse(a: float, b: float) -> float:
    """The larger gap; one that is not finite reads inf."""
    return max(a, b if math.isfinite(b) else math.inf)

