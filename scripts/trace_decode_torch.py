#!/usr/bin/env python3
"""Trace a prefill and warm decode steps of the PyTorch port's serving path
on one card.

    PYTHONPATH=src python3 scripts/trace_decode_torch.py                # starcoder2-3b, mamba2-130m
    PYTHONPATH=src python3 scripts/trace_decode_torch.py --arch zamba2-7b \
        phi-3-vision-4.2b whisper-medium

For each arch at full width, as ``chip_smoke.py`` phase 6b serves it
(batch 8, prompt 1,024, a cache sized for 32 generated tokens, random
weights from seed 0; phi-3-vision-4.2b's 576 image patches before the
prompt, whisper-medium's 1,500 encoder frames under a prompt of 64, both
N(0, 1) from seed 1): one prefill, then a second under ``torch.profiler``
(CPU and CUDA activities), a few warm-up decode steps, then ``--steps``
decode steps on the host clock without a profiler, then ``--steps`` more
under the profiler, with one synchronisation after the last step in each.
From each trace it prints the window (first host event to the end of the
synchronisation, a step's share for decode), the card's busy time in it
(the union of its kernel, copy and set intervals), the idle share, the
device events and the top-level host ops, and the kernels that took the
most device time; then one JSON line per arch. On the card it exits
non-zero when a trace holds no device event; ``--smoke --device cpu
--steps 2`` is a dry run of the script on the host.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BATCH, PROMPT_LEN, GEN = 8, 1024, 32
WARMUP = 3


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _stats(prof, torch, steps: int) -> dict:
    """The card's busy time, idle share, events and top kernels of a
    trace, per step of ``steps``."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if not getattr(e, "is_user_annotation", False)]
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    t_lo = min(e.time_range.start for e in events)
    t_hi = max(e.time_range.end for e in events)
    window_ms = (t_hi - t_lo) / 1e3 / steps
    busy_ms = _union_us([(e.time_range.start, e.time_range.end) for e in on_card]) / 1e3 / steps
    by_name = collections.Counter()
    for e in on_card:
        by_name[e.name] += e.time_range.elapsed_us() / 1e3 / steps
    top_ops = sum(1 for e in host if e.cpu_parent is None and e.name.startswith("aten::"))
    return {"window_ms": window_ms, "busy_ms": busy_ms, "events": len(on_card) / steps,
            "top_ops": top_ops / steps, "by_name": by_name}


def _print_top(by_name, what: str) -> None:
    for name, ms in by_name.most_common(8):
        print(f"[trace]   {ms:9.4f} ms {what}  {name[:100]}", flush=True)


def _inputs(np, arch_id: str, arch, cfg):
    """(prompts, extras, cache slots): phase 6b's inputs
    (``chip_smoke._full_extras``: whisper's frames, phi-3-vision's patches)."""
    import chip_smoke
    from repro_torch.launch import serve

    prompt_len = chip_smoke.WHISPER_PROMPT if arch.is_encdec() else PROMPT_LEN
    extras = chip_smoke._full_extras(np, arch_id, cfg, BATCH)
    slots = prompt_len + GEN + 8 + (cfg.vision.n_patches if "images" in extras else 0)
    return serve.make_prompts(cfg, BATCH, prompt_len, 0), extras, slots


def trace_arch(torch, arch_id: str, steps: int, smoke: bool, device) -> dict:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import serve
    from repro_torch.launch import steps as steps_mod

    if WARMUP + 2 * steps > GEN - 1:
        raise ValueError(f"--steps {steps}: the cache holds {GEN - 1} decode steps")
    arch, cfg, model = serve.build(arch_id, smoke=smoke, seed=0, device=device)
    dev = next(model.parameters()).device
    prompts, extras, slots = _inputs(np, arch_id, arch, cfg)
    prefill = steps_mod.make_prefill(arch, cfg, max_cache_len=slots)
    serve_step = steps_mod.make_serve_step(arch, cfg)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with torch.inference_mode():
        batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long, device=dev),
                 **{k: torch.as_tensor(v, device=dev).to(cfg.dtype) for k, v in extras.items()}}
        prefill(model, batch)
        _sync(torch, dev)
        with profile(activities=activities) as prof_prefill:
            caches, logits = prefill(model, batch)
            _sync(torch, dev)
        tok = steps_mod.greedy(logits)
        for _ in range(WARMUP):
            caches, tok, _ = serve_step(model, caches, tok)
        _sync(torch, dev)
        t0 = time.perf_counter()
        for _ in range(steps):
            caches, tok, _ = serve_step(model, caches, tok)
        _sync(torch, dev)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        with profile(activities=activities) as prof:
            for _ in range(steps):
                caches, tok, _ = serve_step(model, caches, tok)
            _sync(torch, dev)
    pre = _stats(prof_prefill, torch, 1)
    dec = _stats(prof, torch, steps)
    window_ms, busy_ms = dec["window_ms"], dec["busy_ms"]
    out = {
        "arch": arch_id, "steps": steps,
        "step_ms_untraced": host_ms,
        "step_ms_traced": window_ms,
        "card_busy_ms": busy_ms,
        "idle_share_traced": 1.0 - busy_ms / window_ms,
        "idle_share_untraced": 1.0 - busy_ms / host_ms,
        "device_events_per_step": dec["events"],
        "host_top_level_ops_per_step": dec["top_ops"],
        "top_kernels_ms_per_step": dict(dec["by_name"].most_common(8)),
        "prefill_ms_traced": pre["window_ms"],
        "prefill_card_busy_ms": pre["busy_ms"],
        "prefill_idle_share": 1.0 - pre["busy_ms"] / pre["window_ms"],
        "prefill_top_kernels_ms": dict(pre["by_name"].most_common(8)),
    }
    print(f"[trace] {arch_id}: prefill {pre['window_ms']:.3f} ms traced; card busy "
          f"{pre['busy_ms']:.3f} ms, idle {out['prefill_idle_share']:.4f} of the window; "
          f"{pre['events']:.0f} device events and {pre['top_ops']:.0f} top-level host ops",
          flush=True)
    _print_top(pre["by_name"], "of the prefill")
    print(f"[trace] {arch_id}: decode step {host_ms:.3f} ms untraced, {window_ms:.3f} ms "
          f"traced; card busy {busy_ms:.3f} ms a step, idle {out['idle_share_traced']:.4f} of "
          f"the traced window ({out['idle_share_untraced']:.4f} of the untraced step); "
          f"{out['device_events_per_step']:.1f} device events and "
          f"{out['host_top_level_ops_per_step']:.1f} top-level host ops a step", flush=True)
    _print_top(dec["by_name"], "a step")
    del model, caches
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        if not dec["events"] or not pre["events"]:
            raise RuntimeError(f"{arch_id}: a trace holds no device event")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["starcoder2-3b", "mamba2-130m"])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", help="SMOKE widths (a dry run)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    sys.path.insert(0, os.path.join(HERE, ".."))  # chip_smoke's phase 6b inputs
    import torch

    if args.device in (None, "cuda"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()
        print(f"[trace] {smi}; torch {torch.__version__}", flush=True)
    for arch_id in args.arch:
        out = trace_arch(torch, arch_id, args.steps, args.smoke, args.device)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
