#!/usr/bin/env python3
"""Loss trajectories of the PyTorch port's training step at full width, in
several arms from the same weights and batches.

    PYTHONPATH=src python3 scripts/train_trajectory_torch.py          # one card
    PYTHONPATH=src python3 scripts/train_trajectory_torch.py --smoke --device cpu --steps 2

starcoder2-3b (random weights from seed 0, batch 2 x seq 4,096, the
``SyntheticPipeline`` batches of seed 0, ``launch.train``'s AdamW defaults:
peak lr 3e-4, warm-up 20, total steps = the run's) takes ``--steps`` steps
in each arm:

  compressed    the step ``launch.train --compress`` builds (int8 error
                feedback over a one-rank data group), with the kernels
  uncompressed  ``launch.steps.make_train_step``, with the kernels
  plain         ``make_train_step(impl="ref")``: no kernel
  f32           ``make_train_step`` in float32, with the kernels, from the
                same weights (the bf16 values, widened)
  lr/10         ``make_train_step`` at peak lr 3e-5, with the kernels

It prints each step's loss, grad norm, lr and time, then the card's name
and power limit, then one JSON line of every arm's trajectory.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_LR, WARMUP = 3e-4, 20  # launch.train's defaults
ARMS = {
    "compressed": dict(compressed=True),
    "uncompressed": dict(),
    "plain": dict(impl="ref"),
    "f32": dict(f32=True),
    "lr/10": dict(lr_scale=0.1),
}


def run_arm(torch, arch, cfg, dev, batches, *, compressed=False, impl=None, f32=False,
            lr_scale=1.0) -> dict:
    from repro_torch.launch import mesh, steps, train
    from repro_torch.optim import adamw, compress

    init_dtype = cfg.dtype
    if f32:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    model = arch.init(torch.Generator(dev).manual_seed(0), cfg, device=dev)
    with torch.no_grad():
        for p in model.parameters():  # the other arms' starting values
            p.copy_(p.to(init_dtype))
    params = steps.trainable(model)
    opt = adamw.init(params)
    opt_cfg = adamw.AdamWConfig(peak_lr=PEAK_LR * lr_scale, warmup_steps=WARMUP,
                                total_steps=len(batches))
    if compressed:
        cstep = train.make_compressed_dp_step(arch, cfg, opt_cfg, mesh.make_data_group(dev),
                                              impl=impl)
        resid = compress.init_residuals(params)

        def step(m, o, b):
            m, o, _, met = cstep(m, o, resid, b)
            return m, o, met
    else:
        step = steps.make_train_step(arch, cfg, opt_cfg, impl=impl)
    out = {"loss": [], "grad_norm": [], "lr": [], "step_s": []}
    for b in batches:
        t0 = time.perf_counter()
        model, opt, met = step(model, opt, b)
        loss = float(met["loss"])  # waits for the step
        out["step_s"].append(time.perf_counter() - t0)
        out["loss"].append(loss)
        out["grad_norm"].append(float(met["grad_norm"]))
        out["lr"].append(float(met["lr"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None, help="default: cuda; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
    from repro_torch.device import resolve_device
    from repro_torch.launch import steps

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    arch = get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.full
    pipe = SyntheticPipeline(PipelineConfig(vocab=cfg.vocab, seq=args.seq,
                                            global_batch=args.batch, seed=0))
    batches = [steps.batch_to_torch(pipe.batch_at(i), dev) for i in range(args.steps)]
    result = {}
    for name, kw in ARMS.items():
        result[name] = run_arm(torch, arch, cfg, dev, batches, **kw)
        for i, (loss, gn, lr, t) in enumerate(zip(*(result[name][k] for k in (
                "loss", "grad_norm", "lr", "step_s")))):
            print(f"[trajectory] {args.arch} {name} step {i + 1}: loss {loss:.4f}, grad norm "
                  f"{gn:.4f}, lr {lr:.3g}, {t:.3f} s", flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(f"[trajectory] {smi}; torch {torch.__version__}", flush=True)
    print(json.dumps({"arch": args.arch, "batch": args.batch, "seq": args.seq,
                      "arms": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
