"""End-to-end training entry point, the reference's ``launch/train.py``.

    python -m repro_torch.launch.train --arch starcoder2-3b --batch 2 \
        --seq 4096 --steps 10 --compress          # on the card
    python -m repro_torch.launch.train --arch mamba2-130m --smoke \
        --steps 20 --device cpu                   # on the host

Wired in as in the reference: the deterministic resumable data pipeline,
AdamW with its schedule, async checkpoints with preemption-safe restart
(SIGTERM), straggler telemetry, and optional int8 error-feedback gradient
compression over the data axis (``--compress``: NCCL on the card, gloo on
the host; one rank unless ``torchrun`` starts more). ``--mesh DxM`` lays
the world's D * M ranks out as a (data, model) mesh: as in the reference,
the compressed step replicates the parameters over both axes and splits
the batch and the gradient reduction over ``data`` only, so the M ranks of
one data index take the same step.
``--auto-energy`` logs the planner's energy-optimal (f, chips) plan for
the run's shape (``core/planner.py``), from the arch's dry-run artifact
where one exists, else the analytic roofline (``engine.terms_analytic``).
Weights are random, from a seeded ``torch.Generator`` on the device; the
model, its AdamW state and the error-feedback residuals are updated in
place. An encoder-decoder's batches carry ``--seq`` encoder frames and
min(seq, max_target_len) decoder tokens; a VLM's carry its image patches,
as the reference's pipeline draws them.
"""

from __future__ import annotations

import argparse
import itertools
import os
import tempfile
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch import obs
from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh
from repro_torch.launch import steps as steps_mod
from repro_torch.launch.serve import resolve_arch
from repro_torch.optim import adamw, compress
from repro_torch.runtime.trainer import Trainer

DEFAULT_CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


def make_compressed_dp_step(arch, cfg, opt_cfg, group, *, impl: Optional[str] = None):
    """Data-parallel training with int8 error-feedback gradient reduction
    over ``group`` (the reference's ``make_compressed_dp_step`` body):
    each rank takes its contiguous slice of the batch, then loss and
    gradients, compression, the mean of the loss over the group, AdamW.
    ``step(model, opt_state, residuals, batch) -> (model, opt_state,
    residuals, metrics {loss, lr, grad_norm})``. Under a recorder each
    call is a ``train.step`` span (``args.step`` counts the calls) around
    ``train.loss_and_grads``, ``train.compress`` and ``train.adamw``."""
    count = itertools.count()

    def step(model, opt_state, residuals, batch):
        with obs.span("train.step", cat="train", step=next(count)):
            world, rank = dist.get_world_size(group), dist.get_rank(group)
            local = {k: v.chunk(world)[rank] for k, v in batch.items()}
            params = steps_mod.trainable(model)
            with obs.span("train.loss_and_grads", cat="train"):
                loss, _, grads = steps_mod.loss_and_grads(arch, cfg, model, local, impl=impl)
            with obs.span("train.compress", cat="train"):
                grads, residuals = compress.compressed_grad_tree(grads, residuals, group,
                                                                 impl=impl)
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss = loss / world
            with obs.span("train.adamw", cat="train"):
                metrics = adamw.update(opt_cfg, params, grads, opt_state)
        return model, opt_state, residuals, {"loss": loss, **metrics}

    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="example-10m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", default="", help="e.g. 2x4 -> (data, model); default: all data")
    ap.add_argument("--compress", action="store_true", help="int8 EF grads (DP)")
    ap.add_argument("--auto-energy", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="default: cuda; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch, cfg = resolve_arch(args.arch, args.smoke)
    opt_cfg = adamw.AdamWConfig(
        peak_lr=args.lr, warmup_steps=args.warmup, total_steps=max(args.steps, 1))
    pcfg = PipelineConfig(vocab=cfg.vocab, seq=args.seq, global_batch=args.batch,
                          seed=args.seed)
    if arch.is_encdec():
        pcfg = PipelineConfig(vocab=cfg.vocab, seq=min(args.seq, cfg.max_target_len),
                              global_batch=args.batch, seed=args.seed, n_frames=args.seq,
                              d_frame=cfg.d_model)
    if getattr(cfg, "vision", None) is not None:
        pcfg.n_patches = cfg.vision.n_patches
        pcfg.d_vision = cfg.vision.d_vision
    pipeline = SyntheticPipeline(pcfg)

    if args.auto_energy:
        from repro_torch.configs.base import ShapeCell
        from repro_torch.core.planner import EnergyOptimalPlanner

        planner = EnergyOptimalPlanner.default(device=dev)
        plan = planner.plan_for_workload(
            arch_id=args.arch,
            cell=ShapeCell("train", args.seq, args.batch, "train"),
        )
        obs.log(f"[auto-energy] {plan.summary()}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = arch.init(gen, cfg, device=dev)
    params = steps_mod.trainable(model)
    opt_state = adamw.init(params)
    n_params = sum(p.numel() for p in params.values())
    obs.log(f"arch={cfg.name} params={n_params:,} device={dev}")

    if args.compress:
        group = mesh.make_data_group(dev, mesh.parse_mesh(args.mesh, mesh.init_world(dev)))
        cstep = make_compressed_dp_step(arch, cfg, opt_cfg, group)
        state = {"residuals": compress.init_residuals(params)}

        def train_step(model, opt_state, batch):
            model, opt_state, state["residuals"], metrics = cstep(
                model, opt_state, state["residuals"], steps_mod.batch_to_torch(batch, dev))
            return model, opt_state, metrics

    else:
        base_step = steps_mod.make_train_step(arch, cfg, opt_cfg)

        def train_step(model, opt_state, batch):
            return base_step(model, opt_state, steps_mod.batch_to_torch(batch, dev))

    def on_metrics(step, m):
        if step % args.log_every == 0 or step == 1:
            obs.log(
                f"step {step:5d} loss {float(m['loss']):.4f} "
                f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f} "
                f"({m['step_time_s']*1e3:.0f} ms)",
                flush=True,
            )

    trainer = Trainer(
        train_step=train_step,
        params=model,
        opt_state=opt_state,
        pipeline=pipeline,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        on_metrics=on_metrics,
    )
    if trainer.try_restore():
        obs.log(f"resumed from step {trainer.step}")
    result = trainer.run(args.steps)
    obs.log(
        f"exit={result['exit']} step={result['step']} "
        f"final_loss={result['history'][-1]['loss']:.4f}"
        if result["history"]
        else f"exit={result['exit']}"
    )
    return result


if __name__ == "__main__":
    main()
