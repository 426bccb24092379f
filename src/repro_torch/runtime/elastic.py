"""Elastic scaling controller: re-mesh a running job on capacity events,
the reference's ``runtime/elastic.py``.

Glues the pieces the rest of the framework provides:
  * capacity events (node failures, preemptions, quota changes) arrive as
    "the new device pool is D chips";
  * ``core.engine.PlanningEngine`` picks the energy-optimal slice <= D for
    the workload -- the pool cap rides in as an engine ``Constraints``
    (max_cores), so the argmin itself respects the pool (the paper's method
    is the scaling policy);
  * checkpoint + reshard + resume: tensors are stored whole, so restoring
    onto the new mesh is ``distribute_tensor`` with the new placements.

A mesh is a ``DeviceMesh`` over the whole world of ranks
(``launch/mesh.py``): gloo ranks on the host, one NCCL rank a card. So the
controller builds the slice it planned only where that slice is the
world; on a fleet, workers restart into the new world from the shared
checkpoint. Where the model axis is 1, every spec is ``()``: the placed
tree is ``Replicate()`` everywhere, and ``train_compressed`` resumes the
training step on the local tensors, as the reference's replicated
``shard_map`` does.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.manager import CheckpointManager, reshard
from repro_torch.configs.base import ArchDef, ShapeCell
from repro_torch.core.engine import Constraints, Workload
from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import init_world, make_data_group, make_mesh
from repro_torch.optim import adamw, compress
from repro_torch.parallel import sharding as shd


@dataclasses.dataclass
class ElasticEvent:
    available_chips: int
    reason: str = "capacity-change"
    time: float = dataclasses.field(default_factory=time.time)


def mesh_shape_for(chips: int, prefer_model: int = 16):
    """(data, model) shape for a chip budget: keep the model axis at the
    arch-validated width when possible, spend the rest on data."""
    model = min(prefer_model, chips)
    while chips % model:
        model //= 2
    return (chips // model, model)


def _abstract(tree):
    """``tree``'s shapes and dtypes on the meta device (a restore template)."""
    if isinstance(tree, dict):
        return {k: _abstract(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def local(tree):
    """Every DTensor leaf as its local tensor (the whole tensor where the
    placements replicate it)."""
    if isinstance(tree, dict):
        return {k: local(v) for k, v in tree.items()}
    return tree.to_local() if isinstance(tree, DTensor) else tree


class ElasticController:
    """Owns the (mesh, shardings) of a training job and rebuilds them on
    elastic events."""

    def __init__(
        self,
        arch: ArchDef,
        cfg,
        cell: ShapeCell,
        opt_cfg,
        ckpt: CheckpointManager,
        *,
        planner=None,
        prefer_model: int = 16,
        device=None,
    ):
        self.arch = arch
        self.cfg = cfg
        self.cell = cell
        self.opt_cfg = opt_cfg
        self.ckpt = ckpt
        self.planner = planner
        self.prefer_model = prefer_model
        self.device = device
        self.mesh = None
        self.plan = None  # the engine's plan at the last event
        self.events: list[ElasticEvent] = []

    def _choose_chips(self, available: int) -> int:
        """Energy-optimal slice within the pool, straight from the engine.

        ``planner`` may be a ``PlanningEngine`` or the legacy
        ``EnergyOptimalPlanner`` shim (which carries one as ``.engine``).
        The pool cap is an engine constraint, so the argmin itself honors
        it. When the cap is infeasible the engine's fastest-grid-point
        fallback may exceed the pool; the chosen slice then snaps to the
        engine's ``ConfigSpace`` -- the largest grid parallelism value that
        fits -- so a TPU chip pool between grid points still re-plans onto
        a real configuration (the CPU space's unit-step core grid makes
        the snap the identity there). Only a pool below the space's grid
        floor takes everything it has."""
        if self.planner is None:
            return available
        engine = getattr(self.planner, "engine", self.planner)
        plan = self.plan = engine.plan(
            Workload(
                self.arch.arch_id,
                self.cell,
                constraints=Constraints(max_cores=available),
            )
        )
        if plan.chips <= available:
            return plan.chips
        space = getattr(engine, "space", None)
        cap = space.snap_cap(available) if space is not None else None
        return cap if cap is not None else min(plan.chips, available)

    def build(self, chips: int):
        """The (data, model) mesh of ``chips`` ranks; ``make_mesh`` raises
        unless they are the world."""
        shape = mesh_shape_for(chips, self.prefer_model)
        self.mesh = make_mesh(shape, ("data", "model"), self.device)
        return self.mesh

    def shardings_for(self, params, opt_state):
        pspec = shd.param_specs(params, self.arch, self.mesh)
        ospec = shd.opt_state_specs(opt_state, pspec, self.mesh, self.arch)
        return (
            steps_mod.named(self.mesh, pspec),
            steps_mod.named(self.mesh, ospec),
        )

    def handle_event(self, event: ElasticEvent, params, opt_state, step: int):
        """Checkpoint on the old mesh, rebuild for the new pool, restore.

        ``params`` is {name: tensor}, ``opt_state`` the AdamW state (plain
        tensors or DTensors). Returns (params, opt_state) placed on the
        new mesh."""
        self.events.append(event)
        state = {"params": params, "opt_state": opt_state}
        self.ckpt.save(step, state)
        self.build(self._choose_chips(event.available_chips))
        host_state = self.ckpt.restore(step, _abstract(state))
        psh, osh = self.shardings_for(host_state["params"], host_state["opt_state"])
        return reshard(host_state["params"], psh), reshard(host_state["opt_state"], osh)


def train_compressed(arch: ArchDef, cfg, opt_cfg, cell: ShapeCell, n_steps: int, *,
                     controller: Optional[ElasticController] = None, events=None,
                     seed: int = 0, device=None) -> list:
    """``n_steps`` of ``launch.train``'s compressed data-parallel step over
    the world, from ``seed``, on batches of ``cell``'s shape. After step s,
    ``events[s]`` goes to ``controller.handle_event``, and training resumes
    on the placed state's local tensors, which hold the whole tensors: the
    new mesh's model axis must be 1. The error-feedback residuals stay on
    their rank. Returns the losses."""
    dev = resolve_device(device)
    world = init_world(dev)
    group = make_data_group(dev, (world, 1))
    model = arch.init(torch.Generator(dev).manual_seed(seed), cfg, device=dev)
    params = steps_mod.trainable(model)
    opt, resid = adamw.init(params), compress.init_residuals(params)
    cstep = train_mod.make_compressed_dp_step(arch, cfg, opt_cfg, group)
    pipe = SyntheticPipeline(PipelineConfig(vocab=cfg.vocab, seq=cell.seq,
                                            global_batch=cell.batch, seed=seed))
    events = events or {}
    losses = []
    for step in range(1, n_steps + 1):
        _, opt, resid, m = cstep(model, opt, resid, steps_mod.batch_to_torch(pipe.next(), dev))
        losses.append(float(m["loss"]))
        if step in events:
            placed_p, placed_o = controller.handle_event(
                events[step], dict(model.named_parameters()), opt, step)
            if shd.model_size(controller.mesh) != 1:
                raise ValueError(f"training resumes on a (data, 1) mesh; the controller "
                                 f"built {tuple(controller.mesh.shape)}")
            steps_mod.assign(model, local(placed_p))
            opt = local(placed_o)
    return losses
