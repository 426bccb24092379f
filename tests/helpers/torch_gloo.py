"""Gloo worlds on the host for the port's distribution tests
(``tests/test_torch_distributed.py``, ``tests/test_torch_elastic.py``,
``tests/test_torch_train.py``) and ``chip_smoke.py`` phase 10c. Imports no
JAX, so each rank starts quickly, and nothing of ``chip_smoke.py``.

``spawn(world, workdir, jobs, timeout=)`` starts ``world`` processes
(forked from a fork server that has imported torch and the port once, so
a rank starts in well under a second), each of which brings up the world (a ``FileStore`` in ``workdir``, one
intra-op thread a rank: the ranks share the host's cores with the other
tests) and runs the ``jobs`` in it, in order: each a (name, args) of
``JOBS``, ``JOBS[name](workdir, *args) -> output``. It waits for them
within ``timeout`` seconds: a rank that hangs (a collective another rank
skipped) fails its test, not the suite. It returns each rank's list of
outputs. ``shutdown()`` stops the fork server (and the resource tracker)
that the first ``spawn`` started; a script calls it before it exits, so
that it leaves no process behind.
"""

import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


# what every rank imports, imported once by the fork server the ranks
# are forked from (a fresh process that has started no thread)
PRELOAD = ["torch", "torch.distributed.tensor", "numpy", "repro_torch.launch.train",
           "repro_torch.runtime.elastic", "repro_torch.configs"]


def spawn(world: int, workdir, jobs, timeout: float = 120.0) -> list:
    mp.set_forkserver_preload(PRELOAD)
    ctx = mp.start_processes(_rank, args=(world, str(workdir), list(jobs)), nprocs=world,
                             join=False, start_method="forkserver")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(10)
            raise TimeoutError(f"{world} gloo ranks of {[n for n, _ in jobs]} took over "
                               f"{timeout} s")
    outs = []
    for rank in range(world):
        with open(os.path.join(workdir, f"out_{rank}.json")) as f:
            outs.append(json.load(f))
    return outs


def shutdown() -> None:
    """Stop the fork server the ranks were forked from, then the resource
    tracker it shared with this process, and wait for both to exit (each
    stops when its last pipe closes; neither runs if no world was
    spawned)."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def _rank(rank: int, world: int, workdir: str, jobs) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    out = [JOBS[name](workdir, *args) for name, args in jobs]
    with open(os.path.join(workdir, f"out_{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def train(workdir: str, argv: list) -> dict:
    """``launch.train.main(argv)`` on this rank: its losses."""
    from repro_torch.launch import train as train_mod

    result = train_mod.main(argv)
    return {"losses": [h["loss"] for h in result["history"]], "step": result["step"]}


def _model(arch, cfg, workdir: str):
    """The SMOKE model with the weights in ``weights_<arch>.npz`` (float32)."""
    model = arch.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    with np.load(os.path.join(workdir, f"weights_{arch.arch_id}.npz")) as z:
        model.load_state_dict({k: torch.from_numpy(z[k]) for k in z.files})
    return model


def _batch(workdir: str, arch_id: str, seq: int) -> dict:
    with np.load(os.path.join(workdir, f"b{seq}_{arch_id}.npz")) as z:
        return {k: torch.from_numpy(z[k]).long() for k in z.files}


def loss_on(arch, cfg, model, params, batch, mesh, cell) -> float:
    """The loss with ``params`` (placed on ``mesh``) as the model's weights
    and the batch split by the batch rules, under the activation policy."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as shd

    steps.assign(model, params)
    bspec = shd.batch_specs(batch, cell, mesh)
    placed = {k: distribute_tensor(v, mesh, shd.placements(bspec[k], mesh))
              for k, v in batch.items()}
    with torch.no_grad(), steps.activation_policy(arch, cell, mesh):
        loss = arch.loss_fn(cfg, model, placed)[0]
    return float(loss.full_tensor())


def remesh(workdir: str, arch_ids, save_shape, shapes, seq: int) -> dict:
    """The elastic re-mesh (the reference's distributed check 3), for each
    of ``arch_ids`` at SMOKE width: the weights placed on ``save_shape`` are
    checkpointed, then restored (``restore_latest``) and resharded onto
    each of ``shapes``; for each, whether every leaf is bit for bit the
    weights, and the loss there on the batch of sequence ``seq``."""
    from repro_torch.checkpoint.manager import CheckpointManager, reshard
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as shd

    meshes = {}

    def placed_on(shape, tree, arch):
        if shape not in meshes:
            meshes[shape] = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
        mesh = meshes[shape]
        return mesh, reshard(tree, steps.named(mesh, shd.param_specs(tree, arch, mesh)))

    out = {}
    for arch_id in arch_ids:
        arch = get_arch(arch_id)
        cfg = arch.smoke
        model = _model(arch, cfg, workdir)
        host = {k: v.detach().clone() for k, v in model.named_parameters()}
        batch = _batch(workdir, arch_id, seq)
        cell = ShapeCell("t", seq, batch["tokens"].shape[0], "train")
        _, on_a = placed_on(tuple(save_shape), host, arch)
        mgr = CheckpointManager(os.path.join(workdir, "ckpt", arch_id))
        mgr.save(5, {"params": on_a})
        rows = []
        abstract = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                    for k, v in host.items()}
        for shape in map(tuple, shapes):
            step, restored = mgr.restore_latest({"params": abstract})
            mesh, placed = placed_on(shape, restored["params"], arch)
            same = all(torch.equal(placed[k].full_tensor(), host[k]) for k in host)
            sharded = sum(1 for t in placed.values() if any(p.is_shard() for p in t.placements))
            rows.append({"shape": list(shape), "step": step, "same": same,
                         "sharded_leaves": sharded, "tp_mode": shd.tp_mode(arch, mesh),
                         "loss": loss_on(arch, cfg, model, placed, batch, mesh, cell)})
        out[arch_id] = rows
    return out


def constrain_seq(workdir: str, shape, seq: int) -> dict:
    """``constrain`` under gemma3-12b's 'seq' policy on ``shape``: a
    replicated (b, s, d) DTensor comes back split over the sequence (and
    the batch over data), with the same values; outside the policy it is
    returned as it is. Then ``constrain_group_params`` under
    ``param_gather_sharding``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.models import common
    from repro_torch.parallel import context as pctx

    arch = get_arch("gemma3-12b")
    mesh = mesh_mod.make_mesh(shape, ("data", "model"), "cpu")
    h = torch.randn((8, seq, 16), generator=torch.Generator().manual_seed(3))
    hd = distribute_tensor(h, mesh, [Replicate(), Replicate()])
    with steps.activation_policy(arch, ShapeCell("t", seq, 8, "train"), mesh):
        got = pctx.constrain(hd)
        odd = pctx.constrain(distribute_tensor(h[:, :seq - 1], mesh, [Replicate()] * 2))
    out = {"before": [repr(p) for p in hd.placements], "after": [repr(p) for p in got.placements],
           "same": bool(torch.equal(got.full_tensor(), h)),
           "odd_after": [repr(p) for p in odd.placements],
           "outside": pctx.constrain(hd) is hd}
    # the FSDP gather: a layer's weight split over data comes back whole
    # over data (a copy of the layer; the layer keeps its placements)
    layer = common.Linear(16, 12, bias=True, dtype=torch.float32,
                          generator=torch.Generator().manual_seed(4), device="cpu")
    w = layer.w.detach().clone()
    steps.assign(layer, {"w": distribute_tensor(w, mesh, [Shard(0), Shard(1)]),
                         "b": distribute_tensor(layer.b.detach(), mesh, [Replicate()] * 2)})
    with pctx.param_gather_sharding(mesh):
        gathered = pctx.constrain_group_params(layer)
    out.update(gathered=[repr(p) for p in gathered.w.placements],
               kept=[repr(p) for p in layer.w.placements],
               gathered_same=bool(torch.equal(gathered.w.full_tensor(), w)),
               no_policy=pctx.constrain_group_params(layer) is layer)
    return out


def elastic(workdir: str) -> dict:
    """``chip_smoke.py`` phase 10b's run at SMOKE width on this rank:
    mamba2-130m, batch 4 x 32, trained by ``elastic.train_compressed``
    uninterrupted and under an ``ElasticController`` that plans on a
    ``PlanningEngine`` and re-meshes after step 2 onto a pool of the
    world."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.core.planner import EnergyOptimalPlanner
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.optim import adamw
    from repro_torch.runtime import elastic as el

    arch = get_arch("mamba2-130m")
    cfg, cell = arch.smoke, ShapeCell("train", 32, 4, "train")
    opt_cfg = adamw.AdamWConfig(peak_lr=3e-4, warmup_steps=2, total_steps=4)
    ckpt_dir = os.path.join(workdir, "elastic_ckpt")
    ctl = el.ElasticController(arch, cfg, cell, opt_cfg, CheckpointManager(ckpt_dir),
                               planner=EnergyOptimalPlanner.default(device="cpu"),
                               prefer_model=1, device="cpu")
    event = el.ElasticEvent(available_chips=dist.get_world_size(), reason="re-mesh")
    resumed = el.train_compressed(arch, cfg, opt_cfg, cell, 4, controller=ctl,
                                  events={2: event}, device="cpu")
    plain = el.train_compressed(arch, cfg, opt_cfg, cell, 4, device="cpu")
    return {"losses": resumed, "uninterrupted": plain, "mesh": mesh_mod.describe(ctl.mesh),
            "plan": ctl.plan.summary(), "ckpt_steps": sorted(os.listdir(ckpt_dir))}


def tp_step(workdir: str, arch_id: str, shape, seq: int, extra: int) -> dict:
    """One arch at SMOKE width with its weights placed on a ``shape``
    mesh by the partition rules: the loss and every gradient of
    ``loss_and_grads`` on the batch of sequence ``seq``, then a prefill of
    its tokens into caches of ``seq + extra`` slots, brought to the cache
    rules' placements, and one greedy decode step. Rank 0 writes the
    gradients and the step's logits (whole) to ``tp_<arch>.npz``."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.launch import steps
    from repro_torch.parallel import sharding as shd

    arch = get_arch(arch_id)
    cfg = arch.smoke
    model = _model(arch, cfg, workdir)
    batch = _batch(workdir, arch_id, seq)
    mesh = mesh_mod.make_mesh(tuple(shape), ("data", "model"), "cpu")
    cell = ShapeCell("t", seq, batch["tokens"].shape[0], "train")
    host = {k: v.detach().clone() for k, v in model.named_parameters()}
    specs = shd.param_specs(host, arch, mesh)
    steps.assign(model, {k: distribute_tensor(v, mesh, shd.placements(specs[k], mesh))
                         for k, v in host.items()})
    steps.trainable(model)
    placed = {k: distribute_tensor(v, mesh, shd.placements(sp, mesh))
              for (k, v), sp in zip(batch.items(), shd.batch_specs(batch, cell, mesh).values())}
    with steps.activation_policy(arch, cell, mesh):
        loss, _, grads = steps.loss_and_grads(arch, cfg, model, placed)
        model.requires_grad_(False)
        with torch.no_grad():
            caches, _ = arch.prefill(cfg, model, {"tokens": placed["tokens"]},
                                     max_cache_len=seq + extra)
            cspec = shd.cache_specs(caches, arch, cell, mesh)

            def to_spec(t, sp):
                return t.redistribute(mesh, shd.placements(sp, mesh)) if hasattr(
                    t, "redistribute") else t

            caches = [{k: to_spec(v, cspec[i][k]) for k, v in c.items()}
                      for i, c in enumerate(caches)]
            token = torch.full((batch["tokens"].shape[0], 1), 3, dtype=torch.long)
            token = distribute_tensor(token, mesh, shd.placements(
                shd.batch_specs({"t": token}, cell, mesh)["t"], mesh))
            caches, step_logits = arch.decode_step(cfg, model, caches, token)
            placements = sorted({repr(tuple(c["k"].placements)) for c in caches if "k" in c})
    whole = {f"grad.{k}": g.full_tensor().numpy() for k, g in grads.items()}
    whole["logits"] = step_logits.full_tensor().numpy()
    if dist.get_rank() == 0:
        np.savez(os.path.join(workdir, f"tp_{arch_id}.npz"), **whole)
    return {"loss": float(loss.full_tensor()), "cache_placements": placements,
            "tokens": steps.greedy(step_logits).full_tensor()[:, 0].tolist()}


JOBS = {"train": train, "remesh": remesh, "constrain_seq": constrain_seq, "elastic": elastic,
        "tp_step": tp_step}
