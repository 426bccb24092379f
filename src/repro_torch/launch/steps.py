"""Step functions, the reference's ``launch/steps.py``: ``make_train_step``,
``make_prefill`` and ``make_serve_step``, and the shardings of their inputs.

PyTorch runs eagerly, so a step is a plain function of (model, inputs);
``impl="ref"`` runs every kernel's plain version instead. A train step
updates the model and the optimizer state in place (``optim/adamw.py``)
and returns them. The shardings of every input come from
``parallel/sharding.py`` (``named``, ``train_shardings``); the
activation policy (sequence parallelism for head-indivisible archs) and the
FSDP gather are installed around a step by ``activation_policy`` and
``fsdp_policy`` (``parallel/context.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchDef
from repro_torch.optim import adamw
from repro_torch.parallel import context as pctx
from repro_torch.parallel import sharding as shd


def trainable(model: torch.nn.Module) -> Dict[str, torch.nn.Parameter]:
    """Turn gradients on for every parameter (a model is built for
    serving, without them); returns {name: parameter}."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def assign(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> torch.nn.Module:
    """Make ``params`` ({name: tensor}; DTensors too) ``model``'s parameters
    in place of its own, keeping each one's ``requires_grad``."""
    for name, t in params.items():
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner)
        module._parameters[leaf] = torch.nn.Parameter(
            t, requires_grad=module._parameters[leaf].requires_grad)
    return model


def batch_to_torch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy) on ``device``; token ids as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if not t.is_floating_point() else t).to(device)
    return out


def loss_and_grads(arch: ArchDef, cfg, model, batch, *, impl: Optional[str] = None):
    """(loss, parts, grads {name: tensor in the parameter's dtype}) of one
    batch. Every parameter must get a gradient: one that is left out of
    the graph (a kernel output without a ``grad_fn``, say) raises."""
    params = dict(model.named_parameters())
    loss, parts = arch.loss_fn(cfg, model, batch, impl=impl)
    grads = torch.autograd.grad(loss, list(params.values()))
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            dict(zip(params, grads)))


def make_train_step(arch: ArchDef, cfg, opt_cfg: adamw.AdamWConfig, *, accum: int = 1,
                    impl: Optional[str] = None):
    """``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``
    with metrics {loss, ce, lb, z, lr, grad_norm} (0-d tensors).

    ``accum``: gradient-accumulation microbatches. As in the reference,
    the MINOR part of the batch axis is split (microbatch i takes rows
    i, i + accum, ...), gradients are summed in f32 and averaged (so they
    reach AdamW as f32), and the loss and its parts are averaged."""

    def train_step(model, opt_state, batch):
        params = trainable(model)
        if accum > 1:
            gsum = None
            lsum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            parts_all = []
            for i in range(accum):
                mb = {k: microbatch(v, i, accum) for k, v in batch.items()}
                loss, parts, grads = loss_and_grads(arch, cfg, model, mb, impl=impl)
                # the first microbatch's gradients start the sum (0 + g is
                # g), so a DTensor gradient's partial sum over the data
                # axis stays partial until the optimizer reduces it once
                if gsum is None:
                    gsum = {k: g.to(torch.float32) for k, g in grads.items()}
                else:
                    for k, g in grads.items():
                        gsum[k] += g.to(torch.float32)
                lsum = lsum + loss
                parts_all.append(parts)
            grads = {k: g / accum for k, g in gsum.items()}
            loss = lsum / accum
            parts = {k: torch.stack([p[k] for p in parts_all]).mean() for k in parts_all[0]}
        else:
            loss, parts, grads = loss_and_grads(arch, cfg, model, batch, impl=impl)
        metrics = adamw.update(opt_cfg, params, grads, opt_state)
        return model, opt_state, {"loss": loss, **parts, **metrics}

    return train_step


def microbatch(x: torch.Tensor, i: int, accum: int) -> torch.Tensor:
    """Rows i, i + accum, ... of ``x``. A DTensor whose rows are split
    evenly in multiples of ``accum`` a rank takes them from each rank's
    own rows: those are the same global rows, and the batch keeps its
    data sharding, as the reference's split of the minor part does."""
    if pctx.is_dtensor(x) and any(p.is_shard(0) for p in x.placements):
        from torch.distributed.tensor import DTensor

        local = x.to_local()
        if local.shape[0] % accum == 0 and x.shape[0] == local.shape[0] * math.prod(
                x.device_mesh.size(d) for d, p in enumerate(x.placements) if p.is_shard(0)):
            return DTensor.from_local(local[i::accum], x.device_mesh, x.placements,
                                      run_check=False)
    return x[i::accum]


def make_prefill(arch: ArchDef, cfg, *, max_cache_len: int, impl: Optional[str] = None):
    def prefill_step(model, batch):
        return arch.prefill(cfg, model, batch, max_cache_len=max_cache_len, impl=impl)

    return prefill_step


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """(b, s, vocab) -> (b, 1) next tokens: argmax of the last position,
    first index on ties (torch.argmax's rule, as jnp.argmax's); a DTensor
    split over the vocab takes each rank's (max, index) and gathers those
    pairs only (``context.vocab_argmax``)."""
    last = logits[:, -1]
    if pctx.is_dtensor(last) and any(p.is_shard(1) for p in last.placements):
        return pctx.vocab_argmax(last)[:, None]
    return torch.argmax(last, dim=-1)[:, None]


def make_serve_step(arch: ArchDef, cfg, *, impl: Optional[str] = None):
    """One decode step: greedy next token against the caches."""

    def serve_step(model, caches, token):
        caches, logits = arch.decode_step(cfg, model, caches, token, impl=impl)
        return caches, greedy(logits), logits

    return serve_step


# ---------------------------------------------------------------------------
# shardings for each entry point
# ---------------------------------------------------------------------------


def named(mesh, spec_tree):
    """A spec tree as the same tree of ``NamedSharding`` on ``mesh``."""
    return shd.map_tree(lambda _, spec: shd.NamedSharding(mesh, spec), spec_tree)


def abstract_train_state(arch: ArchDef, cfg):
    """(params {name: tensor}, AdamW state) on the meta device: shapes and
    dtypes, nothing allocated."""
    params = dict(arch.init(None, cfg, device="meta").named_parameters())
    return params, adamw.init(params)


def train_shardings(arch: ArchDef, cfg, mesh, cell, params_abs, opt_abs, batch_abs):
    pspec = shd.param_specs(params_abs, arch, mesh)
    ospec = shd.opt_state_specs(opt_abs, pspec, mesh, arch)
    bspec = shd.batch_specs(batch_abs, cell, mesh)
    return named(mesh, pspec), named(mesh, ospec), named(mesh, bspec)


@contextlib.contextmanager
def activation_policy(arch: ArchDef, cell, mesh):
    """The step's activation sharding on ``mesh``; inside it a plain tensor
    that meets a DTensor (positions, masks, constants) is taken as
    replicated."""
    from torch.distributed.tensor.experimental import implicit_replication

    spec = shd.activation_spec(arch, cell, mesh)
    sharding = None if spec is None else shd.NamedSharding(mesh, spec)
    with pctx.activation_sharding(sharding), implicit_replication():
        yield


def fsdp_policy(arch: ArchDef, cfg, mesh, params_abs):
    """When FSDP sharded any layer's weight, install the per-layer gather
    (``pctx.constrain_group_params``), so one layer's weights are
    all-gathered at a time instead of the whole model."""
    full = shd.param_specs(params_abs, arch, mesh, fsdp=True)
    tp = shd.param_specs(params_abs, arch, mesh, fsdp=False)
    if full == tp:
        return contextlib.nullcontext()
    return pctx.param_gather_sharding(mesh)
