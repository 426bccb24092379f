"""Every touchpoint between the benchmark and the program under test, the
PyTorch port (``repro_torch``): its configuration built from a
configuration file, its model made from the benchmark's weights, its
training step and its serving entries, and the spans and counters read
from it. Nothing else in the harness imports the port.
"""

from __future__ import annotations

import contextlib
import importlib
import time
from typing import Dict

import torch

# the port's norms take this epsilon; a configuration that states another
# cannot run on it as stated
PORT_NORM_EPS = 1e-6


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["torch_dtype"])


def arch_and_config(cfg: dict):
    """(ArchDef, LMConfig) of the port for a configuration file: the
    port's config of ``cfg["arch"]`` with the file's sizes in place, by
    ``chipbench/adapters/<family>.py``. Raises where the file states what
    the port cannot run."""
    from repro_torch.configs import get_arch

    arch = get_arch(cfg["arch"])
    if cfg["norm_epsilon"] != PORT_NORM_EPS:
        raise ValueError(f"{cfg['arch']}: the port's norms take eps {PORT_NORM_EPS}, "
                         f"the file states {cfg['norm_epsilon']}")
    adapter = importlib.import_module(f"chipbench.adapters.{cfg['family']}")
    return arch, adapter.port_config(cfg, arch.full, vocab=cfg["vocab_size"],
                                     dtype=dtype_of(cfg), tie_embeddings=True)


def build_model(arch, lm_cfg, weights: Dict[str, torch.Tensor]):
    """The port's model (built on the meta device) holding ``weights`` as
    its parameters; raises unless names, shapes and dtypes all match."""
    from repro_torch.launch import steps

    model = arch.init(None, lm_cfg, device="meta")
    have = {n: (tuple(p.shape), p.dtype) for n, p in model.named_parameters()}
    want = {n: (tuple(w.shape), w.dtype) for n, w in weights.items()}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))[:4]
        raise ValueError(f"the port's parameters differ from the benchmark's: {diff}")
    return steps.assign(model, weights)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def adamw_config(opt: dict):
    from repro_torch.optim import adamw

    return adamw.AdamWConfig(
        peak_lr=opt["peak_lr"], warmup_steps=opt["warmup_steps"],
        total_steps=opt["total_steps"], end_lr_frac=opt["end_lr_frac"], b1=opt["b1"],
        b2=opt["b2"], eps=opt["eps"], weight_decay=opt["weight_decay"],
        clip_norm=opt["clip_norm"])


def train_state(arch, lm_cfg, weights, device, opt: dict):
    """(step, model, AdamW state, residuals): the port's compressed
    data-parallel step over this process's one-rank group (``init_world``:
    NCCL on the card, gloo on the host, its store under the temporary
    directory), and the state that it updates in place."""
    from repro_torch.launch import mesh, steps, train
    from repro_torch.optim import adamw, compress

    model = build_model(arch, lm_cfg, weights)
    params = steps.trainable(model)
    group = mesh.make_data_group(torch.device(device))
    step = train.make_compressed_dp_step(arch, lm_cfg, adamw_config(opt), group)
    return step, model, adamw.init(params), compress.init_residuals(params)


def first_grad_norms(opt_state, b1: float) -> Dict[str, float]:
    """Each leaf's first gradient as AdamW took it, from its first moment
    after one step: m = (1 - b1) g."""
    return {k: float(torch.linalg.vector_norm(m)) / (1 - b1) for k, m in opt_state["m"].items()}


def change_norms(model, first: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(p.detach().float() - first[k].float()))
            for k, p in model.named_parameters()}


class Stamp:
    """A point in the device's stream: a CUDA event on the card, the host
    clock elsewhere."""

    def __init__(self, device):
        self.event = (torch.cuda.Event(enable_timing=True)
                      if torch.device(device).type == "cuda" else None)
        self.t = 0.0

    def record(self) -> "Stamp":
        if self.event is None:
            self.t = time.perf_counter()
        else:
            self.event.record()
        return self

    def ms_to(self, end: "Stamp") -> float:
        """Milliseconds from this stamp to ``end`` (both recorded, the
        device synchronised)."""
        if self.event is None:
            return (end.t - self.t) * 1e3
        return self.event.elapsed_time(end.event)


@contextlib.contextmanager
def step_spans(device, record: Dict[str, list]):
    """While open, the calls that the compressed step makes into each layer
    (loss and gradients, compression, AdamW) record stamps around them
    into ``record[name]`` as (start, end) pairs. The step itself is not
    changed: the module attributes that it calls are wrapped."""
    from repro_torch.launch import steps
    from repro_torch.optim import adamw, compress

    targets = [(steps, "loss_and_grads", "loss_and_grads"),
               (compress, "compressed_grad_tree", "compressed_grad_tree"),
               (adamw, "update", "adamw_update")]
    saved = [(module, attr, getattr(module, attr)) for module, attr, _ in targets]
    for (module, attr, name), (_, _, fn) in zip(targets, saved):

        def wrapped(*args, _fn=fn, _name=name, **kw):
            start = Stamp(device).record()
            out = _fn(*args, **kw)
            record.setdefault(_name, []).append((start, Stamp(device).record()))
            return out

        setattr(module, attr, wrapped)
    try:
        yield record
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)


def launches() -> Dict[str, int]:
    from repro_torch.kernels import ops

    return dict(ops.LAUNCHES)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def prefill_fn(arch, lm_cfg, max_cache_len: int):
    """The serving path's prefill and greedy first token:
    ``fn(model, tokens) -> (caches, first tokens (b, 1))``."""
    from repro_torch.launch import steps

    prefill = steps.make_prefill(arch, lm_cfg, max_cache_len=max_cache_len)

    def fn(model, tokens):
        caches, logits = prefill(model, {"tokens": tokens})
        return caches, steps.greedy(logits)

    return fn


def last_kv(caches):
    """(k, v) of a prefill's last attention cache (b, hk, L, dh), or None
    where no cache holds keys. The port keeps a shared block's caches after
    the layers', one a call, so this is the last attention call's, made by a
    layer or a shared block: the reference's ``last_kv_layer`` is the layer
    it is compared with."""
    for cache in reversed(caches):
        if "k" in cache:
            return cache["k"], cache["v"]
    return None
