"""Batched serving CLI: prefill a batch of prompts, decode greedily, the
reference's ``launch/serve.py``.

    python -m repro_torch.launch.serve --arch starcoder2-3b --batch 8 \
        --prompt-len 1024 --gen 32            # on the card
    python -m repro_torch.launch.serve --arch mamba2-130m --smoke --device cpu

Weights are random, drawn from ``torch.Generator(device).manual_seed(seed)``
on the device; prompts (and whisper's encoder frames after them) come from
``numpy.random.default_rng(seed)`` as in the reference. It prints the
prefill time (ms) and the decode rate (tokens/s), with the host clock
around work that ends in a device synchronisation.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import get_arch
from repro_torch.configs.example_lm import ARCH_100M, EXAMPLES
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch import steps as steps_mod


def resolve_arch(name: str, smoke: bool):
    key = name.replace("example-", "")
    if key in EXAMPLES:
        return ARCH_100M, EXAMPLES[key]
    arch = get_arch(name)
    return arch, (arch.smoke if smoke else arch.full)


def build(name: str, *, smoke: bool = False, seed: int = 0, device: DeviceLike = None):
    """(arch, cfg, model) with random weights from ``seed`` on ``device``."""
    dev = resolve_device(device)
    arch, cfg = resolve_arch(name, smoke)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return arch, cfg, arch.init(gen, cfg, device=dev)


def _draw_prompts(rng: np.random.Generator, cfg, batch: int, prompt_len: int) -> np.ndarray:
    return np.concatenate(
        [rng.integers(0, cfg.vocab, (1, prompt_len)).astype(np.int32)
         for _ in range(batch)], 0)


def make_prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """(batch, prompt_len) token ids, one prompt at a time from the seed's
    numpy generator, as the reference draws them."""
    return _draw_prompts(np.random.default_rng(seed), cfg, batch, prompt_len)


def make_inputs(arch, cfg, batch: int, prompt_len: int, seed: int):
    """(prompts, frames): the prompts of ``make_prompts`` and, for an
    encoder-decoder, the encoder's frames (batch, prompt_len, d_model)
    float64, N(0, 1), drawn from the same generator after the prompts, in
    the reference ``main``'s order; frames is None for an LM."""
    rng = np.random.default_rng(seed)
    prompts = _draw_prompts(rng, cfg, batch, prompt_len)
    if not arch.is_encdec():
        return prompts, None
    return prompts, rng.normal(0, 1, (batch, prompt_len, cfg.d_model))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclasses.dataclass
class ServeRun:
    """One prefill + greedy decode: the tokens, every step's logits and the
    host-clock times."""

    tokens: torch.Tensor  # (b, gen) int64, the greedy tokens
    prefill_logits: torch.Tensor  # (b, 1, vocab) f32
    step_logits: List[torch.Tensor]  # gen - 1 of (b, 1, vocab) f32
    prefill_s: float
    decode_s: float


def run(arch, cfg, model, prompts: np.ndarray, gen: int, *,
        impl: Optional[str] = None, forced: Optional[torch.Tensor] = None,
        frames=None, images=None) -> ServeRun:
    """Prefill ``prompts`` and decode ``gen`` tokens greedily.

    ``frames`` (b, n_frames, d_model): an encoder-decoder's encoder input;
    ``images`` (b, n_patches, d_vision): a VLM's patch embeddings, prepended
    to the prompts (the caches then hold n_patches more slots). Both are
    cast to ``cfg.dtype`` on the model's device.
    ``forced`` (b, gen): decode step i is fed ``forced[:, i]`` instead of
    the greedy token of the step before (teacher forcing; pass another
    run's ``tokens`` to compare two runs step by step). ``tokens`` still
    returns this run's greedy picks."""
    dev = next(model.parameters()).device
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long, device=dev)}
    max_len = prompts.shape[1] + gen + 8
    for key, extra in (("frames", frames), ("images", images)):
        if extra is not None:
            batch[key] = torch.as_tensor(np.asarray(extra), device=dev).to(cfg.dtype)
    if images is not None:
        max_len += batch["images"].shape[1]
    prefill = steps_mod.make_prefill(arch, cfg, max_cache_len=max_len, impl=impl)
    serve_step = steps_mod.make_serve_step(arch, cfg, impl=impl)
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        caches, logits = prefill(model, batch)
        tok = steps_mod.greedy(logits)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        prefill_logits = logits
        generated, step_logits = [tok], []
        t0 = time.perf_counter()
        for i in range(gen - 1):
            feed = tok if forced is None else forced[:, i:i + 1]
            caches, tok, logits = serve_step(model, caches, feed)
            generated.append(tok)
            step_logits.append(logits)
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return ServeRun(tokens=torch.cat(generated, dim=1), prefill_logits=prefill_logits,
                    step_logits=step_logits, prefill_s=t_prefill, decode_s=t_decode)


def main(argv=None) -> ServeRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="example-10m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    arch, cfg, model = build(args.arch, smoke=args.smoke, seed=args.seed,
                             device=args.device)
    prompts, frames = make_inputs(arch, cfg, args.batch, args.prompt_len, args.seed)
    out = run(arch, cfg, model, prompts, args.gen, frames=frames)
    tps = (args.gen * args.batch) / max(out.decode_s, 1e-9)
    dev = next(model.parameters()).device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    obs.log(f"arch={cfg.name} batch={args.batch} device={where}")
    obs.log(f"prefill: {out.prefill_s * 1e3:.1f} ms for {args.batch}x{args.prompt_len} "
            f"tokens")
    obs.log(f"decode:  {args.gen} steps in {out.decode_s * 1e3:.1f} ms -> {tps:.1f} tok/s")
    obs.log(f"sample tokens: {out.tokens[0, :12].tolist()}")
    return out


if __name__ == "__main__":
    main()
