"""What the benchmark makes from ``--seed``: the weights and the token ids.
Both sides, the program and the reference, get the same values.

Weights are drawn on the device in a few large calls: one normal draw in
the model's dtype for every matrix, bias and norm scale, scaled once, then
cut into views; one uniform and one normal draw in float32 for the Mamba2
scalars. The same seed on the same kind of device gives the same values,
so the reference draws them again after the program has trained its own
copy in place.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

MASK63 = (1 << 63) - 1
# streams of one seed: the weights, the batches, the order of a mix, the
# requests a check samples
WEIGHTS, BATCHES, ORDER, SAMPLE = range(4)


def stream_seed(seed: int, stream: int, index: int = 0) -> int:
    """A 63-bit seed for (``seed``, ``stream``, ``index``): distinct
    streams and indices give unrelated generators, for any ``seed`` that
    fits 64 bits."""
    x = (seed * 0x9E3779B97F4A7C15 + stream * 0xBF58476D1CE4E5B9 + index * 0x94D049BB133111EB)
    x &= (1 << 64) - 1
    x ^= x >> 31
    x = (x * 0xD6E8FEB86659FD93) & ((1 << 64) - 1)
    return (x ^ (x >> 29)) & MASK63


def generator(device, seed: int, stream: int, index: int = 0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream, index))


def draw_weights(specs: List[Tuple[str, Tuple[int, ...], str]], cfg: dict, seed: int,
                 device, dtype) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``reference.lm.param_specs`` entries (see there
    for the kinds of init), the model-dtype ones views of one buffer."""
    gen = generator(device, seed, WEIGHTS)
    std = cfg["initializer_range"]
    model = [(n, s, k) for n, s, k in specs if k in ("normal", "one_plus_normal")]
    total = sum(math.prod(s) for _, s, _ in model)
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(0.0, 1.0, generator=gen)
    buf.mul_(std)
    out, off = {}, 0
    for name, shape, kind in model:
        n = math.prod(shape)
        out[name] = buf[off:off + n].view(shape)
        if kind == "one_plus_normal":
            out[name].add_(1.0)
        off += n
    scalars = [(n, s, k) for n, s, k in specs if k not in ("normal", "one_plus_normal")]
    if scalars:
        count = sum(math.prod(s) for _, s, _ in scalars)
        u = torch.rand(count, generator=gen, device=device, dtype=torch.float32)
        z = torch.randn(count, generator=gen, device=device, dtype=torch.float32)
        off = 0
        for name, shape, kind in scalars:
            n = math.prod(shape)
            uu, zz = u[off:off + n].view(shape), z[off:off + n].view(shape)
            if kind == "dt_bias":  # inverse softplus of dt, log-uniform in [dt_min, dt_max]
                lo, hi = math.log(cfg["dt_min"]), math.log(cfg["dt_max"])
                dt = torch.exp(uu * (hi - lo) + lo).clamp_min(cfg["dt_init_floor"])
                out[name] = dt + torch.log(-torch.expm1(-dt))
            elif kind == "a_log":  # A uniform in A_init_range
                lo, hi = cfg["A_init_range"]
                out[name] = torch.log(uu * (hi - lo) + lo)
            elif kind == "one_plus_normal_f32":
                out[name] = 1.0 + std * zz
            else:
                raise ValueError(f"{name}: unknown init {kind!r}")
            off += n
    return out


def tokens(seed: int, index: int, rows: int, cols: int, vocab: int, device) -> torch.Tensor:
    """Batch ``index`` of the seed: uniform token ids (rows, cols), int64."""
    gen = generator(device, seed, BATCHES, index)
    return torch.randint(0, vocab, (rows, cols), generator=gen, device=device)
