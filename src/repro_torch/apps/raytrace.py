"""Raytrace: real-time-style ray caster (PARSEC kernel in PyTorch).

Renders a procedural sphere scene: primary rays from a pinhole camera,
nearest-hit sphere intersection, Lambertian + Blinn-Phong shading with a
single point light, hard shadows via one shadow ray, and one mirror bounce —
the same speed-over-realism recipe as the PARSEC original. Fully vectorized
over pixels; resolution is the input-size knob.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

DEFAULT_N = 64  # image is (n, n)
N_SPHERES = 16


def make_inputs(n: int = DEFAULT_N, seed: int = 0, device: DeviceLike = None):
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-3, 3, (N_SPHERES, 3)).astype(np.float32)
    centers[:, 2] = rng.uniform(4.0, 9.0, N_SPHERES)
    return {
        "centers": torch.from_numpy(centers).to(dev),
        "radii": torch.from_numpy(
            rng.uniform(0.4, 1.0, N_SPHERES).astype(np.float32)).to(dev),
        "colors": torch.from_numpy(
            rng.uniform(0.2, 1.0, (N_SPHERES, 3)).astype(np.float32)).to(dev),
        "res": n,
    }


def _intersect(origin, direction, centers, radii):
    """Nearest positive-t ray/sphere hit. Returns (t, sphere_idx); a pixel
    whose two nearest hits tie takes the lower sphere index."""
    oc = origin[..., None, :] - centers  # (..., S, 3)
    b = torch.sum(oc * direction[..., None, :], dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radii**2
    disc = b * b - c
    hit = disc > 0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 1e-3, t0, t1)
    t = torch.where(hit & (t > 1e-3), t, torch.inf)
    t_min, idx = torch.min(t, dim=-1)
    return t_min, idx


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def _shade(point, normal, view, color, light_pos, in_shadow):
    l = light_pos - point
    l = l / _norm(l)
    diff = torch.clamp_min(torch.sum(normal * l, dim=-1, keepdim=True), 0.0)
    h = l + view
    h = h / torch.clamp_min(_norm(h), 1e-9)
    spec = torch.clamp_min(torch.sum(normal * h, dim=-1, keepdim=True), 0.0) ** 32
    lit = torch.where(in_shadow[..., None], 0.15, 1.0)
    return color * (0.1 + 0.8 * diff * lit) + 0.4 * spec * lit


def _pixel_grid(res: int, dev) -> torch.Tensor:
    """``linspace(-1, 1, res)`` in float32 as the JAX package's jitted
    render computes it, bit for bit: ``start (1 - s) + stop s`` with
    ``s = i x float32(1 / (res - 1))`` (XLA folds the division by the
    constant into a product by its reciprocal)."""
    if res == 1:
        return torch.full((1,), -1.0, device=dev)
    div = res - 1
    step = torch.arange(div, dtype=torch.float32, device=dev) * torch.tensor(
        1.0 / div, dtype=torch.float32, device=dev)
    out = -1.0 * (1 - step) + 1.0 * step
    return torch.cat([out, torch.ones(1, device=dev)])


def _render(centers, radii, colors, res: int):
    dev = centers.device
    light_pos = torch.tensor([5.0, 6.0, 0.0], device=dev)
    xs = _pixel_grid(res, dev)
    px, py = torch.meshgrid(xs, -xs, indexing="xy")
    direction = torch.stack([px, py, torch.ones_like(px)], dim=-1)
    direction = direction / _norm(direction)
    origin = torch.zeros_like(direction)

    def trace(origin, direction):
        t, idx = _intersect(origin, direction, centers, radii)
        hit = torch.isfinite(t)
        t_safe = torch.where(hit, t, 0.0)
        point = origin + t_safe[..., None] * direction
        normal = (point - centers[idx]) / radii[idx][..., None]
        color = colors[idx]
        # shadow ray
        to_light = light_pos - point
        dist_l = _norm(to_light)[..., 0]
        sdir = to_light / dist_l[..., None]
        ts, _ = _intersect(point + 1e-3 * normal, sdir, centers, radii)
        in_shadow = ts < dist_l
        shaded = _shade(point, normal, -direction, color, light_pos, in_shadow)
        return torch.where(hit[..., None], shaded, 0.05), hit, point, normal

    col0, hit0, point0, normal0 = trace(origin, direction)
    # one mirror bounce
    refl = direction - 2.0 * torch.sum(direction * normal0, -1, keepdim=True) * normal0
    col1, hit1, _, _ = trace(point0 + 1e-3 * normal0, refl)
    img = torch.where(hit0[..., None], 0.8 * col0 + 0.2 * col1, col0)
    return torch.clamp(img, 0.0, 1.0)


def run(inputs, device: DeviceLike = None):
    dev = resolve_device(device)
    return {
        "image": _render(
            inputs["centers"].to(dev), inputs["radii"].to(dev),
            inputs["colors"].to(dev), int(inputs["res"]),
        )
    }


def flops(n: int) -> float:
    return 3.0 * n * n * N_SPHERES * 30  # 3 traces x per-sphere quadratic solve
