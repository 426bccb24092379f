"""Carry fitted models and model weights across from the JAX reference.

The port never imports the reference; these functions take the reference
objects' fields as plain numbers and numpy arrays, so a test can install a
reference fit into the port's engine (``PlanningEngine.install_fit``) and
compare the Gram builds and grid sweeps apart from the KKT fit, or load a
reference LM's weights into the port's modules and compare the two
packages' logits and caches.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.power import PowerModel
from repro_torch.core.svr import SVRParams
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import encdec, lm


def power_model_from_reference(coeffs: Sequence[float]) -> PowerModel:
    """A reference ``PowerModel.coeffs()`` tuple as the port's model."""
    c1, c2, c3, c4 = (float(c) for c in coeffs)
    return PowerModel(c1, c2, c3, c4)


def svr_params_from_reference(
    fields: Mapping[str, Any], device: DeviceLike = None
) -> SVRParams:
    """A reference ``SVRParams`` (its fields as numpy arrays and floats,
    e.g. ``dataclasses.asdict``-style with arrays converted by
    ``np.asarray``) as the port's, with the tensors on ``device``."""
    dev = resolve_device(device)

    def tensor(name: str) -> torch.Tensor:
        return torch.from_numpy(np.array(fields[name], np.float32)).to(dev)

    return SVRParams(
        x_train=tensor("x_train"),
        beta=tensor("beta"),
        bias=float(fields["bias"]),
        gamma=float(fields["gamma"]),
        x_mean=tensor("x_mean"),
        x_std=tensor("x_std"),
        y_mean=float(fields["y_mean"]),
        y_std=float(fields["y_std"]),
        log_target=bool(fields["log_target"]),
    )


def flatten_reference(tree, prefix: str = "") -> dict:
    """A reference parameter pytree (nested dicts of arrays) as
    {dotted path: numpy array}, the port's ``state_dict`` naming."""
    out = {}
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            out.update(flatten_reference(tree[k], f"{prefix}{k}."))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def unflatten_reference(flat: Mapping[str, Any]) -> dict:
    """{dotted path: array} as a reference LM pytree, the inverse of
    ``flatten_reference``: nested dicts, with ``blocks`` a list by pattern
    position."""
    tree: dict = {}
    for key, arr in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    if "blocks" in tree:
        tree["blocks"] = [tree["blocks"][str(i)] for i in range(len(tree["blocks"]))]
    return tree


def seeded_reference_params(shapes: Mapping[str, Sequence[int]], seed: int) -> dict:
    """Float32 weights of a reference LM or encoder-decoder pytree, given
    its leaves' shapes by dotted path, drawn from
    ``numpy.random.default_rng(seed)`` in sorted path order: a norm's
    ``scale`` 1 + N(0, 0.1^2), every other leaf N(0, 0.02^2). Weights a
    golden names by their seed instead of holding them."""
    rng = np.random.default_rng(seed)
    flat = {}
    for path in sorted(shapes):
        z = rng.standard_normal(tuple(shapes[path])).astype(np.float32)
        flat[path] = (np.float32(1.0) + np.float32(0.1) * z if path.endswith("scale")
                      else np.float32(0.02) * z)
    return unflatten_reference(flat)


def load_reference_params(module: torch.nn.Module, values: Mapping[str, Any]):
    """Copy {dotted path: array} into ``module``'s parameters of the same
    names, cast to each parameter's dtype; a leaf without a parameter, a
    parameter without a leaf, or a shape that differs raises."""
    state = module.state_dict()
    if set(values) != set(state):
        raise ValueError(
            f"reference leaves without a port parameter: {sorted(set(values) - set(state))}; "
            f"port parameters without a leaf: {sorted(set(state) - set(values))}")
    with torch.no_grad():
        for name, tensor in state.items():
            arr = np.asarray(values[name])
            if tuple(arr.shape) != tuple(tensor.shape):
                raise ValueError(f"{name}: shape {arr.shape} != {tuple(tensor.shape)}")
            # through float32: numpy has no bfloat16; the values are exact in it
            tensor.copy_(torch.from_numpy(np.array(arr, np.float32)).to(tensor.dtype))
    return module


def lm_params_from_reference(params: Mapping[str, Any], cfg: lm.LMConfig,
                             device: DeviceLike = None) -> lm.LM:
    """A reference ``lm.init`` pytree (its leaves as numpy arrays) as the
    port's ``lm.LM`` on ``device``.

    ``params["blocks"][i]`` holds pattern position i's weights stacked over
    ``n_groups``; group g's slice becomes layer ``g * len(pattern) + i``.
    The names below a block are the reference's keys, so every leaf lands
    on the parameter of the same path; zamba2's one ``shared`` block and a
    VLM's ``vision_proj`` land on ``LM.shared`` and ``LM.vision_proj``.
    """
    dev = resolve_device(device)
    model = lm.init(cfg, generator=torch.Generator(device=dev), device=dev)
    n_pat = len(cfg.pattern)
    values = flatten_reference({k: v for k, v in params.items() if k != "blocks"})
    if len(params["blocks"]) != n_pat:
        raise ValueError(f"{len(params['blocks'])} block stacks for pattern {cfg.pattern}")
    for i, stack in enumerate(params["blocks"]):
        for path, arr in flatten_reference(stack).items():
            if arr.shape[0] != cfg.n_groups:
                raise ValueError(f"blocks[{i}].{path}: leading axis {arr.shape[0]} "
                                 f"!= n_groups {cfg.n_groups}")
            for g in range(cfg.n_groups):
                values[f"blocks.{g * n_pat + i}.{path}"] = arr[g]
    return load_reference_params(model, values)


def encdec_params_from_reference(params: Mapping[str, Any], cfg: encdec.EncDecConfig,
                                 device: DeviceLike = None) -> encdec.EncDec:
    """A reference ``encdec.init`` pytree (its leaves as numpy arrays) as
    the port's ``encdec.EncDec`` on ``device``: ``enc_blocks`` and
    ``dec_blocks`` hold each leaf stacked over layers, and layer l's slice
    becomes ``enc_blocks.<l>`` / ``dec_blocks.<l>``."""
    dev = resolve_device(device)
    model = encdec.init(cfg, generator=torch.Generator(device=dev), device=dev)
    stacks = {"enc_blocks": cfg.n_enc_layers, "dec_blocks": cfg.n_dec_layers}
    values = flatten_reference({k: v for k, v in params.items() if k not in stacks})
    for key, n in stacks.items():
        for path, arr in flatten_reference(params[key]).items():
            if arr.shape[0] != n:
                raise ValueError(f"{key}.{path}: leading axis {arr.shape[0]} != {n} layers")
            for layer in range(n):
                values[f"{key}.{layer}.{path}"] = arr[layer]
    return load_reference_params(model, values)


def params_from_reference(params: Mapping[str, Any], cfg, device: DeviceLike = None):
    """``encdec_params_from_reference`` for an ``EncDecConfig``, else
    ``lm_params_from_reference``."""
    if isinstance(cfg, encdec.EncDecConfig):
        return encdec_params_from_reference(params, cfg, device)
    return lm_params_from_reference(params, cfg, device)


def reference_param_path(name: str, cfg) -> str:
    """A port parameter's name as the reference's pytree path ("/"-joined):
    layer ``g * len(pattern) + i``'s leaves live in ``blocks/<i>/...``
    stacked over groups, an encoder-decoder's ``enc_blocks.<l>`` /
    ``dec_blocks.<l>`` leaves in ``enc_blocks/...`` / ``dec_blocks/...``
    stacked over layers."""
    stack, _, rest = name.partition(".")
    if stack == "blocks":
        layer, _, rest = rest.partition(".")
        return f"blocks/{int(layer) % len(cfg.pattern)}/{rest.replace('.', '/')}"
    if stack in ("enc_blocks", "dec_blocks"):
        return f"{stack}/{rest.partition('.')[2].replace('.', '/')}"
    return name.replace(".", "/")


def reference_cache_path(path: str, cfg) -> str:
    """A port cache leaf's path ("<layer>.<key>", an encoder-decoder's
    "<layer>.self.k") as the reference's stacked cache path: pattern
    position i's caches, with zamba2's shared KV caches after them
    (``(layers, shared)``), or an encoder-decoder's ``{self, cross}``."""
    layer, _, rest = path.partition(".")
    rest = rest.replace(".", "/")
    if isinstance(cfg, encdec.EncDecConfig):
        return rest
    n_pat = len(cfg.pattern)
    if not cfg.shared_attn:
        return f"{int(layer) % n_pat}/{rest}"
    if int(layer) >= cfg.n_layers:
        return f"1/{rest}"
    return f"0/{int(layer) % n_pat}/{rest}"
