"""Carry fitted models across from the JAX reference package.

The port never imports the reference; these functions take the reference
objects' fields as plain numbers and numpy arrays, so a test can install a
reference fit into the port's engine (``PlanningEngine.install_fit``) and
compare the Gram builds and grid sweeps apart from the KKT fit.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.core.power import PowerModel
from repro_torch.core.svr import SVRParams
from repro_torch.device import DeviceLike, resolve_device


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
