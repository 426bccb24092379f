"""One rank of the port's gradient compression on gloo, for
``tests/test_torch_optim.py`` (started with ``torch.multiprocessing.spawn``;
imports no JAX, so each rank starts quickly).

Rank r reads ``inputs.npz`` from the work directory (every rank's
gradients and residuals, stacked on a leading rank axis), runs
``compressed_grad_tree`` and ``compressed_psum`` on its own slice, and, when
asked, the error-feedback convergence check restated from
``tests/helpers/distributed_checks.py`` (plain mean vs compressed SGD on a
linear regression). It writes ``out_<r>.npz``.
"""

import os

import numpy as np
import torch
import torch.distributed as dist


def _sgd(group, rank: int, compressed: bool, w_true: np.ndarray, steps: int = 60,
         lr: float = 0.05) -> np.ndarray:
    from repro_torch.optim import compress

    world = dist.get_world_size(group)
    w = torch.zeros(32)
    resid = {"w": torch.zeros(32)}
    for i in range(steps):
        r = np.random.default_rng(i)
        X = r.normal(size=(world, 16, 32)).astype(np.float32)[rank]  # this rank's shard
        y = X @ w_true
        Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
        g = 2.0 * Xt.T @ (Xt @ w - yt) / Xt.shape[0]  # grad of the mean squared error
        if compressed:
            grads = {"w": g}
            compress.compressed_grad_tree(grads, resid, group)
            g = grads["w"]
        else:
            dist.all_reduce(g, group=group)
            g = g / world
        w = w - lr * g
    return w.numpy()


def run(rank: int, world: int, workdir: str, convergence: bool) -> None:
    from repro_torch.optim import compress

    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world)
    group = dist.group.WORLD
    with np.load(os.path.join(workdir, "inputs.npz")) as z:
        names = sorted({k.split("/", 1)[1] for k in z.files if k.startswith("g/")})
        grads = {n: torch.from_numpy(np.array(z[f"g/{n}"][rank])) for n in names}
        resid = {n: torch.from_numpy(np.array(z[f"r/{n}"][rank])) for n in names}
        x = torch.from_numpy(np.array(z["x"][rank]))
    out = {f"psum": compress.compressed_psum(x, group).numpy()}
    compress.compressed_grad_tree(grads, resid, group)
    for n in names:
        out[f"g/{n}"] = grads[n].numpy()
        out[f"r/{n}"] = resid[n].numpy()
    if convergence:
        w_true = np.random.default_rng(0).normal(size=(32,)).astype(np.float32)
        out["w_plain"] = _sgd(group, rank, False, w_true)
        out["w_comp"] = _sgd(group, rank, True, w_true)
        out["w_true"] = w_true
    np.savez(os.path.join(workdir, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()
