#!/usr/bin/env python3
"""Time a checkout's planning kernels on one card, so that one call can
time two commits in turns.

    cd CHECKOUT && python3 /path/to/scripts/kernel_turns_torch.py LABEL

It uses the ``chip_smoke.py`` and ``src/`` of the current directory, which
may hold an older commit unpacked with ``git archive``: the card's name and
power limit, the kernel build, then ``rbf_gram`` at the paper loop's and the
engine's shapes, ``plan_argmin`` at B = 10,000, G = 352 and 350 (each beside
``t.amin(1)``, a yardstick of the read rate), and ``pareto_mask`` at
B = 10,000, G = 352 and past the sort's capacity, each on inputs made here
from a fixed seed (the same in every checkout), checked against the plain
version and timed from CUDA-graph replays (``chip_smoke._time_ms``), one
line each with LABEL. To compare a parent with a change, run it in the
parent's checkout, the change's, the change's again and the parent's, in
one call. It exits non-zero without a CUDA device and outside a checkout.
"""

import os
import sys

RBF_SHAPES = ((4, 1760, 1760, 3), (20, 352, 352, 2), (1, 352, 1760, 3))
ARGMIN_SHAPES = ((10_000, 352), (10_000, 350))  # the engine's round; G % 4 != 0
PARETO_SHAPES = ((10_000, 352), (200, 1500))
SEED = 17


def _pareto_inputs(np, rng, b, g):
    t = rng.lognormal(3.0, 1.0, (b, g)).astype(np.float32)
    e = rng.lognormal(8.0, 0.5, (b, g)).astype(np.float32)
    mask = rng.random((b, g)) < 0.8
    t[:, 5::11] = t[:, 4::11][:, : t[:, 5::11].shape[1]]  # exact (t, e) ties
    e[:, 5::11] = e[:, 4::11][:, : e[:, 5::11].shape[1]]
    return t, e, mask


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.getcwd()
    label = argv[0] if argv else os.path.basename(root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns_torch: no CUDA device", file=sys.stderr)
        return 2
    if not (os.path.isfile(os.path.join(root, "chip_smoke.py"))
            and os.path.isdir(os.path.join(root, "src", "repro_torch"))):
        print(f"kernel_turns_torch: {root} is not a checkout of the port", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(root, "src"), root]
    import chip_smoke as cs
    from repro_torch.core.engine import TIME_FLOOR
    from repro_torch.kernels import ops

    kind, _ = cs.phase_device(torch)
    cs.phase_build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for b, n, m, d in RBF_SHAPES:
        x = torch.from_numpy(rng.uniform(0.0, 32.0, (b, n, d)).astype(np.float32)).to(dev)
        y = torch.from_numpy(rng.uniform(0.0, 32.0, (b, m, d)).astype(np.float32)).to(dev)
        err = float((ops.rbf_gram(x, y, 0.5) - ops.rbf_gram(x, y, 0.5, impl="ref")).abs().max())
        if err > cs.RBF_ATOL:
            raise AssertionError(f"rbf_gram {(b, n, m, d)}: max |err| {err}")
        ms = cs._time_ms(torch, lambda: ops.rbf_gram(x, y, 0.5), 100)
        print(f"[turn {label}] rbf_gram b={b} n={n} m={m} d={d}: {ms:.5f} ms (max |err| "
              f"{err:.3g}) on {kind}", flush=True)
    arng = np.random.default_rng(SEED + 1)  # the other kernels' inputs stay as they were
    for b, g in ARGMIN_SHAPES:
        t, w, k, mask = (torch.from_numpy(a).to(dev) for a in cs._plan_inputs(np, arng, b, g))

        def argmin(impl=None):
            return ops.plan_argmin(t, w, k, mask, time_floor=TIME_FLOOR, impl=impl)

        if not torch.equal(argmin(), argmin("ref")):
            raise AssertionError(f"plan_argmin {(b, g)}: indices differ")
        ms = cs._time_ms(torch, argmin, 200)
        # a yardstick of the card's read rate at this size: one PyTorch
        # reduction over t alone (4 of the 5 bytes a point plan_argmin reads)
        amin_ms = cs._time_ms(torch, lambda: t.amin(1), 200)
        print(f"[turn {label}] plan_argmin B={b} G={g}: {ms:.5f} ms "
              f"(indices identical; t.amin(1) {amin_ms:.5f} ms) on {kind}", flush=True)
    for b, g in PARETO_SHAPES:
        t, e, mask = (torch.from_numpy(a).to(dev) for a in _pareto_inputs(np, rng, b, g))
        if not torch.equal(ops.pareto_mask(t, e, mask), ops.pareto_mask(t, e, mask, impl="ref")):
            raise AssertionError(f"pareto_mask {(b, g)}: keep-sets differ")
        ms = cs._time_ms(torch, lambda: ops.pareto_mask(t, e, mask), 20)
        print(f"[turn {label}] pareto_mask B={b} G={g}: {ms:.5f} ms (keep-sets identical) "
              f"on {kind}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
