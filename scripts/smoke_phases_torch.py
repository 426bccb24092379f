#!/usr/bin/env python3
"""Run the serving and training phases of a checkout's ``chip_smoke.py``
on one card, so that one call can time two commits in turns.

    cd CHECKOUT && python3 /path/to/scripts/smoke_phases_torch.py LABEL

It uses the ``chip_smoke.py`` and ``src/`` of the current directory, which
may hold an older commit unpacked with ``git archive``: the card's name
and power limit, the kernel build, phase 6b (``launch.serve.main`` at full
width for each arch of the checkout's ``SERVE_FULL_ARCHS``, kernel arm and
plain arm: prefill ms and decode tokens/s), phase 8 (starcoder2-3b training at full width:
step time, tokens/s, peak memory, launches a step, one step taken apart,
kernel arm against plain arm) and phase 9's ``launch.train.main`` run of
mamba2-130m (six steps with a resume: step times, peak memory), with LABEL
on its stage lines. To compare a parent with a change,
run it in the parent's checkout, the change's, the change's again and the
parent's, in one call. It exits non-zero without a CUDA device and
outside a checkout.
"""

import os
import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.getcwd()
    label = argv[0] if argv else os.path.basename(root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("smoke_phases_torch: no CUDA device", file=sys.stderr)
        return 2
    if not (os.path.isfile(os.path.join(root, "chip_smoke.py"))
            and os.path.isdir(os.path.join(root, "src", "repro_torch"))):
        print(f"smoke_phases_torch: {root} is not a checkout of the port", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(root, "src"), root]
    import chip_smoke as cs
    from repro_torch.kernels import ops

    cs.phase_device(torch)
    cs.phase_build()
    t0 = time.perf_counter()
    cs.phase_serve_full(torch, np)
    t0 = cs._stage(f"{label}: serve, full width", t0)
    ops.reset_launches()
    cs.phase_train_starcoder(torch, np)
    t0 = cs._stage(f"{label}: train starcoder2-3b, full width", t0)
    cs.phase_train_mamba(torch, np)
    cs._stage(f"{label}: train mamba2-130m, full width", t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
