#!/usr/bin/env python3
"""Take the port's Table 1 gap to the JAX golden apart, on one card.

    python3 scripts/table1_witness_torch.py [APP ...]   # from a checkout's root

For each app (all four of ``tests/data/torch_port_table1_golden.json`` by
default) it runs ``Characterization.cross_validate(k=10)`` at full
characterization (``Node(seed=42)``, 1,760 samples), as ``chip_smoke.py``'s
phase 4b does, in five arms, and holds each arm's (MAE, PAE) to the golden:

* ``card``: the port as the smoke runs it (the Gram by the kernel on the
  card, the KKT ladder on the host in float64, predictions on the card);
* ``card_plain``: the same with the plain PyTorch Gram on the card;
* ``host``: ``device="cpu"``, the plain Gram and the predictions on the host;
* ``host_card_gram``: ``device="cpu"``, every Gram built by the kernel on the
  card and copied to the host, so that only the Gram's bits come from the
  card;
* ``host_seed1``: the host arm on the folds of seed 1, not 0: the size of
  a fault in the folds, which a limit on the gap has to fail.

Beside each arm: the largest gap of its Grams to the host's plain Gram, and
per fold how many training samples change class (zero, free, at the box
bound C) from the host arm's dual coefficients, the ladder's active set.
One line per app and arm, then one JSON object, also written to
``chiprun_out/table1_witness.json``. It exits non-zero without a CUDA
device and outside a checkout.
"""

import json
import os
import sys
import time

ARMS = ("card", "card_plain", "host", "host_card_gram", "host_seed1")
C_DEFAULT = 10e3  # kfold_cv's C; the sets are not standardized, so the bound is C


def _classes(np, beta):
    """Each dual coefficient as 0 (zero), 1 (free) or 2 (at the bound)."""
    a = np.abs(np.asarray(beta, np.float64))
    return np.where(a == 0.0, 0, np.where(a >= C_DEFAULT * (1.0 - 1e-6), 2, 1))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    root = os.getcwd()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("table1_witness_torch: no CUDA device", file=sys.stderr)
        return 2
    if not (os.path.isfile(os.path.join(root, "chip_smoke.py"))
            and os.path.isdir(os.path.join(root, "src", "repro_torch"))):
        print(f"table1_witness_torch: {root} is not a checkout of the port", file=sys.stderr)
        return 2
    sys.path[:0] = [os.path.join(root, "src"), root]
    import chip_smoke as cs
    from repro_torch.core import characterize, svr
    from repro_torch.core.node_sim import Node
    from repro_torch.kernels import ops, ref

    kind, smi = cs.phase_device(torch)
    cs.phase_build()
    with open(cs.TABLE1_GOLDEN) as f:
        golden = json.load(f)
    apps = argv or golden["apps"]
    kernel_gram = ops.rbf_gram
    svr_fit = svr.fit
    state = {}

    def gram(x, y, gamma, *, impl=None):
        arm = state["arm"]
        if arm == "card_plain":
            K = kernel_gram(x, y, gamma, impl="ref")
        elif arm == "host_card_gram":
            K = kernel_gram(x.cuda(), y.cuda(), gamma).cpu()
        else:
            K = kernel_gram(x, y, gamma, impl=impl)
        plain = ref.rbf_gram_ref(x.cpu(), y.cpu(), gamma)
        state["gap"] = max(state["gap"], float((K.cpu() - plain).abs().max()))
        return K

    def fit(*args, **kw):
        m = svr_fit(*args, **kw)
        state["betas"].append(_classes(np, m.beta.cpu().numpy()))
        return m

    ops.rbf_gram = gram
    svr.fit = fit
    out = {"device": smi, "kind": kind, "apps": {}}
    node = Node(seed=golden["seed"])
    sets = {}
    for app in golden["apps"]:  # one node, in the golden's order, as the smoke
        sets[app] = characterize.characterize(characterize.NodeSampler(node, app), app)
    for app in apps:
        ch = sets[app]
        want = golden["table1"][app]
        rows = {}
        for arm in ARMS:
            state.update(arm=arm, gap=0.0, betas=[])
            device = "cuda" if arm.startswith("card") else "cpu"
            t0 = time.perf_counter()
            mae, pae = ch.cross_validate(k=10, device=device, seed=1 if arm == "host_seed1" else 0)
            seconds = time.perf_counter() - t0
            rel = max(abs(mae - want["mae"]) / want["mae"], abs(pae - want["pae"]) / want["pae"])
            rows[arm] = dict(mae=mae, pae=pae, rel=rel, gram_gap=state["gap"], seconds=seconds,
                             classes=state["betas"])
        host = rows["host"]["classes"]
        for arm, row in rows.items():
            betas = row.pop("classes")
            row["class_changes"] = (None if arm == "host_seed1" else
                                    [int((a != b).sum()) for a, b in zip(betas, host)])
            row["free"] = [int((c == 1).sum()) for c in betas]
            row["bound"] = [int((c == 2).sum()) for c in betas]
            print(f"[witness] {app} {arm}: MAE {row['mae']!r}, PAE {row['pae']!r}, rel "
                  f"{row['rel']:.3g} to the JAX golden; Gram gap to the host's plain "
                  f"{row['gram_gap']:.3g}; class changes a fold {row['class_changes']}; free "
                  f"{row['free']}, at C {row['bound']}; {row['seconds']:.1f} s on {smi}",
                  flush=True)
        out["apps"][app] = rows
    os.makedirs(os.path.join(root, "chiprun_out"), exist_ok=True)
    with open(os.path.join(root, "chiprun_out", "table1_witness.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({app: {arm: {k: r[k] for k in ("mae", "pae", "rel", "gram_gap")}
                            for arm, r in rows.items()}
                      for app, rows in out["apps"].items()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
