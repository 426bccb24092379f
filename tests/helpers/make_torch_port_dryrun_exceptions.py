"""Write ``tests/data/torch_port_dryrun_exceptions.json``: every metric of
the port's dry-run records outside the limits of ``torch_dryrun_parity``
against the reference's golden, with its class of gap (``CLASSES``), the
reference's count and the port's count under each torch version it was
counted with.

    PYTHONPATH=src python tests/helpers/make_torch_port_dryrun_exceptions.py
    PYTHONPATH=src python tests/helpers/make_torch_port_dryrun_exceptions.py --sweep DIR
    PYTHONPATH=src python tests/helpers/make_torch_port_dryrun_exceptions.py --records DIR

With no option it runs the port's dry run here, the 66 full cells in
``WORKERS`` processes (``cells[i::WORKERS]`` each, as ``chip_smoke.py``
phase 11a runs them) and the 30 SMOKE cells of the golden, and writes the
file with this torch version's counts alone: a change that moves a count
makes every other version's stale. Each gap keeps the class the file gave
it; a new one needs ``--class CELL METRIC CLASS``.

``--sweep DIR`` (on a machine with another torch, such as the card's)
writes the full cells' records and ``DIR/torch_version`` and nothing else;
``--records DIR`` then adds DIR's counts under its version to the file.
Their gaps must be the file's, metric for metric.

On an 8-core host with torch 2.13 the whole file takes about 5 minutes;
``--sweep`` on the card's machine about 1.5.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "..", "src")
sys.path.insert(0, HERE)

import torch_dryrun_parity as parity  # noqa: E402

WORKERS = 6
CLASSES = {
    "xla-collective": "XLA's partitioner issues collective-permutes and all-to-alls "
                      "(reshards between its own layouts); the port runs its products on each "
                      "rank's shards with fixed placements and issues none.",
    "head-regroup": "Mamba2 with heads split over the model axis (zamba2-7b; mamba2-130m at "
                    "SMOKE width): in_proj's columns split in even chunks across its "
                    "z | xBC | dt boundaries, and one all-to-all hands each rank its own "
                    "heads' columns of each (parallel/context.regroup_columns), where XLA "
                    "moves them with collective-permutes.",
    "decode-cache": "decode: the reference's layer scan slices each layer's cache (or SSM "
                    "state) out of the stacked caches and writes it back, and XLA gathers a "
                    "cache split by sequence; the port keeps a cache a layer, writes one slot "
                    "in place, and attends a split cache where it lies.",
    "lse-merge": "decode over a cache split by sequence: the port merges the ranks' parts by "
                 "log-sum-exp (a max and two sums all-reduced) where XLA reduces once after "
                 "its gather.",
    "prefill-partition": "prefill: XLA splits work the rules leave whole on every rank of the "
                         "model axis (K/V projections whose heads do not split it, MQA's one "
                         "head, the MoE router) over that axis and gathers the results; the "
                         "port computes it on every rank (more flops, no all-gather) and "
                         "all-reduces each row-parallel product's output (two a layer).",
    "nested-remat": "train under scan_nest: the dry run counts the reference's two-level "
                    "recomputation as G more group forwards a microbatch, which the "
                    "reference's SMOKE records show exactly (test_the_nested_term_is_the_"
                    "references); at full width the reference's records of these cells come "
                    "to less, and the port's one-level count already differs where K/V "
                    "projections, the MoE router or Mamba2 heads that 16 does not split are "
                    "whole on every rank, which the G extra forwards multiply.",
    "zero1": "train: the port reduces each microbatch-summed gradient once, onto its moments' "
             "ZeRO-1 shards (a reduce-scatter), and gathers the updated parameters in bf16; "
             "XLA all-reduces gradients and gathers f32 updates.",
    "moe-dispatch": "MoE: the combine weights (b, s, E*C) are built whole on every rank and "
                    "then split by experts, so their gradient is gathered back whole; eager "
                    "ops materialize the (b, s, E*C) dispatch where XLA fuses it.",
    "train-backward": "train at SMOKE width (granite-moe-1b-a400m, phi3.5-moe, whisper-medium, "
                      "mamba2-130m): the step's flops are 5-9% above the reference's while the "
                      "same cells' prefill flops are within 5% (mamba2-130m's equal), so the "
                      "gap lies in the backward or its recomputation; not yet taken apart.",
    "seq-attention": "starcoder2-3b's 24 heads do not split the 16-wide model axis ('seq' "
                     "mode): the port attends each rank's query positions (train, prefill) or "
                     "slots (decode) and gathers the sequence before a tensor-parallel MLP; "
                     "XLA repeats attention on the model axis's ranks.",
    "narrow-smoke": "SMOKE width on (2, 4): the rules shard by the full config's head counts, "
                    "which the narrow config does not split (starcoder2-3b's 3 query heads, "
                    "gemma3-12b's 2 KV heads over 4): the port gathers those heads whole.",
}
FULL_WORKER = (
    "import sys\n"
    "from repro_torch.launch import dryrun\n"
    "for cell in sys.argv[3:]:\n"
    "    dryrun.run_cell(*cell.split(':'), sys.argv[1], device=sys.argv[2])\n")
SMOKE_WORKER = (
    "import json, sys\n"
    "sys.path.insert(0, sys.argv[2])\n"
    "import torch_dryrun_parity as parity\n"
    "from repro_torch.configs import get_arch\n"
    "from repro_torch.configs.base import ShapeCell\n"
    "from repro_torch.launch import dryrun, mesh\n"
    "G = parity.load_golden()\n"
    "for arch_id, kind in (c.split(':') for c in sys.argv[3:]):\n"
    "    arch, spec = get_arch(arch_id), G['smoke_cells'][kind]\n"
    "    cell = ShapeCell(f'smoke_{kind}', spec['seq'], spec['batch'], kind)\n"
    "    with mesh.dryrun_world(8):\n"
    "        m = mesh.make_dryrun_mesh(tuple(G['smoke_mesh']['shape']),\n"
    "                                  tuple(G['smoke_mesh']['axes']), 'cpu')\n"
    "        counts, memory, s = dryrun.count_cell(arch, arch.smoke, cell, m,\n"
    "                                              accum=dryrun.TRAIN_ACCUM.get(arch_id, 1))\n"
    "    with open(f'{sys.argv[1]}/{arch_id}__smoke_{kind}__2x4.json', 'w') as f:\n"
    "        json.dump(dryrun.record(counts, memory, s, 8), f)\n")


def _run(code: str, out: str, extra: str, cells: list) -> None:
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    groups = [cells[i::WORKERS] for i in range(WORKERS)]
    with ThreadPoolExecutor(WORKERS) as pool:
        for r in pool.map(lambda g: subprocess.run(
                [sys.executable, "-c", code, out, extra, *g], env=env, capture_output=True,
                text=True, timeout=1800), groups):
            if r.returncode:
                raise RuntimeError(r.stderr[-3000:])


def sweep(out: str, device: str = "cpu") -> None:
    """The full cells' records in ``out``, and ``out/torch_version``."""
    from repro_torch.launch.dryrun import all_cells

    os.makedirs(out, exist_ok=True)
    _run(FULL_WORKER, out, device, [":".join(c) for c in all_cells()])
    with open(os.path.join(out, "torch_version"), "w") as f:
        f.write(parity.torch_version())


def _read(out: str) -> dict:
    recs = {}
    for name in os.listdir(out):
        if name.endswith(".json"):
            with open(os.path.join(out, name)) as f:
                recs[name[:-5]] = json.load(f)
    return recs


def _gaps(recs: dict, golden: dict) -> dict:
    """{cell: {metric: (port, reference)}} of every record outside its
    limits; raises on a failed record."""
    out = {}
    for key, rec in sorted(recs.items()):
        if not rec["ok"]:
            raise RuntimeError(f"{key}: {rec.get('error')}")
        ref = golden["full"].get(key) or golden["smoke"][key]
        g = parity.gaps(rec, ref)
        if g:
            out[key] = g
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", metavar="DIR", help="only write the full cells' records to DIR")
    ap.add_argument("--records", metavar="DIR", help="add DIR's counts under its torch version")
    ap.add_argument("--class", dest="classes", nargs=3, action="append", default=[],
                    metavar=("CELL", "METRIC", "CLASS"), help="the class of a new gap")
    args = ap.parse_args()
    sys.path.insert(0, SRC)
    if args.sweep:  # the mesh's device the card, where there is one, as phase 11a's
        import torch

        sweep(args.sweep, "cuda" if torch.cuda.is_available() else "cpu")
        return
    golden = parity.load_golden()
    with open(parity.RECORDED) as f:
        old = json.load(f)["cells"]
    if args.records:
        with open(os.path.join(args.records, "torch_version")) as f:
            version = f.read().strip()
        gaps = _gaps(_read(args.records), golden)
        cells = old
        full = {k for k in golden["full"]}
        bad = [k for k in full if set(gaps.get(k, {})) != set(cells.get(k, {}))]
        if bad:
            raise SystemExit("the gaps under torch %s are not the file's: %s" % (version, {
                k: (sorted(gaps.get(k, {})), sorted(cells.get(k, {}))) for k in bad}))
        for key in full & set(cells):
            for metric, entry in cells[key].items():
                entry["port"][version] = gaps[key][metric][0]
    else:
        version = parity.torch_version()
        given = {(c, m): k for c, m, k in args.classes}
        with tempfile.TemporaryDirectory() as tmp:
            sweep(tmp)
            smoke = [f"{k.split('__')[0]}:{k.split('__')[1][len('smoke_'):]}"
                     for k in golden["smoke"]]
            _run(SMOKE_WORKER, tmp, HERE, smoke)
            gaps = _gaps(_read(tmp), golden)
        cells, missing = {}, []
        for key, metrics in gaps.items():
            for metric, (port, ref) in sorted(metrics.items()):
                cls = given.get((key, metric)) or old.get(key, {}).get(metric, {}).get("class")
                if cls not in CLASSES:
                    missing.append(f"{key} {metric}: port {port!r}, reference {ref!r}")
                    continue
                cells.setdefault(key, {})[metric] = {"class": cls, "reference": ref,
                                                     "port": {version: port}}
        if missing:
            raise SystemExit("gaps without a class (--class CELL METRIC CLASS):\n"
                             + "\n".join(missing))
    with open(parity.RECORDED, "w") as f:
        json.dump({"classes": CLASSES, "cells": cells}, f, indent=1, sort_keys=True)
    print(f"wrote {parity.RECORDED}: {sum(map(len, cells.values()))} metrics in "
          f"{len(cells)} cells, torch {version}")


if __name__ == "__main__":
    main()
