"""Run one cell of the port's benchmark once, on the cards of this machine.

    python3 chipbench/run.py --workload starcoder2-3b.train_4k --seed 7 \
        --seconds 30 --trace 0

From the root of a checkout. Prints the result as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` the per-layer metrics and ``breakdown``,
then ``checks``: each number compared beside its limit), and the same
checks as the last lines of standard error. Exits non-zero, printing no
result, without as many CUDA cards as the cell asks for, outside a
checkout that holds the port, or when the process has loaded JAX or the
JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# build and kernel caches at fixed places inside the checkout, so only the
# first run of a checkout compiles (the port builds under build/ itself)
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton", "TORCH_EXTENSIONS_DIR": "build/torch_extensions"}
# one host thread for the CPU's own kernels: the work is the card's, and
# idle worker threads only contend with the thread that launches it
THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = os.path.join(ROOT, rel)
    os.environ.update(THREADS)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

    import torch

    from chipbench import harness, spec

    bench = spec.Spec(ROOT)
    chips = bench.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"chipbench: {args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=T_START, bench=bench)
    found = forbidden_modules()
    if found:
        print(f"chipbench: the process loaded {found}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
        # strict JSON has no inf or NaN: a number that is not finite fails its
        # limit and is written as the largest double
        c.update({k: v if math.isfinite(v) else sys.float_info.max for k, v in c.items()})
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
