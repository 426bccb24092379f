"""Replay pytest-xdist's ``--dist loadfile`` schedule over a junit XML.

    python scripts/xdist_wall.py RUN.xml [-n 6] [--without tests.test_a ...]

Reads each test's time from a finished run's ``--junitxml`` and replays
how xdist 3.x hands out whole files: the files ordered by their number of
tests, most first (``--loadscope-reorder``, the default), one to each
worker, then another to a worker whenever it has at most two tests left.
Prints the replayed wall time (test time only: no start-up, no collection,
no contention between workers), when the longest file starts and on which
worker, and the wall with each ``--without`` file left out, and with all
of them left out. It answers what a file adds to the suite's wall clock,
which its own test time does not say when one file is the long pole.
"""

import argparse
import collections
import xml.etree.ElementTree as ET


def load(path: str) -> dict:
    """Each file (junit ``classname``) to its tests' seconds, in order."""
    files = collections.OrderedDict()
    for case in ET.parse(path).getroot().iter("testcase"):
        files.setdefault(case.get("classname"), []).append(float(case.get("time") or 0.0))
    return files


def replay(files: dict, workers: int, without=()) -> tuple:
    """(wall seconds, {file: (worker, start seconds)})."""
    queue = collections.deque(sorted(((k, v) for k, v in files.items() if k not in without),
                                     key=lambda kv: -len(kv[1])))
    pending = [collections.deque() for _ in range(workers)]
    clock = [0.0] * workers
    placed = {}

    def assign(w):
        if queue:
            name, times = queue.popleft()
            placed[name] = (w, clock[w] + sum(pending[w]))
            pending[w].extend(times)

    for w in range(workers):
        assign(w)
    for w in range(workers):
        if len(pending[w]) <= 2:
            assign(w)
    while any(pending):
        w = min((w for w in range(workers) if pending[w]), key=lambda w: clock[w])
        clock[w] += pending[w].popleft()
        if len(pending[w]) <= 2:
            assign(w)
    return max(clock), placed


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("junit")
    ap.add_argument("-n", type=int, default=6, help="xdist workers")
    ap.add_argument("--without", nargs="*", default=[], help="junit classnames to leave out")
    args = ap.parse_args(argv)
    files = load(args.junit)
    wall, placed = replay(files, args.n)
    longest = max(files, key=lambda k: sum(files[k]))
    worker, start = placed[longest]
    print(f"{len(files)} files, {sum(map(sum, files.values())):.1f} s of tests on {args.n} "
          f"workers: replayed wall {wall:.1f} s; the longest, {longest} "
          f"({sum(files[longest]):.1f} s, {len(files[longest])} tests), starts at {start:.1f} s "
          f"on worker {worker}")
    for name in args.without:
        print(f"without {name} ({sum(files.get(name, [])):.1f} s): "
              f"{replay(files, args.n, [name])[0]:.1f} s")
    if len(args.without) > 1:
        print(f"without all {len(args.without)}: {replay(files, args.n, args.without)[0]:.1f} s")


if __name__ == "__main__":
    main()
