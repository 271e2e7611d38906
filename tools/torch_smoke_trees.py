"""Run ``chip_smoke.py`` from several checkouts in turn on one machine, and
print each run's exit code and wall-clock seconds.

    python3 tools/torch_smoke_trees.py --out DIR TREE [TREE ...]

Each TREE is a directory holding a checkout's ``chip_smoke.py`` (for
example a ``git archive`` of a commit unpacked under ``build/``).  The runs
go one after another, in the order given, each from its tree's root, with
its standard output and errors in ``DIR/<tree name>.log`` and ``.err``.
One JSON line a run: ``{"tree", "rc", "seconds", "last_line"}``, then the
card's name and power limit as ``nvidia-smi`` prints them.  Compare two
trees only within one call, on one card.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    for tree in args.trees:
        name = os.path.basename(os.path.normpath(tree))
        log = os.path.join(args.out, f"{name}.log")
        with open(log, "w") as out, \
                open(os.path.join(args.out, f"{name}.err"), "w") as err:
            t0 = time.perf_counter()
            rc = subprocess.call([sys.executable, "chip_smoke.py"],
                                 cwd=tree, stdout=out, stderr=err)
            seconds = time.perf_counter() - t0
        with open(log) as f:
            lines = f.read().splitlines()
        print(json.dumps({"tree": tree, "rc": rc, "seconds": seconds,
                          "last_line": lines[-1] if lines else None}),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)


if __name__ == "__main__":
    main()
