"""Run a cell's control: the program with one guarantee of its
configuration broken, which the comparison must call not correct.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 --seconds <s> [--control min-combiner|none]

``min-combiner`` binds the edge pair with the port's own ``min`` combiner
in place of last-wins: every triple carries its place in its graph as its
value, so within a graph ``min`` keeps the first of a key's duplicates
where the configuration promises the last. ``none`` runs the program as
configured.
The seeds run one after another in one process (set-up is most of a run);
each prints one JSON line with ``correct`` and the numbers compared. It is
not part of a benchmark run.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def min_combiner():
    """Every transpose-pair table the connector binds keeps its ``min``."""
    from repro_torch.db import connector

    init = connector.Table.__init__

    def patched(self, server, name, combiner="last", transpose=False):
        init(self, server, name, "min" if transpose else combiner, transpose)
    connector.Table.__init__ = patched
    try:
        yield
    finally:
        connector.Table.__init__ = init


CONTROLS = {"min-combiner": min_combiner, "none": contextlib.nullcontext}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", choices=sorted(CONTROLS),
                   default="min-combiner")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from portbench import harness

    if not torch.cuda.is_available():
        print("control.py: needs a CUDA card", file=sys.stderr)
        return 3
    t0 = T0
    for seed in (int(s) for s in args.seeds.split(",")):
        with CONTROLS[args.control]():
            result, _ = harness.run_cell(args.workload, seed, args.seconds,
                                         False, t0)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "correct": result["correct"],
                          "metrics": result["metrics"],
                          "checks": result["checks"]}), flush=True)
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
