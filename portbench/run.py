"""Run one cell of the port's benchmark and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``. The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, ``host``: the
CPUs and threads the run kept to, and last ``checks``: each number compared
with its limit); the last lines of standard
error repeat the checks. Without a CUDA card (or with fewer than the cell
asks for), without the port's sources, or with JAX or the JAX package
loaded once the window has closed, it prints no result and exits non-zero.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPUS = 2
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / sub)
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def keep_to_few_cpus() -> None:
    """The cells are paced by the host's one thread. Every CPU pool of the
    process gets one thread, and the process keeps to the last ``CPUS`` of
    the CPUs it may use, all set before torch starts a thread: a pool that
    spins on a shared host, or a thread that moves between cores, only adds
    to the spread of the times."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.sched_setaffinity(0, sorted(os.sched_getaffinity(0))[-CPUS:])


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0=T0) -> int:
    args = parse(argv)
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        print("run.py: the port's sources (src/repro_torch) are not here",
              file=sys.stderr)
        return 2
    keep_to_few_cpus()
    import torch
    from portbench import harness

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)

    chips = harness.find_cell(harness.load_bench(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    result, checks = harness.run_cell(args.workload, args.seed, args.seconds,
                                      bool(args.trace), t0)
    found = harness.foreign_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 4
    for name, (value, limit) in checks.items():
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    host = {"cpus": sorted(os.sched_getaffinity(0)),
            "torch_threads": torch.get_num_threads(),
            "interop_threads": torch.get_num_interop_threads()}
    result = {**{k: v for k, v in result.items() if k != "checks"},
              "host": host, "checks": result["checks"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
