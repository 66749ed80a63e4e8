#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs as many CUDA cards as the cell asks
for and the port (``pydrobert_tpu_torch``) beside ``portbench/``; without
either it exits non-zero before printing a result. The last line of
standard output is the run's JSON result; the numbers that decide
``correct`` are the last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell named in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: a traced window and the per-layer metrics")
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="1: judge the lower-precision reference in the program's place")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    # every compile cache at a fixed path inside the checkout
    cache = os.path.join(HERE, "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(cache, "inductor")
    os.environ.pop("PDT_CACHE_DIR", None)
    os.environ["USE_FLAX"] = "0"
    # the script's own folder would shadow the standard library's modules
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench import harness

    return harness.main(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
