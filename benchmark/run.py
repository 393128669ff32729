"""Run one cell of the benchmark once and print its result line.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

From the root of a checkout.  The last line of standard output is one
JSON object: correct, attempted, failed, metrics (the cell's end-to-end
metrics, or with --trace 1 its per-layer ones), device, with --trace 1
breakdown, and last `compared`, each number of the correctness check with
its limit (also the last lines of standard error).  --control holds the
check's control (the reference one precision down, in the program's
place) against the reference in place of the program's outputs: it has
to come out not correct.  Exit 2 without a result when no CUDA device
(or too few) is present or a forbidden module was loaded; 1 on any
other failure.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    root = os.getcwd()
    from . import harness
    os.environ.update(harness.cache_dirs(root))
    os.environ["USE_FLAX"] = "0"
    try:
        result = harness.run(root, args.workload, args.seed, args.seconds,
                             bool(args.trace), t_start=T_START,
                             control=args.control)
    except harness.Refused as exc:
        print(f"refused: {exc}", file=sys.stderr, flush=True)
        return 2
    except Exception:
        traceback.print_exc()
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
