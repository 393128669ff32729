"""Find a serving cell's knee: the highest offered rate with no growing
backlog, by open-loop windows at several rates in one process.

    python -m benchmark.sweep --workload serve-bf16-open --seed 1 \
        --rates 2.0,2.4,2.8,3.2 --seconds 40

The voices and weights come from --seed, each rate's arrivals and texts
from --seed plus the rate's index.  For each rate it prints one JSON line: requests, completed per second,
the p50 and p90 latency from the due time, and the median latency of the
first and the last third of the arrivals (a backlog that grows shows as
the last third far above the first).  The cell's workload file then takes
0.8 x the knee as its rate, as a number.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=40.0)
    args = p.parse_args(argv)
    root = os.getcwd()
    from . import harness, traffic as traffic_mod
    os.environ.update(harness.cache_dirs(root))
    import torch
    cell = harness.load_cell(root, args.workload)
    dev = torch.device("cuda")
    print(f"card: {torch.cuda.get_device_name(dev)}", file=sys.stderr,
          flush=True)
    params = dict(cell.traffic_params)
    loop_cls = harness.loop_class(root, params["loop"])
    loop = None
    try:
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            params["rate_per_s"] = rate
            tr = traffic_mod.generate(cell.entry["traffic"], params,
                                      args.seed + i, args.seconds)
            if loop is None:
                loop = loop_cls(cell, tr, args.seed, dev)
                loop.setup()
            else:
                tr.sampler = loop.traffic.sampler
                loop.traffic = tr
            t0 = time.monotonic() + 0.2
            loop.drive(t0, args.seconds)
            served = loop.served
            lat = [(s.done - s.due) * 1e3 for s in served if s.error is None]
            third = max(1, len(lat) // 3)
            end = max(s.done for s in served)
            print(json.dumps({
                "rate_per_s": rate, "requests": len(served),
                "failed": sum(s.error is not None for s in served),
                "completed_per_s": len(lat) / (end - t0),
                "p50_ms": harness.percentile(lat, 0.5),
                "p90_ms": harness.percentile(lat, 0.9),
                "first_third_median_ms": statistics.median(lat[:third]),
                "last_third_median_ms": statistics.median(lat[-third:]),
                "occupancy": loop.server.stats()["mean_occupancy"]}),
                flush=True)
    finally:
        if loop is not None:
            loop.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
