"""One run of one cell: set-up, the measured window, the traced reading,
the correctness check and the result line.

Everything that belongs to a cell is found by name: the cell's entry in
BENCHMARK.json names its configuration (a file under benchmark/configs/)
and its traffic mix (benchmark/traffic/<name>.json, read by
benchmark/traffic.py), whose "loop" names the load loop
(benchmark/loops/<loop>.py: set-up, the window's load, the end-to-end
readings, the sample the check compares); its correctness limits are
benchmark/limits/<cell>.json; each per-layer metric is a reader,
benchmark/metrics/<metric>.py.

The benchmark times from its own side (the host clock, and its spans
around the program's calls), reads the program's counters and the kernel
names in the trace, and imports the program only inside the loops.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "echo_tts_tpu")


class Refused(RuntimeError):
    """A run that must end without a result line (exit code 2)."""


# ---------------------------------------------------------------------------
# The manifest
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Cell:
    root: str
    name: str
    entry: dict
    config: dict
    traffic_params: dict
    limits: dict
    manifest: dict

    @property
    def end_to_end(self) -> List[dict]:
        return [m for m in self.manifest["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    @property
    def per_layer(self) -> List[dict]:
        reported = {m["name"] for m in self.end_to_end}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


def load_cell(root: str, name: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    from . import traffic
    limits_path = os.path.join(root, "benchmark", "limits", f"{name}.json")
    with open(limits_path) as f:
        limits = json.load(f)
    return Cell(root, name, entry, config, traffic.load(root, entry["traffic"]),
                limits, manifest)


def cache_dirs(root: str) -> Dict[str, str]:
    """The program's build and kernel caches, at fixed paths in the
    checkout, so that only a checkout's first run builds."""
    base = os.path.join(root, "benchmark", ".cache")
    return {"ECHO_TORCH_BUILD_DIR": os.path.join(base, "build"),
            "TORCH_EXTENSIONS_DIR": os.path.join(base, "torch_extensions"),
            "TRITON_CACHE_DIR": os.path.join(base, "triton")}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values: List[float], q: float) -> float:
    """The q-quantile by the nearest rank, over all values."""
    xs = sorted(values)
    return xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


# ---------------------------------------------------------------------------
# The traced window
# ---------------------------------------------------------------------------

class Trace:
    """torch.profiler over the window: device intervals and host spans."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.torch = torch

    def __enter__(self):
        self.prof.__enter__()
        self.span = self.torch.profiler.record_function("bench.window")
        self.span.__enter__()
        return self

    def close(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        dev, host = [], []
        w0 = w1 = None
        for ev in self.prof.profiler.kineto_results.events():
            start = ev.start_ns()
            end = start + ev.duration_ns()
            if ev.device_type() == DeviceType.CUDA:
                dev.append((start, end, ev.name()))
            elif ev.name() == "bench.window":
                w0, w1 = start, end
            else:
                host.append((start, end, ev.name()))
        if w0 is None:
            raise RuntimeError("the trace lost its window span")
        self.window = (w0, w1)
        self.device = sorted((max(s, w0), min(e, w1), n) for s, e, n in dev
                             if e > w0 and s < w1)
        self.host = host
        return self

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        busy, cur_s, cur_e = 0, None, None
        for s, e, _ in self.device:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9

    def kernel_s(self, *patterns: str) -> float:
        return sum(e - s for s, e, n in self.device
                   if any(p in n for p in patterns)) / 1e9

    def breakdown(self) -> dict:
        by_name: Dict[str, float] = {}
        for s, e, n in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        ops = [(_short(n), v) for n, v in ops]
        gaps, last = [], self.window[0]
        for s, e, _ in self.device:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        if self.window[1] > last:
            gaps.append((last, self.window[1]))
        named: Dict[str, float] = {}
        for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
            mid = (g0 + g1) // 2
            over = [(e - s, n) for s, e, n in self.host if s <= mid < e]
            what = min(over)[1] if over else "no host op traced"
            named[what] = named.get(what, 0.0) + (g1 - g0) / 1e9
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in idle]}


def _short(name: str) -> str:
    """A kernel's name without its argument list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0][:120] or name[:120]


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads (benchmark/metrics/<name>.py)."""
    cell: Cell
    trace: Trace
    passes: list                        # the loop's spans in the window
    counters: Dict[str, dict]           # the window's change, by group

    @property
    def server_stats(self) -> Dict[str, float]:
        return self.counters.get("server", {})

    @property
    def program_stats(self) -> Dict[str, Dict[str, float]]:
        return self.counters.get("programs", {})


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(root: str, name: str):
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    return _module(path, f"benchmark.metrics.{name.replace('.', '_')}").read


def loop_class(root: str, name: str):
    """The Loop of benchmark/loops/<name>.py."""
    path = os.path.join(root, "benchmark", "loops", f"{name}.py")
    return _module(path, f"benchmark.loops.{name}").Loop


def _change(after: dict, before: dict) -> dict:
    return {k: (_change(v, before.get(k, {})) if isinstance(v, dict)
                else v - before.get(k, 0)) for k, v in after.items()}


# ---------------------------------------------------------------------------
# Run
# ---------------------------------------------------------------------------

def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run(root: str, workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device: str = "cuda", control: bool = False) -> dict:
    """One run of one cell; returns the result line's object.

    `control` holds the check's control, in place of the program's
    outputs, against the reference (benchmark/check.py)."""
    import torch
    from . import traffic as traffic_mod

    cell = load_cell(root, workload)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.entry["chips"]:
            raise Refused(f"{torch.cuda.device_count()} CUDA devices, the "
                          f"cell needs {cell.entry['chips']}")
    dev = torch.device(device)
    params = cell.traffic_params
    traffic = traffic_mod.generate(cell.entry["traffic"], params, seed,
                                   seconds)
    if trace and params.get("trace_seconds"):
        seconds = min(seconds, params["trace_seconds"])
        traffic.trim(seconds)
    loop = loop_class(root, params["loop"])(cell, traffic, seed, dev)
    try:
        loop.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        before = loop.counters()
        tracer = Trace().__enter__() if trace else None
        loop.start()
        t0 = time.monotonic()
        setup_s = t0 - t_start
        loop.drive(t0, seconds)
        loop.stop()
        if tracer is not None:
            tracer.close()
        change = _change(loop.counters(), before)
    finally:
        loop.close()
    found = forbidden_modules()
    if found:
        raise Refused(f"modules loaded in the measuring process: {found}")

    failures = loop.failures()
    for f in failures:
        log(f"failed: {f}")
    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.entry["chips"],
                   "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                         if dev.type == "cuda" else 0)}
    result = {"correct": False, "attempted": loop.attempted(),
              "failed": len(failures)}
    if trace:
        ctx = Context(cell, tracer, loop.passes, change)
        for m in cell.per_layer:
            value = reader(root, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info["busy_s"] = tracer.busy_s()
        device_info["window_s"] = tracer.window_s
        result["breakdown"] = tracer.breakdown()
    else:
        for name, value in loop.end_to_end(t0, seconds).items():
            unit = next(m["unit"] for m in cell.end_to_end
                        if m["name"] == name)
            metrics[name] = {"value": value, "unit": unit}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    result["metrics"] = metrics
    result["device"] = device_info

    # the check: the program's state freed first, so that the reference's
    # memory does not set the peak read above
    sample = loop.collect()
    loop.free()
    compared = loop.compare(sample, control)
    result["correct"] = (not failures and all(
        c["value"] <= c["limit"] for c in compared.values()))
    for name, c in compared.items():
        log(f"compared {name} {c['value']:.6g} limit {c['limit']:.6g}")
    result["compared"] = compared
    return result
