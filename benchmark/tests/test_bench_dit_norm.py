"""The kernel D readers (metrics/dit_norm_roofline.open and .bulk) on
synthetic passes and a synthetic trace: their bytes against a count worked
by hand, and None where the trace holds no kernel D (a tree without it)."""
from __future__ import annotations

import json
import os
import types

import pytest

from benchmark import counts, harness
from benchmark.loops.serving import Pass
from benchmark.tests.conftest import REPO

NAMES = ("dit_norm_roofline.open", "dit_norm_roofline.bulk")


def _cell(config):
    with open(os.path.join(REPO, "benchmark", "configs",
                           f"{config}.json")) as f:
        return types.SimpleNamespace(config=json.load(f))


def _trace(device):
    """A traced window's device intervals, read by the harness's own
    Trace.kernel_s (its profiler is never started)."""
    trace = harness.Trace.__new__(harness.Trace)
    trace.window = (0, 10 ** 10)
    trace.device = device
    return trace


def _pass(rows, seq):
    import torch
    return Pass(0.0, 1.0, [str(i) for i in range(rows)], seq,
                torch.ones((rows, 768), dtype=torch.bool),
                torch.ones((rows, 640), dtype=torch.bool), [rows])


def _hand_bytes(b, seq):
    """A pass of b requests at 40 steps, 20 of them guided (3b rows): per
    layer two AdaLN calls (x read and written, shift and scale read) and
    one Q/K call (q and k read and written), 24 layers of width 2048."""
    m, total = 2048, 0
    for gb in [3 * b] * 20 + [b] * 20:
        e = gb * seq * m
        total += 24 * (2 * (2 * e * 2 + 2 * gb * m * 2) + 4 * e * 2)
    return total


@pytest.mark.parametrize("name,config,passes", [
    ("dit_norm_roofline.bulk", "echo-base-w8a8", [(8, 640), (8, 640)]),
    ("dit_norm_roofline.open", "echo-base-bf16", [(1, 320), (2, 320),
                                                  (8, 320)]),
])
def test_bytes_equal_the_hand_count(name, config, passes):
    """Both instances' calls at every step's rows; the share is the bytes'
    bound over the summed device time of the two kernels alone."""
    read = harness.reader(REPO, name)
    ns = 2_000_000_000
    device = [(0, ns // 4, "void dit_adaln_kernel<8>(...)"),
              (ns // 4, ns // 2, "dit_qk_rope_kernel(...)"),
              (ns // 2, ns, "int8_matmul_kernel<256>(...)")]
    ctx = types.SimpleNamespace(cell=_cell(config), trace=_trace(device),
                                passes=[_pass(b, s) for b, s in passes])
    nbytes = sum(_hand_bytes(b, s) for b, s in passes)
    kernel_d_s = 1.0     # the two kernels' intervals; C's left out
    assert read(ctx) == pytest.approx(100.0 * nbytes / counts.PEAK_BYTES
                                      / kernel_d_s)


@pytest.mark.parametrize("name", NAMES)
def test_none_without_kernel_d(name):
    ctx = types.SimpleNamespace(
        cell=_cell("echo-base-bf16"),
        trace=_trace([(0, 1000, "joint_attention_kernel<false>")]),
        passes=[_pass(8, 320)])
    assert harness.reader(REPO, name)(ctx) is None


def test_manifest_lists_them_in_the_kernels_layer():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["per_layer"]}
    for name in ("dit_norm_roofline.open", "dit_norm_roofline.bulk"):
        layer = by_name[name]["layer"]
        assert layer.startswith("kernels (") and "csrc/dit_norm.cu" in layer
    assert by_name["dit_norm_roofline.open"]["workloads"] == ["serve-bf16-open"]
    assert by_name["dit_norm_roofline.bulk"]["moves"] == "audio_s_per_s"
