"""The harness end to end at the tiny size on the CPU: the port (fp32)
served through MicroBatchServer, held against the reference."""
from __future__ import annotations

import time

import pytest

from benchmark import harness


def _run(root, cell, seconds=3.0, trace=False, **kw):
    return harness.run(root, cell, 2 ** 40 + 17, seconds, trace,
                       t_start=time.monotonic(), device="cpu", **kw)


@pytest.mark.parametrize("cell,metric", [("tiny-open", "request_p90_ms"),
                                         ("tiny-closed", "audio_s_per_s")])
def test_tiny_cell_correct(tiny_root, cell, metric):
    res = _run(tiny_root, cell)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["metrics"][metric]["value"] > 0
    assert res["metrics"]["setup_s"]["value"] > 0
    assert list(res)[-1] == "compared"
    assert res["compared"]["latent_rel_rms"]["value"] < 1e-4


def test_tiny_traced_run_reports_per_layer_shape(tiny_root):
    """A --trace 1 run on the CPU: per-layer metrics in place of the
    end-to-end ones, the device's window and busy time, a breakdown."""
    res = _run(tiny_root, "tiny-open", trace=True)
    assert res["correct"]
    assert "setup_s" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
