"""benchmark/counts.py against the port's kernel table (PERF.md, the bound
column of chip_smoke.py phase 4)."""
from __future__ import annotations

import json
import os

import pytest

from benchmark import counts
from benchmark.tests.conftest import REPO


def _config(name="echo-base-bf16"):
    with open(os.path.join(REPO, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("shape,bound_ms", [
    ((3, 640, 778, 1, 16), 0.0226),
    ((1, 640, 778, 1, 16), 0.0075),
    ((24, 640, 778, 8, 16), 0.1804),
    ((24, 640, 928, 8, 16), 0.1995),
    ((3, 40, 778, 1, 16), 0.0025),
])
def test_attention_bound(shape, bound_ms):
    ops, nbytes = counts.attention(*shape)
    assert counts.bound_s(ops, nbytes) * 1e3 == pytest.approx(bound_ms, abs=1e-4)


@pytest.mark.parametrize("shape,bound_ms", [
    ((1920, 2048, 5888), 0.0234), ((1920, 2048, 2048), 0.0081),
    ((15360, 2048, 2048), 0.0651), ((15360, 5888, 2048), 0.1872),
    ((640, 2048, 2048), 0.0028),
])
def test_int8_matmul_bound(shape, bound_ms):
    ops, nbytes = counts.int8_matmul(*shape)
    assert (counts.bound_s(ops, nbytes, counts.PEAK_INT8) * 1e3
            == pytest.approx(bound_ms, abs=1e-4))


@pytest.mark.parametrize("shape,bound_ms", [
    ((96, 1310720, 4), 2.3451), ((384, 163840, 4), 4.6902),
    ((192, 655360, 4), 4.6902),
])
def test_res_stack_bound(shape, bound_ms):
    ops, nbytes = counts.res_stack(*shape)
    assert counts.bound_s(ops, nbytes) * 1e3 == pytest.approx(bound_ms, abs=1e-4)


def test_pass_shapes():
    cfg = _config()
    assert counts.cfg_steps(cfg["sampler"]) == 20
    calls = counts.attention_calls(cfg["dit"], cfg["sampler"], 8, 640, 768, 640)
    assert len(calls) == 960
    assert calls[0] == (24, 640, 928, 8, 16) and calls[-1][0] == 8
    assert len(counts.int8_matmul_calls(cfg["dit"], cfg["sampler"], 8, 640)) \
        == 7680
    assert counts.res_stack_calls(cfg["codec"], 4, 640) == [
        (384, 163840, 4), (192, 655360, 4), (96, 1310720, 4)]


def test_sampler_flops_match_the_training_count():
    """One step at B rows over the trunk plus the encoders is the training
    bench's useful forward (useful_fwd_tflop) with the static K/V
    projections added."""
    cfg = _config()
    d = cfg["dit"]
    one_step = dict(cfg["sampler"], num_steps=1, cfg_min_t=2.0)
    f = counts.sampler_pass_flops(d, one_step, 2, 640, 768, 640)
    m = d["model_size"]
    kv = 2 * 2 * d["num_layers"] * 2 * m * (1280 * 768 + 1280 * 160)
    useful = 2 * (d["num_layers"] * (5 * m * m + 3 * m * d["intermediate_size"]
                                     + 2 * (640 + 768 + 160) * m) * 2 * 640
                  + 2 * (14 * (5 * 1280 ** 2 + 3 * 1280 * 3328 + 768 * 1280)
                         * 768 + 14 * (5 * 1280 ** 2 + 3 * 1280 * 3328
                                       + 160 * 1280) * 160))
    assert f["linear"] + f["other"] == pytest.approx(useful + kv, rel=1e-12)


def _ctx(passes, kernel_s=1.0, window_s=10.0, name="echo-base-bf16"):
    import types
    cell = types.SimpleNamespace(config=_config(name))
    trace = types.SimpleNamespace(window_s=window_s,
                                  kernel_s=lambda *k: kernel_s)
    return types.SimpleNamespace(cell=cell, trace=trace, passes=passes)


def _pass(rows, text_lengths, speaker_lengths, decode_batches, seq=320):
    import torch
    from benchmark.loops.serving import Pass
    n = len(rows)
    tmask = torch.arange(768)[None] < torch.tensor(text_lengths)[:, None]
    smask = torch.arange(640)[None] < torch.tensor(speaker_lengths)[:, None]
    assert tmask.shape[0] == n
    return Pass(0.0, 1.0, rows, seq, tmask, smask, decode_batches)


def test_mfu_counts_real_requests_at_their_real_lengths():
    """Useful FLOPs: each real request (padding rows left out) at its own
    text and speaker lengths."""
    from benchmark import readers
    cfg = _config()
    p = _pass(["7", "8", "9", "9"], [80, 100, 60, 60], [400, 640, 320, 320],
              [4])
    want = 0.0
    for t, s in ((80, 400), (100, 640), (60, 320)):
        f = counts.sampler_pass_flops(cfg["dit"], cfg["sampler"], 1, 320, t, s)
        want += f["linear"] + f["other"]
    got = readers.mfu(_ctx([p]))
    assert got == pytest.approx(100.0 * want / counts.PEAK_BF16 / 10.0)
    wide = counts.sampler_pass_flops(cfg["dit"], cfg["sampler"], 3, 320,
                                     768, 640)
    assert got < 100.0 * (wide["linear"] + wide["other"]) / counts.PEAK_BF16 \
        / 10.0


def test_rooflines_count_the_launched_shapes():
    """Kernel A at the launched text and speaker widths and every row;
    kernel B at the decode batches launched."""
    from benchmark import readers
    cfg = _config()
    p = _pass(["1", "2", "3", "3"], [80, 90, 70, 70], [400, 400, 400, 400],
              [4], seq=320)
    ctx = _ctx([p])
    a = sum(counts.bound_s(*counts.attention(*c)) for c in
            counts.attention_calls(cfg["dit"], cfg["sampler"], 4, 320, 768,
                                   640))
    assert readers.roofline(ctx, readers.attention_calls(ctx),
                            counts.PEAK_BF16) == pytest.approx(100.0 * a)
    b = sum(counts.bound_s(*counts.res_stack(*c))
            for c in counts.res_stack_calls(cfg["codec"], 4, 320))
    assert readers.roofline(ctx, readers.res_stack_calls(ctx),
                            counts.PEAK_BF16) == pytest.approx(100.0 * b)
    p.decode_batches = [4, 1]
    b1 = sum(counts.bound_s(*counts.res_stack(*c))
             for c in counts.res_stack_calls(cfg["codec"], 1, 320))
    assert readers.roofline(ctx, readers.res_stack_calls(ctx),
                            counts.PEAK_BF16) == pytest.approx(
                                100.0 * (b + b1))
