"""The Dia cell (serve-dia-bulk): its loop served on the CPU at a tiny
size, dia_counts against counts by hand, each of its readers on a made-up
context, and a tree without the program's Dia failing at once."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from benchmark import dia_counts, harness
from benchmark.loops.serve_dia_closed import DiaPass, dialogue, draws_off
from benchmark.tests.conftest import REPO

TINY_DIA_TRAFFIC = {"loop": "serve_dia_closed", "clients": 4, "max_batch": 2,
                    "text_chars": [20, 30], "voices": 2,
                    "voice_latents": [4, 8], "frames_per_char": 0.5,
                    "transcript_chars_per_s": 14, "warm_batches": [2],
                    "check_requests": 2, "base_seed": 7}


def tiny_dia_config() -> dict:
    from echo_tts_torch.config import tiny_dac44k_config
    from echo_tts_torch.config import tiny_dia_config as tiny
    dia = dataclasses.asdict(tiny())
    codec = dataclasses.asdict(tiny_dac44k_config())
    lists = {k: list(v) if isinstance(v, tuple) else v
             for k, v in {**dia, **codec}.items()}
    return {"name": "tiny-dia", "source": "test", "reduced": [],
            "dtype": "float32",
            "dia": {k: lists[k] for k in dia},
            "codec": {k: lists[k] for k in codec},
            "sampler": {"cfg_scale": 3.0, "temperature": 1.3, "top_p": 0.95,
                        "top_k": 8}}


def _root(tmp_path) -> str:
    """A copy of the benchmark with the tiny Dia cell added as data."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cfg = tiny_dia_config()
    with open(os.path.join(root, "benchmark", "configs", "tiny-dia.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "benchmark", "traffic", "tiny-dia.json"),
              "w") as f:
        json.dump(TINY_DIA_TRAFFIC, f)
    with open(os.path.join(root, "benchmark", "limits", "tiny-dia.json"),
              "w") as f:
        json.dump({"limits": {"logits_rel_rms": 1e-4, "audio_rel_rms": 1e-4,
                              "codes_off_draw": 0},
                   "control": {"rest": "fp8"}}, f)
    manifest["configs"].append({"name": "tiny-dia", "source": "test",
                                "file": "benchmark/configs/tiny-dia.json",
                                "reduced": [], "why": "tiny"})
    manifest["workloads"].append({"name": "tiny-dia", "config": "tiny-dia",
                                  "traffic": "tiny-dia", "chips": 1,
                                  "why": "tiny"})
    for m in manifest["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("tiny-dia")
    for m in manifest["per_layer"]:
        if m["name"].endswith(".dia"):
            m["workloads"].append("tiny-dia")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root


@pytest.mark.parametrize("trace", [False, True])
def test_dia_loop_serves_the_tiny_cell_on_the_cpu(tmp_path, trace):
    from echo_tts_torch.sampler import ar
    root = _root(tmp_path)
    steps = ar.generate.steps
    res = harness.run(root, "tiny-dia", 2 ** 40 + 12345, 3.0, trace,
                      t_start=time.monotonic(), device="cpu")
    assert res["correct"], res
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["compared"]) == {"logits_rel_rms", "audio_rel_rms",
                                    "codes_off_draw"}
    assert res["compared"]["logits_rel_rms"]["value"] < 1e-4
    assert res["compared"]["codes_off_draw"]["value"] == 0
    if trace:
        m = res["metrics"]
        assert m["mfu.dia"]["value"] > 0
        assert m["idle_share.dia"]["value"] == pytest.approx(100.0)
        # no device, no kernel: the device readers find nothing
        assert "decode_roofline.dia" not in m
        assert "res_stack_roofline.dia" not in m
    else:
        assert res["metrics"]["audio_s_per_s"]["value"] > 0
    assert ar.generate.steps > steps


def test_dialogue_turns():
    assert dialogue("one two three four") == "[S1] one two [S2] three four"
    assert dialogue("single") == "[S1] single [S2] "


# the hand counts below are of this configuration
HAND = {"encoder_n_layer": 1, "encoder_n_embd": 4, "encoder_n_hidden": 8,
        "encoder_n_head": 2, "encoder_head_dim": 2, "decoder_n_layer": 2,
        "decoder_n_embd": 8, "decoder_n_hidden": 16, "gqa_query_heads": 4,
        "kv_heads": 2, "gqa_head_dim": 2, "cross_query_heads": 4,
        "cross_head_dim": 2, "channels": 3, "tgt_vocab_size": 10,
        "delay_pattern": [0, 1, 2]}


def test_dia_counts_against_hand_counts():
    # one decoder layer's linears for one token: q 8x8, k and v 8x4 each,
    # o 8x8, cross q and o 8x8 each, the MLP 3 x 8 x 16
    linear = 64 + 2 * 32 + 64 + 2 * 64 + 3 * 128
    assert dia_counts._decoder_linear_macs(HAND) == linear == 704
    head = 8 * 3 * 10
    # a token at context 5 over 6 text bytes: self QK and PV 2 x 5 x 8,
    # cross 2 x 6 x 8, both layers, then the head
    assert dia_counts.decoder_token_flops(HAND, 5, 6, True) == 2 * (
        2 * (linear + 80 + 96) + head)
    # the encoder over 3 bytes: 4 projections 4x4, the MLP 3 x 4 x 8,
    # attention 2 x 3 x 3 x 4
    assert dia_counts.encoder_flops(HAND, 3) == 2 * ((64 + 96) * 3 + 72)
    # one step's bytes, 2 rows, attention over 7 positions, text width 5:
    # weights (2 layers x 704 + the head 240) bf16; self K/V 2 layers x 2
    # rows x (k, v) x 4 x 7; cross 2 x 2 x 2 x 8 x 5; the new K/V; the
    # embedding rows 2 x 3 x 8; the logits 2 x 3 x 10 fp32
    want = (2 * (2 * 704 + 240) + 2 * (2 * 2 * 2 * 4 * 7)
            + 2 * (2 * 2 * 2 * 8 * 5) + 2 * (2 * 2 * 2 * 4) + 2 * 2 * 3 * 8
            + 4 * 2 * 3 * 10)
    assert dia_counts.decode_step_bytes(HAND, 2, 7, 5) == want
    assert dia_counts.step_lengths(4, 126, 128, 200) == [128, 128, 200, 200]
    # the request's decode: steps 3 + 2 at context prompt + 1 + s
    f = dia_counts.request_flops(HAND, 6, 4, 3)
    per = dia_counts.decoder_token_flops(HAND, 0, 6, True)
    ctx = sum(4 + 1 + s for s in range(5))
    assert f["decode"] == 2 * (5 * per + 2.0 * 2 * 2 * 8 * ctx)
    assert f["prefill"] == 2 * sum(dia_counts.decoder_token_flops(
        HAND, t + 1, 6, False) for t in range(4))


def test_res_stack_calls_count_each_row_at_its_length():
    codec = {"decoder_dim": 1536, "decoder_rates": [8, 8, 4, 2]}
    calls = dia_counts.res_stack_calls(codec, [10, 4])
    assert len(calls) == 3                       # C = 384, 192, 96
    ops, nbytes = calls[0]
    assert ops == 3 * 2.0 * 8 * 384 ** 2 * 64 * 14
    assert nbytes == 2 * 64 * 14 * 384 * 2 + 3 * 8 * 384 ** 2 * 2 \
        + 3 * 4 * 384 * 2


def _reader(name):
    path = os.path.join(REPO, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(passes, device, window=(0, 10 ** 9)):
    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                      "dia-1.6b-bf16.json")))
    trace = harness.Trace.__new__(harness.Trace)
    trace.window, trace.device, trace.host = window, device, []
    return SimpleNamespace(cell=SimpleNamespace(config=cfg), trace=trace,
                           passes=passes, counters={})


def _pass():
    p = DiaPass(0.0, 1.0, 0, 10 ** 9, ["a", "b", "b"], [900, 800, 800],
                [344, 688, 688], [200, 180, 180], text_width=1024,
                steps=915, capacity=3072, attn_bucket=128,
                decode_batches=[3])
    p.stages = {"dia.decode": [(10 ** 8, 9 * 10 ** 8)]}
    return p


def test_readers_on_a_made_up_context():
    p = _pass()
    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                      "dia-1.6b-bf16.json")))["dia"]
    # half of the decode span busy: 0.4 s of device time inside it
    device = [(2 * 10 ** 8, 4 * 10 ** 8, "gemm"),
              (5 * 10 ** 8, 7 * 10 ** 8, "res_unit_kernel<96>"),
              (9 * 10 ** 8, 10 ** 9, "x")]
    ctx = _ctx([p], device)
    flops = sum(sum(dia_counts.request_flops(cfg, 200 if i == 0 else 180,
                                             344 if i == 0 else 688,
                                             900 if i == 0 else 800).values())
                for i in (0, 1))
    assert _reader("mfu.dia")(ctx) == pytest.approx(
        100 * flops / dia_counts.PEAK_BF16)
    least = sum(dia_counts.decode_step_bytes(cfg, 6, n, 1024)
                for n in dia_counts.step_lengths(915, 688, 128, 3072))
    assert _reader("decode_roofline.dia")(ctx) == pytest.approx(
        100 * least / dia_counts.PEAK_BYTES / 0.4)
    codec = ctx.cell.config["codec"]
    bound = sum(max(o / dia_counts.PEAK_BF16, b / dia_counts.PEAK_BYTES)
                for o, b in dia_counts.res_stack_calls(codec,
                                                       [900, 800, 800]))
    assert _reader("res_stack_roofline.dia")(ctx) == pytest.approx(
        100 * bound / 0.2)
    assert _reader("idle_share.dia")(ctx) == pytest.approx(50.0)
    # a program without the Dia spans: nothing to read
    bare = DiaPass(0.0, 1.0, 0, 10 ** 9, ["a"], [10], [4], [5])
    empty = _ctx([bare], [])
    for name in ("mfu.dia", "decode_roofline.dia", "res_stack_roofline.dia"):
        assert _reader(name)(empty) is None


@pytest.mark.parametrize("changed", [{}, {"cfg_scale": 0.0},
                                     {"temperature": 1.0}, {"top_p": 1.0}])
def test_draw_check_sees_each_sampler_setting(changed):
    """The check's draw count on made-up logits at Dia's vocabulary: codes
    the program's sampler drew at the cell's settings are all on the
    reference's draw; drawn with one setting changed, many are off."""
    import numpy as np
    import torch
    from echo_tts_torch.config import DiaConfig
    from echo_tts_torch.sampler import ar
    cfg = json.load(open(os.path.join(REPO, "benchmark", "configs",
                                      "dia-1.6b-bf16.json")))
    dia = DiaConfig(**{**cfg["dia"], "delay_pattern": tuple(
        cfg["dia"]["delay_pattern"])})
    n, prompt, seed = 40, 5, 2 ** 40 + 9
    steps = n + dia.max_delay
    g = torch.Generator().manual_seed(3)
    lc = 2.0 * torch.randn(steps, dia.channels, 1028, generator=g)
    lu = lc + 0.5 * torch.randn(steps, dia.channels, 1028, generator=g)
    lc, lu = lc.bfloat16().float(), lu.bfloat16().float()
    lo, hi = ar.split_seed(seed)
    u = ar.uniforms(torch.full((steps,), lo), torch.full((steps,), hi),
                    torch.arange(steps) + prompt + 1, dia.channels)
    p = {**cfg["sampler"], **changed}
    drawn = ar.sample_codes(lc, lu, u, dia, p["cfg_scale"], p["temperature"],
                            p["top_p"], p["top_k"]).numpy()
    step = np.arange(n)[:, None] + np.asarray(dia.delay_pattern)[None]
    codes = drawn[step, np.arange(dia.channels)[None]]
    loop = SimpleNamespace(
        cell=SimpleNamespace(config=cfg), device="cpu",
        _request=lambda r, keep: SimpleNamespace(
            seed=seed, prompt_codes=np.zeros((prompt, dia.channels))))
    got = draws_off(loop, [{"request": None, "codes": codes,
                            "logits": torch.stack([lc, lu]).numpy()}])
    assert got["checked"] == n * dia.channels
    assert got["edges"] < 0.05 * got["checked"]
    if changed:
        assert got["off"] >= 5
    else:
        assert got["off"] == 0


def test_a_tree_without_dia_fails_at_once(tmp_path):
    """The parent of the change has no echo_tts_torch Dia: the cell's set-up
    raises before it builds anything."""
    root = _root(tmp_path)
    shutil.copytree(os.path.join(REPO, "echo_tts_torch"),
                    os.path.join(root, "echo_tts_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.remove(os.path.join(root, "echo_tts_torch", "models", "dia.py"))
    code = ("import time, sys; from benchmark import harness\n"
            "try:\n"
            "    harness.run('.', 'tiny-dia', 1, 3.0, False,"
            " t_start=time.monotonic(), device='cpu')\n"
            "except ImportError as e:\n"
            "    print('ImportError', e); sys.exit(1)\n")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1, out.stderr
    assert "ImportError" in out.stdout
    assert time.monotonic() - t0 < 60
