"""The check catches a broken timed path.

Each fault is planted under the harness at the tiny size on the CPU (the
look for a card skipped, everything else a normal run), and the run must
come out not correct: a sampler step that returns its state unchanged;
half of a pass's rows left out (their latents copied from the other
half); an answer altered where it is produced (the served audio).  One
card serves every cell, so no exchange between cards can be left out.
The control, the reference with its products one precision down in the
program's place, runs at each cell's own size on the card (`card`)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import REPO


def _check_every_request(root, traffic):
    path = os.path.join(root, "benchmark", "traffic", f"{traffic}.json")
    with open(path) as f:
        params = json.load(f)
    params["check_requests"] = 1000
    with open(path, "w") as f:
        json.dump(params, f)


def _state_unchanged(monkeypatch):
    from echo_tts_torch.models import dit
    forward = dit.dit_forward_static
    monkeypatch.setattr(dit, "dit_forward_static",
                        lambda *a, **k: torch.zeros_like(forward(*a, **k)))


def _half_the_batch(monkeypatch):
    from echo_tts_torch.serve import batcher
    sample = batcher.sample_euler_cfg_independent_guidances

    def half(*a, **k):
        out = sample(*a, **k)
        n = out.shape[0] // 2
        if n:
            out = out.clone()
            out[out.shape[0] - n:] = out[:n]
        return out
    monkeypatch.setattr(batcher, "sample_euler_cfg_independent_guidances",
                        half)


def _answer_altered(monkeypatch):
    from echo_tts_torch.pipeline import dsp
    crop = dsp.crop_audio_to_flattening_point

    def altered(audio, latent, **k):
        out = crop(audio, latent, **k).copy()
        out[..., : max(1, out.shape[-1] // 10)] *= -1.0
        return out
    monkeypatch.setattr(dsp, "crop_audio_to_flattening_point", altered)


@pytest.mark.parametrize("cell,traffic", [("tiny-open", "tiny-open"),
                                          ("tiny-closed", "tiny-closed")])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered])
def test_fault_fails_the_check(tiny_root, monkeypatch, cell, traffic, fault):
    _check_every_request(tiny_root, traffic)
    fault(monkeypatch)
    res = harness.run(tiny_root, cell, 9876543210, 2.0, False,
                      t_start=time.monotonic(), device="cpu")
    assert not res["correct"], res["compared"]


def test_control_fails_the_check_on_the_cpu(tiny_root):
    """The control at the tiny size: the reference with every product on
    fp8 operands, in the program's place."""
    res = harness.run(tiny_root, "tiny-closed", 9876543210, 2.0, False,
                      t_start=time.monotonic(), device="cpu", control=True)
    assert not res["correct"]
    assert res["compared"]["latent_rel_rms"]["value"] > 1e-2
    assert res["compared"]["audio_rel_rms"]["value"] > 1e-2


def test_sound_run_passes_with_every_request_checked(tiny_root):
    _check_every_request(tiny_root, "tiny-closed")
    res = harness.run(tiny_root, "tiny-closed", 9876543210, 2.0, False,
                      t_start=time.monotonic(), device="cpu")
    assert res["correct"], res["compared"]


@pytest.mark.card
@pytest.mark.parametrize("workload", ["serve-bf16-open", "serve-w8a8-bulk"])
def test_control_is_not_correct(card, workload):
    """The control at the cell's own size, three seeds: the reference one
    precision down in the program's place must fail the check."""
    for seed in (4100000001, 4100000002, 4100000003):
        out = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload", workload,
             "--seed", str(seed), "--seconds", "15", "--trace", "0",
             "--control"], capture_output=True, text=True, cwd=REPO,
            timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert not res["correct"], res["compared"]
