"""Fixtures of the benchmark's own tests: a copy of the benchmark with
tiny cells added as data files, which the harness serves on the CPU.

    python -m pytest benchmark/tests -q

Tests marked `card` need an NVIDIA card and skip without one; on the card
they run with the same command.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")


def tiny_config(dtype: str = "float32", quant: str = "none") -> dict:
    from echo_tts_torch.config import tiny_dac_config, tiny_dit_config
    dit = dataclasses.asdict(tiny_dit_config())
    codec = dataclasses.asdict(tiny_dac_config())
    codec = {k: list(v) if isinstance(v, tuple) else v
             for k, v in codec.items()}
    return {"name": "tiny", "source": "test", "reduced": [],
            "dtype": dtype, "dit_quant": quant, "dit": dit, "codec": codec,
            "sampler": {"num_steps": 4, "cfg_scale_text": 3.0,
                        "cfg_scale_speaker": 8.0, "cfg_min_t": 0.5,
                        "cfg_max_t": 1.0}}


TINY_TRAFFIC = {
    "tiny-open": {"loop": "serve_open", "rate_per_s": 4.0,
                  "sequence_length": 16, "text_chars": [20, 40], "voices": 2,
                  "voice_latents": [8, 16], "speaker_bucket": 16,
                  "max_batch": 4, "warm_batches": [1, 2, 4],
                  "check_requests": 3, "base_seed": 5},
    "tiny-closed": {"loop": "serve_closed", "clients": 4,
                    "sequence_length": 16, "text_chars": [20, 40],
                    "voices": 2, "voice_latents": [8, 16],
                    "speaker_bucket": 16, "max_batch": 2,
                    "warm_batches": [2], "check_requests": 2,
                    "base_seed": 6},
}


def add_cell(root: str, name: str, config: dict, traffic: str,
             limits: dict, end_to_end: str) -> None:
    """A cell added the way a later change adds one: new data files and
    manifest entries, no edit to a file of the harness."""
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        manifest = json.load(f)
    cfg_file = f"benchmark/configs/{config['name']}.json"
    if not any(c["name"] == config["name"] for c in manifest["configs"]):
        with open(os.path.join(root, cfg_file), "w") as f:
            json.dump(config, f)
        manifest["configs"].append(
            {"name": config["name"], "source": "test", "file": cfg_file,
             "reduced": [], "why": "tiny"})
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{traffic}.json"), "w") as f:
        json.dump(TINY_TRAFFIC[traffic], f)
    with open(os.path.join(root, "benchmark", "limits",
                           f"{name}.json"), "w") as f:
        json.dump({"limits": limits, "control": {"rest": "fp8"}}, f)
    manifest["workloads"].append(
        {"name": name, "config": config["name"], "traffic": traffic,
         "chips": 1, "why": "tiny"})
    for m in manifest["end_to_end"]:
        if m["name"] == end_to_end:
            m["workloads"].append(name)
    with open(path, "w") as f:
        json.dump(manifest, f)


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark (BENCHMARK.json and benchmark/) with the
    tiny cells tiny-open (open loop) and tiny-closed (closed loop), fp32
    on the CPU."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    limits = {"latent_rel_rms": 1e-4, "audio_rel_rms": 1e-4}
    add_cell(root, "tiny-open", tiny_config(), "tiny-open", limits,
             "request_p90_ms")
    add_cell(root, "tiny-closed", tiny_config(), "tiny-closed", limits,
             "audio_s_per_s")
    return root
