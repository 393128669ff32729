"""The port's demo (echo_tts_torch/demo/app.py) against the JAX package's
(its preset functions give equal outputs), its session against
sample_pipeline (equal audio), launch_gradio without gradio (a clear
ImportError) and with a stand-in recording its wiring; and the CUDA
deploy files' entry point.
"""
import functools
import importlib.util
import os
import re
import sys
import types

import numpy as np
import pytest
import torch

from echo_tts_tpu.demo import app as japp

from echo_tts_torch.config import tiny_dac_config, tiny_dit_config
from echo_tts_torch.demo import app as tapp
from echo_tts_torch.pipeline import audio_io
from echo_tts_torch.pipeline.pipeline import (euler_sample_fn, random_models,
                                              sample_pipeline)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    return random_models("cpu", torch.float32, dit_cfg=tiny_dit_config(),
                         dac_cfg=tiny_dac_config())


def test_presets_match_jax(tmp_path):
    """The preset tables and appliers, the text-presets library (the copy
    of text_presets.txt is the JAX package's), the voice listing and the
    row selection give the JAX package's outputs."""
    assert tapp.CFG_PRESETS == japp.CFG_PRESETS
    assert tapp.TRUNCATION_PRESETS == japp.TRUNCATION_PRESETS
    assert tapp.SAMPLER_PRESET_FIELDS == japp.SAMPLER_PRESET_FIELDS
    for name in list(japp.CFG_PRESETS) + ["nope"]:
        assert tapp.apply_cfg_preset(name) == japp.apply_cfg_preset(name)
    for name in list(japp.TRUNCATION_PRESETS) + ["nope"]:
        assert (tapp.apply_truncation_preset(name)
                == japp.apply_truncation_preset(name))
    for name in ("enable", "off", "nope"):
        assert (tapp.apply_speaker_kv_preset(name)
                == japp.apply_speaker_kv_preset(name))
    from echo_tts_tpu.serve.presets import load_presets
    for name in list(load_presets()) + ["nope"]:
        assert tapp.apply_sampler_preset(name) == japp.apply_sampler_preset(name)
    rows = tapp.load_text_presets()
    assert rows and rows == japp.load_text_presets()
    with open(tapp.TEXT_PRESETS_PATH, "rb") as a, \
            open(japp.TEXT_PRESETS_PATH, "rb") as b:
        assert a.read() == b.read()
    for row in (0, (1, 2), 10 ** 6, None, []):
        assert (tapp.select_text_preset_row(row)
                == japp.select_text_preset_row(row))
    vd = tmp_path / "voices"
    vd.mkdir()
    for n in ("b.wav", "a.mp3", "notes.txt", "C.flac"):
        (vd / n).write_bytes(b"x")
    for q in ("", "wav", "A"):
        assert (tapp.list_voice_files(str(vd), q)
                == japp.list_voice_files(str(vd), q))
    assert tapp.list_voice_files(None) == [] == japp.list_voice_files(None)


def test_session_audio_equals_sample_pipeline(models, tmp_path, monkeypatch):
    """generate_audio with a speaker file runs sample_pipeline with the
    Euler sampler and the seed given to the models' generator: its audio
    equals sample_pipeline's, called directly with the same arguments,
    bit for bit, and so does the WAV it writes; the reconstruction and the
    original are written; cleanup empties the session's directory."""
    voice = tmp_path / "voice.wav"
    rng = np.random.default_rng(0)
    audio_io.write_wav(str(voice), np.tanh(rng.standard_normal((1, 800)))
                       .astype(np.float32), 44100)
    got = []

    def recording(*a, **k):
        out = sample_pipeline(*a, **k)
        got.append(out[0])
        return out

    monkeypatch.setattr(tapp, "sample_pipeline", recording)
    session = tapp.DemoSession(models, temp_dir=str(tmp_path / "demo"))
    result = session.generate_audio(
        "Demo generation.", str(voice), num_steps=2, rng_seed=5,
        sample_latent_length=8, force_speaker=True,
        reconstruct_reference=True, show_original_audio=True,
        max_speaker_latent_length="16", max_text_byte_length="64")
    fn = functools.partial(
        euler_sample_fn, num_steps=2, cfg_scale_text=3.0,
        cfg_scale_speaker=8.0, cfg_min_t=0.5, cfg_max_t=1.0,
        truncation_factor=1.0, rescale_k=None, rescale_sigma=3.0,
        speaker_kv_scale=1.5, speaker_kv_min_t=0.9, speaker_kv_max_layers=24,
        sequence_length=8)
    want, normalized = sample_pipeline(
        models, fn, "Demo generation.", audio_io.load_audio(str(voice)), 5,
        pad_to_max_text_length=64, pad_to_max_speaker_latent_length=16)
    assert len(got) == 1 and np.array_equal(got[0], want)
    written, sr = audio_io.read_wav(result.audio_path)
    wav = str(tmp_path / "want.wav")
    audio_io.write_wav(wav, want, 44100)
    assert sr == 44100 and np.array_equal(written, audio_io.read_wav(wav)[0])
    assert result.normalized_text == normalized
    assert os.path.isfile(result.reconstruction_path)
    assert os.path.isfile(result.original_path)
    session.cleanup()
    assert os.listdir(session.temp_dir) == []


def test_launch_gradio_without_gradio(models, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)
    with pytest.raises(ImportError, match="gradio"):
        tapp.launch_gradio(models)


def test_launch_gradio_wiring(models, monkeypatch, tmp_path):
    """With a stand-in for gradio that records the components and their
    callbacks, the Generate button drives a session end to end and the
    sampler-preset dropdown updates every sampler field."""
    clicks, changes = [], []

    class Component:
        def __init__(self, *args, **kwargs):
            self.args, self.label = args, kwargs.get("label")

        def change(self, fn, inputs=None, outputs=None):
            changes.append((self, fn, inputs, outputs))

        def select(self, fn, inputs=None, outputs=None):
            pass

        def click(self, fn, inputs=None, outputs=None):
            clicks.append((self, fn, inputs, outputs))

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def launch(self, **kwargs):
            return kwargs

    gr = types.ModuleType("gradio")
    for name in ("Blocks", "Row", "Textbox", "Audio", "Slider", "Number",
                 "Checkbox", "Markdown", "Dropdown", "Dataframe", "Button"):
        setattr(gr, name, Component)
    gr.update = lambda **kw: kw
    gr.SelectData = object
    monkeypatch.setitem(sys.modules, "gradio", gr)
    monkeypatch.setattr(tapp.tempfile, "gettempdir", lambda: str(tmp_path))
    assert tapp.launch_gradio(models, share=False) == {"share": False}
    gen = [c for c in clicks if c[0].args == ("Generate",)]
    assert len(gen) == 1 and len(gen[0][2]) == 16 and len(gen[0][3]) == 4
    path, normalized, took, recon = gen[0][1](
        "Wiring check.", None, 2, 0, 3.0, 8.0, 0.5, 1.0, 1.0, 1.0, 3.0,
        False, 1.5, 0.9, 2, False)
    assert os.path.isfile(path) and path.startswith(str(tmp_path))
    assert "Wiring check" in normalized and took.endswith("s")
    assert recon is None
    preset = [c for c in changes if c[0].label == "Sampler preset"]
    assert len(preset) == 1
    name = next(iter(tapp.load_presets()))
    updates = preset[0][1](name)
    fields = tapp.apply_sampler_preset(name)
    assert [u["value"] for u in updates[:-1]] == [
        fields[f] for f in tapp.SAMPLER_PRESET_FIELDS]


def test_cuda_bootstrap_execs_the_port_handler():
    """deploy/bootstrap_cuda.sh execs the port's serving handler, as
    deploy/bootstrap.sh execs the JAX package's; that module exists and
    its main imports without a card; the image copies the port and
    starts that bootstrap."""
    with open(os.path.join(REPO, "deploy", "bootstrap_cuda.sh")) as f:
        script = f.read()
    execs = re.findall(r"^exec python -m ([\w.]+)\s*$", script, re.M)
    assert execs == ["echo_tts_torch.serve.handler"]
    assert importlib.util.find_spec(execs[0]) is not None
    from echo_tts_torch.serve.handler import main
    assert callable(main)
    with open(os.path.join(REPO, "deploy", "Dockerfile.cuda")) as f:
        docker = f.read()
    assert "COPY echo_tts_torch ./echo_tts_torch" in docker
    assert 'CMD ["bash", "/app/bootstrap_cuda.sh"]' in docker
    assert "jax" not in docker.lower() and "jax" not in script.lower()
