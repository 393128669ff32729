"""Interactive demo: the functional core of the reference Gradio app.

Counterpart of echo_tts_tpu/demo/app.py.  The whole parameter surface of
generate_audio (reference: gradio_app.py:158-319) as a session object
that needs no UI framework: sampler presets (serve/sampler_presets.json),
CFG presets, truncation/rescale presets, force-speaker (speaker-KV)
controls, the text and speaker length buckets, the AE-reconstruction
debug output and session-scoped temp-file cleanup (gradio_app.py:78-107).
`launch_gradio()` wraps it in a Blocks UI when gradio is installed.  A
session generates through sample_pipeline with the Euler sampler, its
noise drawn from a torch.Generator on the models' device seeded with the
request's seed.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import shutil
import tempfile
import time
import uuid
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import SAMPLER_DEFAULTS
from ..pipeline import audio_io
from ..pipeline.pipeline import (EchoModels, ae_reconstruct, euler_sample_fn,
                                 sample_pipeline)
from ..pipeline.text import find_min_bucket_gte
from ..serve.presets import SPEAKER_BUCKETS as DEFAULT_SPEAKER_BUCKETS
from ..serve.presets import TEXT_BUCKETS as DEFAULT_TEXT_BUCKETS
from ..serve.presets import load_presets

# reference: gradio_app.py:372-389
CFG_PRESETS: Dict[str, Tuple[float, float, float, float]] = {
    "higher speaker": (3.0, 8.0, 0.5, 1.0),
    "large guidances": (8.0, 8.0, 0.5, 1.0),
}

# reference: gradio_app.py:409-428 (truncation, rescale_k, rescale_sigma)
TRUNCATION_PRESETS: Dict[str, Tuple[float, float, float]] = {
    "flat": (0.8, 1.2, 3.0),
    "sharp": (0.9, 0.96, 3.0),
    "baseline(sharp)": (1.0, 1.0, 3.0),
}

DEFAULT_SAMPLE_LATENT_LENGTH = 640

TEXT_PRESETS_PATH = os.path.join(os.path.dirname(__file__),
                                 "text_presets.txt")
AUDIO_EXTS = {".wav", ".mp3", ".m4a", ".ogg", ".flac", ".webm", ".aac",
              ".opus"}


# ---------------------------------------------------------------------------
# Preset appliers — UI-framework-independent versions of the reference's
# gr.update factories (gradio_app.py:372-483).  Each returns a plain
# {field: value} dict (None for unknown names); launch_gradio maps them to
# gr.update calls, and tests drive them directly.
# ---------------------------------------------------------------------------

def apply_cfg_preset(name: str) -> Optional[Dict[str, float]]:
    """CFG guidance presets (reference: gradio_app.py:372-389)."""
    if name not in CFG_PRESETS:
        return None
    text_scale, speaker_scale, min_t, max_t = CFG_PRESETS[name]
    return {"cfg_scale_text": text_scale, "cfg_scale_speaker": speaker_scale,
            "cfg_min_t": min_t, "cfg_max_t": max_t}


def apply_truncation_preset(name: str) -> Optional[Dict[str, float]]:
    """Truncation & temporal-rescale presets (gradio_app.py:409-428)."""
    if name not in TRUNCATION_PRESETS:
        return None
    trunc, k, sigma = TRUNCATION_PRESETS[name]
    return {"truncation_factor": trunc, "rescale_k": k, "rescale_sigma": sigma}


def apply_speaker_kv_preset(name: str) -> Optional[Dict[str, bool]]:
    """Speaker-KV enable/off proxies (gradio_app.py:392-406)."""
    if name == "enable":
        return {"force_speaker": True}
    if name == "off":
        return {"force_speaker": False}
    return None


SAMPLER_PRESET_FIELDS = (
    "num_steps", "cfg_scale_text", "cfg_scale_speaker", "cfg_min_t",
    "cfg_max_t", "truncation_factor", "rescale_k", "rescale_sigma",
    "force_speaker", "speaker_kv_scale", "speaker_kv_min_t",
    "speaker_kv_max_layers")


def apply_sampler_preset(name: str) -> Optional[Dict]:
    """Resolve a named sampler preset (serve/sampler_presets.json — same
    values as the reference's sampler_presets.json) to the full field dict
    the preset dropdown drives (gradio_app.py:454-483).

    The per-field fallbacks below are the REFERENCE UI's own defaults
    (gradio_app.py:470-483) — deliberately not config.SAMPLER_DEFAULTS,
    which is the serving-request default set (e.g. cfg_scale_speaker 8.0
    vs the UI's 5.0); they only matter for hand-edited preset files
    missing fields."""
    presets = load_presets()
    if name not in presets:
        return None
    p = presets[name]
    return {
        "num_steps": int(p.get("num_steps", 40)),
        "cfg_scale_text": float(p.get("cfg_scale_text", 3.0)),
        "cfg_scale_speaker": float(p.get("cfg_scale_speaker", 5.0)),
        "cfg_min_t": float(p.get("cfg_min_t", 0.5)),
        "cfg_max_t": float(p.get("cfg_max_t", 1.0)),
        "truncation_factor": float(p.get("truncation_factor", 0.8)),
        "rescale_k": float(p.get("rescale_k", 1.2)),
        "rescale_sigma": float(p.get("rescale_sigma", 3.0)),
        "force_speaker": bool(p.get("speaker_kv_enable", False)),
        "speaker_kv_scale": float(p.get("speaker_kv_scale", 1.5)),
        "speaker_kv_min_t": float(p.get("speaker_kv_min_t", 0.9)),
        "speaker_kv_max_layers": int(p.get("speaker_kv_max_layers", 24)),
    }


def load_text_presets(path: Optional[str] = None):
    """Text-presets library: "Category | text" lines ->
    [category, word_count, text] rows (gradio_app.py:323-341)."""
    path = path or TEXT_PRESETS_PATH
    if not os.path.isfile(path):
        return []
    with open(path, encoding="utf-8") as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    rows = []
    for ln in lines:
        if " | " in ln:
            category, text = ln.split(" | ", 1)
        else:
            category, text = "Uncategorized", ln
        rows.append([category, str(len(text.split())), text])
    return rows


def list_voice_files(voices_dir: Optional[str], query: str = ""):
    """Audio-library listing with substring filter
    (gradio_app.py:487-504)."""
    if not voices_dir or not os.path.isdir(voices_dir):
        return []
    names = sorted(
        (n for n in os.listdir(voices_dir)
         if os.path.isfile(os.path.join(voices_dir, n))
         and os.path.splitext(n)[1].lower() in AUDIO_EXTS),
        key=str.lower)
    q = query.strip().lower()
    if q:
        names = [n for n in names if q in n.lower()]
    return names


@dataclasses.dataclass
class GenerationResult:
    audio_path: str
    normalized_text: str
    generation_seconds: float
    reconstruction_path: Optional[str] = None
    original_path: Optional[str] = None


class DemoSession:
    """One user session: models + temp dir + cleanup, mirroring the
    session-scoped behavior of the reference app."""

    def __init__(self, models: EchoModels, temp_dir: Optional[str] = None,
                 session_id: Optional[str] = None):
        self.models = models
        temp_dir = temp_dir or os.path.join(tempfile.gettempdir(), "echo_demo")
        self.session_id = session_id or uuid.uuid4().hex[:8]
        self.temp_dir = os.path.join(temp_dir, self.session_id)
        os.makedirs(self.temp_dir, exist_ok=True)

    def cleanup(self) -> None:
        """Session temp cleanup (reference: gradio_app.py:78-96)."""
        shutil.rmtree(self.temp_dir, ignore_errors=True)
        os.makedirs(self.temp_dir, exist_ok=True)

    def _save(self, stem: str, audio: np.ndarray) -> str:
        path = os.path.join(self.temp_dir,
                            f"{stem}_{uuid.uuid4().hex[:6]}.wav")
        audio_io.write_wav(path, audio, 44100)
        return path

    def generate_audio(
        self,
        text_prompt: str,
        speaker_audio_path: Optional[str] = None,
        num_steps: int = 40,
        rng_seed: int = 0,
        cfg_scale_text: float = 3.0,
        cfg_scale_speaker: float = 8.0,
        cfg_min_t: float = 0.5,
        cfg_max_t: float = 1.0,
        truncation_factor: float = 1.0,
        rescale_k: float = 1.0,
        rescale_sigma: float = 3.0,
        force_speaker: bool = False,
        speaker_kv_scale: float = 1.5,
        speaker_kv_min_t: float = 0.9,
        speaker_kv_max_layers: int = 24,
        reconstruct_reference: bool = False,
        use_custom_shapes: bool = True,
        max_text_byte_length: str = DEFAULT_TEXT_BUCKETS,
        max_speaker_latent_length: str = DEFAULT_SPEAKER_BUCKETS,
        sample_latent_length: int = DEFAULT_SAMPLE_LATENT_LENGTH,
        show_original_audio: bool = False,
    ) -> GenerationResult:
        """Mirror of the reference generate_audio parameter coercion
        (gradio_app.py:205-277)."""
        t0 = time.time()
        models = self.models
        spl = models.dac_cfg.frame_length

        num_steps = min(max(int(num_steps), 1), 80)  # gradio_app.py:204
        rescale_k_val = float(rescale_k) if rescale_k != 1.0 else None

        kv_scale = kv_min_t = kv_max_layers = None
        if force_speaker:  # gradio_app.py:215-223
            kv_scale = float(speaker_kv_scale)
            kv_min_t = float(speaker_kv_min_t)
            kv_max_layers = int(speaker_kv_max_layers)

        speaker_audio = None
        if speaker_audio_path:
            speaker_audio = audio_io.load_audio(speaker_audio_path)

        if use_custom_shapes:  # gradio_app.py:229-247
            actual_text = len(text_prompt.encode("utf-8")) + 1  # BOS
            pad_text = find_min_bucket_gte(max_text_byte_length, actual_text)
            if speaker_audio is not None:
                ps = models.dit_cfg.speaker_patch_size
                actual_spk = (speaker_audio.shape[-1] // spl) // ps * ps
            else:
                actual_spk = 0
            pad_spk = find_min_bucket_gte(max_speaker_latent_length,
                                          actual_spk)
        else:
            pad_text = pad_spk = None

        sample_fn = functools.partial(
            euler_sample_fn,
            num_steps=num_steps,
            cfg_scale_text=float(cfg_scale_text),
            cfg_scale_speaker=float(cfg_scale_speaker),
            cfg_min_t=float(cfg_min_t), cfg_max_t=float(cfg_max_t),
            truncation_factor=float(truncation_factor),
            rescale_k=rescale_k_val, rescale_sigma=float(rescale_sigma),
            speaker_kv_scale=kv_scale, speaker_kv_min_t=kv_min_t,
            speaker_kv_max_layers=kv_max_layers,
            sequence_length=int(sample_latent_length))

        audio_out, normalized = sample_pipeline(
            models, sample_fn, text_prompt, speaker_audio,
            rng_seed=int(rng_seed),
            pad_to_max_text_length=pad_text,
            pad_to_max_speaker_latent_length=pad_spk)

        result = GenerationResult(
            audio_path=self._save("generated", audio_out),
            normalized_text=normalized,
            generation_seconds=time.time() - t0)

        if reconstruct_reference and speaker_audio is not None:
            # Debug-by-listening round trip (gradio_app.py:291-302)
            n = spl * 640
            clip = speaker_audio[..., :n]
            clip = np.pad(clip, ((0, 0), (0, max(0, n - clip.shape[-1]))))
            recon = ae_reconstruct(models, torch.from_numpy(clip)).cpu().numpy()
            recon = recon[..., : speaker_audio.shape[-1]]
            result.reconstruction_path = self._save("speaker_recon", recon)

        if show_original_audio and speaker_audio is not None:
            result.original_path = self._save("original_audio",
                                              speaker_audio)
        return result


def select_text_preset_row(row_index, rows=None) -> Optional[str]:
    """Resolve a text-presets table row selection to its preset text
    (gradio_app.py:344-357)."""
    rows = load_text_presets() if rows is None else rows
    if isinstance(row_index, (tuple, list)) and row_index:
        row_index = row_index[0]
    if isinstance(row_index, int) and 0 <= row_index < len(rows):
        return rows[row_index][2]
    return None


def launch_gradio(models: EchoModels,
                  voices_dir: Optional[str] = None,
                  **launch_kwargs):  # pragma: no cover
    """Gradio Blocks wrapper covering the reference widget surface
    (reference: gradio_app.py:430-994): sampler-preset dropdown, CFG /
    truncation / speaker-KV preset appliers, text-presets library, voice
    library dropdown, force-speaker row toggle, generate + outputs."""
    try:
        import gradio as gr
    except ImportError as e:
        raise ImportError(
            "launch_gradio needs the gradio package, which is not installed; "
            "DemoSession and the preset functions work without it") from e

    session = DemoSession(models)

    def run(text, speaker, steps, seed, cfg_t, cfg_s, min_t, max_t,
            trunc, rk, rs, force, kvs, kvmt, kvml, recon):
        r = session.generate_audio(
            text, speaker, steps, seed, cfg_t, cfg_s, min_t, max_t,
            trunc, rk, rs, force, kvs, kvmt, kvml, recon)
        return (r.audio_path, r.normalized_text,
                f"{r.generation_seconds:.2f}s", r.reconstruction_path)

    preset_names = list(load_presets())

    with gr.Blocks(title="Echo-TTS (PyTorch)") as demo:
        # --- libraries (gradio_app.py:609-650, 734-760) ---
        voice_search = gr.Textbox(label="Voice search")
        voice_dd = gr.Dropdown(choices=list_voice_files(voices_dir),
                               label="Voice library")
        text_presets = gr.Dataframe(
            value=load_text_presets(),
            headers=["Category", "Words", "Preset Text"])
        text = gr.Textbox(label="Text", lines=4)
        speaker = gr.Audio(label="Speaker reference", type="filepath")

        # --- sampler parameters (gradio_app.py:666-786) ---
        preset_dd = gr.Dropdown(choices=["Custom"] + preset_names,
                                value=preset_names[0],
                                label="Sampler preset")
        steps = gr.Slider(1, 80, SAMPLER_DEFAULTS["num_steps"], step=1,
                          label="Steps")
        seed = gr.Number(0, label="Seed", precision=0)
        cfg_t = gr.Slider(0, 12, 3.0, label="CFG text")
        cfg_s = gr.Slider(0, 12, 8.0, label="CFG speaker")
        min_t = gr.Slider(0, 1, 0.5, label="CFG min t")
        max_t = gr.Slider(0, 1, 1.0, label="CFG max t")
        trunc = gr.Slider(0.5, 1.0, 1.0, label="Truncation")
        rk = gr.Slider(0.5, 2.0, 1.0, label="Rescale k")
        rs = gr.Slider(0.5, 6.0, 3.0, label="Rescale sigma")
        force = gr.Checkbox(False, label="Force speaker")
        with gr.Row(visible=False) as kv_row:
            kvs = gr.Slider(1.0, 3.0, 1.5, label="Speaker KV scale")
            kvmt = gr.Slider(0, 1, 0.9, label="Speaker KV min t")
            kvml = gr.Slider(1, 24, 24, step=1,
                             label="Speaker KV max layers")
        recon = gr.Checkbox(False, label="AE-reconstruct reference")
        cfg_btns = {n: gr.Button(f"CFG: {n}") for n in CFG_PRESETS}
        trunc_btns = {n: gr.Button(f"Truncation: {n}")
                      for n in TRUNCATION_PRESETS}
        kv_on = gr.Button("Speaker KV: enable")
        kv_off = gr.Button("Speaker KV: off")
        btn = gr.Button("Generate")
        audio = gr.Audio(label="Output")
        norm = gr.Markdown()
        took = gr.Markdown()
        recon_audio = gr.Audio(label="Reference reconstruction")

        # --- wiring (gradio_app.py:857-935) ---
        btn.click(run, [text, speaker, steps, seed, cfg_t, cfg_s, min_t,
                        max_t, trunc, rk, rs, force, kvs, kvmt, kvml,
                        recon],
                  [audio, norm, took, recon_audio])

        sampler_fields = [steps, cfg_t, cfg_s, min_t, max_t, trunc, rk,
                          rs, force, kvs, kvmt, kvml]

        def on_sampler_preset(name):
            p = apply_sampler_preset(name)
            if p is None:
                return [gr.update()] * (len(sampler_fields) + 1)
            return ([gr.update(value=p[f]) for f in SAMPLER_PRESET_FIELDS]
                    + [gr.update(visible=p["force_speaker"])])

        preset_dd.change(on_sampler_preset, [preset_dd],
                         sampler_fields + [kv_row])

        def _cfg_clicker(name):
            def apply():
                p = apply_cfg_preset(name)
                return [gr.update(value=p["cfg_scale_text"]),
                        gr.update(value=p["cfg_scale_speaker"]),
                        gr.update(value=p["cfg_min_t"]),
                        gr.update(value=p["cfg_max_t"]),
                        gr.update(value="Custom")]
            return apply

        for name, b in cfg_btns.items():
            b.click(_cfg_clicker(name), [],
                    [cfg_t, cfg_s, min_t, max_t, preset_dd])

        def _trunc_clicker(name):
            def apply():
                p = apply_truncation_preset(name)
                return [gr.update(value=p["truncation_factor"]),
                        gr.update(value=p["rescale_k"]),
                        gr.update(value=p["rescale_sigma"]),
                        gr.update(value="Custom")]
            return apply

        for name, b in trunc_btns.items():
            b.click(_trunc_clicker(name), [], [trunc, rk, rs, preset_dd])

        def _kv_clicker(name):
            def apply():
                p = apply_speaker_kv_preset(name)
                return [gr.update(value=p["force_speaker"]),
                        gr.update(visible=p["force_speaker"]),
                        gr.update(value="Custom")]
            return apply

        kv_on.click(_kv_clicker("enable"), [], [force, kv_row, preset_dd])
        kv_off.click(_kv_clicker("off"), [], [force, kv_row, preset_dd])

        force.change(lambda v: gr.update(visible=bool(v)), [force],
                     [kv_row])

        def on_text_preset(evt: gr.SelectData):
            t = select_text_preset_row(getattr(evt, "index", None))
            return gr.update(value=t) if t is not None else gr.update()

        text_presets.select(on_text_preset, None, [text])

        def on_voice_search(q):
            return gr.update(choices=list_voice_files(voices_dir, q))

        voice_search.change(on_voice_search, [voice_search], [voice_dd])

        def on_voice_pick(name):
            if name and voices_dir:
                return gr.update(value=os.path.join(voices_dir, name))
            return gr.update()

        voice_dd.change(on_voice_pick, [voice_dd], [speaker])

    return demo.launch(**launch_kwargs)
