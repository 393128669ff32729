"""Host audio IO: decode, resample, WAV/Opus encode.

The reference decodes with torchcodec + resamples with torchaudio and
Opus-encodes through an ffmpeg subprocess (reference: inference.py:104-113,
handler.py:517-535).  This environment has neither torchaudio nor a
guaranteed ffmpeg, so:
  * WAV read/write is native (stdlib `wave` + numpy);
  * other formats decode through ffmpeg when present (same subprocess
    contract as the reference), with a clear error otherwise;
  * resampling is a polyphase windowed-sinc (Hann) kernel equivalent to
    torchaudio.functional.resample's "sinc_interp_hann" method.
"""
from __future__ import annotations

import math
import shutil
import struct
import subprocess
import wave
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SAMPLE_RATE = 44_100


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


# ---------------------------------------------------------------------------
# WAV
# ---------------------------------------------------------------------------

def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns ((channels, samples) float32 in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        n_ch = w.getnchannels()
        width = w.getsampwidth()
        sr = w.getframerate()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        ints = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
        data = ints.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    return data.reshape(-1, n_ch).T.copy(), sr


def write_wav(path: str, audio: np.ndarray, sample_rate: int) -> None:
    """audio: (channels, samples) or (samples,) float32 in [-1, 1];
    writes 16-bit PCM."""
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = np.asarray(audio, dtype=np.float32)
    pcm = np.clip(np.round(pcm * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(pcm.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.T.tobytes())


# ---------------------------------------------------------------------------
# ffmpeg-backed decode / Opus encode (process boundary, like the reference)
# ---------------------------------------------------------------------------

def decode_with_ffmpeg(path: str, max_duration: Optional[float] = None
                       ) -> Tuple[np.ndarray, int]:
    """Decode any container to float32 PCM via ffmpeg."""
    if not ffmpeg_available():
        raise RuntimeError(
            f"ffmpeg not available; cannot decode {path!r} "
            "(only .wav is supported natively)")
    probe = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "a:0",
         "-show_entries", "stream=sample_rate,channels",
         "-of", "csv=p=0", str(path)],
        capture_output=True, text=True, check=True)
    sr_s, ch_s = probe.stdout.strip().split(",")[:2]
    sr, n_ch = int(sr_s), int(ch_s)
    cmd = ["ffmpeg", "-v", "error", "-i", str(path)]
    if max_duration is not None:
        cmd += ["-t", str(max_duration)]
    cmd += ["-f", "f32le", "-acodec", "pcm_f32le", "-"]
    out = subprocess.run(cmd, capture_output=True, check=True).stdout
    data = np.frombuffer(out, dtype="<f4")
    return data.reshape(-1, n_ch).T.copy(), sr


def encode_opus(wav_path: str, ogg_path: str, *, sample_rate: int = 24_000,
                bitrate: str = "128k") -> None:
    """OGG/Opus encode with the reference's exact ffmpeg flags
    (handler.py:519-529)."""
    if not ffmpeg_available():
        raise RuntimeError("ffmpeg not available; cannot encode Opus")
    subprocess.run(
        ["ffmpeg", "-i", str(wav_path), "-ar", str(sample_rate),
         "-c:a", "libopus", "-b:a", bitrate, "-vbr", "on",
         "-compression_level", "10", "-y", str(ogg_path)],
        capture_output=True, text=True, check=True)


# ---------------------------------------------------------------------------
# Resampling (polyphase windowed-sinc, Hann) — torchaudio-equivalent
# ---------------------------------------------------------------------------

def resample(waveform: np.ndarray, orig_freq: int, new_freq: int,
             lowpass_filter_width: int = 6, rolloff: float = 0.99
             ) -> np.ndarray:
    """(channels, samples) float32 -> resampled.

    Polyphase windowed-sinc with a Hann(cos^2) window — the same algorithm
    and defaults as torchaudio.functional.resample (sinc_interp_hann),
    which the reference uses at inference.py:110.
    """
    if orig_freq == new_freq:
        return waveform.astype(np.float32)
    gcd = math.gcd(int(orig_freq), int(new_freq))
    orig = int(orig_freq) // gcd
    new = int(new_freq) // gcd

    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)

    idx = np.arange(-width, width + orig, dtype=np.float64)[None, :] / orig
    phases = (np.arange(0, -new, -1, dtype=np.float64)[:, None] / new)
    t = np.clip((phases + idx) * base_freq,
                -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * math.pi / lowpass_filter_width / 2) ** 2
    t = t * math.pi
    kernel = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernel = (kernel * window * (base_freq / orig)).astype(np.float32)

    n_ch, length = waveform.shape
    target_length = int(math.ceil(new * length / orig))
    padded = np.pad(waveform.astype(np.float32),
                    ((0, 0), (width, width + orig)))
    K = kernel.shape[1]
    frames = np.lib.stride_tricks.sliding_window_view(
        padded, K, axis=1)[:, ::orig, :]            # (C, F, K)
    res = np.einsum("cfk,pk->cfp", frames, kernel)  # (C, F, new)
    out = res.reshape(n_ch, -1)
    return out[:, :target_length]


# ---------------------------------------------------------------------------
# load_audio (reference: inference.py:104-113)
# ---------------------------------------------------------------------------

def load_audio(path: str, max_duration: float = 300) -> np.ndarray:
    """Decode -> mono mean -> resample to 44.1 kHz -> peak normalize.
    Returns (1, samples) float32."""
    suffix = Path(path).suffix.lower()
    if suffix == ".wav":
        audio, sr = read_wav(path)
        if max_duration is not None:
            audio = audio[:, : int(max_duration * sr)]
    else:
        audio, sr = decode_with_ffmpeg(path, max_duration)
    mono = audio.mean(axis=0, keepdims=True).astype(np.float32)
    mono = resample(mono, sr, SAMPLE_RATE)
    from .dsp import peak_normalize
    return peak_normalize(mono)
