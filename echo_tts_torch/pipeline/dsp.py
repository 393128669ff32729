"""Host DSP: crossfade, boundary normalization, end-of-speech crop.

Numpy float32 mirrors of the reference host-side audio processing
(reference: handler.py:126-240, inference.py:288-301).  Audio arrays are
(channels, samples) float32, matching the reference's torch layout.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import native


def crossfade_chunks(audio_chunks: List[np.ndarray],
                     overlap_samples: int = 4410) -> np.ndarray:
    """Linear crossfade (reference: handler.py:126-171)."""
    if len(audio_chunks) <= 1:
        return (np.concatenate(audio_chunks, axis=-1) if audio_chunks
                else np.zeros((0,), dtype=np.float32))

    result = audio_chunks[0]
    for i in range(1, len(audio_chunks)):
        chunk_length = audio_chunks[i].shape[-1]
        prev_length = result.shape[-1]
        actual_overlap = min(overlap_samples, chunk_length // 4,
                             prev_length // 4)

        if actual_overlap > 0:
            fade_out = np.linspace(1, 0, actual_overlap,
                                   dtype=np.float32)
            fade_in = np.linspace(0, 1, actual_overlap, dtype=np.float32)
            if audio_chunks[i].ndim == 2:
                fade_out = fade_out.reshape(1, -1)
                fade_in = fade_in.reshape(1, -1)

            prev_chunk_end = result[..., -actual_overlap:] * fade_out
            result = result[..., :-actual_overlap]
            curr_chunk_start = audio_chunks[i][..., :actual_overlap] * fade_in
            crossfaded = prev_chunk_end + curr_chunk_start
            result = np.concatenate(
                [result, crossfaded, audio_chunks[i][..., actual_overlap:]],
                axis=-1)
        else:
            result = np.concatenate([result, audio_chunks[i]], axis=-1)
    return result


def normalize_chunk_boundaries(audio_chunks: List[np.ndarray],
                               sample_rate: int = 44100,
                               silence_threshold: float = 0.01,
                               min_silence_samples: int = 22050) -> np.ndarray:
    """Per-chunk trailing-silence normalization then crossfade
    (reference: handler.py:174-240)."""
    if not audio_chunks:
        return np.zeros((0,), dtype=np.float32)
    if len(audio_chunks) == 1:
        return audio_chunks[0]

    normalized = []
    for i, chunk in enumerate(audio_chunks):
        if chunk.ndim == 1:
            chunk = chunk[None, :]

        if i < len(audio_chunks) - 1:
            tail_samples = min(chunk.shape[-1], min_silence_samples * 2)
            tail = np.abs(chunk[..., -tail_samples:]).flatten()
            # per-sample scan in C when a toolchain is present
            # (reference: handler.py:210-218 python loop)
            trailing_silence = native.trailing_silence(
                tail, silence_threshold)

            if trailing_silence > min_silence_samples:
                chunk = chunk[..., :-(trailing_silence - min_silence_samples)]
            elif 0 < trailing_silence < min_silence_samples:
                extra = min_silence_samples - trailing_silence
                silence = np.zeros((*chunk.shape[:-1], extra),
                                   dtype=chunk.dtype)
                chunk = np.concatenate([chunk, silence], axis=-1)
            elif trailing_silence == 0:
                silence = np.zeros((*chunk.shape[:-1], min_silence_samples),
                                   dtype=chunk.dtype)
                chunk = np.concatenate([chunk, silence], axis=-1)

        normalized.append(chunk)

    return crossfade_chunks(normalized)


def find_flattening_point(data: np.ndarray, target_value: float = 0.0,
                          window_size: int = 20,
                          std_threshold: float = 0.05) -> int:
    """End-of-speech heuristic over latents (length, 80)
    (reference: inference.py:288-296).  The reference's Python loop is
    vectorized into one windowed mean/std sweep; std is the UNBIASED
    (n-1) estimator torch uses."""
    data = np.asarray(data, dtype=np.float32)
    n = len(data)
    got = native.flattening_point(data, target_value, window_size,
                                  std_threshold)
    if got is not None:
        return got
    padded = np.concatenate(
        [data, np.zeros((window_size, *data.shape[1:]), dtype=data.dtype)])
    # windows[i] = padded[i:i+window], flattened over feature dims
    flat = padded.reshape(len(padded), -1)
    win = np.lib.stride_tricks.sliding_window_view(
        flat, window_size, axis=0)[:n]          # (n, F, W)
    count = win.shape[1] * win.shape[2]
    means = win.mean(axis=(1, 2))
    var = np.square(win - means[:, None, None]).sum(axis=(1, 2)) / (count - 1)
    stds = np.sqrt(var)
    ok = (stds < std_threshold) & (np.abs(means - target_value) < 0.1)
    idx = int(np.argmax(ok))
    if not ok[idx]:
        return n
    return idx


def crop_audio_to_flattening_point(audio: np.ndarray, latent: np.ndarray,
                                   samples_per_latent: int = 2048) -> np.ndarray:
    """(reference: inference.py:298-301)."""
    fp = find_flattening_point(latent)
    return audio[..., : fp * samples_per_latent]


def peak_normalize(audio: np.ndarray) -> np.ndarray:
    """audio / max(|audio|.max(), 1) (reference: inference.py:111)."""
    return (audio / np.maximum(np.abs(audio).max(), 1.0)).astype(np.float32)
