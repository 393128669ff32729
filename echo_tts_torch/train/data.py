"""Training data: (audio, transcript) -> whitened-latent shards -> batches
for the flow-matching step.

Counterpart of echo_tts_tpu/train/data.py, with the same shard layout and
the same draws, so that shards pass between the two packages and
`iter_batches` yields the JAX package's batches bit for bit.  Each shard
is one .npz with object arrays
  latents[i]: (T_i, 80) f32 whitened latents of utterance i,
  texts[i]:   str transcript.
A batch follows train/step.py: the speaker clip is the utterance's first
latents and the target window the latents after it (the two never
overlap, or the clean target would leak through the speaker K/V); past
`sequence_length` latents are cropped, shorter windows zero-padded and
left out of the loss through `latent_mask`.

Encoding runs the codec on the models' device (kernel B on the card);
its latents come back through numpy, as in the JAX package, so that
tensors made under the pipeline's inference mode never reach autograd.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Iterator, List, Sequence, Tuple

import numpy as np
import torch

from ..config import MAX_TEXT_LENGTH
from ..pipeline.pipeline import EchoModels, ae_encode
from ..pipeline.text import get_text_input_ids_and_mask


@dataclasses.dataclass(frozen=True)
class DataConfig:
    sequence_length: int = 640      # training window (reference default seq)
    text_length: int = MAX_TEXT_LENGTH
    speaker_length: int = 640       # speaker-reference clip, in latents
    min_latents: int = 8            # drop utterances shorter than this


def encode_utterance(models: EchoModels, audio: np.ndarray) -> np.ndarray:
    """(1, samples) or (samples,) waveform -> (T, 80) f32 whitened
    latents."""
    if audio.ndim == 1:
        audio = audio[None, :]
    lat = ae_encode(models, torch.from_numpy(
        np.ascontiguousarray(audio, dtype=np.float32))).cpu().numpy()
    n = audio.shape[-1] // models.dac_cfg.frame_length
    return lat[0, :max(n, 1)]


def write_shards(
    models: EchoModels,
    items: Iterable[Tuple[np.ndarray, str]],   # (waveform, transcript)
    out_dir: str,
    *,
    shard_size: int = 128,
    cfg: DataConfig = DataConfig(),
) -> List[str]:
    """Encode utterances and write .npz shards; returns the shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths: List[str] = []
    latents: List[np.ndarray] = []
    texts: List[str] = []

    def flush():
        if not latents:
            return
        path = os.path.join(out_dir, f"shard_{len(paths):05d}.npz")
        # np.asarray(..., dtype=object) would stack equal-length latents
        # into one (N, T, 80) array of boxed scalars: build the 1-D object
        # array explicitly
        lat_arr = np.empty(len(latents), dtype=object)
        lat_arr[:] = latents
        np.savez_compressed(path, latents=lat_arr,
                            texts=np.asarray(texts, dtype=object))
        paths.append(path)
        latents.clear()
        texts.clear()

    for audio, text in items:
        lat = encode_utterance(models, audio)
        if lat.shape[0] < cfg.min_latents:
            continue
        latents.append(lat.astype(np.float32))
        texts.append(text)
        if len(latents) >= shard_size:
            flush()
    flush()
    return paths


def load_shard(path: str) -> List[Tuple[np.ndarray, str]]:
    with np.load(path, allow_pickle=True) as z:
        return list(zip(z["latents"], [str(t) for t in z["texts"]]))


def iter_batches(
    shard_paths: Sequence[str],
    models: EchoModels,
    *,
    batch_size: int,
    cfg: DataConfig = DataConfig(),
    seed: int = 0,
    loop: bool = True,
) -> Iterator[dict]:
    """Yield numpy batches forever (or one epoch when loop=False), shards
    and utterances shuffled by numpy.random.default_rng(seed)."""
    if not shard_paths:
        raise ValueError("no shards")
    ps = models.dit_cfg.speaker_patch_size
    spk_len = cfg.speaker_length // ps * ps
    rng = np.random.default_rng(seed)

    def make_batch(group: List[Tuple[np.ndarray, str]]) -> dict:
        dim = group[0][0].shape[-1]
        lat_b = np.zeros((batch_size, cfg.sequence_length, dim), np.float32)
        lat_m = np.zeros((batch_size, cfg.sequence_length), bool)
        spk_b = np.zeros((batch_size, spk_len, dim), np.float32)
        spk_m = np.zeros((batch_size, spk_len), bool)
        for i, (lat, _) in enumerate(group):
            # speaker clip lat[:k], target lat[k:]; the clip takes at most
            # half the utterance, so that the target is never empty
            k = min(lat.shape[0] // 2, spk_len) // ps * ps
            spk_b[i, :k] = lat[:k]
            spk_m[i, :k] = True
            target = lat[k:k + cfg.sequence_length]
            lat_b[i, :target.shape[0]] = target
            lat_m[i, :target.shape[0]] = True
        ids, mask = get_text_input_ids_and_mask(
            [t for _, t in group], max_length=cfg.text_length)
        return {"latents": lat_b, "latent_mask": lat_m, "text_ids": ids,
                "text_mask": mask, "speaker_latent": spk_b,
                "speaker_mask": spk_m}

    while True:
        yielded = 0
        order = rng.permutation(len(shard_paths))
        for si in order:
            utts = load_shard(shard_paths[si])
            rng.shuffle(utts)
            for i in range(0, len(utts) - batch_size + 1, batch_size):
                yield make_batch(utts[i:i + batch_size])
                yielded += 1
        if not yielded:
            raise ValueError(
                f"no shard holds >= batch_size={batch_size} utterances; "
                "lower batch_size or raise shard_size (an endless loop "
                "would otherwise spin without yielding)")
        if not loop:
            return
