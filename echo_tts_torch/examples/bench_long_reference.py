"""The cost of a long speaker reference, per serving speaker bucket
(serve/presets.py SPEAKER_BUCKETS: 640, 2816, 6400 latents, up to about
5 min of reference audio).  Counterpart of
examples/bench_long_reference.py.

Per bucket, with a bucket-length reference of seeded noise:

  voice_encode_ms  the chunked codec encode
                   (pipeline.get_speaker_latent_and_mask, pad_to_max:
                   640-latent chunks, kernel B in every encoder block;
                   10 chunks at 6400)
  prefill_ms       the text and speaker K/V at that width
  sampler_ms       the 40-step sampler over 768 text + the speaker's
                   patch columns (T = 2368 at 6400)
  rtf_640seq       640 latents of audio over prefill + sampler

with encode_chunks, speaker_latents (the encode's output, a whole number
of chunks when the bucket is not) and static_columns; each time the
median of --reps.  One JSON line: {"metric": "long_reference_buckets",
"buckets": {bucket: {...}}}.

    python -m echo_tts_torch.examples.bench_long_reference
    python -m echo_tts_torch.examples.bench_long_reference --tiny --device cpu
"""
from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..pipeline.pipeline import get_speaker_latent_and_mask
from ..serve.presets import SPEAKER_BUCKETS
from . import stages

CHUNK_LATENTS = 640     # get_speaker_latent_and_mask's chunk


def buckets() -> list:
    return [int(b) for b in SPEAKER_BUCKETS.split(",")]


def measure(models, lengths, bucket: int, audio: np.ndarray, args) -> dict:
    dev, dt = models.device, models.dtype
    (lat, mask), enc_runs = stages.timed_stage(
        lambda: get_speaker_latent_and_mask(
            models, audio, max_speaker_latent_length=bucket,
            pad_to_max=True), args)
    inputs = stages.request_inputs(models.dit_cfg, 1, lengths, 0, dev)
    inputs["speaker_latent"] = torch.from_numpy(lat).to(dev)
    inputs["speaker_mask"] = torch.from_numpy(mask).to(dev)
    pre, pre_runs = stages.timed_stage(
        lambda: stages.prefill(models.dit, inputs, dt), args)
    plan = stages.step_plan(lengths.steps)
    latents, smp_runs = stages.timed_stage(
        lambda: stages.sampler(models.dit, plan, pre, inputs, dt), args)
    pre_ms, smp_ms = stages.median(pre_runs), stages.median(smp_runs)
    return {
        "voice_encode_ms": stages.median(enc_runs),
        "prefill_ms": pre_ms,
        "sampler_ms": smp_ms,
        "rtf_640seq": stages.audio_seconds(models, lengths.seq)
        / ((pre_ms + smp_ms) / 1e3),
        "encode_chunks": math.ceil(audio.shape[1]
                                   / (CHUNK_LATENTS
                                      * models.dac_cfg.frame_length)),
        "speaker_latents": int(lat.shape[1]),
        "speaker_valid": int(mask.sum()),
        "static_columns": int(pre.kv_static[0].shape[2]),
        "latents_finite": bool(torch.isfinite(latents).all()),
        "ranges": {"voice_encode_ms": stages.span(enc_runs),
                   "prefill_ms": stages.span(pre_runs),
                   "sampler_ms": stages.span(smp_runs)},
    }


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, steps=True)
    args, models, lengths = stages.setup(ap, argv, models, blockwise=False)
    spl = models.dac_cfg.frame_length
    rng = np.random.default_rng(7)
    report = {}
    for bucket in buckets():
        audio = (0.1 * rng.standard_normal((1, bucket * spl))).astype(np.float32)
        report[str(bucket)] = measure(models, lengths, bucket, audio, args)
        print(f"# bucket {bucket}: {report[str(bucket)]}", file=sys.stderr,
              flush=True)
    return stages.emit({"metric": "long_reference_buckets",
                        "buckets": report}, models.device)


if __name__ == "__main__":
    sys.exit(main())
