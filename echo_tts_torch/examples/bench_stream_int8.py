"""Streaming with the W8A8 DiT: time to first audio and streamed RTF, bf16
against int8.  Counterpart of examples/bench_stream_int8.py.

A stream's first audio waits on the 40-step sampler over its first block,
so the int8 mode's per-step gain is measured at the streaming surface
too: one stream of the growing schedule (40, 80, 160, 320, 320, 320; 1240
latents, 57.6 s of audio) through serve/streaming.stream_synthesize with
the bf16 DiT, then with ops.quant.quantize_dit of it, the same schedule,
speaker and seed.  ttfa_*_ms is the time to the first block's audio on
the host and streamed_rtf_* the audio seconds over the stream's wall
seconds, medians of --reps.  Non-parity opt-in mode; the bf16 numbers are
the reference-comparable ones.  One JSON line.

    python -m echo_tts_torch.examples.bench_stream_int8
    python -m echo_tts_torch.examples.bench_stream_int8 --tiny --device cpu
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from ..ops.quant import quantize_dit
from . import stages


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, steps=True)
    args, models, lengths = stages.setup(ap, argv, models)
    blocks = stages.TINY_STREAM_BLOCKS if args.tiny else stages.STREAM_BLOCKS
    speaker = np.random.default_rng(1).standard_normal(
        (1, lengths.speaker, models.dit_cfg.latent_size)).astype(np.float32)
    sampler_kw = dict(num_steps=lengths.steps, cfg_scale_text=3.0,
                      cfg_scale_speaker=8.0, cfg_min_t=0.5, cfg_max_t=1.0)
    audio_s = stages.audio_seconds(models, sum(blocks))
    out, ranges = {}, {}
    for tag, m in (("bf16", models),
                   ("int8", dataclasses.replace(
                       models, dit=quantize_dit(models.dit)))):
        for _ in range(args.warmup):
            stages.stream_once(m, speaker, blocks, sampler_kw)
        runs = [stages.stream_once(m, speaker, blocks, sampler_kw)
                for _ in range(args.reps)]
        ttfa = [1e3 * r[0] for r in runs]
        rtf = [audio_s / r[1] for r in runs]
        out[f"ttfa_{tag}_ms"] = stages.median(ttfa)
        out[f"streamed_rtf_{tag}"] = stages.median(rtf)
        ranges[f"ttfa_{tag}_ms"] = stages.span(ttfa)
        ranges[f"streamed_rtf_{tag}"] = stages.span(rtf)
    return stages.emit(dict(
        metric="stream_int8_nonparity",
        value=out["streamed_rtf_int8"],
        unit="x_realtime",
        **out,
        audio_seconds=audio_s,
        ranges=ranges,
        note="int8 = ECHO_DIT_QUANT=int8 non-parity mode; the bf16 keys are "
             "the reference-comparable ones"), models.device)


if __name__ == "__main__":
    sys.exit(main())
