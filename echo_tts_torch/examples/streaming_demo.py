"""Block-by-block synthesis to a WAV file: the counterpart of
examples/streaming_demo.py (the reference's `python inference_blockwise.py`,
inference_blockwise.py:126-220).  Each block's audio is printed as it
arrives; the WAV holds the blocks' audio concatenated.

    python -m echo_tts_torch.examples.streaming_demo [--voice ref.wav] \
        [--chunk-size 160 --num-chunks 4 | --total-latents 640] \
        [--seed 0] [--out stream.wav] [--random-weights] [--device cpu]

--total-latents uses the growing schedule (40, 80, 160, 320, ...;
serve.presets.growing_schedule) in place of uniform blocks, which brings
the first audio sooner.  Models load as in generate.py; runs on the card
unless --device cpu or ECHO_DEVICE=cpu.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from ..pipeline import audio_io
from ..serve.models import load_models
from ..serve.presets import growing_schedule
from ..serve.streaming import stream_synthesize


def main(argv=None, *, models=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--text", default="Streaming synthesis produces audio "
                    "block by block, so playback can begin immediately.")
    ap.add_argument("--voice", default=None, help="speaker reference audio")
    ap.add_argument("--chunk-size", type=int, default=160)
    ap.add_argument("--num-chunks", type=int, default=4)
    ap.add_argument("--total-latents", type=int, default=None,
                    help="the growing schedule for this many latents in "
                    "place of uniform chunks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="stream.wav")
    ap.add_argument("--random-weights", action="store_true",
                    help="seeded random weights when ECHO_MODEL_DIR is unset")
    ap.add_argument("--device", default=None,
                    help="torch device (default: ECHO_DEVICE, else cuda)")
    args = ap.parse_args(argv)

    if models is None:
        models = load_models(os.environ.get("ECHO_MODEL_DIR"),
                             device=args.device or os.environ.get(
                                 "ECHO_DEVICE", "cuda"),
                             allow_random=args.random_weights)
    speaker = audio_io.load_audio(args.voice) if args.voice else None
    chunk_sizes = None
    if args.total_latents:
        chunk_sizes = growing_schedule(args.total_latents)
        print(f"schedule: {chunk_sizes}")

    rate = models.dac_cfg.sample_rate
    pieces = []
    t0 = time.perf_counter()
    for chunk in stream_synthesize(
            models, args.text, speaker, chunk_size=args.chunk_size,
            num_chunks=args.num_chunks, chunk_sizes=chunk_sizes,
            seed=args.seed):
        print(f"block {chunk.index}: +{chunk.audio.shape[-1] / rate:.2f} s "
              f"audio at t={time.perf_counter() - t0:.2f} s (latents "
              f"{chunk.latent_start}:{chunk.latent_end})", flush=True)
        pieces.append(chunk.audio)

    audio = np.concatenate(pieces, axis=-1)
    audio_io.write_wav(args.out, audio, rate)
    print(f"wrote {args.out}: {audio.shape[-1] / rate:.2f} s total")
    return 0


if __name__ == "__main__":
    sys.exit(main())
