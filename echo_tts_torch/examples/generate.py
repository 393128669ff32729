"""Text to a WAV file, end to end: the counterpart of examples/generate.py
(the reference's `python -m inference`, inference.py:524-558).

    python -m echo_tts_torch.examples.generate --text "Hello!" \
        [--voice ref.wav] [--preset Independent-High-Speaker-CFG] \
        [--seed 0] [--steps N] [--out out.wav] [--random-weights] \
        [--device cpu]

With ECHO_MODEL_DIR set to the published safetensors (or to the port's
checkpoint bundle) this speaks; with --random-weights and no model
directory the same pipeline runs on seeded random weights at the published
width (same compute, noise audio).  The models load through
serve.models.load_models, so the serving variables apply: ECHO_DIT_QUANT=int8
serves the W8A8 DiT.  Runs on the card unless --device cpu or
ECHO_DEVICE=cpu.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from ..pipeline import audio_io
from ..pipeline.pipeline import sample_pipeline
from ..serve.handler import build_sample_fn
from ..serve.models import load_models


def main(argv=None, *, models=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--text", default="The quick brown fox jumps over the "
                    "lazy dog, then reads it a bedtime story.")
    ap.add_argument("--voice", default=None, help="speaker reference audio")
    ap.add_argument("--preset", default=None,
                    help="a named sampler preset (serve/sampler_presets.json)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--out", default="out.wav")
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
    params = {} if args.steps is None else {"num_steps": args.steps}
    sample_fn, p = build_sample_fn(params, preset=args.preset)
    print("sampler:", p)

    speaker = audio_io.load_audio(args.voice) if args.voice else None
    t0 = time.perf_counter()
    audio, text = sample_pipeline(models, sample_fn, args.text, speaker,
                                  rng_seed=args.seed)
    dt = time.perf_counter() - t0
    rate = models.dac_cfg.sample_rate
    dur = audio.shape[-1] / rate
    audio_io.write_wav(args.out, audio, rate)
    print(f"wrote {args.out}: {dur:.2f} s audio in {dt:.2f} s "
          f"({dur / dt:.2f}x realtime)\nnormalized text: {text}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
