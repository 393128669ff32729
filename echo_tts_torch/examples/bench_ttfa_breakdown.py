"""Where a stream's time to first audio goes.  Counterpart of
examples/bench_ttfa_breakdown.py.

Times each stage between a request's arrival and its first block's audio
on the host, for the growing schedule (first block 40 latents, 1.9 s of
audio), each on the host clock between two synchronises of the card,
median of --reps (the host-only stages of 3 x --reps):

  host_text_ms     byte tokenize and pad to the 768 bucket (host)
  prefill_ms       the text and speaker K/V (sampler/blockwise.py
                   _prefill_core's program)
  sampler40_ms     the first block's 40 steps (sampler/blockwise.py
                   _block_core's first-block program, no latent segment)
  decode40_ms      the first block's incremental decode from a fresh
                   state (pipeline.ae_decode_block, _decode_block_core's
                   program)
  transfer_ms      its (1, 81920) fp32 audio to the host
  wav_write_ms     the WAV encode to a file (host)
  ttfa_stream_ms   the measured time to the first block's audio of
                   serve/streaming.stream_synthesize
  residual_ms      ttfa_stream - (host_text + prefill + sampler40 +
                   decode40 + transfer): what the stream's generator and
                   the gaps between the stages add

  fused_first_ms   serve/streaming._fused_first_core: the prefill, the
                   first block and its decode as one program, and the
                   audio's copy to the host, which is what a fresh
                   stream runs for its first chunk.

Each stage's first call (the warm-up) runs eagerly and captures its
program; the timed calls replay it (utils/programs.py).

One JSON line.

    python -m echo_tts_torch.examples.bench_ttfa_breakdown
    python -m echo_tts_torch.examples.bench_ttfa_breakdown --tiny --device cpu
"""
from __future__ import annotations

import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..config import MAX_TEXT_LENGTH, SAMPLER_DEFAULTS
from ..pipeline import audio_io
from ..pipeline.pipeline import ae_decode_block, ae_decode_stream_init
from ..models.dac.streaming import MAX_POSITIONS
from ..pipeline.text import get_text_input_ids_and_mask
from ..sampler import blockwise as bw
from ..serve.streaming import _fused_first_core, stream_synthesize
from . import stages

FIRST_BLOCK, TINY_FIRST_BLOCK = 40, 4


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, steps=True)
    args, models, lengths = stages.setup(ap, argv, models)
    model, dt, dev = models.dit, models.dtype, models.device
    cfg = models.dit_cfg
    first = TINY_FIRST_BLOCK if args.tiny else FIRST_BLOCK
    blocks = stages.TINY_STREAM_BLOCKS if args.tiny else stages.STREAM_BLOCKS
    p = dict(SAMPLER_DEFAULTS, num_steps=lengths.steps)
    p.pop("sequence_length")
    host_reps = 3 * args.reps

    spk_np = (0.1 * np.random.default_rng(3).standard_normal(
        (1, lengths.speaker, cfg.latent_size))).astype(np.float32)
    spk = torch.from_numpy(spk_np).to(dev)
    spk_mask = torch.ones((1, lengths.speaker), dtype=torch.bool, device=dev)

    def tokenize():
        return get_text_input_ids_and_mask([stages.STREAM_TEXT],
                                           max_length=MAX_TEXT_LENGTH)

    (ids_np, tmask_np), text_runs = stages.timed_stage(tokenize, args, host_reps)
    ids = torch.from_numpy(ids_np).to(dev)
    tmask = torch.from_numpy(tmask_np).to(dev)

    statics = bw.sampler_statics(dtype=dt, **p)

    prefill_core = bw._prefill_core(model, dt)

    def prefill():
        return prefill_core(ids, tmask, spk)

    noise = torch.randn((1, first, cfg.latent_size),
                        generator=torch.Generator().manual_seed(5)).to(dev)
    first_core = bw._block_core(model, first, first, *statics, False, True)

    def first_block(kv):
        return first_core(noise, kv[0], kv[1], tmask, spk_mask)

    def decode(x_t):
        return ae_decode_block(models, ae_decode_stream_init(models), x_t)[0]

    kv, pre_runs = stages.timed_stage(prefill, args)
    x_t, smp_runs = stages.timed_stage(lambda: first_block(kv), args)
    audio_dev, dec_runs = stages.timed_stage(lambda: decode(x_t), args)
    audio, xfer_runs = stages.timed_stage(lambda: audio_dev.cpu().numpy(),
                                          args, host_reps)
    with tempfile.TemporaryDirectory() as tmp:
        _, wav_runs = stages.timed_stage(
            lambda: audio_io.write_wav(os.path.join(tmp, "b.wav"), audio,
                                       models.dac_cfg.sample_rate), args, host_reps)

    def stream_ttfa():
        """Seconds to the stream's first block on the host; the stream is
        closed there (it leaves no work queued on the card)."""
        gen = stream_synthesize(
            models, stages.STREAM_TEXT, speaker_latent=spk_np,
            chunk_sizes=list(blocks), seed=0, sampler_params=p)
        t0 = time.perf_counter()
        next(gen)
        ttfa = time.perf_counter() - t0
        gen.close()
        return 1e3 * ttfa

    for _ in range(args.warmup):
        stream_ttfa()
    ttfa_runs = [stream_ttfa() for _ in range(args.reps)]

    fused_core = _fused_first_core(models, first, statics, MAX_POSITIONS)

    def fused():
        return fused_core(ids, tmask, spk, spk_mask, noise,
                          ae_decode_stream_init(models)["inner"])[0].cpu()

    _, fused_runs = stages.timed_stage(fused, args)

    ms = {k: stages.median(v) for k, v in dict(
        host_text_ms=text_runs, prefill_ms=pre_runs, sampler40_ms=smp_runs,
        decode40_ms=dec_runs, transfer_ms=xfer_runs, wav_write_ms=wav_runs,
        ttfa_stream_ms=ttfa_runs, fused_first_ms=fused_runs).items()}
    split = (ms["prefill_ms"] + ms["sampler40_ms"] + ms["decode40_ms"]
             + ms["transfer_ms"])
    components = split + ms["host_text_ms"] + ms["wav_write_ms"]
    return stages.emit({
        **{k: ms[k] for k in ("host_text_ms", "prefill_ms", "sampler40_ms",
                              "decode40_ms", "transfer_ms", "wav_write_ms")},
        "components_sum_ms": components,
        "ttfa_stream_ms": ms["ttfa_stream_ms"],
        "residual_ms": ms["ttfa_stream_ms"] - components + ms["wav_write_ms"],
        "fused_first_ms": ms["fused_first_ms"],
        "fused_vs_split_ms": split - ms["fused_first_ms"],
        "first_block_latents": first,
        "audio_finite": bool(np.isfinite(audio).all()),
        "ranges": {k: stages.span(v) for k, v in dict(
            prefill_ms=pre_runs, sampler40_ms=smp_runs, decode40_ms=dec_runs,
            ttfa_stream_ms=ttfa_runs, fused_first_ms=fused_runs).items()},
    }, models.device)


if __name__ == "__main__":
    sys.exit(main())
