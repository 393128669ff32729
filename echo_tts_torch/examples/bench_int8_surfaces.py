"""The W8A8 DiT (ECHO_DIT_QUANT=int8) on the two serving surfaces the
one-shot request does not cover: short-utterance latency and batched
throughput.  Counterpart of examples/bench_int8_surfaces.py.

  p50_short_int8_ms   one whole request at seq 224 (10.4 s of audio): the
                      40-step W8A8 sampler with its prefill, and the
                      decode; median of --reps
  throughput_rtf_b8_chip_int8
                      one serve.batcher.run_batch pass of eight requests
                      at seq 640 (each with 640 random speaker latents):
                      the (G*B)-row sampler (kernel C at M = 24 x 640 =
                      15360 rows on the CFG steps, 8 x 640 = 5120 on the
                      others) and the decode in two slices of four, as the
                      micro-batching server runs it; audio seconds of the
                      eight over the pass's median wall seconds

Non-parity opt-in mode (the reference has no quantization).  One JSON
line.

    python -m echo_tts_torch.examples.bench_int8_surfaces
    python -m echo_tts_torch.examples.bench_int8_surfaces --tiny --device cpu
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from ..ops.quant import quantize_dit
from ..pipeline.pipeline import ae_decode
from ..sampler.euler import sample_euler_cfg_independent_guidances
from ..serve.batcher import BatchRequest, run_batch
from . import stages

SHORT_SEQ, TINY_SHORT_SEQ = 224, 8
BATCH = 8
TEXT = ("Tickets are available at the machines by the entrance, and the "
        "next train leaves from platform four in a few minutes.")


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, steps=True)
    args, models, lengths = stages.setup(ap, argv, models, blockwise=False)
    qmodels = dataclasses.replace(models, dit=quantize_dit(models.dit))
    short = TINY_SHORT_SEQ if args.tiny else SHORT_SEQ
    inputs = stages.request_inputs(models.dit_cfg, 1, lengths,
                                   lengths.speaker, models.device, seq=short)
    sampler_kw = dict(num_steps=lengths.steps, cfg_scale_text=3.0,
                      cfg_scale_speaker=8.0, cfg_min_t=0.5, cfg_max_t=1.0)

    def request():
        latents = sample_euler_cfg_independent_guidances(
            qmodels.dit, inputs["speaker_latent"], inputs["speaker_mask"],
            inputs["text_ids"], inputs["text_mask"], sequence_length=short,
            dtype=models.dtype, initial_noise=inputs["noise"], **sampler_kw)
        return ae_decode(qmodels, latents)

    audio, short_runs = stages.timed_stage(request, args)
    p50_ms = stages.median(short_runs)

    speaker = inputs["speaker_latent"][:1].cpu().numpy()
    requests = [BatchRequest(text=TEXT, seed=i, speaker_latent=speaker)
                for i in range(BATCH)]
    params = dict(sampler_kw, sequence_length=lengths.seq)
    results, b8_runs = stages.timed_stage(
        lambda: run_batch(qmodels, requests, params), args)
    b8_s = stages.median(b8_runs) / 1e3
    rtf_b8 = BATCH * stages.audio_seconds(models, lengths.seq) / b8_s
    finite = bool(torch.isfinite(audio).all()) and all(
        np.isfinite(r.audio).all() for r in results)
    return stages.emit({
        "metric": "int8_surfaces_nonparity",
        "value": rtf_b8,
        "unit": "x_realtime",
        "p50_short_int8_ms": p50_ms,
        "p50_short_rtf_int8": stages.audio_seconds(models, short)
        / (p50_ms / 1e3),
        "throughput_rtf_b8_chip_int8": rtf_b8,
        "b8_pass_ms": b8_s * 1e3,
        "audio_finite": finite,
        "ranges": {"p50_short_int8_ms": stages.span(short_runs),
                   "b8_pass_ms": stages.span(b8_runs)},
        "note": "ECHO_DIT_QUANT=int8 non-parity surfaces"}, models.device)


if __name__ == "__main__":
    sys.exit(main())
