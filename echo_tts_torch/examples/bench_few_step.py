"""The few-step non-parity sampler on the card.  Counterpart of
examples/bench_few_step.py.

train/distill.py makes an N-step CFG-free student; this times what that
mode runs at, with random weights (timing does not depend on the weight
values), over the headline request (640 latents, 768 text + 640 speaker
latents of static K/V): the 8-step plain sampler
(few_step_sampler_params(8)), the same with the W8A8 DiT (few8_int8; the
two levers multiply), and the parity 40-step dual-CFG sampler (cfg40),
each after one prefill, with the decode of the 40-step latents; the RTFs
put prefill, sampler and decode together.  The number is the mechanical
ceiling of distillation: real few-step audio needs distilled weights.

Keys: prefill_ms, sampler_few8_ms, sampler_few8_int8_ms,
sampler_cfg40_ms, decode_ms (medians of --reps), value (the few8 RTF),
rtf_parity_40step, rtf_few8_int8.  One JSON line.

    python -m echo_tts_torch.examples.bench_few_step
    python -m echo_tts_torch.examples.bench_few_step --tiny --device cpu
"""
from __future__ import annotations

import sys

import torch

from ..ops.quant import quantize_dit
from ..pipeline.pipeline import ae_decode
from ..train.distill import few_step_sampler_params
from . import stages

FEW_STEPS = 8


def few_step_plan(num_steps: int = FEW_STEPS):
    """(the student's sampler params, its step plan)."""
    fs = few_step_sampler_params(num_steps)
    return fs, stages.step_plan(fs["num_steps"], fs["cfg_min_t"],
                                fs["cfg_max_t"])


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, steps=True)
    args, models, lengths = stages.setup(ap, argv, models, blockwise=False)
    model, dt = models.dit, models.dtype
    inputs = stages.request_inputs(models.dit_cfg, 1, lengths,
                                   lengths.speaker, models.device)
    pre, pre_runs = stages.timed_stage(
        lambda: stages.prefill(model, inputs, dt), args)
    fs, plan_few = few_step_plan()
    few = dict(cfg_scale_text=fs["cfg_scale_text"],
               cfg_scale_speaker=fs["cfg_scale_speaker"])
    qdit = quantize_dit(model)
    runs = {}
    for name, m, plan, scales in (
            ("few8", model, plan_few, few),
            ("cfg40", model, stages.step_plan(lengths.steps), {}),
            ("few8_int8", qdit, plan_few, few)):
        out, runs[name] = stages.timed_stage(
            lambda: stages.sampler(m, plan, pre, inputs, dt, **scales),
            args)
        if name == "cfg40":
            latents = out
    del qdit
    audio, dec_runs = stages.timed_stage(lambda: ae_decode(models, latents),
                                         args)
    ms = {k: stages.median(v) for k, v in runs.items()}
    pre_ms, dec_ms = stages.median(pre_runs), stages.median(dec_runs)
    secs = stages.audio_seconds(models, lengths.seq)

    def rtf(sampler_ms):
        return secs / ((pre_ms + sampler_ms + dec_ms) / 1e3)

    return stages.emit({
        "metric": "few_step_nonparity_rtf",
        "value": rtf(ms["few8"]),
        "unit": "x_realtime",
        "prefill_ms": pre_ms,
        "sampler_few8_ms": ms["few8"],
        "sampler_few8_int8_ms": ms["few8_int8"],
        "sampler_cfg40_ms": ms["cfg40"],
        "decode_ms": dec_ms,
        "rtf_parity_40step": rtf(ms["cfg40"]),
        "rtf_few8_int8": rtf(ms["few8_int8"]),
        "audio_finite": bool(torch.isfinite(audio).all()),
        "ranges": {"prefill_ms": stages.span(pre_runs),
                   "decode_ms": stages.span(dec_runs),
                   **{f"sampler_{k}_ms": stages.span(v)
                      for k, v in runs.items()}},
        "note": "few8 = mechanical timing of the distilled mode; needs "
                "distilled weights for real audio (train/distill.py)",
    }, models.device)


if __name__ == "__main__":
    sys.exit(main())
