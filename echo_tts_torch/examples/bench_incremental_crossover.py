"""The latent prefix carried or re-encoded, over a whole stream.
Counterpart of examples/bench_incremental_crossover.py.

Streams TOTAL latents (default 3840, 2 min 58 s of audio) through the
blockwise sampler alone (no decode, the same in both forms) on the
serving schedule (serve/presets.growing_schedule, or past its 16-block
cap blocks of 320), copying each block's latents to the host as the
serving layer does, and times the whole drain:

  reencode     the whole prefix buffer re-encoded through the latent
               encoder before every block after the first (the
               reference's form)
  incremental  each block's patches encoded once, after it is sampled,
               and carried (models/dit.py latent_kv_append_block)

The port allocates the prefix buffer at the stream's own total; `bucket`
is the stream-total bucket serving files the stream under.  The prefix
work alone, without the step loop, is tools/stream_checks.prefix_checks,
on the same set-up (stages.stream_setup).  One JSON line: {"metric":
"incremental_latent_crossover", "totals": {TOTAL: {...}}}.

    python -m echo_tts_torch.examples.bench_incremental_crossover [TOTAL ...]
    python -m echo_tts_torch.examples.bench_incremental_crossover 320 \
        --tiny --device cpu
"""
from __future__ import annotations

import sys

import torch

from ..sampler.blockwise import iter_blockwise_euler_cfg_independent_guidances
from . import stages

def drain(models, inputs, schedule, sampler_kw, incremental: bool) -> None:
    """The whole stream's blocks, each copied to the host."""
    gen = torch.Generator(device=models.device).manual_seed(0)
    for _, x_t, _ in iter_blockwise_euler_cfg_independent_guidances(
            models.dit, inputs["speaker_latent"], inputs["speaker_mask"],
            inputs["text_ids"], inputs["text_mask"], block_sizes=schedule,
            dtype=models.dtype, generator=gen,
            incremental_latent=incremental, **sampler_kw):
        x_t.cpu()


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, reps=2)
    ap.add_argument("totals", nargs="*", type=int, default=[3840],
                    help="stream lengths in latents")
    args, models, lengths = stages.setup(ap, argv, models)
    inputs = stages.request_inputs(models.dit_cfg, 1, lengths,
                                   lengths.speaker, models.device)
    sampler_kw = dict(num_steps=lengths.steps, cfg_scale_text=3.0,
                      cfg_scale_speaker=8.0, cfg_min_t=0.5, cfg_max_t=1.0)
    report = {}
    for total in args.totals:
        setup = stages.stream_setup(models, total)
        audio_s = stages.audio_seconds(models, total)
        row = {"schedule_blocks": len(setup["schedule"]),
               "bucket": setup["bucket"], "audio_s": audio_s, "ranges": {}}
        with torch.inference_mode():
            for label, inc in (("reencode", False), ("incremental", True)):
                _, runs = stages.timed_stage(
                    lambda: drain(models, inputs, setup["schedule"],
                                  sampler_kw, inc), args)
                row[label + "_s"] = stages.median(runs) / 1e3
                row[label + "_rtf"] = audio_s / row[label + "_s"]
                row["ranges"][label + "_s"] = [x / 1e3
                                               for x in stages.span(runs)]
        row["incremental_wins"] = row["incremental_s"] < row["reencode_s"]
        report[str(total)] = row
        print(f"# total {total}: {row}", file=sys.stderr, flush=True)
    return stages.emit({"metric": "incremental_latent_crossover",
                        "totals": report}, models.device)


if __name__ == "__main__":
    sys.exit(main())
