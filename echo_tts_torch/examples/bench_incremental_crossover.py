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

The two forms run in turns (re-encode, carried, carried, re-encode, ...,
after `--warmup` calls of each), so that a drift of the host's speed
falls on both; "carried_over_reencode" is the median, and the range, of
each turn's ratio of the two.  The prefix buffer is padded to `bucket`,
the stream-total bucket serving files the stream under (the blockwise
sampler's total_len_bucket, as JAX's script passes it), so that the
drains replay the block programs a served stream would.  The prefix
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
from ..utils.profiling import wall_ms
from . import stages

def drain(models, inputs, schedule, sampler_kw, incremental: bool,
          bucket) -> None:
    """The whole stream's blocks, each copied to the host."""
    gen = torch.Generator(device=models.device).manual_seed(0)
    for _, x_t, _ in iter_blockwise_euler_cfg_independent_guidances(
            models.dit, inputs["speaker_latent"], inputs["speaker_mask"],
            inputs["text_ids"], inputs["text_mask"], block_sizes=schedule,
            dtype=models.dtype, generator=gen,
            incremental_latent=incremental, total_len_bucket=bucket,
            **sampler_kw):
        x_t.cpu()


FORMS = (("reencode", False), ("incremental", True))


def drains_in_turns(models, inputs, schedule, sampler_kw, args,
                    bucket=None) -> dict:
    """{form: [host ms of each timed drain]}, the forms in turns."""
    def run(inc):
        return lambda: drain(models, inputs, schedule, sampler_kw, inc,
                             bucket)

    for _ in range(args.warmup):
        for _, inc in FORMS:
            run(inc)()
    runs = {label: [] for label, _ in FORMS}
    for i in range(args.reps):
        for label, inc in (FORMS if i % 2 == 0 else FORMS[::-1]):
            runs[label] += wall_ms(run(inc))[1]
    return runs


def main(argv=None, *, models=None) -> int:
    ap = stages.parser(__doc__, reps=2, steps=True)
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
            runs = drains_in_turns(models, inputs, setup["schedule"],
                                   sampler_kw, args, setup["bucket"])
        for label, _ in FORMS:
            row[label + "_s"] = stages.median(runs[label]) / 1e3
            row[label + "_rtf"] = audio_s / row[label + "_s"]
            row["ranges"][label + "_s"] = [x / 1e3
                                           for x in stages.span(runs[label])]
        ratios = [c / r for c, r in zip(runs["incremental"], runs["reencode"])]
        row["carried_over_reencode"] = stages.median(ratios)
        row["ranges"]["carried_over_reencode"] = stages.span(ratios)
        row["incremental_wins"] = row["incremental_s"] < row["reencode_s"]
        report[str(total)] = row
        print(f"# total {total}: {row}", file=sys.stderr, flush=True)
    return stages.emit({"metric": "incremental_latent_crossover",
                        "totals": report}, models.device)


if __name__ == "__main__":
    sys.exit(main())
