"""What the bench modules (bench_*.py, and the headline bench,
echo_tts_torch/bench.py) share: their arguments, device and
models; the headline request's seeded inputs; the stages they time (the
prefill of the static K/V and the Euler step loop over them, as the JAX
scripts' jitted `prefill` and `sampler` programs compute them, through
the serving sampler's own two halves in sampler/euler.py; one stream on
the serving schedule); and one JSON line out.

A stage is clocked on the host between two synchronises of the card
(utils.profiling.wall_ms): `--warmup` calls first, then the median of
`--reps` calls, with the range of the runs beside it under "ranges".
The JAX scripts' scalar-checksum barriers have no counterpart: a
synchronise ends the card's work.  As the JAX scripts jit each stage,
`prefill` and `sampler` here are captured programs (utils/programs.py,
one CUDA graph per model, key and shapes), as the serving sampler is:
a stage's first call at a shape runs eagerly and captures it, which the
warm-up call pays, and the timed calls replay it, so that the stages and
the one-shot request (sampler/euler._euler_core) are timed alike.

--tiny runs the tiny config in fp32 at short lengths (TINY); the tiny
heads (16 wide, fp32) are not kernel A's, so --tiny needs --device cpu.
Without it the published widths run with seeded random weights
(pipeline.random_models): timing does not depend on the weight values.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import statistics
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import (base_dit_config, tiny_dac_config, tiny_dit_config)
from ..device import card_name, resolve_device
from ..models import dit
from ..pipeline.pipeline import EchoModels, random_models
from ..sampler.euler import (StaticPrefill, build_step_plan,
                             prefill_static, run_step_segments,
                             step_layer_scales)
from ..serve.presets import growing_schedule, pick_stream_total_bucket
from ..serve.streaming import stream_synthesize
from ..utils import programs
from ..utils.profiling import wall_ms


@dataclasses.dataclass(frozen=True)
class Lengths:
    """The request the JAX scripts time (their SEQ, TEXT_LEN, SPK_LEN)."""
    seq: int = 640            # latents generated (29.7 s of audio)
    text: int = 768           # text columns (MAX_TEXT_LENGTH)
    text_valid: int = 200     # of them valid
    speaker: int = 640        # speaker latents (the 640 bucket)
    steps: int = 40           # Euler steps


FULL = Lengths()
TINY = Lengths(seq=16, text=32, text_valid=20, speaker=16, steps=2)

# The streamed shape of bench.py's streaming stage: growing blocks, 1240
# latents (57.6 s of audio), and its text
STREAM_BLOCKS = (40, 80, 160, 320, 320, 320)
TINY_STREAM_BLOCKS = (4, 8, 4)
STREAM_TEXT = ("The quick brown fox jumps over the lazy dog while the "
               "orchestra tunes quietly in the hall, and a narrator "
               "describes the scene in a calm, steady voice for the "
               "benchmark recording. ") * 3
# bench.py's B = 8 pass: one text a request, each a different sentence
BATCH_TEXTS = [
    "Request number %d reads a different sentence so the batch is not "
    "degenerate; the narrator keeps an even pace throughout." % i
    for i in range(8)
]


def parser(doc: str, reps: Optional[int] = 3) -> argparse.ArgumentParser:
    """The bench modules' arguments; reps=None leaves --reps unset, for a
    module whose stages each have their own count."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: ECHO_DEVICE, else cuda)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny config in fp32 at short lengths (CPU)")
    ap.add_argument("--reps", type=int, default=reps,
                    help="timed calls of each stage (the median is reported)")
    ap.add_argument("--warmup", type=int, default=1,
                    help="untimed calls of each stage before them")
    return ap


def parse(ap: argparse.ArgumentParser, argv) -> argparse.Namespace:
    args = ap.parse_args(argv)
    if (args.reps is not None and args.reps < 1) or args.warmup < 0:
        ap.error("--reps must be >= 1 and --warmup >= 0")
    return args


def device(ap: argparse.ArgumentParser, args: argparse.Namespace
           ) -> torch.device:
    """--device, else ECHO_DEVICE, else the card (raising without one)."""
    dev = resolve_device(args.device or os.environ.get("ECHO_DEVICE")
                         or "cuda")
    if args.tiny and dev.type == "cuda":
        ap.error("the tiny config's heads (16 wide, fp32) are not kernel "
                 "A's; run --tiny with --device cpu")
    return dev


def setup(ap: argparse.ArgumentParser, argv, models: Optional[EchoModels],
          blockwise: bool = True) -> Tuple[argparse.Namespace, EchoModels,
                                           Lengths]:
    """Parse argv; the models (`models`, else seeded random ones on the
    device asked for) and the lengths to run."""
    args = parse(ap, argv)
    if models is None:
        dev = device(ap, args)
        if args.tiny:
            models = random_models(dev, torch.float32,
                                   dit_cfg=tiny_dit_config(blockwise),
                                   dac_cfg=tiny_dac_config())
        else:
            models = random_models(dev, dit_cfg=base_dit_config(blockwise))
    return args, models, TINY if args.tiny else FULL


def timed_stage(fn, args: argparse.Namespace, reps: Optional[int] = None):
    """(fn()'s last result, [host ms of each timed call]): args.warmup
    untimed calls, then `reps` (default args.reps) timed ones."""
    for _ in range(args.warmup):
        fn()
    return wall_ms(fn, args.reps if reps is None else reps)


def median(runs: Sequence[float]) -> float:
    return float(statistics.median(runs))


def span(runs: Sequence[float]) -> List[float]:
    return [float(min(runs)), float(max(runs))]


def audio_seconds(models: EchoModels, latents: int) -> float:
    return latents * models.dac_cfg.frame_length / models.dac_cfg.sample_rate


def memory_mb(device: torch.device) -> Optional[float]:
    """torch.cuda.memory_allocated in MiB; None on the CPU."""
    if device.type != "cuda":
        return None
    return torch.cuda.memory_allocated(device) / 2**20


def request_inputs(cfg, batch: int, lengths: Lengths, speaker: int,
                   device: torch.device, seq: Optional[int] = None,
                   seed: int = 1) -> Dict[str, torch.Tensor]:
    """Seeded inputs of `batch` requests: random text bytes (the first
    lengths.text_valid valid), `speaker` random speaker latents (all
    valid) and the starting noise of `seq` (default lengths.seq) latents,
    drawn on the host so that the CPU and the card see the same values."""
    g = torch.Generator().manual_seed(seed)
    seq = lengths.seq if seq is None else seq
    text_mask = (torch.arange(lengths.text) < lengths.text_valid)[None]
    out = dict(
        text_ids=torch.randint(0, 256, (batch, lengths.text), generator=g,
                               dtype=torch.int32),
        text_mask=text_mask.repeat(batch, 1),
        speaker_latent=torch.randn((batch, speaker, cfg.latent_size),
                                   generator=g),
        speaker_mask=torch.ones((batch, speaker), dtype=torch.bool),
        noise=torch.randn((batch, seq, cfg.latent_size), generator=g))
    return {k: v.to(device) for k, v in out.items()}


def step_plan(num_steps: int, cfg_min_t: float = 0.5, cfg_max_t: float = 1.0):
    return build_step_plan(num_steps, cfg_min_t, cfg_max_t, None, None, None,
                           None)


# The stages' programs (module docstring), as many as the sampler's
STAGE_PROGRAMS = programs.ProgramCache("stages", 64)


@torch.inference_mode()
def prefill(model: dit.EchoDiT, inputs: Dict[str, torch.Tensor], dtype,
            kv_quant: bool = False) -> StaticPrefill:
    """The requests' static K/V [text, speaker] (int8 when kv_quant), their
    speaker columns and CFG branch masks: sampler/euler.prefill_static,
    the serving sampler's own prefill, as one program."""
    return STAGE_PROGRAMS(
        ("prefill", dtype, kv_quant), model,
        [inputs[k] for k in ("speaker_latent", "speaker_mask", "text_ids",
                             "text_mask")],
        lambda: functools.partial(prefill_static, dtype=dtype,
                                  kv_quant=kv_quant))


def _sampler_body(model, noise, kv_static, spk_cols, mask_cfg, mask_plain, *,
                  plan, layer_scales, dtype, cfg_scale_text,
                  cfg_scale_speaker) -> torch.Tensor:
    return run_step_segments(
        model, noise.to(torch.float32, copy=True), plan, kv_static, spk_cols,
        mask_cfg, mask_plain, cfg_scale_text=cfg_scale_text,
        cfg_scale_speaker=cfg_scale_speaker, speaker_kv_max_layers=None,
        dtype=dtype, layer_scales=layer_scales)


@torch.inference_mode()
def sampler(model: dit.EchoDiT, plan, pre: StaticPrefill,
            inputs: Dict[str, torch.Tensor], dtype, *,
            cfg_scale_text: float = 3.0, cfg_scale_speaker: float = 8.0
            ) -> torch.Tensor:
    """The Euler step loop (sampler/euler.run_step_segments, the serving
    sampler's own) over a prefill from the inputs' noise, as one program
    keyed on the step plan and the scales; float32 latents."""
    key = ("sampler", tuple(np.asarray(f).tobytes() for f in plan), dtype,
           float(cfg_scale_text), float(cfg_scale_speaker))
    device = inputs["noise"].device

    def make_body():
        return functools.partial(
            _sampler_body, plan=plan,
            layer_scales=step_layer_scales(plan, model.cfg.num_layers, None,
                                           device),
            dtype=dtype, cfg_scale_text=cfg_scale_text,
            cfg_scale_speaker=cfg_scale_speaker)

    return STAGE_PROGRAMS(key, model, [inputs["noise"], *pre], make_body)


UNIFORM_BLOCK = 320


def stream_setup(models, total: int) -> dict:
    """One stream of `total` latents: its block schedule (the growing one,
    or past its block cap the uniform 320 one that serving accepts up to
    16 blocks), its stream-total bucket, and seeded latents of its length
    for its prefix."""
    try:
        schedule = growing_schedule(total)
    except ValueError:
        if total % UNIFORM_BLOCK or total // UNIFORM_BLOCK > 16:
            raise
        schedule = [UNIFORM_BLOCK] * (total // UNIFORM_BLOCK)
    gen = torch.Generator(device=models.device).manual_seed(total)
    prefix = torch.randn((1, total, models.dit_cfg.latent_size),
                         generator=gen, device=models.device)
    return dict(schedule=schedule, bucket=pick_stream_total_bucket(total),
                prefix=prefix)


def stream_once(models: EchoModels, speaker_latent: np.ndarray,
                blocks: Sequence[int], sampler_params: dict,
                speaker_mask: Optional[np.ndarray] = None,
                audio: Optional[list] = None) -> Tuple[float, float]:
    """One stream of STREAM_TEXT through stream_synthesize; (seconds to the
    first block's audio on the host, seconds to the last).  `audio`, when
    given, receives each block's audio."""
    t0 = time.perf_counter()
    ttfa = None
    for chunk in stream_synthesize(models, STREAM_TEXT,
                                   speaker_latent=speaker_latent,
                                   speaker_mask=speaker_mask,
                                   chunk_sizes=list(blocks), seed=0,
                                   sampler_params=sampler_params):
        if ttfa is None:
            ttfa = time.perf_counter() - t0
        if audio is not None:
            audio.append(chunk.audio)
    return ttfa, time.perf_counter() - t0


def emit(line: dict, dev: torch.device) -> int:
    """Print `line` with the card's name and power limit as one JSON line."""
    print(json.dumps({**line, "card": card_name(dev)}), flush=True)
    return 0
