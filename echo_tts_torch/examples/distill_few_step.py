"""Few-step distillation, end to end: teacher checkpoint -> latent shards
-> quant-aware distilled student -> checkpoint bundle -> serving smoke.
Counterpart of examples/distill_few_step.py, over train/recipe.py.

Distils the 40-step dual-CFG teacher into an N-step CFG-free student,
trained quant-aware so that it serves under ECHO_DIT_QUANT=int8.  Opt-in
and non-parity (train/distill.py).

With weights:

    python -m echo_tts_torch.examples.distill_few_step \
        --model-dir /path/to/weights --data /path/to/corpus \
        --out distilled/ --steps 4000 --student-steps 8 --batch-size 8

  * --model-dir: the published safetensors or the port's checkpoint bundle
    (tools/checkpoint.py), loaded in bf16 on the card;
  * --data: a directory of audio files, each with its transcript in a
    sibling .txt of the same stem (else the file name is the text);
  * the student's bundle lands at <out>/checkpoint (safetensors, where the
    JAX package writes orbax); serve it with ECHO_MODEL_DIR=<out>/checkpoint
    and the request parameters few_step_sampler_params(N).

Without --model-dir (or with --tiny) the same chain runs on a random tiny
teacher and synthetic audio, in fp32, with the steps, student steps,
substeps and batch capped (48, 4, 2, 4).  Like every entry point it runs
on the card unless --device cpu or ECHO_DEVICE=cpu is given, and the tiny
config's heads are not kernel A's, so the tiny chain needs the CPU:

    python -m echo_tts_torch.examples.distill_few_step --tiny --device cpu

The report (<out>/distill_report.json) holds the loss curve, the
evaluation curve (the student's N steps against the teacher's CFG sampling
from fixed noise on held-out prompts) and the serving smoke; its summary is
printed.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from ..config import tiny_dac_config, tiny_dit_config
from ..device import resolve_device
from ..pipeline import audio_io
from ..pipeline.pipeline import load_models_from_dir, random_models
from ..tools.checkpoint import is_bundle, load_checkpoint
from ..train.data import DataConfig
from ..train.recipe import distill_few_step


def iter_corpus(data_dir: str, exts=(".wav",)):
    """(waveform (1, samples), transcript) pairs from a directory of audio
    files, the transcript from a sibling .txt of the same stem, else the
    file name."""
    for name in sorted(os.listdir(data_dir)):
        if not name.lower().endswith(exts):
            continue
        stem = os.path.splitext(os.path.join(data_dir, name))[0]
        if os.path.isfile(stem + ".txt"):
            with open(stem + ".txt") as f:
                text = f.read().strip()
        else:
            text = os.path.basename(stem).replace("_", " ")
        yield audio_io.load_audio(os.path.join(data_dir, name)), text


def synthetic_corpus(models, n: int = 16, seed: int = 0):
    """n seeded noise utterances of 24-39 latents, four texts in turn."""
    rng = np.random.default_rng(seed)
    spl = models.dac_cfg.frame_length
    texts = ["A synthetic training utterance.",
             "Distilled students serve fast.",
             "Guidance folds into the weights.",
             "Few steps, same trajectory."]
    for i in range(n):
        n_latents = int(rng.integers(24, 40))
        audio = (rng.standard_normal((1, n_latents * spl))
                 .astype(np.float32) * 0.1)
        yield audio, texts[i % len(texts)]


def main(argv=None, *, models=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model-dir", help="teacher weights (published "
                    "safetensors or the port's bundle); omit for the tiny "
                    "synthetic pipeline")
    ap.add_argument("--data", help="corpus dir (audio + .txt pairs)")
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny synthetic pipeline (the default without "
                    "--model-dir)")
    ap.add_argument("--out", default="distilled")
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--student-steps", type=int, default=8)
    ap.add_argument("--substeps", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--no-quant-aware", action="store_true",
                    help="train without int8 fake-quant (the student then "
                    "serves bf16 only)")
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--seq", type=int, default=640,
                    help="training window in latents")
    ap.add_argument("--device", default=None,
                    help="torch device (default: ECHO_DEVICE, else cuda)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    tiny = args.tiny or not args.model_dir
    if args.tiny and args.model_dir:
        ap.error("--tiny and --model-dir exclude each other")
    if not tiny and not args.data:
        ap.error("--model-dir needs --data")
    if models is None:
        device = resolve_device(args.device or os.environ.get("ECHO_DEVICE")
                                or "cuda")
        if tiny and device.type == "cuda":
            ap.error("the tiny config's heads (16 wide, fp32) are not kernel "
                     "A's; run it with --device cpu")

    if tiny:
        print("no --model-dir: the tiny synthetic pipeline")
        if models is None:
            models = random_models(device, torch.float32,
                                   dit_cfg=tiny_dit_config(),
                                   dac_cfg=tiny_dac_config())
        data = synthetic_corpus(models)
        data_cfg = DataConfig(sequence_length=16, text_length=16,
                              speaker_length=8, min_latents=8)
        args.steps = min(args.steps, 48)
        args.student_steps = min(args.student_steps, 4)
        args.substeps = min(args.substeps, 2)
        args.batch_size = min(args.batch_size, 4)
        args.lr = max(args.lr, 1e-3)
    else:
        if models is None:
            models = (load_checkpoint(args.model_dir, device)
                      if is_bundle(args.model_dir)
                      else load_models_from_dir(args.model_dir, device))
        data = iter_corpus(args.data)
        data_cfg = DataConfig(sequence_length=args.seq)

    report = distill_few_step(
        models, data, args.out,
        num_steps=args.steps, num_student_steps=args.student_steps,
        substeps=args.substeps, batch_size=args.batch_size,
        data_cfg=data_cfg, lr=args.lr,
        quant_aware=not args.no_quant_aware,
        ema_decay=None if args.no_ema else 0.999)
    print(json.dumps({k: report[k] for k in
                      ("eval_mse_initial", "eval_mse_final", "improved",
                       "loss_first", "loss_last", "checkpoint",
                       "wall_seconds", "serve_smoke")}, indent=2))
    return 0 if report["serve_smoke"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
