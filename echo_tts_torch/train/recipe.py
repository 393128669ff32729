"""The few-step distillation recipe end to end: teacher -> data ->
distilled student -> checkpoint bundle -> serving.  Opt-in, non-parity
(train/distill.py).

Counterpart of echo_tts_tpu/train/recipe.py:

  1. latent shards from (audio, transcript) pairs through the codec
     (train/data.py);
  2. guidance and step distillation of the 40-step dual-CFG teacher into
     an N-step CFG-free student, quant-aware by default so that its
     checkpoint serves under ECHO_DIT_QUANT=int8 (train/distill.py);
  3. evaluation against the teacher between segments: the latent MSE of
     the student's N plain Euler steps against the teacher's full CFG
     sampling from the same fixed noise, on held-out prompts;
  4. the port's checkpoint bundle (tools/checkpoint.py) at
     <out_dir>/checkpoint, which serve/models.py loads directly;
  5. one synthesis through the serving handler with
     few_step_sampler_params(N), in the models' dtype and (optionally)
     under ECHO_DIT_QUANT=int8.

The evaluation samples in the models' own dtype (the JAX package samples
its evaluation in fp32 over bf16 parameters; here a model computes in its
parameters' dtype).  The report (also <out_dir>/distill_report.json)
carries the loss curve, the evaluation curve and the serving result.

Over a (data, model) mesh (`mesh=`) the teacher and the student are
sharded, each data coordinate evaluates its rows of the prompts (the MSE
summed over the data group), rank 0 writes the shards, the gathered
bundle and the report and runs the serving smoke, and every rank returns
the report.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import tempfile
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import SAMPLER_DEFAULTS
from ..models import dit
from ..pipeline.pipeline import EchoModels
from ..parallel.inference import place_request
from ..parallel.mesh import data_group, gather_params
from ..pipeline.text import get_text_input_ids_and_mask
from ..sampler.euler import sample_euler_cfg_independent_guidances
from .data import DataConfig, iter_batches, write_shards
from .distill import few_step_sampler_params, make_distill_step, shard_teacher
from .step import create_train_state, make_optimizer

log = logging.getLogger("echo_tts_torch.train")

_CFG_KEYS = ("cfg_scale_text", "cfg_scale_speaker", "cfg_min_t", "cfg_max_t")


def _eval_inputs(texts: Sequence[str], models: EchoModels,
                 data_cfg: DataConfig, seed: int = 1234):
    """Held-out prompts as sampler inputs with fixed noise, without a
    speaker reference (zeros and a zero mask, the reference's no-voice
    path, inference.py:329-331), so that the evaluation depends on the DiT
    alone."""
    dev = models.device
    ids, mask = get_text_input_ids_and_mask(list(texts),
                                            max_length=data_cfg.text_length)
    b = len(texts)
    ps, latent = models.dit_cfg.speaker_patch_size, models.dit_cfg.latent_size
    gen = torch.Generator(device=dev).manual_seed(seed)
    noise = torch.randn((b, data_cfg.sequence_length, latent), generator=gen,
                        device=dev)
    return (torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev),
            torch.zeros((b, ps, latent), device=dev),
            torch.zeros((b, ps), dtype=torch.bool, device=dev), noise)


def eval_few_step_gap(
    models: EchoModels,
    teacher: dit.EchoDiT,
    student: dit.EchoDiT,
    eval_inputs,
    *,
    num_student_steps: int,
    teacher_sampler_params: Optional[Dict] = None,
    teacher_latents: Optional[torch.Tensor] = None,
    mesh=None,
) -> Tuple[float, torch.Tensor]:
    """Latent MSE between the student's N-step CFG-free sample and the
    teacher's full CFG sample from the same fixed noise.  Returns (mse,
    teacher_latents), so that the teacher's pass runs once.  Under a mesh
    the models are the rank's shards and each data coordinate samples its
    rows of the inputs; the MSE is the whole batch's."""
    ids, mask, spk, spk_m, noise = eval_inputs
    if mesh is not None:
        spk, spk_m, ids, mask, noise = place_request(mesh, spk, spk_m, ids,
                                                     mask, noise)
    dtype = models.dtype
    if teacher_latents is None:
        p = dict(SAMPLER_DEFAULTS)
        p.pop("sequence_length")
        p.update(teacher_sampler_params or {})
        teacher_latents = sample_euler_cfg_independent_guidances(
            teacher, spk, spk_m, ids, mask, sequence_length=noise.shape[1],
            dtype=dtype, initial_noise=noise, mesh=mesh, **p)
    student_latents = sample_euler_cfg_independent_guidances(
        student, spk, spk_m, ids, mask, sequence_length=noise.shape[1],
        dtype=dtype, initial_noise=noise, mesh=mesh,
        **few_step_sampler_params(num_student_steps))
    sq = torch.square(student_latents - teacher_latents)
    group = None if mesh is None else data_group(mesh)
    if group is None:
        return float(torch.mean(sq)), teacher_latents
    parts = torch.stack([sq.sum(), torch.tensor(float(sq.numel()),
                                                device=sq.device)])
    dist.all_reduce(parts, group=group)
    return float(parts[0] / parts[1]), teacher_latents


def _whole_student(student: dit.EchoDiT, teacher: dit.EchoDiT,
                   mesh) -> Optional[dit.EchoDiT]:
    """The student as one model: itself without a mesh; under one, its
    gathered parameters in a copy of the (whole) teacher on rank 0, None
    on the other ranks (every rank gathers)."""
    if mesh is None:
        return student
    state = gather_params(student, mesh)
    if dist.get_rank() != 0:
        return None
    whole = copy.deepcopy(teacher)
    whole.load_state_dict(state)
    return whole


def distill_few_step(
    models: EchoModels,
    data: Iterable[Tuple[np.ndarray, str]],
    out_dir: str,
    *,
    num_steps: int,
    num_student_steps: int = 8,
    substeps: int = 5,
    batch_size: int = 4,
    data_cfg: Optional[DataConfig] = None,
    eval_texts: Sequence[str] = ("The quick brown fox.",
                                 "Distillation evaluation prompt."),
    eval_every: Optional[int] = None,
    teacher_sampler_params: Optional[Dict] = None,
    quant_aware: bool = True,
    lr: float = 5e-5,
    ema_decay: Optional[float] = 0.999,
    seed: int = 0,
    serve_smoke: bool = True,
    mesh=None,
    **distill_kw,
) -> Dict:
    """Run the whole few-step pipeline; returns the report (also written
    to <out_dir>/distill_report.json).

    `data` is an iterable of (waveform (1, samples) or (samples,), text)
    pairs; shards go under <out_dir>/shards.  The teacher is models.dit
    (left as it is); the student's bundle lands at <out_dir>/checkpoint,
    which serve/models.py loads directly.  mesh: a (data, model)
    DeviceMesh (module docstring)."""
    from ..tools.checkpoint import save_checkpoint

    t_start = time.time()
    writer = mesh is None or dist.get_rank() == 0
    os.makedirs(out_dir, exist_ok=True)
    data_cfg = data_cfg or DataConfig()
    eval_every = eval_every or max(1, num_steps // 4)
    whole_teacher = models.dit
    teacher = shard_teacher(whole_teacher, mesh)

    # 1. data: audio -> whitened-latent shards -> batches
    shards = [None]
    if writer:
        shards[0] = write_shards(models, data,
                                 os.path.join(out_dir, "shards"), cfg=data_cfg)
    if mesh is not None:
        dist.broadcast_object_list(shards, src=0)
    shards = shards[0]
    if not shards:
        raise ValueError("no usable utterances in `data` "
                         f"(min_latents={data_cfg.min_latents})")
    batches = iter_batches(shards, models, batch_size=batch_size,
                           cfg=data_cfg, seed=seed)

    # 2 + 3. distill in eval_every-sized segments, the gap measured on the
    # live student between them
    eval_in = _eval_inputs(eval_texts, models, data_cfg, seed=seed + 1)
    mse0, teacher_lat = eval_few_step_gap(
        models, teacher, teacher, eval_in,
        num_student_steps=num_student_steps,
        teacher_sampler_params=teacher_sampler_params, mesh=mesh)
    log.info("eval step 0: few-step-vs-teacher MSE %.6f (student == "
             "teacher: the step and guidance gap alone)", mse0)
    tx = make_optimizer(lr=lr, weight_decay=0.01)
    state = create_train_state(whole_teacher, tx, ema=ema_decay is not None,
                               mesh=mesh)
    step_fn = make_distill_step(
        tx, ema_decay=ema_decay if ema_decay is not None else 0.999,
        mesh=mesh, num_student_steps=num_student_steps, substeps=substeps,
        quant_aware=quant_aware,
        **{k: v for k, v in (teacher_sampler_params or {}).items()
           if k in _CFG_KEYS}, **distill_kw)
    gen = torch.Generator(device=models.device).manual_seed(seed + 7)
    losses: List[float] = []
    mse_curve: List[Tuple[int, float]] = [(0, mse0)]
    for step in range(num_steps):
        state, loss = step_fn(state, teacher, next(batches), gen)
        losses.append(float(loss))
        if (step + 1) % eval_every == 0 or step + 1 == num_steps:
            mse, _ = eval_few_step_gap(
                models, teacher, state.model, eval_in,
                num_student_steps=num_student_steps,
                teacher_latents=teacher_lat, mesh=mesh)
            mse_curve.append((step + 1, mse))
            log.info("eval step %d/%d: loss %.6f, eval MSE %.6f", step + 1,
                     num_steps, losses[-1], mse)

    # the shipped weights: the EMA when tracked, else the live parameters
    student = state.ema if state.ema is not None else state.model
    mse_final, _ = eval_few_step_gap(
        models, teacher, student, eval_in,
        num_student_steps=num_student_steps, teacher_latents=teacher_lat,
        mesh=mesh)

    # 4. the bundle that serving loads
    ckpt_dir = os.path.join(out_dir, "checkpoint")
    student = _whole_student(student, whole_teacher, mesh)
    if writer:
        save_checkpoint(ckpt_dir, dataclasses.replace(models, dit=student))

    report = {
        "num_steps": num_steps,
        "num_student_steps": num_student_steps,
        "substeps": substeps,
        "quant_aware": quant_aware,
        "ema": ema_decay is not None,
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_curve": [round(v, 8) for v in
                       losses[:: max(1, len(losses) // 64)]],
        "eval_mse_curve": [(s, round(m, 8)) for s, m in mse_curve],
        "eval_mse_initial": mse0,
        "eval_mse_final": mse_final,
        "improved": mse_final < mse0,
        "checkpoint": ckpt_dir,
        "shards": shards,
        "wall_seconds": round(time.time() - t_start, 1),
    }

    # 5. the checkpoint through the serving path
    if serve_smoke and writer:
        report["serve_smoke"] = serve_checkpoint_smoke(
            ckpt_dir, num_student_steps=num_student_steps,
            sequence_length=data_cfg.sequence_length,
            device=models.device, dtype=models.dtype)

    if writer:
        with open(os.path.join(out_dir, "distill_report.json"), "w") as f:
            json.dump(report, f, indent=2)
    return report


def serve_checkpoint_smoke(ckpt_dir: str, *, num_student_steps: int,
                           sequence_length: int, device="cuda",
                           dtype=torch.bfloat16, int8: bool = False,
                           text: str = "Few step serving smoke test.",
                           ) -> Dict:
    """Load the checkpoint bundle through serve/models.py and run one
    synthesis with few_step_sampler_params(N) through the serving handler
    (under ECHO_DIT_QUANT=int8 when int8=True).  The serving model cache
    is set aside for the call and restored after it."""
    from ..pipeline import audio_io
    from ..serve import handler as serve_handler
    from ..serve import models as serve_models
    from ..serve.config import load_config

    device = torch.device(device)
    params = dict(few_step_sampler_params(num_student_steps))
    params["sequence_length"] = sequence_length
    old_env = os.environ.get("ECHO_DIT_QUANT")
    with serve_models._CACHE_LOCK:
        saved = (serve_models._MODELS, serve_models._MODELS_KEY)
        serve_models._MODELS = serve_models._MODELS_KEY = None
    try:
        os.environ["ECHO_DIT_QUANT"] = "int8" if int8 else "none"
        with tempfile.TemporaryDirectory() as tmp:
            cfg = load_config({"ECHO_MODEL_DIR": ckpt_dir,
                               "AUDIO_VOICES_DIR": tmp,
                               "OUTPUT_AUDIO_DIR": tmp,
                               "HF_TOKEN": "unused",
                               "ECHO_DEVICE": device.type})
            bundle = serve_models.load_models(ckpt_dir, device=device,
                                              dtype=dtype)
            out = serve_handler.synthesize(
                {"text": text, "parameters": params, "seed": 0},
                cfg=cfg, models=bundle)
            ok = (out.get("status") == "success"
                  and os.path.isfile(out["local_path"]))
            audio_finite, peak = False, 0.0
            if ok:
                audio, _ = audio_io.read_wav(out["local_path"])
                audio_finite = bool(np.isfinite(audio).all())
                peak = float(np.abs(audio).max()) if audio.size else 0.0
            return {
                "ok": bool(ok and audio_finite),
                "int8": int8,
                "quant_reported": serve_models.served_quant_mode(),
                "duration_seconds": (out.get("metadata", {})
                                     .get("duration_seconds")),
                "audio_peak": peak,
                "sampler": params,
            }
    finally:
        if old_env is None:
            os.environ.pop("ECHO_DIT_QUANT", None)
        else:
            os.environ["ECHO_DIT_QUANT"] = old_env
        with serve_models._CACHE_LOCK:
            serve_models._MODELS, serve_models._MODELS_KEY = saved
        serve_handler.clear_voice_cache()
