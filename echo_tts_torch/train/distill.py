"""Few-step guidance and step distillation: opt-in, non-parity.

Counterpart of echo_tts_tpu/train/distill.py.  A 40-step dual-CFG
teacher is distilled into a student of the same architecture that
integrates the same trajectory in N plain (CFG-free) Euler steps:

  teacher target  one student-grid interval [t_i -> t_{i+1}] integrated
                  by `substeps` teacher Euler steps with dual CFG, gated
                  by the sampler's window rule; the student's target is
                  the average velocity v* = (x_end - x_t) / dt_student.
  student         initialized from the teacher; one forward, no CFG
                  branches, so the guidance is distilled into the weights.
  sampling        the Euler sampler with an empty CFG window,
                  `few_step_sampler_params(N)`: every step takes the
                  batch-B plain path.

The teacher runs without grad through dit_forward_static at 3B rows
(kernel A launched directly on the card), with the sampler's own branch
masks; the student's one forward runs under grad (kernel A through its
autograd Function), plain or through the QAT fake-quant
(ops/quant.qat_tag_dit_params), never through kernel C.  Serving reaches
a distilled model by loading its bundle (tools/checkpoint.py) and passing
few_step_sampler_params(N) per request; no shipped preset changes.

Over a (data, model) mesh (`mesh=`) the teacher is sharded like the
student, i and eps are drawn for the global batch and each rank keeps its
rows, and the loss is the global mean, as in train/step.py.

Without a mesh the step is one program of DISTILL_PROGRAMS, as the train
step is one of train/step.py's TRAIN_PROGRAMS: the teacher's substeps,
the student's forward and backward, the clip, AdamW and the EMA in one
CUDA graph per static key and batch shapes on a card, i and eps drawn
before it.  Its owners are the student's TrainState and the teacher: the
graph reads the teacher's weights in place, and is dropped when either
is freed.  Under a mesh the step runs eagerly.
"""
from __future__ import annotations

import copy
import functools
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..models import dit
from ..ops.quant import qat_tag_dit_params
from ..sampler.euler import INIT_SCALE, make_cfg_branch_masks
from ..parallel.mesh import shard_params
from ..utils import programs
from .step import (Optimizer, TrainState, apply_gradients, attention_route,
                   create_train_state, global_batch, make_optimizer,
                   masked_mse, place_batch, rows)


NUM_STUDENT_STEPS = 8      # distill_loss's default grid


def few_step_sampler_params(num_steps: int = 8) -> dict:
    """Sampler kwargs for a distilled student: N plain Euler steps on the
    INIT_SCALE-scaled grid the teacher was distilled against, the CFG
    window empty."""
    return dict(num_steps=num_steps, cfg_scale_text=0.0,
                cfg_scale_speaker=0.0, cfg_min_t=2.0, cfg_max_t=3.0)


def _static_kv(model: dit.EchoDiT, batch: Dict[str, torch.Tensor],
               dtype, mesh=None) -> Tuple[dit.KV, torch.Tensor]:
    return dit.concat_static_kv(
        dit.get_kv_cache_text(model, batch["text_ids"], batch["text_mask"],
                              mesh),
        dit.get_kv_cache_speaker(model, batch["speaker_latent"].to(dtype),
                                 mesh))


def draw_noise(latents: torch.Tensor, generator: Optional[torch.Generator],
               i: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None,
               num_student_steps: int = NUM_STUDENT_STEPS,
               mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """distill_loss's grid index i (B,) uniform over num_student_steps and
    eps ~ N(0, 1) like the latents, each drawn from `generator` (i first)
    unless given, on the latents' device; under a mesh the global
    batch's."""
    dev = latents.device
    if (i is None or eps is None) and generator is None:
        raise ValueError("pass a generator, or i and eps")
    b = global_batch(mesh, latents.shape[0])
    if i is None:
        i = torch.randint(0, num_student_steps, (b,), generator=generator,
                          device=dev)
    if eps is None:
        eps = torch.randn((b, *latents.shape[1:]), generator=generator,
                          device=dev)
    return i.to(dev), eps.to(dev)


def distill_loss(
    student: dit.EchoDiT,
    teacher: dit.EchoDiT,
    batch: Dict[str, torch.Tensor],
    generator: Optional[torch.Generator] = None,
    *,
    i: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
    num_student_steps: int = NUM_STUDENT_STEPS,
    substeps: int = 5,
    cfg_scale_text: float = 3.0,
    cfg_scale_speaker: float = 8.0,
    cfg_min_t: float = 0.5,
    cfg_max_t: float = 1.0,
    quant_aware: bool = False,
    mesh=None,
) -> torch.Tensor:
    """MSE between the student's one-step velocity and the teacher's
    `substeps`-step CFG-guided average velocity over one student-grid
    interval, at a grid index i (B,) drawn uniformly per example, with
    x_t from the forward process at t_i and eps ~ N(0, 1); both drawn
    from `generator` unless given.  quant_aware=True runs the student
    through the W8A8 fake-quant forward, so that its checkpoint serves
    under ECHO_DIT_QUANT=int8; the optimizer sees the plain parameters.
    The compute dtype is the models'.  Under a mesh the batch is the
    rank's rows and i and eps the global batch's (train/step.py)."""
    dtype = next(student.parameters()).dtype
    x0 = batch["latents"].float()
    dev = x0.device
    i, eps = draw_noise(x0, generator, i, eps, num_student_steps, mesh)
    i, eps = rows(mesh, i), rows(mesh, eps)
    b = x0.shape[0]

    # the student grid: t_i = INIT_SCALE * (1 - i / N), one step -INIT_SCALE / N
    n = torch.full((b,), num_student_steps, dtype=torch.float32, device=dev)
    t_hi = float(np.float32(INIT_SCALE)) * (1.0 - i.float() / n)
    dt_student = np.float32(-INIT_SCALE / num_student_steps)
    dt_sub = np.float32(dt_student / substeps)
    x_t = t_hi[:, None, None] * eps + (1.0 - t_hi[:, None, None]) * x0

    # the sampler's own masks: branch order [cond, uncond_text,
    # uncond_speaker] is the one production sampling uses
    mask_cfg, mask_plain = make_cfg_branch_masks(
        student.cfg, batch["text_mask"], batch["speaker_mask"])
    s_text, s_spk = float(np.float32(cfg_scale_text)), float(
        np.float32(cfg_scale_speaker))
    with torch.no_grad():
        kv_t, spk_cols = _static_kv(teacher, batch, dtype, mesh)
        x = x_t
        for j in range(substeps):
            t_j = t_hi + float(np.float32(j) * dt_sub)      # (B,), decreasing
            v = dit.dit_forward_static(
                teacher, torch.cat([x, x, x]).to(dtype),
                torch.cat([t_j, t_j, t_j]).to(dtype), kv_t, spk_cols,
                mask_cfg, mesh=mesh)
            v_c, v_ut, v_us = torch.chunk(v, 3)
            in_win = ((t_j >= float(np.float32(cfg_min_t)))
                      & (t_j <= float(np.float32(cfg_max_t))))[:, None, None]
            st = torch.where(in_win, s_text, 0.0)
            ss = torch.where(in_win, s_spk, 0.0)
            v = v_c + st * (v_c - v_ut) + ss * (v_c - v_us)
            x = x + v * float(dt_sub)
        v_target = (x - x_t) / float(dt_student)

    kv_s, spk_cols = _static_kv(student, batch, dtype, mesh)
    student_fwd = qat_tag_dit_params(student) if quant_aware else student
    v_pred = dit.dit_forward_static(student_fwd, x_t.to(dtype),
                                    t_hi.to(dtype), kv_s, spk_cols,
                                    mask_plain, mesh=mesh)
    return masked_mse(v_pred, v_target, batch.get("latent_mask"), mesh)


def shard_teacher(teacher: dit.EchoDiT, mesh) -> dit.EchoDiT:
    """The teacher sharded like the student (a copy; `teacher` is left as
    it is), or `teacher` itself without a mesh."""
    return teacher if mesh is None else shard_params(copy.deepcopy(teacher),
                                                     mesh)


# One program per static key (distill_loss's keywords, EMA and its
# decay, the clip, the attention route), (train state, teacher) and batch
# shapes (JAX: make_distill_step's jitted distill_step, distill.py:164-202).
DISTILL_PROGRAMS = programs.ProgramCache("distill_step", 8)


def _distill_body(owners: Tuple[TrainState, dit.EchoDiT],
                  batch: Dict[str, torch.Tensor], i: torch.Tensor,
                  eps: torch.Tensor, lr: torch.Tensor, *, tx: Optimizer,
                  ema_decay: float, distill_kw: dict,
                  mesh=None) -> torch.Tensor:
    """One update of the student's state in place; returns the loss."""
    state, teacher = owners
    state.optimizer.zero_grad(set_to_none=False)
    loss = distill_loss(state.model, teacher, batch, i=i, eps=eps,
                        mesh=mesh, **distill_kw)
    loss.backward()
    apply_gradients(state, tx, lr, ema_decay, mesh)
    return loss.detach()


def make_distill_step(tx: Optimizer, ema_decay: float = 0.999, mesh=None,
                      **distill_kw):
    """The distillation step (mirrors step.make_train_step):
    distill_step(state, teacher, batch, generator=None, *, i=None,
    eps=None) -> (state, loss), state updated in place; the frozen teacher
    rides as its own argument (under a mesh, sharded like the student:
    shard_teacher) and the batch is the global one.  Without a mesh the
    update is one program of DISTILL_PROGRAMS (module docstring);
    `distill_step.eager` runs the same body without it."""
    body = functools.partial(_distill_body, tx=tx, ema_decay=ema_decay,
                             distill_kw=distill_kw)
    n_steps = distill_kw.get("num_student_steps", NUM_STUDENT_STEPS)

    def inputs(state: TrainState, batch: Dict, generator, i, eps) -> tuple:
        device = next(state.model.parameters()).device
        batch = place_batch(batch, device, mesh)
        i, eps = draw_noise(batch["latents"], generator, i, eps, n_steps,
                            mesh)
        return batch, i, eps, tx.learning_rate(state.step, device)

    def eager(state: TrainState, teacher: dit.EchoDiT, batch: Dict,
              generator: Optional[torch.Generator] = None, *,
              i: Optional[torch.Tensor] = None,
              eps: Optional[torch.Tensor] = None
              ) -> Tuple[TrainState, torch.Tensor]:
        loss = body((state, teacher), *inputs(state, batch, generator, i, eps),
                    mesh=mesh)
        state.step += 1
        return state, loss

    def distill_step(state: TrainState, teacher: dit.EchoDiT, batch: Dict,
                     generator: Optional[torch.Generator] = None, *,
                     i: Optional[torch.Tensor] = None,
                     eps: Optional[torch.Tensor] = None
                     ) -> Tuple[TrainState, torch.Tensor]:
        if mesh is not None:
            return eager(state, teacher, batch, generator, i=i, eps=eps)
        key = (tuple(sorted(distill_kw.items())), state.ema is not None,
               ema_decay, tx.grad_clip, attention_route())
        loss = DISTILL_PROGRAMS(key, (state, teacher),
                                inputs(state, batch, generator, i, eps),
                                lambda: body)
        state.step += 1
        return state, loss

    distill_step.eager = eager
    return distill_step


def distill(
    teacher: dit.EchoDiT,
    batches: Iterable[dict],
    *,
    num_steps: int,
    num_student_steps: int = 8,
    substeps: int = 5,
    lr: float = 5e-5,
    weight_decay: float = 0.01,
    ema_decay: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    on_step=None,
    mesh=None,
    **cfg_kw,
) -> TrainState:
    """Distill `teacher` (left as it is) into a `num_student_steps`
    student that starts as a trainable copy of it; returns the final
    TrainState.  i and eps are drawn from `generator` (default: one seeded
    0 on the teacher's device).  cfg_kw goes to distill_loss (CFG scales
    and window, quant_aware).  mesh: a (data, model) DeviceMesh; the
    student and the teacher are the rank's shards, the batches global."""
    tx = make_optimizer(lr=lr, weight_decay=weight_decay)
    state = create_train_state(teacher, tx, ema=ema_decay is not None,
                               mesh=mesh)
    teacher = shard_teacher(teacher, mesh)
    step_fn = make_distill_step(
        tx, ema_decay=ema_decay if ema_decay is not None else 0.999,
        mesh=mesh, num_student_steps=num_student_steps, substeps=substeps,
        **cfg_kw)
    if generator is None:
        generator = torch.Generator(
            device=next(teacher.parameters()).device).manual_seed(0)
    it = iter(batches)
    for step in range(num_steps):
        try:
            batch = next(it)
        except StopIteration:
            raise ValueError(
                f"batches exhausted after {step} of {num_steps} steps; pass "
                "an infinite iterator (e.g. itertools.cycle) or lower "
                "num_steps") from None
        state, loss = step_fn(state, teacher, batch, generator)
        if on_step is not None:
            on_step(step, float(loss))
    return state
