"""The training loop around the flow-matching step, on one card or over a
(data, model) mesh.

Counterpart of echo_tts_tpu/train/loop.py: batches from any iterator of
host arrays, updates, periodic checkpoints of the parameters (and of the
EMA when it is tracked) and stage timing (`data`, `step`, `checkpoint`).
A checkpoint is a `step_XXXXXXXX/` directory holding `params.safetensors`
(and `ema.safetensors`) under the published state-dict keys, in place of
the JAX package's orbax trees.  Batches are assembled by train/data.py or
by hand, as train/step.py describes.  Over a mesh every rank iterates the
same global batches and keeps its rows, and a checkpoint holds the whole
parameters (gathered over "model"), written by rank 0 in the same layout.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from ..models import dit
from ..parallel.mesh import gather_params
from ..utils.profiling import StageTimer
from .step import (TrainState, create_train_state, make_optimizer,
                   make_train_step, place_batch)

log = logging.getLogger("echo_tts_torch.train")


def save_params(path: str, state: TrainState, mesh=None) -> str:
    """Write the state's parameters (and EMA) under
    <path>/step_XXXXXXXX/; returns that directory.  Under a mesh every
    rank gathers the whole tensors and rank 0 writes them."""
    from safetensors.torch import save_file

    out = os.path.join(os.path.abspath(path), f"step_{state.step:08d}")
    writer = mesh is None or dist.get_rank() == 0
    if writer:
        os.makedirs(out, exist_ok=True)
    trees = [("params", state.model)]
    if state.ema is not None:
        trees.append(("ema", state.ema))
    for name, model in trees:
        tensors = gather_params(model, mesh)
        if writer:
            save_file({k: v.detach().contiguous() for k, v in tensors.items()},
                      os.path.join(out, f"{name}.safetensors"))
    return out


def train(
    model: dit.EchoDiT,
    batches: Iterable[dict],
    *,
    num_steps: int,
    lr: float = 1e-4,
    weight_decay: float = 0.01,
    warmup_steps: int = 0,
    cosine_decay: bool = False,
    ema_decay: Optional[float] = None,
    generator: Optional[torch.Generator] = None,
    fixed_noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 1000,
    log_every: int = 50,
    on_step: Optional[Callable[[int, float], None]] = None,
    remat: str = "attn",
    mesh=None,
) -> TrainState:
    """Run `num_steps` updates of a trainable copy of `model` (which is
    left as it is); returns the final TrainState.

    cosine_decay=True uses linear warmup (warmup_steps) + cosine decay
    over num_steps; ema_decay (e.g. 0.999) keeps EMA weights,
    checkpointed beside the parameters.  t and eps are drawn from
    `generator` (default: one seeded 0 on the model's device), or, with
    fixed_noise=(t, eps), are those at every step: an argument the JAX
    package's train does not have, there so that a smoke run or a test
    can drive this loop on fixed draws and compare steps and remat modes
    on one loss.  remat: one of
    models.dit.REMAT_MODES (see flow_matching_loss).  mesh: a (data,
    model) DeviceMesh; the batches are global, the state the rank's shard
    (train/step.py)."""
    tx = make_optimizer(lr=lr, weight_decay=weight_decay,
                        warmup_steps=warmup_steps,
                        total_steps=num_steps if cosine_decay else 0)
    state = create_train_state(model, tx, ema=ema_decay is not None,
                               mesh=mesh)
    step_fn = make_train_step(
        tx, ema_decay=ema_decay if ema_decay is not None else 0.999,
        remat=remat, mesh=mesh)
    device = next(state.model.parameters()).device
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    t, eps = fixed_noise if fixed_noise is not None else (None, None)

    timer = StageTimer()
    it = iter(batches)
    t0 = time.time()
    for i in range(num_steps):
        with timer.stage("data"):
            try:
                batch = place_batch(next(it), device)
            except StopIteration:
                raise ValueError(
                    f"batches exhausted after {i} of {num_steps} steps; "
                    "pass an infinite iterator (e.g. itertools.cycle) or "
                    "lower num_steps") from None
        with timer.stage("step"):
            state, loss = step_fn(state, batch, generator, t=t, eps=eps)
            loss = float(loss)
        if on_step is not None:
            on_step(i, loss)
        if (i + 1) % log_every == 0:
            log.info("step %d loss %.4f (%.2f steps/s)", i + 1, loss,
                     (i + 1) / (time.time() - t0))
        if checkpoint_dir and (i + 1) % checkpoint_every == 0:
            with timer.stage("checkpoint"):
                save_params(checkpoint_dir, state, mesh)
    log.info("training done: %s", timer.report())
    return state
