"""The flow-matching training step for EchoDiT, on one card or over a
(data, model) mesh.

Counterpart of echo_tts_tpu/train/step.py: a rectified-flow
(v-prediction) objective consistent with the Euler sampler's convention
(x_{t'} = x + v dt with t: 1 -> 0, x(1) = noise), optimized with AdamW.
Convention: x_t = t eps + (1 - t) x0, so the target velocity is
v* = eps - x0.

Over a mesh (parallel/mesh.py; `mesh=`) the model is the rank's
tensor-parallel shard and each data coordinate takes its rows of the
global batch, and the step computes what the one-card step computes:
  * t and eps are drawn for the global batch from the same generator on
    every rank, and each rank keeps its rows;
  * the loss is the global masked mean: the numerator and the count of
    masked_mse are summed over "data" apart, and each rank
    differentiates its share (its numerator over the global count), so
    that the gradients summed over "data" are the mean gradient;
  * the global-norm clip sums the squares of the sharded gradients over
    "model" and counts the replicated ones once;
  * AdamW and the EMA are elementwise, so each rank updates its blocks.

The optimizer is optax's chain, clip_by_global_norm then adamw, in
PyTorch terms:
  * clipping scales the gradients by max_norm / norm only when the
    global norm reaches max_norm (torch's clip_grad_norm_ divides by
    norm + 1e-6 always);
  * the learning rate of update n (counting from 0) is the schedule at n,
    so with a warmup the first update has lr 0, and the cosine horizon
    includes the warmup (optax.warmup_cosine_decay_schedule);
  * weight decay reaches every trainable parameter, those without a
    gradient too (optax decays them; torch.optim.AdamW skips a parameter
    whose .grad is None, so every gradient is kept allocated, zero where
    the loss does not reach, as the latent encoder's at blockwise=True).
The Adam moments take the parameter dtype, as optax's do; the EMA is
updated in fp32 and cast back to its own dtype.

Without a mesh the step is one program of TRAIN_PROGRAMS
(utils/programs.py), the counterpart of the JAX package's jitted
train_step: the loss, its backward, the clip, AdamW and the EMA as one
CUDA graph per static key and batch shapes on a card, its owner the
TrainState, whose tensors it updates in place.  So nothing in the body
waits on the host:
  * the clip keeps the global norm a 0-d fp32 tensor and selects on the
    card, as optax does: g / where(norm < clip, 1, norm) * where(norm <
    clip, 1, clip), which is g itself below the clip.  The divisor is
    broadcast as a dimensioned fp32 tensor, so that a bf16 gradient is
    divided at fp32, as by the host float before (a 0-d fp32 tensor
    would round it to bf16 first);
  * the learning rate is an input: the schedule's float32 value at the
    update count, a 0-d tensor copied into AdamW's tensor `lr`;
  * on a card AdamW is capturable (its step counts and bias corrections
    on the card).  Its arithmetic differs from the non-capturable form
    that the CPU runs: it divides by device tensors, which rounds its
    bias corrections to the parameters' dtype.  One update of the
    published DiT in bf16 from the same gradients differs by rel-RMS
    1.066e-2 of the update, in 0.737 % of the elements, at most 1.221e-4
    (tools/train_checks.adamw_form_gap on an H100 80GB HBM3 at 700 W);
  * t and eps are drawn by the caller's generator before the program, in
    the order flow_matching_loss draws them, and passed in.
The update count stays on the host.  Over a mesh the step is a program
too, with the mesh as its scope (parallel/mesh.py, "Programs over a
mesh"): masked_mse's two all-reduces, the row-parallel ones of the
forward and the backward, the gradients' all-reduce over "data"
(reduce_gradients) and the clip's over "model" are captured with the
kernels.  The clip splits the gradients into the sharded and the
replicated ones on the host, where the program is built, so that the
body copies nothing to the card.

A batch is a dict of arrays or tensors (`place_batch` moves it to the
model's device):
  latents (B, S, 80) f32, text_ids (B, T) int, text_mask (B, T) bool,
  speaker_latent (B, Sp, 80) f32, speaker_mask (B, Sp) bool,
  latent_mask (B, S) bool, optional: valid target positions; without it
  zero-padded window tails would be trained as silence.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..models import dit
from ..parallel.mesh import (all_reduce_fp32, batch_spec, data_group,
                             mesh_coords, model_group, program_scope,
                             sharded_params)
from ..utils import programs


def place_batch(batch: Dict, device: torch.device,
                mesh=None) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on `device`; under a mesh, the rows
    of the rank's data coordinate."""
    return {k: rows(mesh, torch.as_tensor(v)).to(device)
            for k, v in batch.items()}


def rows(mesh, x: torch.Tensor) -> torch.Tensor:
    """The rank's rows of a global-batch tensor (x itself without a
    mesh)."""
    return x if mesh is None else x[batch_spec(mesh, x.shape[0])]


def global_batch(mesh, local: int) -> int:
    return local * (1 if mesh is None else mesh_coords(mesh).dp)


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
    """Mean squared error over the valid positions of `mask` (B, S), all
    of them without one (step.py:91-96).  Over a data axis the rows are
    the rank's: the value is the global batch's mean on every rank, and
    the gradient that of the rank's share of it (module docstring)."""
    sq = torch.square(pred - target)
    group = None if mesh is None else data_group(mesh)
    if group is None:
        if mask is None:
            return sq.mean()
        m = mask.float()[:, :, None]
        return (sq * m).sum() / torch.clamp(m.sum() * pred.shape[-1], min=1.0)
    if mask is None:
        num, count = sq.sum(), torch.full((), float(sq.numel()),
                                          device=sq.device)
    else:
        m = mask.float()[:, :, None]
        num, count = (sq * m).sum(), m.sum() * pred.shape[-1]
    count = count.detach().clone()
    dist.all_reduce(count, group=group)
    share = num / torch.clamp(count, min=1.0)
    total = share.detach().clone()
    dist.all_reduce(total, group=group)
    return share + (total - share.detach())


def draw_noise(latents: torch.Tensor, generator: Optional[torch.Generator],
               t: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None, mesh=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """flow_matching_loss's t (B,) ~ U[0, 1) and eps ~ N(0, 1) like the
    latents, each drawn from `generator` (t first) unless given, on the
    latents' device; under a mesh the global batch's."""
    dev = latents.device
    if (t is None or eps is None) and generator is None:
        raise ValueError("pass a generator, or t and eps")
    b = global_batch(mesh, latents.shape[0])
    if t is None:
        t = torch.rand((b,), generator=generator, device=dev)
    if eps is None:
        eps = torch.randn((b, *latents.shape[1:]), generator=generator,
                          device=dev)
    return t.to(dev), eps.to(dev)


def flow_matching_loss(model: dit.EchoDiT, batch: Dict[str, torch.Tensor],
                       generator: Optional[torch.Generator] = None, *,
                       t: Optional[torch.Tensor] = None,
                       eps: Optional[torch.Tensor] = None,
                       remat: str = "attn", mesh=None) -> torch.Tensor:
    """MSE between the predicted and the target velocity.

    t (B,) ~ U[0, 1) and eps ~ N(0, 1) like the latents are drawn from
    `generator` unless given (tests inject the JAX package's draws).
    The model's parameter dtype is the compute dtype (JAX's `dtype`
    argument: cast the model instead).  remat: one of
    models.dit.REMAT_MODES; "attn" saves each layer's attention output
    and recomputes the rest.  Under a mesh the batch is the rank's rows,
    and t and eps (drawn or given) the global batch's, of which the rank
    keeps its rows."""
    dtype = next(model.parameters()).dtype
    x0 = batch["latents"].float()
    t, eps = draw_noise(x0, generator, t, eps, mesh)
    t, eps = rows(mesh, t).float(), rows(mesh, eps)
    x_t = t[:, None, None] * eps + (1.0 - t[:, None, None]) * x0
    v_target = eps - x0

    kv_text = dit.get_kv_cache_text(model, batch["text_ids"],
                                    batch["text_mask"], mesh)
    kv_speaker = dit.get_kv_cache_speaker(
        model, batch["speaker_latent"].to(dtype), mesh)
    v_pred = dit.dit_forward(model, x_t.to(dtype), t.to(dtype),
                             batch["text_mask"], batch["speaker_mask"],
                             kv_text, kv_speaker, remat=remat, mesh=mesh)
    return masked_mse(v_pred, v_target, batch.get("latent_mask"), mesh)


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

def warmup_cosine_decay(peak: float, warmup_steps: int, decay_steps: int,
                        end_value: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps, end_value) in its float32 arithmetic: linear from 0 over
    the warmup, then cosine decay to end_value over the remaining
    decay_steps - warmup_steps updates, constant after."""
    f32 = np.float32
    alpha = f32(0.0 if peak == 0.0 else end_value / peak)
    horizon = decay_steps - warmup_steps
    if horizon <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = f32(1.0) - f32(count) / f32(warmup_steps)
            return float(f32(-peak) * frac + f32(peak))
        c = f32(min(count - warmup_steps, horizon))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * c / f32(horizon)))
        return float(f32(peak) * ((f32(1.0) - alpha) * cosine + alpha))

    return schedule


def clip_by_global_norm_(grads: List[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax's clip_by_global_norm in place, selected on the card: each
    gradient divided by where(norm < max_norm, 1, norm) and multiplied by
    where(norm < max_norm, 1, max_norm), so that below the clip it is
    exactly itself.  norm is a 0-d fp32 tensor; each gradient is divided
    (and multiplied) at fp32 and rounded once to its dtype, as by a host
    float: the scale is broadcast as a dimensioned fp32 tensor (a 0-d
    fp32 tensor would be rounded to a bf16 gradient's dtype first)."""
    below = norm < max_norm
    denom = torch.where(below, 1.0, norm)
    # at max_norm 1 the multiplier is 1 on both sides of the clip
    mult = None if max_norm == 1.0 else torch.where(below, 1.0, max_norm)
    for g in grads:
        shape = (1,) * g.dim()
        g.div_(denom.reshape(shape))
        if mult is not None:
            g.mul_(mult.reshape(shape))


def _square_sum(grads: List[torch.Tensor], device) -> torch.Tensor:
    """The sum of the squares of every gradient's norm, a 0-d fp32 tensor
    on `device` (0 for none)."""
    if not grads:
        return torch.zeros((), device=device)
    return torch.stack(torch._foreach_norm(grads)).float().square().sum()


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """AdamW (b1 0.9, b2 0.95, eps 1e-8) with optax's global-norm clipping
    and a learning-rate schedule (module docstring): `init` builds the
    torch optimizer over a model's parameters, `update` applies one step
    from their gradients."""
    schedule: Callable[[int], float]
    weight_decay: float
    grad_clip: float

    def learning_rate(self, count: int, device) -> torch.Tensor:
        """Update `count`'s learning rate, the schedule's float32 value, as
        a 0-d fp32 tensor on `device` (a fill, no host copy)."""
        return torch.full((), self.schedule(count), dtype=torch.float32,
                          device=device)

    def init(self, params: List[torch.nn.Parameter]) -> torch.optim.AdamW:
        """AdamW over params with a tensor learning rate on their device;
        capturable on a card (module docstring)."""
        params = list(params)
        for p in params:
            # every parameter is decayed, reached by the loss or not
            p.grad = torch.zeros_like(p)
        device = params[0].device
        return torch.optim.AdamW(params, lr=self.learning_rate(0, device),
                                 betas=(0.9, 0.95), eps=1e-8,
                                 weight_decay=self.weight_decay,
                                 capturable=device.type == "cuda")

    def update(self, opt: torch.optim.AdamW, lr: Union[int, torch.Tensor],
               mesh=None, sharded: frozenset = frozenset()) -> torch.Tensor:
        """Clip the gradients as optax does, set the learning rate and
        step; returns the global gradient norm, a 0-d fp32 tensor.  lr: the
        update count, or its learning rate already a 0-d fp32 tensor on
        the parameters' device (a program's input).  Under a mesh,
        `sharded` holds the ids of the tensor-parallel parameters, whose
        squares are summed over the model group."""
        params = [p for group in opt.param_groups for p in group["params"]]
        grads = [p.grad for p in params]
        device = grads[0].device
        group = None if mesh is None else model_group(mesh)
        if group is None:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)).float())
        else:
            sq_split = _square_sum([p.grad for p in params
                                    if id(p) in sharded], device)
            dist.all_reduce(sq_split, group=group)
            sq_rep = _square_sum([p.grad for p in params
                                  if id(p) not in sharded], device)
            norm = (sq_split + sq_rep).sqrt()
        clip_by_global_norm_(grads, norm, self.grad_clip)
        if not isinstance(lr, torch.Tensor):
            lr = self.learning_rate(lr, device)
        for group in opt.param_groups:
            group["lr"].copy_(lr)
        opt.step()
        return norm


def make_optimizer(lr: float = 1e-4, weight_decay: float = 0.01,
                   grad_clip: float = 1.0, warmup_steps: int = 0,
                   total_steps: int = 0, end_lr_ratio: float = 0.1
                   ) -> Optimizer:
    """AdamW with global-norm clipping; pass warmup_steps/total_steps for
    linear warmup + cosine decay (to lr * end_lr_ratio), else the learning
    rate is constant."""
    if warmup_steps and not total_steps:
        raise ValueError(
            "warmup_steps requires total_steps (the cosine-decay horizon);"
            " without it the warmup would be silently ignored")
    if total_steps:
        schedule = warmup_cosine_decay(lr, warmup_steps, total_steps,
                                       lr * end_lr_ratio)
    else:
        schedule = lambda count: lr  # noqa: E731
    return Optimizer(schedule, weight_decay, grad_clip)


# ---------------------------------------------------------------------------
# The train state and step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TrainState:
    """The trained model (its own copy), its AdamW, the update count and
    the EMA of its parameters (the weights diffusion models ship; None
    when disabled)."""
    model: dit.EchoDiT
    optimizer: torch.optim.AdamW
    step: int = 0
    ema: Optional[dit.EchoDiT] = None


def create_train_state(model: dit.EchoDiT, tx: Optimizer,
                       ema: bool = False, mesh=None) -> TrainState:
    """A trainable copy of `model` with AdamW moments over it; ema=True
    starts an EMA copy at the initial parameters.  Under a mesh the copy
    is the rank's tensor-parallel shard (parallel.mesh.shard_params), and
    the moments and the EMA are its.  `model` itself is not changed."""
    from ..parallel.mesh import shard_params

    trained = dit.trainable_copy(model)
    if mesh is not None:
        shard_params(trained, mesh)
    return TrainState(
        model=trained, optimizer=tx.init(trained.parameters()),
        ema=dit.trainable_copy(trained).requires_grad_(False) if ema else None)


@torch.no_grad()
def update_ema(ema: torch.nn.Module, model: torch.nn.Module,
               decay: float) -> None:
    """ema = decay * ema + (1 - decay) * params, in fp32, cast back to the
    EMA's dtype (step.py:160-166)."""
    d = np.float32(decay)
    for e, p in zip(ema.parameters(), model.parameters()):
        e.copy_(float(d) * e.float() + float(np.float32(1.0) - d) * p.float())


@torch.no_grad()
def reduce_gradients(model: torch.nn.Module, mesh) -> None:
    """Sum every gradient over the data group (fp32, one rounding): each
    rank's is the gradient of its share of the global mean."""
    group = data_group(mesh)
    if group is None:
        return
    for p in model.parameters():
        if p.grad is not None:
            p.grad.copy_(all_reduce_fp32(p.grad, group))


def apply_gradients(state: TrainState, tx: Optimizer, lr: torch.Tensor,
                    ema_decay: float, mesh=None) -> None:
    """One optimizer update from the gradients on state.model at learning
    rate lr (a 0-d fp32 tensor), and the EMA; under a mesh, the gradients
    summed over "data" first.  The update count is the caller's."""
    if mesh is None:
        tx.update(state.optimizer, lr)
    else:
        reduce_gradients(state.model, mesh)
        tx.update(state.optimizer, lr, mesh, sharded_params(state.model))
    if state.ema is not None:
        update_ema(state.ema, state.model, ema_decay)


def attention_route():
    """The joint attention the DiT's forward calls now: kernel A's wrapper,
    or the plain version under models.plain.plain_kernels.  It is part of
    a training program's key, since a graph replays what its capture
    launched whatever the module binds later."""
    return dit.fused_joint_attention


# One program per static key (remat mode, EMA and its decay, the clip,
# the attention route), train state, mesh and batch shapes (JAX:
# make_train_step's jitted train_step, step.py:154-168).
TRAIN_PROGRAMS = programs.ProgramCache("train_step", 16)


def _train_body(state: TrainState, batch: Dict[str, torch.Tensor],
                t: torch.Tensor, eps: torch.Tensor, lr: torch.Tensor, *,
                tx: Optimizer, ema_decay: float, remat: str,
                mesh=None) -> torch.Tensor:
    """One update of `state` in place (gradients zeroed, the loss, its
    backward, the clip, AdamW, the EMA); returns the loss."""
    state.optimizer.zero_grad(set_to_none=False)
    loss = flow_matching_loss(state.model, batch, t=t, eps=eps, remat=remat,
                              mesh=mesh)
    loss.backward()
    apply_gradients(state, tx, lr, ema_decay, mesh)
    return loss.detach()


def make_train_step(tx: Optimizer, ema_decay: float = 0.999,
                    remat: str = "attn", mesh=None):
    """The train step: train_step(state, batch, generator=None, *, t=None,
    eps=None) -> (state, loss), state updated in place.  `remat` goes to
    flow_matching_loss.  The update runs as one program of TRAIN_PROGRAMS
    (module docstring): its first call at a key, state, mesh and batch
    shapes runs eagerly and captures, later ones replay.  Under a mesh
    (state from create_train_state with the same mesh) the batch, t and
    eps are the global batch's, of which each rank takes its rows, and the
    loss is the global one.  t and eps are drawn from `generator` before
    the update unless given.  `train_step.eager` takes the same arguments
    and runs the same body without the program (over a gloo mesh on a
    card, which no graph can capture)."""
    dit.remat_mode(remat)
    body = functools.partial(_train_body, tx=tx, ema_decay=ema_decay,
                             remat=remat, mesh=mesh)

    def inputs(state: TrainState, batch: Dict, generator, t, eps) -> tuple:
        device = next(state.model.parameters()).device
        batch = place_batch(batch, device, mesh)
        t, eps = draw_noise(batch["latents"], generator, t, eps, mesh)
        return batch, t, eps, tx.learning_rate(state.step, device)

    def eager(state: TrainState, batch: Dict,
              generator: Optional[torch.Generator] = None, *,
              t: Optional[torch.Tensor] = None,
              eps: Optional[torch.Tensor] = None
              ) -> Tuple[TrainState, torch.Tensor]:
        loss = body(state, *inputs(state, batch, generator, t, eps))
        state.step += 1
        return state, loss

    def train_step(state: TrainState, batch: Dict,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None
                   ) -> Tuple[TrainState, torch.Tensor]:
        key = (remat, state.ema is not None, ema_decay, tx.grad_clip,
               attention_route())
        loss = TRAIN_PROGRAMS(key, state,
                              inputs(state, batch, generator, t, eps),
                              lambda: body, scope=program_scope(mesh))
        state.step += 1
        return state, loss

    train_step.eager = eager
    return train_step
