"""Euler flow-matching sampler with independent text/speaker CFG.

Counterpart of echo_tts_tpu/sampler/euler.py (reference:
inference.py:427-517).  The per-step schedule is host numpy, resolved
before the loop (build_step_plan); the steps run as a Python loop in which
CFG steps run one batch-3B forward (branches [cond, uncond_text,
uncond_speaker], G-major over the batch-B static KV) and the other steps a
batch-B forward, as the reference's dynamic `has_cfg` branch does.

Under a (data, model) mesh (`mesh=`, parallel/): the model is the rank's
tensor-parallel shard (parallel.inference.shard_models) and the request
tensors are the rank's rows (parallel.inference.place_request); the CFG
batch is built from those rows, so it stays G-major over the rank's own
static K/V, and the result is the rank's rows of the latents.

Without a mesh the sampler runs as one captured program per static
configuration and input shapes, `_euler_core` (JAX euler.py:197-257, one
jitted program over the prefill and every step): on a card a CUDA graph
(utils/programs.py), replayed with one launch.  The per-step scalars are
Python floats baked into it, as the JAX core bakes them from its cache
key.  Under a mesh the sampler runs eagerly.
"""
from __future__ import annotations

import functools
import itertools
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import EchoDiTConfig
from ..models import dit
from ..ops.quant import quantize_kv_int8
from ..parallel.mesh import mesh_coords
from ..utils import programs


class StepPlan(NamedTuple):
    """Per-step schedule, resolved on the host."""
    t: np.ndarray            # (N,) f32 — current t per step
    dt: np.ndarray           # (N,) f32 — (t_next - t)
    has_cfg: np.ndarray      # (N,) bool
    speaker_scale: np.ndarray  # (N,) f32 — functional KV scale per step
    rescale_c1: np.ndarray   # (N,) f32 — v' = c1 * v + c2 * x
    rescale_c2: np.ndarray   # (N,) f32


INIT_SCALE = 0.999  # so rescale applies at step 0 (inference.py:452)


def build_step_plan(num_steps: int, cfg_min_t: float, cfg_max_t: float,
                    rescale_k: Optional[float], rescale_sigma: Optional[float],
                    speaker_kv_scale: Optional[float],
                    speaker_kv_min_t: Optional[float]) -> StepPlan:
    """The reference's per-step host logic in float32
    (inference.py:459, 481-515)."""
    t_sched = (np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float32)
               * np.float32(INIT_SCALE)).astype(np.float32)
    t = t_sched[:-1]
    t_next = t_sched[1:]
    dt = (t_next - t).astype(np.float32)

    has_cfg = (t >= np.float32(cfg_min_t)) & (t <= np.float32(cfg_max_t))

    # speaker-KV scale: applied up-front, un-applied after the step where
    # t crosses below speaker_kv_min_t (inference.py:467-468, 511-513).
    scales = np.ones(num_steps, dtype=np.float32)
    if speaker_kv_scale is not None:
        state = np.float32(speaker_kv_scale)
        min_t = np.float32(speaker_kv_min_t)
        for i in range(num_steps):
            scales[i] = state
            if t_next[i] < min_t and t[i] >= min_t:
                state = np.float32(1.0)

    # temporal score rescale (arXiv 2510.01184; inference.py:416-424):
    #   v' = ratio*v + (ratio-1)/(1-t)*x
    c1 = np.ones(num_steps, dtype=np.float32)
    c2 = np.zeros(num_steps, dtype=np.float32)
    if rescale_k is not None and rescale_sigma is not None:
        k = np.float32(rescale_k)
        sig = np.float32(rescale_sigma)
        for i in range(num_steps):
            ti = t[i]
            if ti < 1.0:
                snr = (1 - ti) ** 2 / (ti ** 2)
                ratio = (snr * sig ** 2 + 1) / (snr * sig ** 2 / k + 1)
                c1[i] = ratio
                c2[i] = (ratio - 1) / (1 - ti)

    return StepPlan(t=t, dt=dt, has_cfg=has_cfg, speaker_scale=scales,
                    rescale_c1=c1.astype(np.float32),
                    rescale_c2=c2.astype(np.float32))


def _segments(has_cfg: np.ndarray) -> List[Tuple[bool, int, int]]:
    """Contiguous (cfg?, start, stop) runs of the step index."""
    out = []
    i = 0
    for flag, grp in itertools.groupby(has_cfg.tolist()):
        n = len(list(grp))
        out.append((bool(flag), i, i + n))
        i += n
    return out


def make_cfg_branch_masks(cfg: EchoDiTConfig, text_mask: torch.Tensor,
                          speaker_mask: torch.Tensor,
                          latent_mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static key masks (mask_cfg (3B, T), mask_plain (B, T)).  Branch
    order [cond, uncond_text, uncond_speaker] (inference.py:474-475):
    uncond_text zeroes the text columns, uncond_speaker the speaker ones;
    a blockwise latent-prefix mask is the same in all three
    (euler.py:111-126)."""
    zero_t = torch.zeros_like(text_mask)
    zero_s = torch.zeros_like(speaker_mask)
    full_text = torch.cat([text_mask, zero_t, text_mask], dim=0)
    full_spk = torch.cat([speaker_mask, speaker_mask, zero_s], dim=0)
    lat3 = None if latent_mask is None else torch.cat([latent_mask] * 3, dim=0)
    mask_plain = dit.static_attention_mask(cfg, text_mask, speaker_mask,
                                           latent_mask)
    mask_cfg = dit.static_attention_mask(cfg, full_text, full_spk, lat3)
    return mask_cfg, mask_plain


def step_layer_scales(plan: StepPlan, num_layers: int,
                      speaker_kv_max_layers: Optional[int],
                      device) -> torch.Tensor:
    """Every step's per-layer speaker-KV scale, (N, L) fp32 on `device`:
    the step's scale on the first speaker_kv_max_layers layers, 1 above.
    A host copy, so a program builds it once, before its capture."""
    max_layers = (num_layers if speaker_kv_max_layers is None
                  else min(speaker_kv_max_layers, num_layers))
    gate = np.arange(num_layers) < max_layers
    return torch.from_numpy(np.where(
        gate[None, :], plan.speaker_scale[:, None], np.float32(1.0)
    ).astype(np.float32)).to(device)


def run_step_segments(model: dit.EchoDiT, x_t: torch.Tensor, plan: StepPlan,
                      kv_static: dit.KV, spk_cols: torch.Tensor,
                      mask_cfg: torch.Tensor, mask_plain: torch.Tensor, *,
                      cfg_scale_text: float, cfg_scale_speaker: float,
                      speaker_kv_max_layers: Optional[int], dtype,
                      start_pos: int = 0, mesh=None,
                      layer_scales: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The Euler loop over the step plan (reference loop:
    inference.py:481-515); x_t (B, S, latent) float32.  `layer_scales`
    (step_layer_scales) is made here when not given."""
    batch_size = x_t.shape[0]
    if layer_scales is None:
        layer_scales = step_layer_scales(plan, model.cfg.num_layers,
                                         speaker_kv_max_layers, x_t.device)
    s_text = float(np.float32(cfg_scale_text))
    s_spk = float(np.float32(cfg_scale_speaker))

    steps = [(is_cfg, i) for is_cfg, start, stop in _segments(plan.has_cfg)
             for i in range(start, stop)]
    for is_cfg, i in steps:
        t_i, dt_i = float(plan.t[i]), float(plan.dt[i])
        c1, c2 = float(plan.rescale_c1[i]), float(plan.rescale_c2[i])
        if is_cfg:
            x3 = torch.cat([x_t, x_t, x_t], dim=0).to(dtype)
            t3 = torch.full((3 * batch_size,), t_i, dtype=torch.float32,
                            device=x_t.device).to(dtype)
            v = dit.dit_forward_static(
                model, x3, t3, kv_static, spk_cols, mask_cfg,
                start_pos=start_pos, speaker_scale_by_layer=layer_scales[i],
                mesh=mesh)
            v_c, v_ut, v_us = torch.chunk(v, 3, dim=0)
            v = v_c + s_text * (v_c - v_ut) + s_spk * (v_c - v_us)
        else:
            t1 = torch.full((batch_size,), t_i, dtype=torch.float32,
                            device=x_t.device).to(dtype)
            v = dit.dit_forward_static(
                model, x_t.to(dtype), t1, kv_static, spk_cols, mask_plain,
                start_pos=start_pos, speaker_scale_by_layer=layer_scales[i],
                mesh=mesh)
        v = c1 * v + c2 * x_t
        x_t = x_t + v * dt_i
    return x_t


class StaticPrefill(NamedTuple):
    """A request's prefilled static K/V and what the step loop reads with
    them (run_step_segments(model, x_t, plan, *prefill, ...))."""
    kv_static: object          # (k, v), or quantize_kv_int8's dict
    spk_cols: torch.Tensor
    mask_cfg: torch.Tensor
    mask_plain: torch.Tensor


@torch.inference_mode()
def prefill_static(model: dit.EchoDiT, speaker_latent: torch.Tensor,
                   speaker_mask: torch.Tensor, text_input_ids: torch.Tensor,
                   text_mask: torch.Tensor, *, dtype=torch.bfloat16,
                   kv_quant: bool = False, mesh=None) -> StaticPrefill:
    """The one-time prefill before the step loop (reference:
    inference.py:464-465), in model dtype: the text and speaker K/V
    concatenated once, stored int8 when kv_quant, and the CFG branch
    masks."""
    device = next(model.parameters()).device
    text_input_ids = text_input_ids.to(device)
    text_mask = text_mask.to(device)
    speaker_mask = speaker_mask.to(device)
    kv_text = dit.get_kv_cache_text(model, text_input_ids, text_mask, mesh)
    kv_speaker = dit.get_kv_cache_speaker(
        model, speaker_latent.to(device=device, dtype=dtype), mesh)
    kv_static, spk_cols = dit.concat_static_kv(kv_text, kv_speaker)
    if kv_quant:
        kv_static = quantize_kv_int8(*kv_static)
    mask_cfg, mask_plain = make_cfg_branch_masks(model.cfg, text_mask,
                                                 speaker_mask)
    return StaticPrefill(kv_static, spk_cols, mask_cfg, mask_plain)


@torch.inference_mode()
def sample_euler_cfg_independent_guidances(
    model: dit.EchoDiT,
    speaker_latent: torch.Tensor,
    speaker_mask: torch.Tensor,
    text_input_ids: torch.Tensor,
    text_mask: torch.Tensor,
    *,
    num_steps: int,
    cfg_scale_text: float,
    cfg_scale_speaker: float,
    cfg_min_t: float,
    cfg_max_t: float,
    truncation_factor: Optional[float] = None,
    rescale_k: Optional[float] = None,
    rescale_sigma: Optional[float] = None,
    speaker_kv_scale: Optional[float] = None,
    speaker_kv_max_layers: Optional[int] = None,
    speaker_kv_min_t: Optional[float] = None,
    sequence_length: int = 640,
    dtype=torch.bfloat16,
    initial_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    kv_quant: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Latents (B, sequence_length, latent_size) float32 on the model's
    device.  Exactly one of `initial_noise` (f32) or `generator` (a
    torch.Generator on the model's device, in place of the JAX rng_key)
    draws the starting noise.

    kv_quant=True stores the prefilled static K/V int8
    (ops.quant.quantize_kv_int8, once, before the step loop): half the
    K/V's memory and read bytes, their scales folded into the attention's
    column scales.  Opt-in and non-parity (per-token rounding), as in the
    JAX package (euler.py:244-246).

    mesh: a (data, model) DeviceMesh (module docstring); the inputs and
    the result are the rank's rows.  Over more than one data rank the
    noise is the rank's rows of the request's, from place_request: a
    generator here would draw another noise on every rank."""
    cfg = model.cfg
    device = next(model.parameters()).device
    batch_size = text_input_ids.shape[0]
    if initial_noise is None:
        if generator is None:
            raise ValueError("provide initial_noise or generator")
        if mesh is not None and mesh_coords(mesh).dp > 1:
            raise ValueError("over a data axis > 1 pass initial_noise (the "
                             "rank's rows, parallel.inference.place_request)")
        initial_noise = torch.randn(
            (batch_size, sequence_length, cfg.latent_size),
            generator=generator, device=device, dtype=torch.float32)
    if mesh is None:
        core = _euler_core(
            model, num_steps, float(cfg_scale_text), float(cfg_scale_speaker),
            float(cfg_min_t), float(cfg_max_t), _opt_float(truncation_factor),
            _opt_float(rescale_k), _opt_float(rescale_sigma),
            _opt_float(speaker_kv_scale), speaker_kv_max_layers,
            _opt_float(speaker_kv_min_t), dtype, bool(kv_quant))
        return core(speaker_latent, speaker_mask, text_input_ids, text_mask,
                    initial_noise)

    plan = build_step_plan(num_steps, cfg_min_t, cfg_max_t, rescale_k,
                           rescale_sigma, speaker_kv_scale, speaker_kv_min_t)
    return _euler_body(
        model, speaker_latent, speaker_mask, text_input_ids, text_mask,
        initial_noise.to(device), plan=plan, layer_scales=None,
        truncation_factor=truncation_factor, cfg_scale_text=cfg_scale_text,
        cfg_scale_speaker=cfg_scale_speaker,
        speaker_kv_max_layers=speaker_kv_max_layers, dtype=dtype,
        kv_quant=kv_quant, mesh=mesh)


def _opt_float(x) -> Optional[float]:
    return None if x is None else float(x)


# The sampler's programs, one per static configuration (the model, its
# parameters and the JAX core's key) and input shapes, at most 64: the
# bound of the JAX package's lru_cache on _euler_core.
EULER_PROGRAMS = programs.ProgramCache("euler", 64)


def _euler_body(model, speaker_latent, speaker_mask, text_input_ids,
                text_mask, initial_noise, *, plan: StepPlan,
                layer_scales: Optional[torch.Tensor], truncation_factor,
                cfg_scale_text, cfg_scale_speaker, speaker_kv_max_layers,
                dtype, kv_quant: bool, mesh=None) -> torch.Tensor:
    """The prefill and every step on one request's tensors (what
    _euler_core captures; under a mesh, what the sampler runs eagerly)."""
    x_t = initial_noise.to(torch.float32, copy=True)
    if truncation_factor is not None:
        x_t = x_t * float(np.float32(truncation_factor))
    pre = prefill_static(model, speaker_latent, speaker_mask, text_input_ids,
                         text_mask, dtype=dtype, kv_quant=kv_quant, mesh=mesh)
    return run_step_segments(
        model, x_t, plan, *pre, cfg_scale_text=cfg_scale_text,
        cfg_scale_speaker=cfg_scale_speaker,
        speaker_kv_max_layers=speaker_kv_max_layers, dtype=dtype, mesh=mesh,
        layer_scales=layer_scales)


def _euler_core(model: dit.EchoDiT, num_steps: int, cfg_scale_text: float,
                cfg_scale_speaker: float, cfg_min_t: float, cfg_max_t: float,
                truncation_factor: Optional[float], rescale_k: Optional[float],
                rescale_sigma: Optional[float],
                speaker_kv_scale: Optional[float],
                speaker_kv_max_layers: Optional[int],
                speaker_kv_min_t: Optional[float], dtype,
                kv_quant: bool = False):
    """The sampler core of one static configuration (JAX euler.py:197-257):
    run(speaker_latent, speaker_mask, text_input_ids, text_mask,
    initial_noise) -> latents (B, S, latent) fp32, the prefill and every
    step as one program of EULER_PROGRAMS per input shapes.  Its key is
    the JAX core's (the model's config and the sampler's parameters, the
    dtype, kv_quant) with the model itself, whose weights the program
    reads.  The per-step scalars are baked into the program; the step plan
    and the per-layer speaker scales are built once, on its miss.  The
    inputs are moved to the model's device first; the noise is drawn by
    the caller."""
    cfg = model.cfg
    device = next(model.parameters()).device
    key = (cfg, num_steps, cfg_scale_text, cfg_scale_speaker, cfg_min_t,
           cfg_max_t, truncation_factor, rescale_k, rescale_sigma,
           speaker_kv_scale, speaker_kv_max_layers, speaker_kv_min_t, dtype,
           kv_quant)

    def make_body():
        plan = build_step_plan(num_steps, cfg_min_t, cfg_max_t, rescale_k,
                               rescale_sigma, speaker_kv_scale,
                               speaker_kv_min_t)
        return functools.partial(
            _euler_body, plan=plan,
            layer_scales=step_layer_scales(plan, cfg.num_layers,
                                           speaker_kv_max_layers, device),
            truncation_factor=truncation_factor,
            cfg_scale_text=cfg_scale_text, cfg_scale_speaker=cfg_scale_speaker,
            speaker_kv_max_layers=speaker_kv_max_layers, dtype=dtype,
            kv_quant=kv_quant)

    def run(speaker_latent, speaker_mask, text_input_ids, text_mask,
            initial_noise):
        inputs = [x.to(device) for x in (speaker_latent, speaker_mask,
                                         text_input_ids, text_mask)]
        inputs.append(initial_noise.to(device=device, dtype=torch.float32))
        with torch.inference_mode():
            return EULER_PROGRAMS(key, model, inputs, make_body)

    return run
