"""Blockwise (streaming) Euler sampler with latent-prefix conditioning.

Counterpart of echo_tts_tpu/sampler/blockwise.py (reference:
inference_blockwise.py:14-123):

  * the prefix buffer (zeros for blocks not generated yet) is re-encoded
    through the causal latent encoder at each block after the first, as
    the reference does (inference_blockwise.py:72-73); causality and the
    position-gated latent mask (model.py:243-244) make the zero region
    irrelevant.  `incremental_latent=True` instead encodes each block's
    patches once (models/dit.py `latent_kv_append_block`), the same
    result at O(block) encoder work;
  * the stream's first block without a continuation drops the latent
    segment: all its columns would be masked, so its static K/V are
    exactly the one-shot sampler's;
  * the step plan is rebuilt per block, which re-applies the speaker-KV
    scale at each block start (inference_blockwise.py:68-70, 114-116);
  * `continuation_latent` is prepended and sets the starting position
    (inference_blockwise.py:62-65);
  * per-block noise is injected (`initial_noises`) or drawn, block after
    block, from one torch.Generator on the model's device, the torch
    reference's own order (inference_blockwise.py:42, 76), outside the
    programs below.

Every block runs as a captured program (utils/programs.py), one per the
JAX core's key and the model, on a card a CUDA graph: the prefill
(`_prefill_core`), the carried prefix's append (`_latent_inc_core`) and
the block itself (`_block_core`).  As in the JAX module, the block's
start position is an input tensor (the RoPE rows gathered at start + i,
the latent mask computed on the device), so a stream of N same-size
blocks captures one program, not N; the first block's program drops the
latent segment and reads the RoPE table at max_pos = block size, so it
is independent of the stream total.  `total_len_bucket` pads the prefix
buffer to a bucket, so that every stream whose total falls in it shares
its later-block programs (the padding lies past every start and stays
masked).  `prefill_kv` and `first_block_latents` let the streaming layer
run the prefill, the first block and its decode as one program
(serve/streaming.py) and continue the stream here.
"""
from __future__ import annotations

import functools
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import dit
from ..utils import programs
from .euler import (build_step_plan, make_cfg_branch_masks, run_step_segments,
                    step_layer_scales)

# The block programs, at most as many as the JAX package's lru_caches
# hold (blockwise.py:42-86): the prefill per model and dtype, the
# prefix's append per model, dtype and block shape, the blocks per key.
PREFILL_PROGRAMS = programs.ProgramCache("prefill", 8)
LATENT_INC_PROGRAMS = programs.ProgramCache("latent_inc", 64)
BLOCK_PROGRAMS = programs.ProgramCache("block", 256)


def _prefill_body(model, text_input_ids, text_mask, speaker_latent, *, dtype):
    return (dit.get_kv_cache_text(model, text_input_ids, text_mask),
            dit.get_kv_cache_speaker(model, speaker_latent.to(dtype)))


def _prefill_core(model: dit.EchoDiT, dtype):
    """run(text_input_ids, text_mask, speaker_latent fp32) -> (kv_text,
    kv_speaker), the text and speaker K/V once per stream
    (blockwise.py:42-51; inference.py:464-465)."""
    def run(text_input_ids, text_mask, speaker_latent):
        with torch.inference_mode():
            return PREFILL_PROGRAMS(
                (model.cfg, dtype), model,
                [text_input_ids, text_mask, speaker_latent],
                lambda: functools.partial(_prefill_body, dtype=dtype))
    return run


def _latent_inc_body(model, state, block, *, dtype):
    return dit.latent_kv_append_block(model, state, block.to(dtype))


def _latent_inc_core(model: dit.EchoDiT, dtype):
    """run(state, block (B, S_block, latent) fp32) -> the state with the
    block's patches appended (blockwise.py:54-66).  The state is copied in
    and cloned out (utils/programs.py: there is no counterpart of the JAX
    core's donated buffers)."""
    def run(state, block):
        with torch.inference_mode():
            return LATENT_INC_PROGRAMS(
                (model.cfg, dtype), model, [state, block],
                lambda: functools.partial(_latent_inc_body, dtype=dtype))
    return run


def sampler_statics(*, num_steps, cfg_scale_text, cfg_scale_speaker,
                    cfg_min_t, cfg_max_t, truncation_factor=None,
                    rescale_k=None, rescale_sigma=None,
                    speaker_kv_scale=None, speaker_kv_max_layers=None,
                    speaker_kv_min_t=None, dtype) -> tuple:
    """The hashable static tuple _block_core is keyed on, shared by the
    iterator and the streaming layer's fused first block so that the two
    can never key differently (blockwise.py:177-194)."""
    def opt(x):
        return None if x is None else float(x)
    return (int(num_steps), float(cfg_scale_text), float(cfg_scale_speaker),
            float(cfg_min_t), float(cfg_max_t), opt(truncation_factor),
            opt(rescale_k), opt(rescale_sigma), opt(speaker_kv_scale),
            speaker_kv_max_layers, opt(speaker_kv_min_t), dtype)


def _denoise(model, noise, kv_static, spk_cols, mask_cfg, mask_plain,
             start_pos, max_pos, *, plan, layer_scales, truncation_factor,
             cfg_scale_text, cfg_scale_speaker, speaker_kv_max_layers, dtype):
    x_t = noise.to(torch.float32)
    if truncation_factor is not None:
        x_t = x_t * float(np.float32(truncation_factor))
    return run_step_segments(
        model, x_t, plan, kv_static, spk_cols, mask_cfg, mask_plain,
        cfg_scale_text=cfg_scale_text, cfg_scale_speaker=cfg_scale_speaker,
        speaker_kv_max_layers=speaker_kv_max_layers, dtype=dtype,
        start_pos=start_pos, max_pos=max_pos, layer_scales=layer_scales)


def _first_block_body(model, noise, kv_text, kv_speaker, text_mask,
                      speaker_mask, *, block_size: int, **kw):
    kv_static, spk_cols = dit.concat_static_kv(kv_text, kv_speaker)
    mask_cfg, mask_plain = make_cfg_branch_masks(model.cfg, text_mask,
                                                 speaker_mask)
    return _denoise(model, noise, kv_static, spk_cols, mask_cfg, mask_plain,
                    0, block_size, **kw)


def _later_block_body(model, prefix, noise, start_pos, kv_text, kv_speaker,
                      text_mask, speaker_mask, *latent_kv, total_len: int,
                      external_latent_kv: bool, **kw):
    cfg = model.cfg
    n_lat = prefix.shape[1] // cfg.speaker_patch_size
    if external_latent_kv:
        kv_latent = (latent_kv[0], latent_kv[1])
    else:
        # the re-encode (inference_blockwise.py:72-74), constant over the
        # block's steps
        kv_latent = dit.get_kv_cache_latent(model, prefix.to(kw["dtype"]))
    lat_mask = dit.latent_prefix_mask(
        text_mask.shape[0], n_lat, start_pos, cfg.speaker_patch_size)
    kv_static, spk_cols = dit.concat_static_kv(kv_text, kv_speaker, kv_latent)
    mask_cfg, mask_plain = make_cfg_branch_masks(cfg, text_mask, speaker_mask,
                                                 lat_mask)
    x_t = _denoise(model, noise, kv_static, spk_cols, mask_cfg, mask_plain,
                   start_pos, total_len, **kw)
    # the block's columns of the prefix, which the program returns
    cols = start_pos + torch.arange(x_t.shape[1], device=x_t.device)
    prefix.index_copy_(1, cols, x_t)
    return x_t, prefix


def block_body(cfg, total_len: int, block_size: int, statics: tuple,
               external_latent_kv: bool, first_block: bool, device):
    """The body of _block_core's program for one key (made on its miss):
    the step plan and every step's layer scales built once, here, since
    the scales are a host copy that a capture cannot hold."""
    (num_steps, cfg_scale_text, cfg_scale_speaker, cfg_min_t, cfg_max_t,
     truncation_factor, rescale_k, rescale_sigma, speaker_kv_scale,
     speaker_kv_max_layers, speaker_kv_min_t, dtype) = statics
    plan = build_step_plan(num_steps, cfg_min_t, cfg_max_t, rescale_k,
                           rescale_sigma, speaker_kv_scale, speaker_kv_min_t)
    kw = dict(plan=plan,
              layer_scales=step_layer_scales(plan, cfg.num_layers,
                                             speaker_kv_max_layers, device),
              truncation_factor=truncation_factor,
              cfg_scale_text=cfg_scale_text,
              cfg_scale_speaker=cfg_scale_speaker,
              speaker_kv_max_layers=speaker_kv_max_layers, dtype=dtype)
    if first_block:
        return functools.partial(_first_block_body, block_size=block_size,
                                 **kw)
    return functools.partial(_later_block_body, total_len=total_len,
                             external_latent_kv=external_latent_kv, **kw)


def _block_core(model: dit.EchoDiT, total_len: int, block_size: int,
                num_steps: int, cfg_scale_text: float,
                cfg_scale_speaker: float, cfg_min_t: float, cfg_max_t: float,
                truncation_factor: Optional[float],
                rescale_k: Optional[float], rescale_sigma: Optional[float],
                speaker_kv_scale: Optional[float],
                speaker_kv_max_layers: Optional[int],
                speaker_kv_min_t: Optional[float], dtype,
                external_latent_kv: bool = False, first_block: bool = False):
    """One block of a fixed size as a BLOCK_PROGRAMS program
    (blockwise.py:69-174), keyed on the JAX core's key and the model:

      * first_block=True: run(noise, kv_text, kv_speaker, text_mask,
        speaker_mask) -> x_t (B, S_block, latent) fp32, without a latent
        segment, at RoPE positions 0..S_block-1 of a block_size table, so
        the program is independent of the stream total;
      * else run(prefix, noise, start_pos, kv_text, kv_speaker, text_mask,
        speaker_mask, *latent_kv) -> (x_t, prefix with x_t written at
        start_pos), start_pos a 0-d int64 tensor and max_pos = total_len,
        the prefix's length; latent_kv the carried (lat_k, lat_v) when
        external_latent_kv, else the prefix is re-encoded in the program.

    start_pos + S_block <= total_len is the caller's check."""
    statics = (num_steps, cfg_scale_text, cfg_scale_speaker, cfg_min_t,
               cfg_max_t, truncation_factor, rescale_k, rescale_sigma,
               speaker_kv_scale, speaker_kv_max_layers, speaker_kv_min_t,
               dtype)
    key = (model.cfg, total_len, block_size) + statics + (
        bool(external_latent_kv), bool(first_block))
    device = next(model.parameters()).device

    def run(*inputs):
        with torch.inference_mode():
            return BLOCK_PROGRAMS(
                key, model, list(inputs),
                lambda: block_body(model.cfg, total_len, block_size, statics,
                                   external_latent_kv, first_block, device))
    return run


@torch.inference_mode()
def iter_blockwise_euler_cfg_independent_guidances(
    model: dit.EchoDiT,
    speaker_latent: torch.Tensor,
    speaker_mask: torch.Tensor,
    text_input_ids: torch.Tensor,
    text_mask: torch.Tensor,
    *,
    block_sizes: Sequence[int],
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
    continuation_latent: Optional[torch.Tensor] = None,
    dtype=torch.bfloat16,
    initial_noises: Optional[List[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    incremental_latent: bool = False,
    total_len_bucket: Optional[int] = None,
    prefill_kv: Optional[Tuple[dit.KV, dit.KV]] = None,
    first_block_latents: Optional[torch.Tensor] = None,
) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
    """Generator over blocks: yields (block_start, block_latents, prefix)
    after each block, block_latents (B, S_block, latent) float32 and
    prefix the running (B, total, latent) float32 buffer, a tensor of its
    own at each block (blockwise.py:198-362).

    Exactly one of `initial_noises` (a list, one (B, S_block, latent)
    tensor per block) or `generator` (a torch.Generator on the model's
    device, in place of the JAX rng_key) gives the noise.

    total_len_bucket pads the prefix buffer to that many latents (at
    least the continuation and the blocks, on the patch grid), so that
    every stream whose total falls in the bucket shares its later-block
    programs; the latents are those of the unbucketed run.  `prefill_kv`
    ((kv_text, kv_speaker)) skips the prefill, and `first_block_latents`
    stands for block 0's latents (no continuation), which the caller has
    sampled: its noise is then not drawn here."""
    cfg = model.cfg
    ps = cfg.speaker_patch_size
    device = next(model.parameters()).device
    batch_size = text_input_ids.shape[0]
    block_sizes = [int(b) for b in block_sizes]
    if initial_noises is None and generator is None:
        raise ValueError("provide initial_noises or generator")

    total = sum(block_sizes)
    cont_len = 0 if continuation_latent is None else continuation_latent.shape[1]
    pad = 0
    if total_len_bucket is not None:
        if total_len_bucket < cont_len + total:
            raise ValueError(
                f"total_len_bucket {total_len_bucket} smaller than "
                f"continuation {cont_len} + sum(block_sizes) {total}")
        if total_len_bucket % ps != 0:
            raise ValueError(
                f"total_len_bucket {total_len_bucket} must be divisible by "
                f"speaker_patch_size {ps}")
        pad = total_len_bucket - cont_len - total
    if (cont_len + total) % ps != 0:
        raise ValueError(
            f"continuation length {cont_len} + sum(block_sizes) {total} must "
            f"be divisible by speaker_patch_size {ps}")
    if first_block_latents is not None and continuation_latent is not None:
        raise ValueError(
            "first_block_latents only applies to streams without a "
            "continuation (block 0 must be the latent-free first block)")
    prefix = torch.zeros((batch_size, cont_len + total + pad, cfg.latent_size),
                         dtype=torch.float32, device=device)
    if continuation_latent is not None:
        prefix[:, :cont_len] = continuation_latent.to(prefix)
    # every later block's start, on the device once: a program's input
    starts = [int(x) for x in np.cumsum([cont_len] + block_sizes[:-1])]
    starts_dev = torch.tensor(starts, dtype=torch.long).to(device)

    text_input_ids = text_input_ids.to(device)
    text_mask = text_mask.to(device)
    speaker_mask = speaker_mask.to(device)
    if prefill_kv is not None:
        kv_text, kv_speaker = prefill_kv
    else:
        kv_text, kv_speaker = _prefill_core(model, dtype)(
            text_input_ids, text_mask,
            speaker_latent.to(device, torch.float32))
    statics = sampler_statics(
        num_steps=num_steps, cfg_scale_text=cfg_scale_text,
        cfg_scale_speaker=cfg_scale_speaker, cfg_min_t=cfg_min_t,
        cfg_max_t=cfg_max_t, truncation_factor=truncation_factor,
        rescale_k=rescale_k, rescale_sigma=rescale_sigma,
        speaker_kv_scale=speaker_kv_scale,
        speaker_kv_max_layers=speaker_kv_max_layers,
        speaker_kv_min_t=speaker_kv_min_t, dtype=dtype)

    inc_state = None
    inc_pos = 0                         # the state's "pos", on the host
    max_patches = prefix.shape[1] // ps
    if incremental_latent:
        bad = [b for b in [cont_len] + block_sizes[:-1] if b % ps != 0]
        if bad:
            # a partial patch is encoded zero-padded by the re-encode but
            # stays zero in the incremental buffer, and its column is
            # visible under the position-gated mask: refuse it
            raise ValueError(
                "incremental_latent requires the continuation length and "
                "every non-final block size to be divisible by "
                f"speaker_patch_size {ps}; got {bad}")
        inc_core = _latent_inc_core(model, dtype)
        inc_state = dit.init_latent_inc_state(cfg, batch_size, max_patches,
                                              dtype, device)

        def append(state, block):
            nonlocal inc_pos
            n_new = block.shape[1] // ps
            if inc_pos + n_new > max_patches:
                raise ValueError(f"{inc_pos} + {n_new} patches exceed the "
                                 f"state's {max_patches}")
            inc_pos += n_new
            return inc_core(state, block)

        if cont_len:
            inc_state = append(inc_state, prefix[:, :cont_len])

    for b_idx, block_size in enumerate(block_sizes):
        first = b_idx == 0 and continuation_latent is None
        if first and first_block_latents is not None:
            noise = None                # sampled by the caller
        elif initial_noises is not None:
            noise = initial_noises[b_idx].to(device, torch.float32)
        else:
            noise = torch.randn((batch_size, block_size, cfg.latent_size),
                                generator=generator, device=device,
                                dtype=torch.float32)
        if first:
            if first_block_latents is not None:
                x_t = first_block_latents
            else:
                # keyed on the block size alone, in both prefix forms
                x_t = _block_core(model, block_size, block_size, *statics,
                                  False, True)(
                    noise, kv_text, kv_speaker, text_mask, speaker_mask)
            prefix[:, :block_size] = x_t
        else:
            core = _block_core(model, prefix.shape[1], block_size, *statics,
                               incremental_latent, False)
            extra = ((inc_state["lat_k"], inc_state["lat_v"])
                     if incremental_latent else ())
            x_t, prefix = core(prefix, noise, starts_dev[b_idx], kv_text,
                               kv_speaker, text_mask, speaker_mask, *extra)
        yield starts[b_idx], x_t, prefix
        if incremental_latent and b_idx + 1 < len(block_sizes):
            # the just-generated block's patches, for the later blocks
            inc_state = append(inc_state, x_t)


def sample_blockwise_euler_cfg_independent_guidances(*args, **kwargs
                                                     ) -> torch.Tensor:
    """Run every block; return the latents (B, cont_len + sum(block_sizes),
    latent) float32, without a bucket's padding (blockwise.py:365-375;
    reference: inference_blockwise.py:14-123)."""
    prefix, end = None, 0
    for start, x_t, prefix in iter_blockwise_euler_cfg_independent_guidances(
            *args, **kwargs):
        end = start + x_t.shape[1]
    return prefix[:, :end]
