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
    reference's own order (inference_blockwise.py:42, 76).

The JAX module's lru-cached jitted cores and `sampler_statics` exist only
to key XLA programs (one per block size and total), and its
`total_len_bucket` (a padded prefix buffer), `prefill_kv` argument and
`first_block_latents` (the fused first block of its streaming layer) only
to bound or save XLA programs and dispatches.  PyTorch runs eagerly, so
none of them has a counterpart here.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import dit
from .euler import build_step_plan, make_cfg_branch_masks, run_step_segments


def prefill_text_speaker_kv(model: dit.EchoDiT, speaker_latent: torch.Tensor,
                            text_input_ids: torch.Tensor,
                            text_mask: torch.Tensor, dtype=torch.bfloat16
                            ) -> Tuple[dit.KV, dit.KV]:
    """The text and speaker K/V, once per stream (inference.py:464-465)."""
    device = next(model.parameters()).device
    return (dit.get_kv_cache_text(model, text_input_ids.to(device),
                                  text_mask.to(device)),
            dit.get_kv_cache_speaker(model, speaker_latent.to(device, dtype)))


def denoise_block(model: dit.EchoDiT, noise: torch.Tensor,
                  prefill_kv: Tuple[dit.KV, dit.KV], text_mask: torch.Tensor,
                  speaker_mask: torch.Tensor, *, start_pos: int = 0,
                  kv_latent: Optional[dit.KV] = None, num_steps: int,
                  cfg_scale_text: float, cfg_scale_speaker: float,
                  cfg_min_t: float, cfg_max_t: float,
                  truncation_factor: Optional[float] = None,
                  rescale_k: Optional[float] = None,
                  rescale_sigma: Optional[float] = None,
                  speaker_kv_scale: Optional[float] = None,
                  speaker_kv_max_layers: Optional[int] = None,
                  speaker_kv_min_t: Optional[float] = None,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """One block's Euler loop from its noise (B, S_block, latent): the
    block's static K/V are [latent, text, speaker] with the latent columns
    at position * patch_size >= start_pos masked, or [text, speaker] when
    kv_latent is None (the first block).  Returns (B, S_block, latent)
    float32."""
    cfg = model.cfg
    kv_text, kv_speaker = prefill_kv
    lat_mask = None
    if kv_latent is not None:
        lat_mask = dit.latent_prefix_mask(
            text_mask.shape[0], kv_latent[0].shape[2], start_pos,
            cfg.speaker_patch_size, device=text_mask.device)
    kv_static, spk_cols = dit.concat_static_kv(kv_text, kv_speaker, kv_latent)
    mask_cfg, mask_plain = make_cfg_branch_masks(cfg, text_mask, speaker_mask,
                                                 lat_mask)
    plan = build_step_plan(num_steps, cfg_min_t, cfg_max_t, rescale_k,
                           rescale_sigma, speaker_kv_scale, speaker_kv_min_t)
    x_t = noise.to(device=text_mask.device, dtype=torch.float32)
    if truncation_factor is not None:
        x_t = x_t * float(np.float32(truncation_factor))
    return run_step_segments(
        model, x_t, plan, kv_static, spk_cols, mask_cfg, mask_plain,
        cfg_scale_text=cfg_scale_text, cfg_scale_speaker=cfg_scale_speaker,
        speaker_kv_max_layers=speaker_kv_max_layers, dtype=dtype,
        start_pos=start_pos)


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
) -> Iterator[Tuple[int, torch.Tensor, torch.Tensor]]:
    """Generator over blocks: yields (block_start, block_latents, prefix)
    after each block, block_latents (B, S_block, latent) float32 and
    prefix the running (B, total, latent) float32 buffer, which later
    blocks write in place (blockwise.py:198-362).

    Exactly one of `initial_noises` (a list, one (B, S_block, latent)
    tensor per block) or `generator` (a torch.Generator on the model's
    device, in place of the JAX rng_key) gives the noise."""
    cfg = model.cfg
    ps = cfg.speaker_patch_size
    device = next(model.parameters()).device
    batch_size = text_input_ids.shape[0]
    block_sizes = [int(b) for b in block_sizes]
    if initial_noises is None and generator is None:
        raise ValueError("provide initial_noises or generator")

    total = sum(block_sizes)
    cont_len = 0 if continuation_latent is None else continuation_latent.shape[1]
    if (cont_len + total) % ps != 0:
        raise ValueError(
            f"continuation length {cont_len} + sum(block_sizes) {total} must "
            f"be divisible by speaker_patch_size {ps}")
    prefix = torch.zeros((batch_size, cont_len + total, cfg.latent_size),
                         dtype=torch.float32, device=device)
    if continuation_latent is not None:
        prefix[:, :cont_len] = continuation_latent.to(prefix)

    text_input_ids = text_input_ids.to(device)
    text_mask = text_mask.to(device)
    speaker_mask = speaker_mask.to(device)
    kv_prefill = prefill_text_speaker_kv(model, speaker_latent,
                                         text_input_ids, text_mask, dtype)
    sampler = dict(
        num_steps=num_steps, cfg_scale_text=cfg_scale_text,
        cfg_scale_speaker=cfg_scale_speaker, cfg_min_t=cfg_min_t,
        cfg_max_t=cfg_max_t, truncation_factor=truncation_factor,
        rescale_k=rescale_k, rescale_sigma=rescale_sigma,
        speaker_kv_scale=speaker_kv_scale,
        speaker_kv_max_layers=speaker_kv_max_layers,
        speaker_kv_min_t=speaker_kv_min_t, dtype=dtype)

    inc_state = None
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
        inc_state = dit.init_latent_inc_state(
            cfg, batch_size, prefix.shape[1] // ps, dtype, device)
        if cont_len:
            dit.latent_kv_append_block(model, inc_state,
                                       prefix[:, :cont_len].to(dtype))

    start_pos = cont_len
    for b_idx, block_size in enumerate(block_sizes):
        if initial_noises is not None:
            noise = initial_noises[b_idx]
        else:
            noise = torch.randn((batch_size, block_size, cfg.latent_size),
                                generator=generator, device=device,
                                dtype=torch.float32)
        if b_idx == 0 and continuation_latent is None:
            kv_latent = None
        elif incremental_latent:
            kv_latent = (inc_state["lat_k"], inc_state["lat_v"])
        else:
            kv_latent = dit.get_kv_cache_latent(model, prefix.to(dtype))
        x_t = denoise_block(model, noise, kv_prefill, text_mask,
                            speaker_mask, start_pos=start_pos,
                            kv_latent=kv_latent, **sampler)
        prefix[:, start_pos:start_pos + block_size] = x_t
        yield start_pos, x_t, prefix
        if incremental_latent and b_idx + 1 < len(block_sizes):
            # the just-generated block's patches, for the later blocks
            dit.latent_kv_append_block(model, inc_state, x_t.to(dtype))
        start_pos += block_size


def sample_blockwise_euler_cfg_independent_guidances(*args, **kwargs
                                                     ) -> torch.Tensor:
    """Run every block; return the latents (B, cont_len + sum(block_sizes),
    latent) float32 (blockwise.py:365-375; reference:
    inference_blockwise.py:14-123)."""
    prefix = None
    for _, _, prefix in iter_blockwise_euler_cfg_independent_guidances(
            *args, **kwargs):
        pass
    return prefix
