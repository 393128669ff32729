"""The Euler flow-matching sampler with independent text and speaker
guidance (published inference.py:427-517), over reference/dit.py.

CFG steps (t in [cfg_min_t, cfg_max_t]) run the branches [cond,
uncond_text, uncond_speaker] as one 3B-row forward: uncond_text hides the
text columns, uncond_speaker the speaker ones.  `t_dtype` rounds the
timestep to the dtype the model is served in, as the published model
takes it; everything else is float32.
"""
from __future__ import annotations

import numpy as np
import torch

from . import dit


def step_plan(num_steps: int, cfg_min_t: float, cfg_max_t: float):
    """(t, dt, has_cfg) per step, float32 (inference.py:452-459)."""
    sched = (np.linspace(1.0, 0.0, num_steps + 1, dtype=np.float32)
             * np.float32(0.999)).astype(np.float32)
    t, dt = sched[:-1], (sched[1:] - sched[:-1]).astype(np.float32)
    has_cfg = (t >= np.float32(cfg_min_t)) & (t <= np.float32(cfg_max_t))
    return t, dt, has_cfg


def sample(W: dit.Weights, c: dict, s: dict, speaker_latent, speaker_mask,
           text_ids, text_mask, noise, t_dtype=torch.float32) -> torch.Tensor:
    """Latents (B, S, latent) float32 from noise (B, S, latent).

    `s` is the configuration's "sampler" group: num_steps, cfg_scale_text,
    cfg_scale_speaker, cfg_min_t, cfg_max_t."""
    k_st, v_st = dit.static_kv(W, c, text_ids, text_mask, speaker_latent)
    spk = speaker_mask[:, ::c["speaker_patch_size"]]
    plain = torch.cat([text_mask, spk], 1)
    no_t, no_s = torch.zeros_like(text_mask), torch.zeros_like(spk)
    cfg_keep = torch.cat([plain, torch.cat([no_t, spk], 1),
                          torch.cat([text_mask, no_s], 1)], 0)
    t_all, dt_all, has_cfg = step_plan(s["num_steps"], s["cfg_min_t"],
                                       s["cfg_max_t"])
    x = noise.float().clone()
    b = x.shape[0]
    for t, dt, guided in zip(t_all, dt_all, has_cfg):
        tt = torch.tensor(float(t), device=x.device).to(t_dtype).float()
        if guided:
            v = dit.denoiser(W, c, x.repeat(3, 1, 1), tt.repeat(3 * b), k_st,
                             v_st, cfg_keep)
            v_c, v_ut, v_us = v.chunk(3, 0)
            v = (v_c + float(np.float32(s["cfg_scale_text"])) * (v_c - v_ut)
                 + float(np.float32(s["cfg_scale_speaker"])) * (v_c - v_us))
        else:
            v = dit.denoiser(W, c, x, tt.repeat(b), k_st, v_st, plain)
        x = x + v * float(dt)
    return x
