"""Timestep embedding (reference: model.py:27-43); counterpart of
echo_tts_tpu/ops/embeddings.py."""
from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _freqs(embed_size: int, device: torch.device) -> torch.Tensor:
    half = embed_size // 2
    freqs = 1000.0 * np.exp(
        -np.log(10000.0) * np.arange(half, dtype=np.float32) / half
    ).astype(np.float32)
    # a normal tensor even when first asked for under inference mode (see
    # ops/rope.py)
    with torch.inference_mode(False):
        return torch.from_numpy(freqs).to(device)


def get_timestep_embedding(timestep: torch.Tensor, embed_size: int) -> torch.Tensor:
    """Sinusoidal embedding, frequencies scaled by 1000, [cos, sin] concat.

    timestep: (B,) in model dtype.  The product is float32 and the result
    is cast back to the timestep dtype."""
    assert embed_size % 2 == 0
    freqs = _freqs(embed_size, timestep.device)
    args = timestep[..., None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1).to(timestep.dtype)
