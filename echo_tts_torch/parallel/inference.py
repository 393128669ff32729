"""Sharded inference: the sampler over a (data, model) mesh.

Counterpart of echo_tts_tpu/parallel/inference.py.  Latency scaling for
one utterance is tensor parallelism over the DiT's 16 heads and SwiGLU
hidden units (the training layout, parallel/mesh.py); throughput scaling
gives each data coordinate its own rows of the request batch.  This module
only places: the models' forwards take `mesh=` and run the collectives
(models/dit.py).

The codec and the PCA stay whole on each rank's card: the codec is
bandwidth-bound and small, and kernel B runs on each rank as on one card
(the JAX package's res_stack_eligible turns its kernel off in multi-device
processes, res_stack.py:48-57, but a rank here is a one-card process).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..pipeline.pipeline import EchoModels
from . import mesh as pmesh


def shard_models(models: EchoModels, mesh) -> EchoModels:
    """The bundle with its DiT tensor-parallel sharded in place
    (shard_params: the rank's blocks kept, the rest freed); the codec and
    the PCA as they are."""
    return dataclasses.replace(models, dit=pmesh.shard_params(models.dit, mesh))


def place_request(mesh, speaker_latent, speaker_mask, text_ids, text_mask,
                  initial_noise=None) -> Tuple[torch.Tensor, ...]:
    """This rank's rows of each request array (the rows of its data
    coordinate; every rank of a model group gets the same rows), as tensors
    where each already is.  The noise is the request's whole (B, S, latent)
    draw, so that every row keeps the noise it has on one card."""
    rows = pmesh.batch_spec(mesh, int(text_ids.shape[0]))

    def put(a):
        return torch.as_tensor(a)[rows]

    out = tuple(put(a) for a in (speaker_latent, speaker_mask, text_ids,
                                 text_mask))
    if initial_noise is not None:
        out = out + (put(initial_noise),)
    return out
