"""Joining a multi-card, multi-host world.

Counterpart of echo_tts_tpu/parallel/distributed.py.  The reference
scales by share-nothing workers; the JAX package joins one process per
host through `jax.distributed`, each process driving every chip of its
host.  Here a process drives ONE card, picked by its local rank
(ECHO_PROC_ID modulo the cards of a host), so:

  * ECHO_NUM_PROCS counts cards (processes), not hosts;
  * the rows of a request batch a rank feeds belong to its coordinate on
    the mesh's "data" axis, not to its process (`process_local_batch_slice`);
  * the "model" axis stays inside one host (NVLink), as the JAX package's
    stays inside one host's ICI island (`global_mesh`).

Launch recipe, one process per card (two hosts of eight cards shown; the
same command everywhere, ECHO_PROC_ID = host * 8 + local card):

  ECHO_COORD=10.0.0.1:8476 ECHO_NUM_PROCS=16 ECHO_PROC_ID=<0..15> \\
      python -m echo_tts_torch.serve.handler --warmup-compile

The join is NCCL for ECHO_DEVICE=cuda (the default) and gloo for
ECHO_DEVICE=cpu.  `initialize_from_env()` is a no-op when ECHO_COORD is
unset, so single-card deployments are unaffected.  Tested on the CPU with
two gloo processes (tests/test_torch_distributed.py).
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from . import mesh as pmesh


def initialize_from_env() -> bool:
    """Join the process group described by ECHO_COORD (host:port of rank
    0), ECHO_NUM_PROCS and ECHO_PROC_ID, on ECHO_DEVICE (default "cuda":
    the local card is selected first and the join is NCCL; "cpu" joins
    over gloo).  Returns True if it joined, False when ECHO_COORD is
    unset."""
    coord = os.environ.get("ECHO_COORD")
    if not coord:
        return False
    num = int(os.environ["ECHO_NUM_PROCS"])
    pid = int(os.environ["ECHO_PROC_ID"])
    device = resolve_device(os.environ.get("ECHO_DEVICE", "cuda"))
    if device.type == "cuda":
        torch.cuda.set_device(pid % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=num, rank=pid)
    return True


def cards_per_host() -> int:
    """The cards of one host: CUDA's device count under NCCL; under gloo
    (CPU processes, all on one host) the world size."""
    if dist.get_backend() == "nccl":
        return torch.cuda.device_count()
    return dist.get_world_size()


def global_mesh(tp: Optional[int] = None):
    """The (data, model) mesh over every rank of the world.  tp (default 1,
    pure data parallelism: the serving shape) must divide the cards of a
    host, so that the model axis never leaves one host's NVLink."""
    tp = tp or 1
    local = cards_per_host()
    if tp > local or local % tp != 0:
        raise ValueError(
            f"tp={tp} must divide the per-host device count {local}: the "
            "model axis must stay inside one host's NVLink island")
    return pmesh.make_mesh(dp=dist.get_world_size() // tp, tp=tp)


def process_local_batch_slice(global_batch: int, mesh=None) -> slice:
    """The rows of a [global_batch, ...] request batch this rank feeds:
    the contiguous block of its data coordinate (the ranks of one model
    group feed the same rows).  Without a mesh, every rank is its own data
    coordinate."""
    if mesh is None:
        mesh = pmesh.ShardCoords(dp=dist.get_world_size(),
                                 data=dist.get_rank())
    n = pmesh.mesh_coords(mesh).dp
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} must divide across {n} data ranks")
    return pmesh.batch_spec(mesh, global_batch)
