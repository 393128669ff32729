"""Sequence-parallel (SP) speaker prefill.

Counterpart of echo_tts_tpu/parallel/sp.py.  The speaker encoder runs 14
causal layers over up to 1600 patches (a 6400-latent reference); this
module splits the prefill's patch axis over the mesh's "model" axis, so
that each rank encodes 1/tp of the patches.  It is for the multi-card
regime (references far beyond the 6400 bucket, prefill towers in sharded
training); the serving path does not engage it.

Gathered-KV sequence parallelism, not a ring: in each layer every rank
all-gathers K/V and computes the attention of its own queries only, with
causality over global positions (key column j is visible to the rank's
query row i iff j <= offset + i).  The attention is plain PyTorch (fp32
logits), as the JAX package's is an einsum and not a Pallas kernel.  The
encoder's weights are whole on every rank (the JAX package's shard_map
takes them replicated), so the model is not tensor-parallel sharded here.
The encoded patches are gathered once more at the end, and every rank
returns the same (L, B, T, H, Dh) K/V as dit.get_kv_cache_speaker; a
tensor-parallel rank takes its heads with parallel.mesh.kv_cache_spec.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models import dit as _dit
from ..ops.norms import rms_norm
from ..ops.rope import apply_rotary_emb, freqs_tensor
from .mesh import MODEL_AXIS, is_sharded


def _all_gather(x: torch.Tensor, group, tp: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _sp_patch_encoder(blocks, cfg, x: torch.Tensor, n_total: int, group,
                      rank: int, tp: int) -> torch.Tensor:
    """x (B, N_local, D), this rank's patches -> the encoded patches."""
    b, n_local, _ = x.shape
    h, dh = cfg.speaker_num_heads, cfg.speaker_head_dim
    eps = cfg.norm_eps
    offset = rank * n_local
    dev = x.device
    freqs = freqs_tensor(dh, n_total, dev)[offset:offset + n_local]
    col = torch.arange(n_total, device=dev)[None, :]
    row = offset + torch.arange(n_local, device=dev)[:, None]
    hidden = ~(col <= row)[None, None]         # (1, 1, n_local, n_total)
    scale = 1.0 / (dh ** 0.5)
    for blk in blocks:
        a = blk.attention
        xn = rms_norm(x, blk.attention_norm.weight, eps)
        q = a.wq(xn).reshape(b, n_local, h, dh)
        k = a.wk(xn).reshape(b, n_local, h, dh)
        v = a.wv(xn).reshape(b, n_local, h, dh)
        gate = a.gate(xn)
        q = apply_rotary_emb(rms_norm(q, a.q_norm.weight, eps), freqs)
        k = apply_rotary_emb(rms_norm(k, a.k_norm.weight, eps), freqs)
        # K/V cross the interconnect once per layer; queries stay local
        k_all = _all_gather(k, group, tp, 1)
        v_all = _all_gather(v, group, tp, 1)
        logits = torch.einsum("bnhd,bmhd->bhnm", q.float(),
                              k_all.float()) * scale
        w = torch.softmax(logits.masked_fill(hidden, float("-inf")),
                          dim=-1).to(v_all.dtype)
        attn = torch.einsum("bhnm,bmhd->bnhd", w, v_all).reshape(b, n_local, -1)
        x = x + a.wo(attn * torch.sigmoid(gate))
        x = x + _dit._mlp(blk.mlp, rms_norm(x, blk.mlp_norm.weight, eps))
    return x


@torch.inference_mode()
def get_kv_cache_speaker_sp(model: _dit.EchoDiT,
                            speaker_latent: torch.Tensor, mesh,
                            axis: str = MODEL_AXIS) -> _dit.KV:
    """Sequence-parallel twin of dit.get_kv_cache_speaker: the patch axis
    splits over `axis` of `mesh` (a DeviceMesh), and every rank returns the
    whole (L, B, T, H, Dh) K/V.  Every rank passes the whole latent.  The
    patch count must divide the axis; callers pad the reference to a
    bucket (serve/presets.py) whose patch count does."""
    cfg = model.cfg
    s = speaker_latent.shape[1]
    ps = cfg.speaker_patch_size
    if s % ps != 0:
        raise ValueError(f"latent length {s} must be divisible by "
                         f"speaker_patch_size {ps}")
    n = s // ps
    tp = mesh.size(mesh.mesh_dim_names.index(axis))
    if n % tp != 0:
        raise ValueError(
            f"speaker patch count {n} must divide the '{axis}' axis ({tp})"
            " for sequence-parallel prefill; pad to a bucket that does")
    if any(is_sharded(m) for m in model.modules()):
        raise ValueError("sequence-parallel prefill takes the whole model on "
                         "every rank, not a tensor-parallel shard")
    rank = mesh.get_local_rank(axis)
    group = mesh[axis].get_group()
    n_local = n // tp
    local = speaker_latent[:, rank * n_local * ps:(rank + 1) * n_local * ps]
    x = _dit.patchify(model.speaker_encoder, cfg, local)
    x = _sp_patch_encoder(model.speaker_encoder.blocks, cfg, x, n, group,
                          rank, tp)
    state = rms_norm(_all_gather(x, group, tp, 1), model.speaker_norm.weight,
                     cfg.norm_eps)
    return _dit._stacked_kv(model, state, "speaker")
