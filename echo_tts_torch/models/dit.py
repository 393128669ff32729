"""EchoDiT, its text/speaker encoders and the blockwise latent prefix, in
PyTorch.

Counterpart of echo_tts_tpu/models/dit.py (reference: model.py:472-642).
The modules are named after the reference module tree, so their
`state_dict()` keys are the published checkpoint's keys
(echo_tts_tpu/tools/convert.py:37-138 spells them): linears store
(out, in), layers are `blocks.{i}` instead of a stacked leading axis.

The functions keep the JAX names and layouts: hidden states (B, S, D),
attention tensors (B, S, H, Dh), KV caches (L, B, T, H, Dh) stacked over
layers.  CFG branches ride as a leading multiple of the batch (q-batch
G*B, G-major) while the static KV stays at batch B; the joint-attention
kernel reads static row b = gb % B.

The blockwise latent prefix (`blockwise=True` configs, streaming):
`get_kv_cache_latent` re-encodes a whole prefix, and
`init_latent_inc_state` / `latent_kv_append_block` encode each block's
new patches once, with the patch encoder's K/V carried per layer, writing
the new columns in place into preallocated buffers (JAX donates its
buffers to `dynamic_update_slice` for the same effect).  The latent
segment goes first in the static K/V: [latent, text, speaker].

`dit_forward` is the four-segment forward that training differentiates
(self, latent prefix, text, speaker), with per-layer activation
checkpointing (`remat`); `trainable_copy` gives the trainable modules
that training updates, leaving the frozen model that serving loads as
it is.

`mesh=` (parallel/mesh.py) runs the encoders, the prefill and both
forwards tensor-parallel on a model that shard_params has cut to its
rank's heads and hidden units; every path with mesh=None is unchanged.
"""
from __future__ import annotations

import copy
import functools
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..config import EchoDiTConfig
from ..device import resolve_device
from ..ops.attention import sdpa
from ..ops.embeddings import get_timestep_embedding
from ..ops.joint_attention import fused_joint_attention, shardable
from ..ops.norms import LowRankAdaLN, low_rank_adaln, rms_norm
from ..ops.quant import kv_is_quantized
from ..ops.rope import (apply_rotary_emb, apply_rotary_emb_half_heads,
                        freqs_tensor)
from ..parallel.mesh import (copy_to_model, is_sharded, mesh_coords,
                             row_parallel)

KV = Tuple[torch.Tensor, torch.Tensor]  # (L, B, S, H, Dh) each


# ---------------------------------------------------------------------------
# Modules (reference module tree)
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """A bare RMSNorm weight: (D,) or (H, Dh) for the QK-norms."""

    def __init__(self, *shape: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(shape))


class MLP(nn.Module):
    def __init__(self, d: int, inter: int):
        super().__init__()
        self.w1 = nn.Linear(d, inter, bias=False)
        self.w2 = nn.Linear(inter, d, bias=False)
        self.w3 = nn.Linear(d, inter, bias=False)


class SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo", "gate"):
            setattr(self, name, nn.Linear(d, d, bias=False))
        self.q_norm = Norm(heads, d // heads)
        self.k_norm = Norm(heads, d // heads)


class EncoderBlock(nn.Module):
    def __init__(self, d: int, heads: int, inter: int):
        super().__init__()
        self.attention = SelfAttention(d, heads)
        self.mlp = MLP(d, inter)
        self.attention_norm = Norm(d)
        self.mlp_norm = Norm(d)


class TextEncoder(nn.Module):
    def __init__(self, cfg: EchoDiTConfig):
        super().__init__()
        self.text_embedding = nn.Embedding(cfg.text_vocab_size, cfg.text_model_size)
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg.text_model_size, cfg.text_num_heads,
                         cfg.text_intermediate_size)
            for _ in range(cfg.text_num_layers))


class PatchEncoder(nn.Module):
    """The speaker encoder (and the blockwise latent encoder)."""

    def __init__(self, cfg: EchoDiTConfig):
        super().__init__()
        self.in_proj = nn.Linear(cfg.latent_size * cfg.speaker_patch_size,
                                 cfg.speaker_model_size, bias=True)
        self.blocks = nn.ModuleList(
            EncoderBlock(cfg.speaker_model_size, cfg.speaker_num_heads,
                         cfg.speaker_intermediate_size)
            for _ in range(cfg.speaker_num_layers))


class JointAttention(nn.Module):
    def __init__(self, cfg: EchoDiTConfig):
        super().__init__()
        m, dt, ds = cfg.model_size, cfg.text_model_size, cfg.speaker_model_size
        for name in ("wq", "wk", "wv", "wo", "gate"):
            setattr(self, name, nn.Linear(m, m, bias=False))
        self.wk_text = nn.Linear(dt, m, bias=False)
        self.wv_text = nn.Linear(dt, m, bias=False)
        self.wk_speaker = nn.Linear(ds, m, bias=False)
        self.wv_speaker = nn.Linear(ds, m, bias=False)
        if cfg.blockwise:
            self.wk_latent = nn.Linear(ds, m, bias=False)
            self.wv_latent = nn.Linear(ds, m, bias=False)
        self.q_norm = Norm(cfg.num_heads, cfg.head_dim)
        self.k_norm = Norm(cfg.num_heads, cfg.head_dim)


class DiTBlock(nn.Module):
    def __init__(self, cfg: EchoDiTConfig):
        super().__init__()
        self.attention = JointAttention(cfg)
        self.mlp = MLP(cfg.model_size, cfg.intermediate_size)
        self.attention_adaln = LowRankAdaLN(cfg.model_size, cfg.adaln_rank)
        self.mlp_adaln = LowRankAdaLN(cfg.model_size, cfg.adaln_rank)


class EchoDiT(nn.Module):
    def __init__(self, cfg: EchoDiTConfig):
        super().__init__()
        self.cfg = cfg
        m = cfg.model_size
        self.text_encoder = TextEncoder(cfg)
        self.speaker_encoder = PatchEncoder(cfg)
        self.text_norm = Norm(cfg.text_model_size)
        self.speaker_norm = Norm(cfg.speaker_model_size)
        if cfg.blockwise:
            self.latent_encoder = PatchEncoder(cfg)
            self.latent_norm = Norm(cfg.speaker_model_size)
        self.cond_module = nn.Sequential(
            nn.Linear(cfg.timestep_embed_size, m, bias=False), nn.SiLU(),
            nn.Linear(m, m, bias=False), nn.SiLU(),
            nn.Linear(m, 3 * m, bias=False))
        self.in_proj = nn.Linear(cfg.latent_size, m, bias=True)
        self.blocks = nn.ModuleList(DiTBlock(cfg) for _ in range(cfg.num_layers))
        self.out_norm = Norm(m)
        self.out_proj = nn.Linear(m, cfg.latent_size, bias=True)


# ---------------------------------------------------------------------------
# Shared blocks
# ---------------------------------------------------------------------------

# Under a mesh (parallel/mesh.py) a sharded module holds its rank's heads
# and hidden units: head counts are read from the QK-norms' (H, Dh)
# weights, the replicated input of the column-parallel projections goes
# through copy_to_model, and row-parallel outputs through row_parallel.
# With mesh=None, or a module left whole, both are the identity.

def _col_input(x: torch.Tensor, mod: nn.Module, mesh) -> torch.Tensor:
    return copy_to_model(x, mesh) if mesh is not None and is_sharded(mod) else x


def _mlp(p: MLP, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """SwiGLU MLP (reference: model.py:296-308)."""
    x = _col_input(x, p.w1, mesh)
    return row_parallel(p.w2, F.silu(p.w1(x)) * p.w3(x), mesh)


def _self_attention(p: SelfAttention, x: torch.Tensor,
                    mask: Optional[torch.Tensor], freqs: torch.Tensor, *,
                    is_causal: bool, eps: float, mesh=None) -> torch.Tensor:
    """Encoder self-attention with sigmoid output gate
    (reference: model.py:106-161)."""
    b, s, _ = x.shape
    heads = p.q_norm.weight.shape[0]
    x = _col_input(x, p.wq, mesh)
    q = p.wq(x).reshape(b, s, heads, -1)
    k = p.wk(x).reshape(b, s, heads, -1)
    v = p.wv(x).reshape(b, s, heads, -1)
    gate = p.gate(x)
    q = rms_norm(q, p.q_norm.weight, eps)
    k = rms_norm(k, p.k_norm.weight, eps)
    q = apply_rotary_emb(q, freqs[:s])
    k = apply_rotary_emb(k, freqs[:s])
    attn_mask = mask[:, None, None, :] if mask is not None else None
    out = sdpa(q, k, v, mask=attn_mask, is_causal=is_causal).reshape(b, s, -1)
    return row_parallel(p.wo, out * torch.sigmoid(gate), mesh)


def _encoder_blocks(blocks: nn.ModuleList, x: torch.Tensor,
                    mask: Optional[torch.Tensor], freqs: torch.Tensor, *,
                    is_causal: bool, eps: float, mesh=None) -> torch.Tensor:
    """Pre-RMSNorm residual blocks (reference: model.py:311-339)."""
    for blk in blocks:
        x = x + _self_attention(
            blk.attention, rms_norm(x, blk.attention_norm.weight, eps), mask,
            freqs, is_causal=is_causal, eps=eps, mesh=mesh)
        x = x + _mlp(blk.mlp, rms_norm(x, blk.mlp_norm.weight, eps), mesh)
    return x


# ---------------------------------------------------------------------------
# Encoders and KV prefill (reference: model.py:392-469, 606-636)
# ---------------------------------------------------------------------------

def text_encoder(model: EchoDiT, input_ids: torch.Tensor,
                 mask: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
    """Byte-level text encoder, non-causal blocks (model.py:392-427)."""
    cfg = model.cfg
    p = model.text_encoder
    x = p.text_embedding(input_ids.long())
    freqs = freqs_tensor(cfg.text_head_dim, input_ids.shape[1], x.device)
    return _encoder_blocks(p.blocks, x, mask, freqs, is_causal=False,
                           eps=cfg.norm_eps, mesh=mesh)


def patchify(p: PatchEncoder, cfg: EchoDiTConfig,
             latent: torch.Tensor) -> torch.Tensor:
    """(B, S, latent) -> the patch encoder's (B, S / patch, D) input."""
    b, s, d = latent.shape
    ps = cfg.speaker_patch_size
    if s % ps != 0:
        raise ValueError(
            f"latent length {s} must be divisible by speaker_patch_size {ps}; "
            "crop with get_speaker_latent_and_mask (divis_by_patch_size)")
    x = p.in_proj(latent.reshape(b, s // ps, d * ps))
    return x / 6.0  # activation-dynamics scale (reference: model.py:462)


def _patch_encoder(p: PatchEncoder, cfg: EchoDiTConfig,
                   latent: torch.Tensor, mesh=None) -> torch.Tensor:
    """Patchify + causal blocks (model.py:429-469)."""
    x = patchify(p, cfg, latent)
    freqs = freqs_tensor(cfg.speaker_head_dim, x.shape[1], x.device)
    return _encoder_blocks(p.blocks, x, None, freqs, is_causal=True,
                           eps=cfg.norm_eps, mesh=mesh)


def _stacked_kv(model: EchoDiT, state: torch.Tensor, which: str,
                mesh=None) -> KV:
    """Project encoder state through every layer's K/V weights; k gets the
    layer's k_norm (model.py:270-282).  Under a mesh, the rank's heads."""
    cfg = model.cfg
    b, s, _ = state.shape
    ks, vs = [], []
    state = _col_input(state, getattr(model.blocks[0].attention, f"wk_{which}"),
                       mesh)
    for blk in model.blocks:
        a = blk.attention
        heads = a.k_norm.weight.shape[0]
        k = getattr(a, f"wk_{which}")(state).reshape(b, s, heads, -1)
        v = getattr(a, f"wv_{which}")(state).reshape(b, s, heads, -1)
        ks.append(rms_norm(k, a.k_norm.weight, cfg.norm_eps))
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def get_kv_cache_text(model: EchoDiT, text_input_ids: torch.Tensor,
                      text_mask: Optional[torch.Tensor], mesh=None) -> KV:
    """The text segment's static K/V (L, B, T, H, Dh); under a mesh, the
    rank's rows (as given) and heads."""
    state = text_encoder(model, text_input_ids, text_mask, mesh)
    state = rms_norm(state, model.text_norm.weight, model.cfg.norm_eps)
    return _stacked_kv(model, state, "text", mesh)


def get_kv_cache_speaker(model: EchoDiT, speaker_latent: torch.Tensor,
                         mesh=None) -> KV:
    """The speaker segment's static K/V; under a mesh, as the text's."""
    state = _patch_encoder(model.speaker_encoder, model.cfg, speaker_latent,
                           mesh)
    state = rms_norm(state, model.speaker_norm.weight, model.cfg.norm_eps)
    return _stacked_kv(model, state, "speaker", mesh)


def get_kv_cache_latent(model: EchoDiT, prefix_latent: torch.Tensor) -> KV:
    """Blockwise latent-prefix KV (dit.py:224-239; reference:
    model.py:623-636): encoder output i sits at RoPE position
    i * patch_size, and k is rotated on HALF the heads (model.py:284-293)."""
    cfg = model.cfg
    state = _patch_encoder(model.latent_encoder, cfg, prefix_latent)
    state = rms_norm(state, model.latent_norm.weight, cfg.norm_eps)
    k, v = _stacked_kv(model, state, "latent")
    s, ps = state.shape[1], cfg.speaker_patch_size
    freqs = freqs_tensor(cfg.head_dim, s * ps, state.device)[::ps]
    return apply_rotary_emb_half_heads(k, freqs), v


def concat_static_kv(kv_text: KV, kv_speaker: KV,
                     kv_latent: Optional[KV] = None
                     ) -> Tuple[KV, torch.Tensor]:
    """Concatenate the per-request static KV once per sampler call (or
    streamed block).

    Segment order [latent?, text, speaker].  Returns ((k, v) (L, B, T, H,
    Dh), spk_cols (T,) bool marking the speaker columns, the target of the
    speaker-KV scale)."""
    parts = [kv_text, kv_speaker]
    if kv_latent is not None:
        parts.insert(0, kv_latent)
    k = torch.cat([p[0] for p in parts], dim=2)
    v = torch.cat([p[1] for p in parts], dim=2)
    t_spk = kv_speaker[0].shape[2]
    spk_cols = torch.zeros((k.shape[2],), dtype=torch.bool, device=k.device)
    spk_cols[k.shape[2] - t_spk:] = True
    return (k, v), spk_cols


def static_attention_mask(cfg: EchoDiTConfig, text_mask: torch.Tensor,
                          speaker_mask: torch.Tensor,
                          latent_mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """(GB, T) key mask over [latent?, text, speaker] with the speaker mask
    subsampled by patch_size (model.py:581)."""
    parts = [text_mask, speaker_mask[..., ::cfg.speaker_patch_size]]
    if latent_mask is not None:
        parts.insert(0, latent_mask)
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# Incremental latent-prefix encoding (dit.py:284-417).  The latent encoder
# is strictly causal, so patches encoded once never change: each block's
# NEW patches are encoded with the per-layer K/V of the earlier ones, and
# the result equals get_kv_cache_latent on the real prefix.
# ---------------------------------------------------------------------------

def init_latent_inc_state(cfg: EchoDiTConfig, batch: int, max_patches: int,
                          dtype=torch.bfloat16, device="cuda") -> dict:
    """Zero state (dit.py:297-312): the patch encoder's per-layer K/V and
    the DiT latent-KV buffer, preallocated at max_patches; columns at and
    past "pos" (a 0-d int64 tensor on the device, the patches encoded so
    far) are zeros that the latent prefix mask hides.  A device position
    lets one captured append program serve every block of a stream; its
    callers keep a host mirror for the bound check (sampler/blockwise.py).
    Raises without CUDA unless device='cpu'."""
    device = resolve_device(device)
    enc = (cfg.speaker_num_layers, batch, max_patches, cfg.speaker_num_heads,
           cfg.speaker_head_dim)
    lat = (cfg.num_layers, batch, max_patches, cfg.num_heads, cfg.head_dim)
    return {"enc_k": torch.zeros(enc, dtype=dtype, device=device),
            "enc_v": torch.zeros(enc, dtype=dtype, device=device),
            "lat_k": torch.zeros(lat, dtype=dtype, device=device),
            "lat_v": torch.zeros(lat, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.long, device=device)}


def latent_kv_append_block(model: EchoDiT, state: dict,
                           latent_block: torch.Tensor) -> dict:
    """Encode ONE block's latents (B, S_block, latent), S_block a multiple
    of the patch size, through the causal patch encoder with the carried
    K/V, and write the new DiT latent-KV columns (dit.py:315-398).

    The state's buffers are written in place (index_copy_ at the device
    positions pos + i) and the same dict is returned, with "pos" advanced;
    "lat_k"/"lat_v" then stand for get_kv_cache_latent's output (RoPE at
    idx * patch_size), valid for columns < pos.  Nothing is read back to
    the host, so the call can be captured: pos + n_new <= max_patches is
    the caller's check, on its host mirror.  Encoder logits are fp32 with
    sdpa's 1/sqrt(dh) and -inf off the causal visibility col <= pos + i."""
    cfg = model.cfg
    p = model.latent_encoder
    b, s, d = latent_block.shape
    ps = cfg.speaker_patch_size
    if s % ps != 0:
        raise ValueError(f"block length {s} must be divisible by "
                         f"speaker_patch_size {ps}")
    n_new = s // ps
    max_patches = state["enc_k"].shape[2]
    pos = state["pos"]
    eps = cfg.norm_eps
    h_enc, dh_enc = cfg.speaker_num_heads, cfg.speaker_head_dim
    dev = latent_block.device
    new = pos + torch.arange(n_new, device=dev)        # the new columns

    x = p.in_proj(latent_block.reshape(b, n_new, d * ps)) / 6.0
    freqs_new = freqs_tensor(dh_enc, max_patches, dev).index_select(0, new)
    col = torch.arange(max_patches, device=dev)[None, :]
    hidden = ~(col <= new[:, None])[None, None]  # (1, 1, n_new, max_patches)
    for li, blk in enumerate(p.blocks):
        a = blk.attention
        xn = rms_norm(x, blk.attention_norm.weight, eps)
        q = a.wq(xn).reshape(b, n_new, h_enc, dh_enc)
        k = a.wk(xn).reshape(b, n_new, h_enc, dh_enc)
        v = a.wv(xn).reshape(b, n_new, h_enc, dh_enc)
        gate = a.gate(xn)
        q = apply_rotary_emb(rms_norm(q, a.q_norm.weight, eps), freqs_new)
        k = apply_rotary_emb(rms_norm(k, a.k_norm.weight, eps), freqs_new)
        k_cache, v_cache = state["enc_k"][li], state["enc_v"][li]
        k_cache.index_copy_(1, new, k.to(k_cache.dtype))
        v_cache.index_copy_(1, new, v.to(v_cache.dtype))
        logits = torch.einsum("bnhd,bmhd->bhnm", q.float(),
                              k_cache.to(q.dtype).float()) * (1.0 / dh_enc ** 0.5)
        w = torch.softmax(logits.masked_fill(hidden, float("-inf")),
                          dim=-1).to(v_cache.dtype)
        attn = torch.einsum("bhnm,bmhd->bnhd", w, v_cache)
        attn = attn.reshape(b, n_new, -1).to(x.dtype)
        x = x + a.wo(attn * torch.sigmoid(gate))
        x = x + _mlp(blk.mlp, rms_norm(x, blk.mlp_norm.weight, eps))

    # the new patches' DiT latent-KV columns (get_kv_cache_latent's twin):
    # RoPE at (pos + i) * patch_size on half the heads
    k_new, v_new = _stacked_kv(
        model, rms_norm(x, model.latent_norm.weight, eps), "latent")
    table = freqs_tensor(cfg.head_dim, max_patches * ps, dev)[::ps]
    k_new = apply_rotary_emb_half_heads(k_new, table.index_select(0, new))
    state["lat_k"].index_copy_(2, new, k_new.to(state["lat_k"].dtype))
    state["lat_v"].index_copy_(2, new, v_new.to(state["lat_v"].dtype))
    state["pos"] = pos + n_new
    return state


def latent_prefix_mask(batch_size: int, num_latents: int,
                       start_pos: Union[int, torch.Tensor], patch_size: int,
                       *, device=None) -> torch.Tensor:
    """(B, num_latents) bool: position * patch_size < start_pos
    (dit.py:401-417; reference: model.py:243-244).  start_pos is a host int
    or a 0-d int tensor on the device (a block program's start, so that one
    captured program serves every block position), whose device the mask
    takes; one function serves both of the JAX package's variants."""
    if isinstance(start_pos, torch.Tensor):
        device = start_pos.device
    positions = torch.arange(num_latents, device=device) * patch_size
    return (positions < start_pos).expand(batch_size, num_latents)


# ---------------------------------------------------------------------------
# Joint attention + DiT forward over the static KV
# ---------------------------------------------------------------------------

def _joint_attention_static(p: JointAttention, x: torch.Tensor,
                            static_mask: torch.Tensor,
                            col_scale: torch.Tensor, freqs_q: torch.Tensor,
                            k_static: torch.Tensor, v_static: torch.Tensor, *,
                            num_heads: int, eps: float,
                            kv_scales=None, mesh=None) -> torch.Tensor:
    """Joint attention over [self | pre-concatenated static KV]
    (dit.py:596-682); the speaker-KV scale is a per-column multiplier of
    the static logits (K side) and weights (V side).  int8 static K/V come
    with kv_scales ((B, T, H), (B, T, H)) fp32, which the kernel folds into
    those multipliers.  Under a mesh the layer holds num_heads / tp heads
    (the static K/V the same heads): kernel A runs on them as they are,
    and RoPE reaches the shard's heads in the first half of all of them."""
    gb, s, _ = x.shape
    heads, dh = p.q_norm.weight.shape
    offset = 0
    if mesh is not None and is_sharded(p.wq):
        offset = mesh_coords(mesh).model * heads
        x = copy_to_model(x, mesh)
    q = p.wq(x).reshape(gb, s, heads, dh)
    k_self = p.wk(x).reshape(gb, s, heads, dh)
    v_self = p.wv(x).reshape(gb, s, heads, dh)
    gate = p.gate(x)
    q = rms_norm(q, p.q_norm.weight, eps)
    k_self = rms_norm(k_self, p.k_norm.weight, eps)
    q = apply_rotary_emb_half_heads(q, freqs_q, offset, num_heads)
    k_self = apply_rotary_emb_half_heads(k_self, freqs_q, offset, num_heads)
    out = fused_joint_attention(q, k_self, v_self, k_static, v_static,
                                static_mask, col_scale,
                                sm_scale=1.0 / (dh ** 0.5), kv_scales=kv_scales)
    return row_parallel(p.wo, out.reshape(gb, s, -1) * torch.sigmoid(gate),
                        mesh)


def _dit_layer(blk: DiTBlock, h: torch.Tensor, cond: torch.Tensor,
               freqs_q: torch.Tensor, static_mask: torch.Tensor,
               col_scale: Optional[torch.Tensor], k_st: torch.Tensor,
               v_st: torch.Tensor, kv_scales=None, *,
               cfg: EchoDiTConfig, mesh=None) -> torch.Tensor:
    """One DiT block: AdaLN, joint attention over [self | static K/V],
    AdaLN, SwiGLU MLP, each behind its tanh gate (model.py:526-561)."""
    h_norm, gate = low_rank_adaln(h, cond, blk.attention_adaln, cfg.norm_eps)
    h = h + gate * _joint_attention_static(
        blk.attention, h_norm, static_mask, col_scale, freqs_q, k_st, v_st,
        num_heads=cfg.num_heads, eps=cfg.norm_eps, kv_scales=kv_scales,
        mesh=mesh)
    h_norm, gate = low_rank_adaln(h, cond, blk.mlp_adaln, cfg.norm_eps)
    return h + gate * _mlp(blk.mlp, h_norm, mesh)


def check_mesh(model: EchoDiT, mesh, kv_batch: int) -> None:
    """The rule of the JAX package's _select_attention_impl under a mesh
    (dit.py:446-461), where kernel A is the only attention on the card:
    the DiT's heads must divide the model axis (`shardable`: the KV batch,
    kv_batch rows a rank, divides the data axis by construction), and the
    model must hold its rank's heads (shard_params)."""
    dp, tp = mesh_coords(mesh)[:2]
    heads = model.cfg.num_heads
    if not shardable(mesh, kv_batch * dp, heads):
        raise ValueError(
            f"joint attention under a mesh needs num_heads % model == 0; got "
            f"heads={heads}, mesh (dp, tp)=({dp}, {tp})")
    local = model.blocks[0].attention.q_norm.weight.shape[0]
    if local * tp != heads:
        raise ValueError(f"the DiT holds {local} of {heads} heads under a "
                         f"model axis of {tp}: shard it (parallel.mesh."
                         "shard_params) before running it on the mesh")


def _layer_col_scales(speaker_scale_by_layer: Optional[torch.Tensor],
                      spk_cols: torch.Tensor) -> Optional[torch.Tensor]:
    """Every layer's (T,) column scale in one (L, T) table: 1 off the
    speaker columns, the layer's speaker-KV scale on them."""
    if speaker_scale_by_layer is None:
        return None
    return 1.0 + ((speaker_scale_by_layer.float()[:, None] - 1.0)
                  * spk_cols.float())


def _embed(model: EchoDiT, x: torch.Tensor, t: torch.Tensor,
           start_pos: Union[int, torch.Tensor], max_pos: Optional[int] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(h, cond (GB, 1, 3M), freqs_q): the forward's input projection,
    timestep conditioning and query RoPE table, rows start_pos + i of the
    max_pos table (default start_pos + S).  start_pos is a host int or a
    0-d int tensor (a block program's traced start, dit.py:707-713), which
    needs max_pos, the bound on start_pos + S."""
    cfg = model.cfg
    s = x.shape[1]
    if max_pos is None:
        if isinstance(start_pos, torch.Tensor):
            raise ValueError("a tensor start_pos needs max_pos, the bound "
                             "on start_pos + S")
        max_pos = start_pos + s
    rows = start_pos + torch.arange(s, device=x.device)
    freqs_q = freqs_tensor(cfg.head_dim, max_pos, x.device).index_select(
        0, rows)
    cond = get_timestep_embedding(t, cfg.timestep_embed_size)
    cond = model.cond_module(cond)[:, None]
    return model.in_proj(x), cond, freqs_q


def _out(model: EchoDiT, h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, model.out_norm.weight, model.cfg.norm_eps)
    return model.out_proj(h).float()


# Activation checkpointing of the DiT layers (dit.py:859-871): what
# each selective mode saves; the rest recomputes in the backward.  The
# weight products are the linears' mm/addmm over the flattened rows (the
# JAX package's batch-dim-free dots); the attention forward is one op
# (ops/joint_attention.joint_attention_op), and its plain version's
# batched products run inside it.
_MM = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
_ATTN = (torch.ops.echo_tts.joint_attention.default,)
_REMAT_SAVES = {
    "dots": _MM,
    "dots_all": _MM + (torch.ops.aten.bmm.default,) + _ATTN,
    "attn": _ATTN,
}
REMAT_MODES = ("none", "full") + tuple(_REMAT_SAVES)


def remat_mode(remat: Union[bool, str]) -> str:
    """dit_forward's `remat` as one of REMAT_MODES: False -> "none",
    True -> "full"; anything else raises."""
    mode = "full" if remat is True else "none" if remat is False else remat
    if mode not in REMAT_MODES:
        raise ValueError(f"remat={remat!r}: expected one of {REMAT_MODES} "
                         "(or False / True)")
    return mode


def _remat_context_fn(mode: str):
    saves = _REMAT_SAVES[mode]

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saves
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy)


def dit_forward_static(model: EchoDiT, x: torch.Tensor, t: torch.Tensor,
                       kv_static: Union[KV, Dict[str, torch.Tensor]],
                       spk_cols: torch.Tensor,
                       static_mask: torch.Tensor, *,
                       start_pos: Union[int, torch.Tensor] = 0,
                       max_pos: Optional[int] = None,
                       speaker_scale_by_layer: Optional[torch.Tensor] = None,
                       remat: Union[bool, str] = False,
                       mesh=None) -> torch.Tensor:
    """Denoiser forward over the pre-concatenated static KV (dit.py:685).

    x (GB, S, latent) and t (GB,) in the model dtype; kv_static the (k, v)
    pair from concat_static_kv, or its int8 form from
    ops.quant.quantize_kv_int8 (dit.py:716-756); static_mask (GB, T) bool;
    speaker_scale_by_layer (L,) fp32; start_pos the block's first
    position, a host int or a 0-d int tensor with max_pos (_embed).
    remat checkpoints each layer for
    the backward (non-reentrant torch.utils.checkpoint): False/"none"
    saves everything; True/"full" saves nothing (every layer re-runs its
    forward, kernel A included); "dots" saves the weight products;
    "dots_all" the weight products and the attention; "attn" only the
    attention output.  int8 K/V serve and never train, so they take no
    remat.  Under a (data, model) mesh (parallel/mesh.py) x, t, the static
    K/V and the mask are the rank's rows, the K/V its heads, and the model
    its shard; every rank of a model group runs the same layers, so the
    all-reduces (recomputed under remat) meet in the same order.  Returns
    float32 (model.py:604)."""
    mode = remat_mode(remat)
    kv_q8 = kv_is_quantized(kv_static)
    if kv_q8 and mode != "none":
        raise ValueError(f"remat={remat!r} with int8 static K/V: the int8 "
                         "form serves and never trains")
    if mesh is not None:
        check_mesh(model, mesh,
                   (kv_static["k8"] if kv_q8 else kv_static[0]).shape[1])
    h, cond, freqs_q = _embed(model, x, t, start_pos, max_pos)
    col_scales = _layer_col_scales(speaker_scale_by_layer, spk_cols)
    layer = functools.partial(_dit_layer, cfg=model.cfg, mesh=mesh)
    for li, blk in enumerate(model.blocks):
        col_scale = None if col_scales is None else col_scales[li]
        if kv_q8:
            k_st, v_st = kv_static["k8"][li], kv_static["v8"][li]
            kv_scales = (kv_static["ks"][li], kv_static["vs"][li])
        else:
            k_st, v_st, kv_scales = kv_static[0][li], kv_static[1][li], None
        args = (blk, h, cond, freqs_q, static_mask, col_scale, k_st, v_st,
                kv_scales)
        if mode == "none":
            h = layer(*args)
        elif mode == "full":
            h = checkpoint(layer, *args, use_reentrant=False)
        else:
            h = checkpoint(layer, *args, use_reentrant=False,
                           context_fn=_remat_context_fn(mode))
    return _out(model, h)


def dit_forward(model: EchoDiT, x: torch.Tensor, t: torch.Tensor,
                text_mask: torch.Tensor, speaker_mask: torch.Tensor,
                kv_text: KV, kv_speaker: KV, *, start_pos: int = 0,
                kv_latent: Optional[KV] = None,
                latent_mask: Optional[torch.Tensor] = None,
                speaker_scale_by_layer: Optional[torch.Tensor] = None,
                remat: Union[bool, str] = False, mesh=None) -> torch.Tensor:
    """One denoiser forward over [self, latent prefix?, text, speaker]
    (dit.py:767-882; reference: model.py:563-604): the form training
    differentiates.

    x (GB, S, latent) and t (GB,) in the model dtype; text_mask and
    speaker_mask (GB, T_seg) bool, the speaker mask subsampled here by
    speaker_patch_size (model.py:581); kv_* (L, B, T_seg, H, Dh); the
    optional latent prefix comes with its (GB, T_lat) mask;
    speaker_scale_by_layer (L,) multiplies the speaker K and V of each
    layer (kernel A's column scale).  The segments are concatenated once,
    as the JAX package's kernel branch does (dit.py:516-539), and
    dit_forward_static runs the layers, with remat and mesh as it takes
    them.  Returns float32."""
    static_mask = static_attention_mask(model.cfg, text_mask, speaker_mask,
                                        latent_mask)
    kv_static, spk_cols = concat_static_kv(kv_text, kv_speaker, kv_latent)
    return dit_forward_static(model, x, t, kv_static, spk_cols, static_mask,
                              start_pos=start_pos,
                              speaker_scale_by_layer=speaker_scale_by_layer,
                              remat=remat, mesh=mesh)


# ---------------------------------------------------------------------------
# Seeded random initialization (counterpart of init_dit_params, dit.py:912:
# the same scales, not the same bits)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Linear weights N(0, 1/fan_in), biases 0, embeddings N(0, 1), norm
    weights 1 — in place, in module order."""
    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=generator, device=p.device,
                            dtype=torch.float32) * std)

    for mod in module.modules():
        if isinstance(mod, nn.Linear):
            normal_(mod.weight, mod.in_features ** -0.5)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            normal_(mod.weight, 1.0)
        elif isinstance(mod, Norm):
            mod.weight.fill_(1.0)
    return module


def init_dit(cfg: EchoDiTConfig, *, device="cuda", dtype=torch.bfloat16,
             seed: int = 0) -> EchoDiT:
    """A seeded random-weight EchoDiT on `device` (raises without CUDA
    unless device='cpu')."""
    device = resolve_device(device)
    with torch.device("meta"):
        model = EchoDiT(cfg)
    model = model.to(dtype).to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_random_(model, gen).eval().requires_grad_(False)


def trainable_copy(model: nn.Module) -> nn.Module:
    """A copy of `model` whose parameters require grad, for training to
    update; `model` (frozen, as init_dit and the bridge give it) is left
    as it is."""
    return copy.deepcopy(model).requires_grad_(True)
