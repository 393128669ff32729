"""EchoDiT and its text/speaker encoders, one-shot subset, in PyTorch.

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

The blockwise latent encoder (`blockwise=True` configs) has its parameters
here so checkpoints load, but its functions are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import EchoDiTConfig
from ..device import resolve_device
from ..ops.attention import sdpa
from ..ops.embeddings import get_timestep_embedding
from ..ops.joint_attention import fused_joint_attention
from ..ops.norms import LowRankAdaLN, low_rank_adaln, rms_norm
from ..ops.rope import (apply_rotary_emb, apply_rotary_emb_half_heads,
                        freqs_tensor)

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

def _mlp(p: MLP, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP (reference: model.py:296-308)."""
    return p.w2(F.silu(p.w1(x)) * p.w3(x))


def _self_attention(p: SelfAttention, x: torch.Tensor,
                    mask: Optional[torch.Tensor], freqs: torch.Tensor, *,
                    num_heads: int, is_causal: bool, eps: float) -> torch.Tensor:
    """Encoder self-attention with sigmoid output gate
    (reference: model.py:106-161)."""
    b, s, d = x.shape
    q = p.wq(x).reshape(b, s, num_heads, -1)
    k = p.wk(x).reshape(b, s, num_heads, -1)
    v = p.wv(x).reshape(b, s, num_heads, -1)
    gate = p.gate(x)
    q = rms_norm(q, p.q_norm.weight, eps)
    k = rms_norm(k, p.k_norm.weight, eps)
    q = apply_rotary_emb(q, freqs[:s])
    k = apply_rotary_emb(k, freqs[:s])
    attn_mask = mask[:, None, None, :] if mask is not None else None
    out = sdpa(q, k, v, mask=attn_mask, is_causal=is_causal).reshape(b, s, d)
    return p.wo(out * torch.sigmoid(gate))


def _encoder_blocks(blocks: nn.ModuleList, x: torch.Tensor,
                    mask: Optional[torch.Tensor], freqs: torch.Tensor, *,
                    num_heads: int, is_causal: bool, eps: float) -> torch.Tensor:
    """Pre-RMSNorm residual blocks (reference: model.py:311-339)."""
    for blk in blocks:
        x = x + _self_attention(
            blk.attention, rms_norm(x, blk.attention_norm.weight, eps), mask,
            freqs, num_heads=num_heads, is_causal=is_causal, eps=eps)
        x = x + _mlp(blk.mlp, rms_norm(x, blk.mlp_norm.weight, eps))
    return x


# ---------------------------------------------------------------------------
# Encoders and KV prefill (reference: model.py:392-469, 606-636)
# ---------------------------------------------------------------------------

def text_encoder(model: EchoDiT, input_ids: torch.Tensor,
                 mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Byte-level text encoder, non-causal blocks (model.py:392-427)."""
    cfg = model.cfg
    p = model.text_encoder
    x = p.text_embedding(input_ids.long())
    freqs = freqs_tensor(cfg.text_head_dim, input_ids.shape[1], x.device)
    return _encoder_blocks(p.blocks, x, mask, freqs,
                           num_heads=cfg.text_num_heads, is_causal=False,
                           eps=cfg.norm_eps)


def _patch_encoder(p: PatchEncoder, cfg: EchoDiTConfig,
                   latent: torch.Tensor) -> torch.Tensor:
    """Patchify + causal blocks (model.py:429-469)."""
    b, s, d = latent.shape
    ps = cfg.speaker_patch_size
    if s % ps != 0:
        raise ValueError(
            f"latent length {s} must be divisible by speaker_patch_size {ps}; "
            "crop with get_speaker_latent_and_mask (divis_by_patch_size)")
    x = p.in_proj(latent.reshape(b, s // ps, d * ps))
    x = x / 6.0  # activation-dynamics scale (reference: model.py:462)
    freqs = freqs_tensor(cfg.speaker_head_dim, x.shape[1], x.device)
    return _encoder_blocks(p.blocks, x, None, freqs,
                           num_heads=cfg.speaker_num_heads, is_causal=True,
                           eps=cfg.norm_eps)


def _stacked_kv(model: EchoDiT, state: torch.Tensor, which: str) -> KV:
    """Project encoder state through every layer's K/V weights; k gets the
    layer's k_norm (model.py:270-282)."""
    cfg = model.cfg
    b, s, _ = state.shape
    ks, vs = [], []
    for blk in model.blocks:
        a = blk.attention
        k = getattr(a, f"wk_{which}")(state).reshape(b, s, cfg.num_heads, -1)
        v = getattr(a, f"wv_{which}")(state).reshape(b, s, cfg.num_heads, -1)
        ks.append(rms_norm(k, a.k_norm.weight, cfg.norm_eps))
        vs.append(v)
    return torch.stack(ks), torch.stack(vs)


def get_kv_cache_text(model: EchoDiT, text_input_ids: torch.Tensor,
                      text_mask: Optional[torch.Tensor]) -> KV:
    state = text_encoder(model, text_input_ids, text_mask)
    state = rms_norm(state, model.text_norm.weight, model.cfg.norm_eps)
    return _stacked_kv(model, state, "text")


def get_kv_cache_speaker(model: EchoDiT, speaker_latent: torch.Tensor) -> KV:
    state = _patch_encoder(model.speaker_encoder, model.cfg, speaker_latent)
    state = rms_norm(state, model.speaker_norm.weight, model.cfg.norm_eps)
    return _stacked_kv(model, state, "speaker")


def concat_static_kv(kv_text: KV, kv_speaker: KV) -> Tuple[KV, torch.Tensor]:
    """Concatenate the per-request static KV once per sampler call.

    Segment order [text, speaker].  Returns ((k, v) (L, B, T, H, Dh),
    spk_cols (T,) bool marking the speaker columns, the target of the
    speaker-KV scale)."""
    k = torch.cat([kv_text[0], kv_speaker[0]], dim=2)
    v = torch.cat([kv_text[1], kv_speaker[1]], dim=2)
    t_text, t_spk = kv_text[0].shape[2], kv_speaker[0].shape[2]
    spk_cols = torch.zeros((t_text + t_spk,), dtype=torch.bool, device=k.device)
    spk_cols[t_text:] = True
    return (k, v), spk_cols


def static_attention_mask(cfg: EchoDiTConfig, text_mask: torch.Tensor,
                          speaker_mask: torch.Tensor) -> torch.Tensor:
    """(GB, T) key mask over [text, speaker] with the speaker mask
    subsampled by patch_size (model.py:581)."""
    return torch.cat([text_mask, speaker_mask[..., ::cfg.speaker_patch_size]],
                     dim=-1)


# ---------------------------------------------------------------------------
# Joint attention + DiT forward over the static KV
# ---------------------------------------------------------------------------

def _joint_attention_static(p: JointAttention, x: torch.Tensor,
                            static_mask: torch.Tensor,
                            col_scale: torch.Tensor, freqs_q: torch.Tensor,
                            k_static: torch.Tensor, v_static: torch.Tensor, *,
                            num_heads: int, eps: float) -> torch.Tensor:
    """Joint attention over [self | pre-concatenated static KV]
    (dit.py:596-682); the speaker-KV scale is a per-column multiplier of
    the static logits (K side) and weights (V side)."""
    gb, s, d = x.shape
    dh = d // num_heads
    q = p.wq(x).reshape(gb, s, num_heads, dh)
    k_self = p.wk(x).reshape(gb, s, num_heads, dh)
    v_self = p.wv(x).reshape(gb, s, num_heads, dh)
    gate = p.gate(x)
    q = rms_norm(q, p.q_norm.weight, eps)
    k_self = rms_norm(k_self, p.k_norm.weight, eps)
    q = apply_rotary_emb_half_heads(q, freqs_q)
    k_self = apply_rotary_emb_half_heads(k_self, freqs_q)
    out = fused_joint_attention(q, k_self, v_self, k_static, v_static,
                                static_mask, col_scale,
                                sm_scale=1.0 / (dh ** 0.5))
    return p.wo(out.reshape(gb, s, d) * torch.sigmoid(gate))


def dit_forward_static(model: EchoDiT, x: torch.Tensor, t: torch.Tensor,
                       kv_static: KV, spk_cols: torch.Tensor,
                       static_mask: torch.Tensor, *, start_pos: int = 0,
                       speaker_scale_by_layer: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Denoiser forward over the pre-concatenated static KV (dit.py:685).

    x (GB, S, latent) and t (GB,) in the model dtype; kv_static from
    concat_static_kv; static_mask (GB, T) bool; speaker_scale_by_layer (L,)
    fp32.  Returns float32 (model.py:604)."""
    cfg = model.cfg
    s = x.shape[1]
    freqs_q = freqs_tensor(cfg.head_dim, start_pos + s, x.device)[start_pos:]

    cond = get_timestep_embedding(t, cfg.timestep_embed_size)
    cond = model.cond_module(cond)[:, None]        # (GB, 1, 3M)
    h = model.in_proj(x)
    # every layer's (T,) column scale in one table: 1 off the speaker
    # columns, the layer's speaker-KV scale on them
    col_scales = None
    if speaker_scale_by_layer is not None:
        col_scales = 1.0 + ((speaker_scale_by_layer.float()[:, None] - 1.0)
                            * spk_cols.float())
    for li, blk in enumerate(model.blocks):
        col_scale = None if col_scales is None else col_scales[li]
        h_norm, gate = low_rank_adaln(h, cond, blk.attention_adaln, cfg.norm_eps)
        h = h + gate * _joint_attention_static(
            blk.attention, h_norm, static_mask, col_scale, freqs_q,
            kv_static[0][li], kv_static[1][li],
            num_heads=cfg.num_heads, eps=cfg.norm_eps)
        h_norm, gate = low_rank_adaln(h, cond, blk.mlp_adaln, cfg.norm_eps)
        h = h + gate * _mlp(blk.mlp, h_norm)
    h = rms_norm(h, model.out_norm.weight, cfg.norm_eps)
    return model.out_proj(h).float()


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
