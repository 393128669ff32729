"""Incremental (stateful) S1-DAC decode and encode for streaming synthesis.

Counterpart of echo_tts_tpu/models/dac/streaming.py.  The codec is fully
causal (a window-limited transformer, stride == kernel or K = 2s transpose
convs, causal conv stacks; reference: autoencoder.py:376-496, 932-998), so
its receptive field is bounded and each streamed block costs O(block)
when the causal context is carried from block to block:

  * window transformers: per-layer rolling K/V of the last (window - 1)
    positions, keys cached after RoPE at absolute positions, and the
    absolute position (a 0-d int64 tensor on the device) for the RoPE
    table and window mask, so that one captured block program
    (pipeline._decode_block_core) serves every block of a stream; the
    bound check is the caller's, on its host mirror
    (pipeline.ae_decode_block, ae_encode_block);
  * every causal conv: its last (k_eff - stride) raw input frames, which
    replace the zero left pad (conv.py `history`); transpose convs their
    last (K / stride - 1) input frames;
  * the residual stacks: each unit's last 6 * d frames of snake1 of its
    input, the history form of kernel B (ops/res_stack.py) at C <= 384,
    or of the unrolled units above, as the one-shot path splits them.

The state is a dict of tensors on the codec's device; zero state is the
one-shot causal pad, so block 0 is the one-shot op, and streamed output
equals the one-shot decode up to float reduction order.  A block call
never writes into the state it is given: it returns new tensors, so one
zero state may be shared by every stream (pipeline.ae_decode_stream_init).

    state = init_decode_state(cfg, batch, dtype, device)
    audio_block, state = decode_zq_block(dac, state, z_q_block)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...config import AETransformerConfig, DACConfig
from ...device import resolve_device
from .conv import (CausalConv, CausalConvTranspose, ConvNeXtBlock,
                   causal_conv1d, causal_conv_transpose1d, layer_norm,
                   roll_history, snake)
from .dac import DILATIONS, S1DAC, _res_stack, zq_from_codes
from .quantize import rvq_encode
from .transformer import (WindowLimitedTransformer, _apply_rope,
                          _rms_norm_ae, rope_table)

# Default RoPE-table bound for streaming decode: ~6.3 min of latents at
# 21.5 Hz, past the reference's 300 s load_audio cap (inference.py:104-113).
MAX_POSITIONS = 8192
# The encoder-side transformer runs at the 512-sample hop (86 Hz), so the
# encode bound must be ~4x higher for the same audio length.
MAX_ENC_POSITIONS = 32768


def check_positions(pos: int, n: int, max_positions: int, what: str,
                    hint: str = "") -> None:
    """Raise ValueError unless a block of n positions from the host
    position pos fits the RoPE table: pos + n <= max_positions.  The block
    functions below read the position from the state on the device and
    check nothing (a captured program cannot read it back, and a gather
    past the table is a device-side assert that ends the CUDA context), so
    every caller keeps a host mirror of the position and calls this before
    each block (pipeline.ae_decode_block and ae_encode_block do)."""
    if pos + n > max_positions:
        raise ValueError(f"{what} position {pos} + block {n} exceeds the "
                         f"RoPE bound {max_positions}{hint}")


# ---------------------------------------------------------------------------
# State initialization (streaming.py:51-96, 273-314)
# ---------------------------------------------------------------------------

def _zeros(batch, width, c, dtype, device):
    return torch.zeros((batch, width, c), dtype=dtype, device=device)


def _conv_state(batch, k, stride, dilation, c_in, dtype, device):
    return _zeros(batch, (k - 1) * dilation + 1 - stride, c_in, dtype, device)


def _convt_state(batch, k, stride, c_in, dtype, device):
    return _zeros(batch, k // stride - 1, c_in, dtype, device)


def _res_state(batch, c, dtype, device):
    """The three units' snake1 tails, (B, 6d, C) for d = 1, 3, 9."""
    return [_conv_state(batch, 7, 1, d, c, dtype, device) for d in DILATIONS]


def _window_state(tcfg: AETransformerConfig, batch, dtype, device):
    shape = (tcfg.n_layer, batch, tcfg.window_size - 1, tcfg.n_head,
             tcfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.long, device=device)}


def init_decode_state(cfg: DACConfig, batch: int = 1, dtype=torch.float32,
                      device="cuda") -> dict:
    """Zero state == the one-shot causal pads.  Raises without CUDA unless
    device='cpu'."""
    device = resolve_device(device)
    d = cfg.latent_dim
    upsample = [{"convt": _convt_state(batch, f, f, d, dtype, device),
                 "dwconv": _conv_state(batch, 7, 1, 1, d, dtype, device)}
                for f in reversed(cfg.downsample_factor)]
    ch = cfg.decoder_dim
    blocks = [{"up": _convt_state(batch, 2 * stride, stride, ch // 2 ** bi,
                                  dtype, device),
               "res": _res_state(batch, ch // 2 ** (bi + 1), dtype, device)}
              for bi, stride in enumerate(cfg.decoder_rates)]
    final = ch // 2 ** len(cfg.decoder_rates)
    return {
        "post": _window_state(cfg.quantizer_transformer_config(), batch,
                              dtype, device),
        "upsample": upsample,
        "decoder": {"conv_in": _conv_state(batch, 7, 1, 1, d, dtype, device),
                    "blocks": blocks,
                    "conv_out": _conv_state(batch, 7, 1, 1, final, dtype,
                                            device)},
    }


def init_encode_state(cfg: DACConfig, batch: int = 1, dtype=torch.float32,
                      device="cuda") -> dict:
    """Zero state == the one-shot causal pads (encoder side).  Raises
    without CUDA unless device='cpu'."""
    device = resolve_device(device)
    dim = cfg.encoder_dim
    blocks = []
    for stride, n_t in zip(cfg.encoder_rates, cfg.encoder_transformer_layers):
        blk = {"res": _res_state(batch, dim, dtype, device),
               # the down conv, k = 2s at stride s: history width s
               "down": _conv_state(batch, 2 * stride, stride, 1, dim, dtype,
                                   device)}
        dim *= 2
        if n_t:
            blk["transformer"] = _window_state(
                cfg.encoder_transformer_config(dim, n_t), batch, dtype, device)
        blocks.append(blk)
    return {
        "conv_in": _conv_state(batch, 7, 1, 1, 1, dtype, device),
        "blocks": blocks,
        "conv_out": _conv_state(batch, 3, 1, 1, dim, dtype, device),
        "downsample": [{"dwconv": _conv_state(batch, 7, 1, 1, cfg.latent_dim,
                                              dtype, device)}
                       for _ in cfg.downsample_factor],
        "pre": _window_state(cfg.quantizer_transformer_config(), batch, dtype,
                             device),
    }


# ---------------------------------------------------------------------------
# Stateful building blocks (streaming.py:103-136; `_roll` is
# conv.roll_history)
# ---------------------------------------------------------------------------

def _sconv(hist, x, conv: CausalConv):
    out = causal_conv1d(x, conv.conv.kernel(), conv.conv.bias,
                        stride=conv.stride, dilation=conv.dilation,
                        groups=conv.groups, history=hist)
    return roll_history(hist, x), out


def _sconvt(hist, x, convt: CausalConvTranspose):
    out = causal_conv_transpose1d(x, convt.conv.kernel(), convt.conv.bias,
                                  stride=convt.stride, history=hist)
    return roll_history(hist, x), out


def _convnext_block_s(blk: ConvNeXtBlock, hist, x):
    """Streaming twin of ConvNeXtBlock.forward: only the k7 depthwise conv
    carries state."""
    hist, y = _sconv(hist, x, blk.dwconv)
    y = layer_norm(y, blk.norm.weight, blk.norm.bias, 1e-6)
    y = blk.pwconv2(F.gelu(blk.pwconv1(y), approximate="none"))
    return hist, x + blk.gamma * y


def transformer_decode_block(p: WindowLimitedTransformer,
                             cfg: AETransformerConfig, st: dict,
                             x: torch.Tensor, max_positions: int):
    """Incremental WindowLimitedTransformer over one block x (B, S, D)
    (streaming.py:150-206; one-shot twin: transformer.transformer_forward).

    st: {"k", "v": (L, B, W-1, H, Dh) post-RoPE rolling caches, "pos": the
    absolute position of this block's first token, a 0-d int tensor}.
    The RoPE rows pos + i are gathered from the max_positions table on
    the device (streaming.py:162-165); pos + s <= max_positions is the
    caller's check.  Returns (out, new state)."""
    b, s, d = x.shape
    h, hd, w = cfg.n_head, cfg.head_dim, cfg.window_size
    pos = st["pos"]
    dev = x.device
    table = rope_table(max_positions, hd, cfg.rope_base, dev).index_select(
        0, pos + torch.arange(s, device=dev))
    scale = 1.0 / (hd ** 0.5)
    # cache slot m holds position pos - (W-1) + m, block key n position
    # pos + n, query i position pos + i: visible iff the key position is
    # >= 0 and in (q - W, q] (autoencoder.py:762-784)
    q_off = torch.arange(s, device=dev)[:, None]
    k_off = torch.cat([torch.arange(w - 1, device=dev) - (w - 1),
                       torch.arange(s, device=dev)])[None, :]
    hidden = ~((k_off + pos >= 0) & (k_off <= q_off)
               & (k_off > q_off - w))[None, None]
    new_k, new_v = [], []
    for li, blk in enumerate(p.layers):
        xn = _rms_norm_ae(x, blk.attention_norm.weight, cfg.norm_eps)
        q, k, v = torch.chunk(blk.attention.wqkv(xn), 3, dim=-1)
        q = _apply_rope(q.reshape(b, s, h, hd), table)
        k = _apply_rope(k.reshape(b, s, h, hd), table)
        v = v.reshape(b, s, h, hd)
        k_all = torch.cat([st["k"][li].to(k.dtype), k], dim=1)
        v_all = torch.cat([st["v"][li].to(v.dtype), v], dim=1)
        logits = torch.einsum("bshd,bthd->bhst", q.float(), k_all.float()) * scale
        wts = torch.softmax(logits.masked_fill(hidden, float("-inf")),
                            dim=-1).to(v.dtype)
        attn = torch.einsum("bhst,bthd->bshd", wts, v_all).reshape(b, s, d)
        x = x + blk.attention_layer_scale.gamma * blk.attention.wo(attn)
        xn = _rms_norm_ae(x, blk.ffn_norm.weight, cfg.norm_eps)
        ff = blk.feed_forward
        x = x + blk.ffn_layer_scale.gamma * ff.w2(F.silu(ff.w1(xn)) * ff.w3(xn))
        new_k.append(k_all[:, k_all.shape[1] - (w - 1):])
        new_v.append(v_all[:, v_all.shape[1] - (w - 1):])
    out = _rms_norm_ae(x, p.norm.weight, cfg.norm_eps)
    return out, {"k": torch.stack(new_k).to(st["k"].dtype),
                 "v": torch.stack(new_v).to(st["v"].dtype), "pos": pos + s}


# ---------------------------------------------------------------------------
# Incremental decode_zq and encode_zq (streaming.py:213-385)
# ---------------------------------------------------------------------------

def decode_zq_block(dac: S1DAC, state: dict, z_q: torch.Tensor, *,
                    max_positions: int = MAX_POSITIONS):
    """z_q (B, T_block, latent_dim) -> (audio (B, T_block * frame_length,
    1), new state): dac.decode_zq restricted to the new block, with all
    causal context from `state` (reference one-shot: autoencoder.py:486-496,
    1128-1132).  `max_positions` is the RoPE-table bound and must stay the
    same over one stream's blocks.  The state's position is not checked
    against it here: call through pipeline.ae_decode_block, or check a host
    mirror with check_positions first."""
    cfg = dac.cfg
    q = dac.quantizer
    z, post = transformer_decode_block(
        q.post_module, cfg.quantizer_transformer_config(), state["post"], z_q,
        max_positions)
    upsample = []
    for (convt, convnext), st in zip(q.upsample, state["upsample"]):
        st_t, z = _sconvt(st["convt"], z, convt)
        st_dw, z = _convnext_block_s(convnext, st["dwconv"], z)
        upsample.append({"convt": st_t, "dwconv": st_dw})

    dec, dst = dac.decoder, state["decoder"]
    n = len(cfg.decoder_rates)
    ap = cfg.snake_approx                # the decoder-side fast snake
    st_in, x = _sconv(dst["conv_in"], z, dec.model[0])
    blocks = []
    for blk, bst in zip(dec.model[1:1 + n], dst["blocks"]):
        x = snake(x, blk.block[0].vec(), approx=ap)
        st_up, x = _sconvt(bst["up"], x, blk.block[1])
        x, st_res = _res_stack(blk.block[2:5], x, approx_snake=ap,
                               history=bst["res"])
        blocks.append({"up": st_up, "res": st_res})
    x = snake(x, dec.model[n + 1].vec(), approx=ap)
    st_out, x = _sconv(dst["conv_out"], x, dec.model[n + 2])
    return torch.tanh(x), {
        "post": post, "upsample": upsample,
        "decoder": {"conv_in": st_in, "blocks": blocks, "conv_out": st_out}}


def encode_zq_block(dac: S1DAC, state: dict, audio: torch.Tensor, *,
                    max_positions: int = MAX_ENC_POSITIONS):
    """audio (B, L_block, 1), L_block a multiple of frame_length ->
    (z_q (B, L_block / frame_length, latent_dim), new state): dac.encode_zq
    restricted to the new block, the one-shot right pad to a frame
    multiple being the caller's (reference one-shot:
    autoencoder.py:1080-1126).  Consecutive blocks reproduce the one-shot
    encode of the concatenated audio; the quantizers are per frame and
    carry no state.  The window transformers' positions (one per
    hop_length samples) are not checked against `max_positions` here:
    call through pipeline.ae_encode_block, or check a host mirror with
    check_positions first."""
    cfg = dac.cfg
    if audio.shape[1] % cfg.frame_length != 0:
        raise ValueError(f"block length {audio.shape[1]} must be a multiple "
                         f"of frame_length {cfg.frame_length}")
    enc = dac.encoder
    n = len(cfg.encoder_rates)
    st_in, x = _sconv(state["conv_in"], audio, enc.block[0])
    blocks = []
    dim = cfg.encoder_dim
    for blk, bst, n_t in zip(enc.block[1:1 + n], state["blocks"],
                             cfg.encoder_transformer_layers):
        dim *= 2
        x, st_res = _res_stack(blk.block[:3], x, history=bst["res"])
        x = snake(x, blk.block[3].vec())
        st_down, x = _sconv(bst["down"], x, blk.block[4])
        new = {"res": st_res, "down": st_down}
        if n_t:
            x, new["transformer"] = transformer_decode_block(
                blk.block[5], cfg.encoder_transformer_config(dim, n_t),
                bst["transformer"], x, max_positions)
        blocks.append(new)
    x = snake(x, enc.block[n + 1].vec())
    st_out, z = _sconv(state["conv_out"], x, enc.block[n + 2])

    q = dac.quantizer
    downsample = []
    for (conv, convnext), st in zip(q.downsample, state["downsample"]):
        st_dw, z = _convnext_block_s(convnext, st["dwconv"], conv(z))
        downsample.append({"dwconv": st_dw})
    z, pre = transformer_decode_block(
        q.pre_module, cfg.quantizer_transformer_config(), state["pre"], z,
        max_positions)
    sem_zq, sem_codes = rvq_encode(q.semantic_quantizer, z)
    _, res_codes = rvq_encode(q.quantizer, z - sem_zq)
    z_q = zq_from_codes(q, cfg, torch.cat([sem_codes, res_codes], dim=1))
    return z_q, {"conv_in": st_in, "blocks": blocks, "conv_out": st_out,
                 "downsample": downsample, "pre": pre}
