"""Dia's operations and bytes, from shapes alone: the model FLOPs of a
request (mfu.dia), the bytes a decode step launches (decode_roofline.dia)
and kernel B's centred calls of a codec decode (res_stack_roofline.dia).

`cfg` is the configuration's "dia" group (config.json's widths under the
port's DiaConfig names), `codec` its "codec" group.  A request's model
FLOPs count both of its rows (conditional and unconditional, the
guidance the sampler needs) at its real lengths: the encoder over its
text's bytes, the cross K/V projections over them, the decoder over its
prompt (the prefill) and over each step of its frames and the flush (one
token, attending to every position before it and to its text), and the
logits head at each step; 2 FLOPs a multiply-add.  The decode step's bytes
are a floor of what its kernels must move: the decoder's weights and the
head read once, the self K/V at the positions the attention reads (the
length bucket launched) for every row, the cross K/V at the text width
launched, the step's new K/V written, the embedding rows gathered and the
logits written.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from .counts import PEAK_BF16, PEAK_BYTES, res_stack  # noqa: F401

BF16 = 2


def _decoder_linear_macs(cfg: dict) -> int:
    """Multiply-adds of one token through one decoder layer's linears."""
    d = cfg["decoder_n_embd"]
    q = cfg["gqa_query_heads"] * cfg["gqa_head_dim"]
    kv = cfg["kv_heads"] * cfg["gqa_head_dim"]
    c = cfg["cross_query_heads"] * cfg["cross_head_dim"]
    return d * q + 2 * d * kv + q * d + 2 * d * c + 3 * d * cfg[
        "decoder_n_hidden"]


def _head_macs(cfg: dict) -> int:
    return cfg["decoder_n_embd"] * cfg["channels"] * cfg["tgt_vocab_size"]


def encoder_flops(cfg: dict, text_len: int) -> float:
    """One row through the encoder over text_len bytes."""
    d, f = cfg["encoder_n_embd"], cfg["encoder_n_hidden"]
    inner = cfg["encoder_n_head"] * cfg["encoder_head_dim"]
    per_layer = (4 * d * inner + 3 * d * f) * text_len \
        + 2 * text_len * text_len * inner
    return 2.0 * cfg["encoder_n_layer"] * per_layer


def cross_kv_flops(cfg: dict, text_len: int) -> float:
    """One row's cross-attention K and V projections, every layer."""
    c = cfg["cross_query_heads"] * cfg["cross_head_dim"]
    return 2.0 * cfg["decoder_n_layer"] * 2 * cfg["encoder_n_embd"] * c \
        * text_len


def decoder_token_flops(cfg: dict, context: int, text_len: int,
                        head: bool) -> float:
    """One token of one row through the decoder, attending to `context`
    positions (itself included) and to text_len bytes; with the head."""
    q = cfg["gqa_query_heads"] * cfg["gqa_head_dim"]
    c = cfg["cross_query_heads"] * cfg["cross_head_dim"]
    attn = 2 * context * q + 2 * text_len * c
    macs = cfg["decoder_n_layer"] * (_decoder_linear_macs(cfg) + attn)
    return 2.0 * (macs + (_head_macs(cfg) if head else 0))


def request_flops(cfg: dict, text_len: int, prompt: int,
                  frames: int) -> dict:
    """Model FLOPs of one request (both rows), by stage."""
    flush = max(cfg["delay_pattern"])
    enc = 2 * (encoder_flops(cfg, text_len) + cross_kv_flops(cfg, text_len))
    pre = 2 * sum(decoder_token_flops(cfg, t + 1, text_len, False)
                  for t in range(prompt))
    # step s reads position prompt + s and every one before it
    steps = frames + flush
    q = cfg["gqa_query_heads"] * cfg["gqa_head_dim"]
    per = decoder_token_flops(cfg, 0, text_len, True)
    ctx = steps * (prompt + 1) + steps * (steps - 1) // 2
    dec = 2 * (steps * per + 2.0 * cfg["decoder_n_layer"] * 2 * q * ctx)
    return {"encode": enc, "prefill": pre, "decode": dec}


def decoder_weight_bytes(cfg: dict) -> int:
    """The decoder layers' and the head's weights, bf16."""
    return BF16 * (cfg["decoder_n_layer"] * _decoder_linear_macs(cfg)
                   + _head_macs(cfg))


def decode_step_bytes(cfg: dict, rows: int, attn_len: int,
                      text_width: int) -> float:
    """Bytes one decode step of `rows` model rows must move (module
    docstring)."""
    layers = cfg["decoder_n_layer"]
    kv = cfg["kv_heads"] * cfg["gqa_head_dim"]
    c = cfg["cross_query_heads"] * cfg["cross_head_dim"]
    self_kv = layers * rows * 2 * kv * attn_len * BF16
    cross = layers * rows * 2 * c * text_width * BF16
    new_kv = layers * rows * 2 * kv * BF16
    emb = rows * cfg["channels"] * cfg["decoder_n_embd"] * BF16
    out = rows * cfg["channels"] * cfg["tgt_vocab_size"] * 4
    return decoder_weight_bytes(cfg) + self_kv + cross + new_kv + emb + out


def step_lengths(steps: int, p_max: int, bucket: int,
                 capacity: int) -> List[int]:
    """The self-attention length launched at each step (sampler/ar.py
    FrameState.attn_len): the bucket that holds position p_max + s."""
    return [min(-(-(p_max + s + 1) // bucket) * bucket, capacity)
            for s in range(steps)]


def res_stack_calls(codec: dict, frames: Sequence[int],
                    max_width: int = 384) -> List[Tuple[float, float]]:
    """(ops, bytes) of each kernel B call of one codec decode slice whose
    rows generate `frames` frames: the decoder blocks at widths the kernel
    takes, each row counted at its own length (the centred instance skips
    a row's tiles past it), the weights once a call."""
    out = []
    rate = 1
    for bi, stride in enumerate(codec["decoder_rates"]):
        rate *= stride
        c = codec["decoder_dim"] // 2 ** (bi + 1)
        if c > max_width:
            continue
        ops = nbytes = 0.0
        for n in frames:
            o, b = res_stack(c, n * rate, 1)
            ops += o
            nbytes += 2 * n * rate * c * BF16
        nbytes += 3 * 8 * c * c * BF16 + 3 * 4 * c * BF16
        out.append((ops, nbytes))
    return out
