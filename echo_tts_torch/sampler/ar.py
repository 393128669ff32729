"""Dia's frame loop: autoregressive decoding of delayed codebooks through a
KV cache, under classifier-free guidance, each step a captured program.

Counterpart of the generate() loop of the public dia/model.py, for a
batch of requests that share one pass:

  * the delay pattern: channel c of frame j sits at position 1 + j + d_c
    (position 0 is BOS, then the voice prompt's frames, then the
    generated ones; a channel reads BOS before its delay), `delay_tokens`
    applies it and `undelay` undoes it;
  * each request has two rows, conditional (its text) and unconditional
    (the same text with every byte 0, under the conditional row's mask),
    the first and second half of the model's rows; the step's logits are
    l_c + cfg_scale (l_c - l_u), then the published filters: EOS, PAD and
    BOS off every channel, temperature, top-k, top-p (dia/model.py
    _sample_next_token);
  * seeded per-request sampling: the draw for position t and channel c
    is a uniform from a counter hash of (the request's seed, t, c), the
    inverse CDF of the filtered distribution, so that a request samples
    the same codes alone or in any batch, and the step needs no host
    random state (a captured graph replays it);
  * each row runs at its own position, P_b + s at step s after a prompt
    of P_b frames, so a pass's prompts need not share a length: the
    prefill covers positions 0 .. max P_b - 1 for every row (a row's
    positions past its own prompt are rewritten by its steps before any
    step reads them), and a step writes the next position where the
    delay left it unknown (-1), the prompt's delayed tail being kept;
  * each request's requested frames N_b: with random weights EOS has no
    meaning, so EOS stays off channel 0 until the frames are out; then
    the max-delay flush the public loop runs after EOS (channel c takes
    EOS at d_c steps past the last frame, PAD after), `max_delay` steps;
  * one step (every layer, the guidance, the filters, the draw and the
    write-back) is one program of STEP_PROGRAMS (utils/programs.py) per
    self-attention length bucket (ATTN_BUCKET positions), owned by the
    model and the pass state; `FrameState.warm` builds every bucket up to
    the cache's capacity when the state is made, so no pass captures.

The counters `generate.steps` (one a step, counted inside the program,
exact under replay) and `generate.frames` (the requested frames of each
pass's rows) are registered with programs.register_counters.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import numpy as np
import torch

from ..config import DiaConfig
from ..models import dia
from ..utils import programs

STEP_PROGRAMS = programs.ProgramCache("dia_step", 64)
ATTN_BUCKET = 128
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The delay pattern
# ---------------------------------------------------------------------------

def delay_tokens(prompts: Sequence[np.ndarray], cfg: DiaConfig,
                 length: int) -> np.ndarray:
    """(B, length, channels) int64: BOS at position 0, each prompt's frames
    (P_b, channels) after it, -1 where a frame is not known yet, every
    channel delayed by its d_c (BOS before it)."""
    c = cfg.channels
    out = np.full((len(prompts), length, c), -1, np.int64)
    for b, p in enumerate(prompts):
        p = np.asarray(p, np.int64).reshape(-1, c)
        if 1 + p.shape[0] + cfg.max_delay > length:
            raise ValueError(f"a prompt of {p.shape[0]} frames does not fit "
                             f"{length} positions")
        for ch, d in enumerate(cfg.delay_pattern):
            out[b, :1 + d, ch] = cfg.audio_bos_value
            out[b, 1 + d:1 + d + p.shape[0], ch] = p[:, ch]
    return out


def undelay(tokens: torch.Tensor, start: torch.Tensor, n_frames: int,
            delay: torch.Tensor) -> torch.Tensor:
    """tokens (B, length, channels) delayed -> codes (B, n_frames, channels):
    frame j of row b is its frame start_b + j, channel c read at position
    1 + start_b + j + d_c."""
    b, _, c = tokens.shape
    j = torch.arange(n_frames, device=tokens.device)
    pos = 1 + start[:, None, None] + j[None, :, None] + delay[None, None, :]
    return tokens.gather(1, pos.clamp(max=tokens.shape[1] - 1))


# ---------------------------------------------------------------------------
# Seeded draws
# ---------------------------------------------------------------------------

def _mul32(x: torch.Tensor, k: int) -> torch.Tensor:
    """(x * k) mod 2^32 for x in [0, 2^32) held in int64, in 16-bit halves
    so that no product leaves int64's range."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * k + ((hi * (k & 0xFFFF)) << 16)) & M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniforms(seed_lo: torch.Tensor, seed_hi: torch.Tensor,
             position: torch.Tensor, channels: int) -> torch.Tensor:
    """(B, channels) fp32 in (0, 1): a hash of each row's seed (two 32-bit
    words), the position it samples and the channel."""
    ch = torch.arange(channels, device=position.device)
    x = _fmix32((position[:, None] * channels + ch[None] + 0x9E3779B9) & M32)
    x = _fmix32(x ^ seed_hi[:, None])
    x = _fmix32(x ^ seed_lo[:, None])
    return (x >> 8).float() * 2.0 ** -24 + 2.0 ** -25


def split_seed(seed: int):
    """A request's seed as its two 32-bit words (lo, hi)."""
    seed = int(seed) % (1 << 64)
    return seed & M32, (seed >> 32) & M32


def sample_codes(lc: torch.Tensor, lu: torch.Tensor, u: torch.Tensor,
                 cfg: DiaConfig, cfg_scale: float, temperature: float,
                 top_p: float, top_k: int) -> torch.Tensor:
    """The conditional and unconditional logits (B, channels, vocab) fp32
    and the draws u (B, channels) -> codes (B, channels): the guidance,
    EOS, PAD and BOS off, temperature, top-k, top-p, then the first code
    whose cumulative probability passes u."""
    logit = lc + cfg_scale * (lc - lu)
    vocab = torch.arange(logit.shape[-1], device=logit.device)
    logit = logit.masked_fill(vocab >= cfg.audio_eos_value, float("-inf"))
    vals, idx = torch.topk(logit / temperature, top_k, dim=-1)
    probs = torch.softmax(vals, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep each code whose predecessors hold at most top_p (the first
    # always), as _sample_next_token's shifted mask
    probs = probs.masked_fill(cum - probs > top_p, 0.0)
    cdf = torch.cumsum(probs, dim=-1)
    target = u[..., None] * cdf[..., -1:]
    choice = (cdf <= target).sum(-1).clamp(max=top_k - 1)
    return idx.gather(-1, choice[..., None])[..., 0]


# ---------------------------------------------------------------------------
# The pass state and the step program
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SamplerParams:
    cfg_scale: float = 3.0
    temperature: float = 1.3
    top_p: float = 0.95
    top_k: int = 35


class FrameState:
    """The device state of one pass of `requests` requests (2 x requests
    model rows): the self K/V cache (layers, rows, kv_heads, capacity, hd),
    the cross K/V (layers, rows, heads, text_length, hd), the delayed
    tokens (requests, capacity + 1, channels), each request's prompt
    length, requested frames and seed, and, for `keep` requests, the
    record of their conditional and unconditional logits at every step
    (keep, 2, capacity, channels, vocab) fp32.  Made once per model and
    shape and reused by every pass (its programs are owned by it)."""

    def __init__(self, model: dia.DiaModel, requests: int, keep: int,
                 capacity: int, bucket: int, dtype, device):
        cfg = model.cfg
        self.requests, self.keep = requests, keep
        self.capacity, self.bucket = capacity, bucket
        r, nl = 2 * requests, cfg.decoder_n_layer
        kv = (nl, r, cfg.kv_heads, capacity, cfg.gqa_head_dim)
        cross = (nl, r, cfg.cross_query_heads, cfg.text_length,
                 cfg.cross_head_dim)
        self.k_self = torch.zeros(kv, dtype=dtype, device=device)
        self.v_self = torch.zeros(kv, dtype=dtype, device=device)
        self.k_cross = torch.zeros(cross, dtype=dtype, device=device)
        self.v_cross = torch.zeros(cross, dtype=dtype, device=device)
        self.text_valid = torch.ones((r, cfg.text_length), dtype=torch.bool,
                                     device=device)
        self.tokens = torch.zeros((requests, capacity + 1, cfg.channels),
                                  dtype=torch.long, device=device)
        longs = dict(dtype=torch.long, device=device)
        self.start = torch.zeros(requests, **longs)
        self.frames = torch.zeros(requests, **longs)
        self.seed_lo = torch.zeros(requests, **longs)
        self.seed_hi = torch.zeros(requests, **longs)
        self.delay = torch.tensor(cfg.delay_pattern, **longs)
        self.steps = torch.arange(capacity, **longs)
        self.keep_rows = torch.zeros(keep, **longs)
        self.keep_logits = (torch.zeros(
            (keep, 2, capacity, cfg.channels, cfg.tgt_vocab_size),
            dtype=torch.float32, device=device) if keep else None)

    def buckets(self) -> List[int]:
        return list(range(self.bucket, self.capacity, self.bucket)) + [
            self.capacity]

    def attn_len(self, last_position: int) -> int:
        """The bucket that holds positions 0 .. last_position."""
        n = -(-(last_position + 1) // self.bucket) * self.bucket
        return min(n, self.capacity)

    def warm(self, model: dia.DiaModel, params: SamplerParams) -> None:
        """Build the step program of every bucket (the state's tokens are
        still valid codes, so the runs read no unknown position)."""
        for n in self.buckets():
            _step(model, self, 0, n, params)


def _step_body(owners, s, *, attn_len: int, params: SamplerParams):
    model, st = owners
    cfg = model.cfg
    b, c = st.requests, cfg.channels
    pos = st.start + s
    at = pos.view(b, 1, 1).expand(b, 1, c)
    x = dia.embed(model, st.tokens.gather(1, at)[:, 0])
    logit = dia.decode_step(model, torch.cat([x, x]), torch.cat([pos, pos]),
                            st.k_self, st.v_self, st.k_cross, st.v_cross,
                            st.text_valid, attn_len)
    lc, lu = logit[:b], logit[b:]
    if st.keep:
        st.keep_logits[:, 0].index_copy_(1, s, lc[st.keep_rows][:, None])
        st.keep_logits[:, 1].index_copy_(1, s, lu[st.keep_rows][:, None])
    nxt = pos + 1
    code = sample_codes(lc, lu, uniforms(st.seed_lo, st.seed_hi, nxt, c),
                        cfg, params.cfg_scale, params.temperature,
                        params.top_p, params.top_k)
    # past the requested frames: channel c takes EOS d_c steps after the
    # last one, PAD after that (the public loop's flush)
    after = (nxt - (st.start + st.frames + 1))[:, None]
    d = st.delay[None]
    forced = torch.where(after == d, cfg.audio_eos_value, cfg.audio_pad_value)
    code = torch.where(after >= d, forced, code)
    at = nxt.view(b, 1, 1).expand(b, 1, c)
    known = st.tokens.gather(1, at)[:, 0]
    code = torch.where(known == -1, code, known)
    st.tokens.scatter_(1, at, code[:, None])
    generate.steps += 1
    return code


def _step(model, st: FrameState, s: int, attn_len: int,
          params: SamplerParams) -> torch.Tensor:
    return STEP_PROGRAMS(
        ("dia_step", attn_len, dataclasses.astuple(params)), (model, st),
        [st.steps[s:s + 1]],
        lambda: functools.partial(_step_body, attn_len=attn_len,
                                  params=params))


def state_for(model: dia.DiaModel, requests: int, keep: int, dtype,
              params: SamplerParams) -> FrameState:
    """The model's pass state for `requests` requests, its cache holding
    audio_length positions, made (with every bucket's step program built)
    on first use.  One state lives at a time: one of another shape frees
    the last, and its programs with it."""
    capacity, bucket = model.cfg.audio_length, ATTN_BUCKET
    key = (requests, keep, capacity, bucket, dtype)
    held = getattr(model, "_frame_state", None)
    if held is not None and held[0] == key:
        return held[1]
    model._frame_state = None
    del held
    programs.purge()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    device = next(model.parameters()).device
    st = FrameState(model, requests, keep, capacity, bucket, dtype, device)
    st.warm(model, params)
    model._frame_state = (key, st)
    return st


# ---------------------------------------------------------------------------
# A pass
# ---------------------------------------------------------------------------

def begin(st: FrameState, prompts: Sequence[np.ndarray],
          frames: Sequence[int], seeds: Sequence[int],
          keep_rows: Sequence[int], cfg: DiaConfig) -> int:
    """Load a pass's requests into the state: delayed tokens, prompt
    lengths, frames, seeds, the kept requests' rows.  Returns the number
    of steps (max frames + the flush); raises if a request would run past
    the cache."""
    b = st.requests
    if len(prompts) != b or len(frames) != b or len(seeds) != b:
        raise ValueError(f"a pass of this state holds {b} requests")
    if len(keep_rows) > st.keep:
        raise ValueError(f"{len(keep_rows)} requests ask for their logits; "
                         f"the state keeps {st.keep}")
    start = [np.asarray(p).reshape(-1, cfg.channels).shape[0] for p in prompts]
    steps = max(frames) + cfg.max_delay
    if max(start) + steps + 1 > st.capacity:
        raise ValueError(f"a prompt of {max(start)} frames and {steps} steps "
                         f"pass the cache's {st.capacity} positions")
    dev = st.tokens.device
    st.tokens.copy_(torch.from_numpy(
        delay_tokens(prompts, cfg, st.capacity + 1)).to(dev))
    lo_hi = [split_seed(x) for x in seeds]
    for t, v in ((st.start, start), (st.frames, list(frames)),
                 (st.seed_lo, [x[0] for x in lo_hi]),
                 (st.seed_hi, [x[1] for x in lo_hi])):
        t.copy_(torch.tensor(v, dtype=torch.long))
    if st.keep:
        rows = list(keep_rows) + [0] * (st.keep - len(keep_rows))
        st.keep_rows.copy_(torch.tensor(rows, dtype=torch.long))
    generate.frames += int(sum(frames))
    return steps


def run_prefill(model: dia.DiaModel, st: FrameState, p_max: int) -> None:
    """Positions 0 .. p_max - 1 of every row through the decoder, writing
    the self K/V (unknown tokens read as code 0: those positions belong
    to rows whose prompt is shorter, whose steps rewrite them)."""
    if p_max == 0:
        return
    tok = st.tokens[:, :p_max].clamp_min(0)
    dia.prefill(model, torch.cat([tok, tok]), st.k_self, st.v_self,
                st.k_cross, st.v_cross, st.text_valid)


def generate(model: dia.DiaModel, st: FrameState, steps: int,
             p_max: int, params: SamplerParams) -> None:
    """The frame loop: `steps` step programs, each at the bucket that holds
    the furthest row's position."""
    for s in range(steps):
        _step(model, st, s, st.attn_len(p_max + s), params)


generate.steps = 0
generate.frames = 0
programs.register_counters(generate, "steps", "frames")
