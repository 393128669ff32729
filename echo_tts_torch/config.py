"""Model configurations for the PyTorch/CUDA port of Echo-TTS.

A copy of echo_tts_tpu/config.py (EchoDiTConfig, AETransformerConfig,
DACConfig, the tiny/base constructors, SAMPLER_DEFAULTS and the length
limits) so that this package never imports the JAX one.  The JAX config's
`attention_impl` field is left out: here the joint-attention backend follows
the device of the tensors (ops/joint_attention.py).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class EchoDiTConfig:
    """EchoDiT + text/speaker/latent encoder hyperparameters
    (reference: model.py:472-559, values from inference.py:16-24)."""

    latent_size: int = 80
    model_size: int = 2048
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 5888
    norm_eps: float = 1e-5

    text_vocab_size: int = 256
    text_model_size: int = 1280
    text_num_layers: int = 14
    text_num_heads: int = 10
    text_intermediate_size: int = 3328

    speaker_patch_size: int = 4
    speaker_model_size: int = 1280
    speaker_num_layers: int = 14
    speaker_num_heads: int = 10
    speaker_intermediate_size: int = 3328

    timestep_embed_size: int = 512
    adaln_rank: int = 256

    # When False the latent_encoder / latent_norm / wk_latent / wv_latent
    # parameters are absent (reference: inference.py:28-34).
    blockwise: bool = True

    @property
    def head_dim(self) -> int:
        return self.model_size // self.num_heads

    @property
    def text_head_dim(self) -> int:
        return self.text_model_size // self.text_num_heads

    @property
    def speaker_head_dim(self) -> int:
        return self.speaker_model_size // self.speaker_num_heads


def base_dit_config(blockwise: bool = True) -> EchoDiTConfig:
    """The single published configuration (reference: inference.py:16-24)."""
    return EchoDiTConfig(blockwise=blockwise)


def tiny_dit_config(blockwise: bool = True) -> EchoDiTConfig:
    """Small config for unit tests; same structural ratios."""
    return EchoDiTConfig(
        latent_size=80,
        model_size=64,
        num_layers=2,
        num_heads=4,
        intermediate_size=96,
        norm_eps=1e-5,
        text_vocab_size=256,
        text_model_size=48,
        text_num_layers=2,
        text_num_heads=4,
        text_intermediate_size=80,
        speaker_patch_size=4,
        speaker_model_size=48,
        speaker_num_layers=2,
        speaker_num_heads=4,
        speaker_intermediate_size=80,
        timestep_embed_size=16,
        adaln_rank=8,
        blockwise=blockwise,
    )


@dataclasses.dataclass(frozen=True)
class AETransformerConfig:
    """GPT-style transformer inside the autoencoder
    (reference: autoencoder.py:503-527)."""

    n_layer: int = 8
    n_head: int = 16
    dim: int = 1024
    intermediate_size: int = 3072
    head_dim: int = 64
    rope_base: float = 10000.0
    norm_eps: float = 1e-5
    # Causal window-limited attention window; None = plain causal
    window_size: int | None = None
    input_dim: int = 1024


@dataclasses.dataclass(frozen=True)
class DACConfig:
    """Fish S1-DAC configuration (reference: autoencoder.py:1144-1192).

    As in the JAX package: only the last encoder block carries a
    transformer, and the decoder has NO transformer at runtime (the
    reference builds its DecoderBlock transformer but never registers it,
    autoencoder.py:944-965).
    """

    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    latent_dim: int = 1024
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    sample_rate: int = 44100
    encoder_transformer_layers: Tuple[int, ...] = (0, 0, 0, 4)

    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    semantic_codebook_size: int = 4096
    downsample_factor: Tuple[int, ...] = (2, 2)
    quantizer_transformer_layers: int = 8

    # Opt-in polynomial sin^2 in the DECODER's snakes only
    # (ops/activations.py:sin2_poly); the encoder always runs exact sin.
    snake_approx: bool = False

    # False: the decoder's convolutions are centred ("same" padding), as
    # in Descript's DAC (dac/model/dac.py), where Fish's S1-DAC is causal
    # (models/dac/dac.py, decoder_forward)
    causal: bool = True

    @property
    def hop_length(self) -> int:
        h = 1
        for r in self.encoder_rates:
            h *= r
        return h

    @property
    def frame_length(self) -> int:
        # hop_length * 4 (reference: autoencoder.py:1044)
        return self.hop_length * 4

    def quantizer_transformer_config(self) -> AETransformerConfig:
        return AETransformerConfig(
            n_layer=self.quantizer_transformer_layers,
            n_head=self.latent_dim // 64, dim=self.latent_dim,
            intermediate_size=self.latent_dim * 3,
            head_dim=64, norm_eps=1e-5, window_size=128,
            input_dim=self.latent_dim,
        )

    def encoder_transformer_config(self, dim: int, n_layer: int) -> AETransformerConfig:
        return AETransformerConfig(
            n_layer=n_layer, n_head=dim // 64, dim=dim,
            intermediate_size=dim * 3, head_dim=64, norm_eps=1e-5,
            window_size=512, input_dim=dim,
        )


def base_dac_config() -> DACConfig:
    return DACConfig()


def tiny_dac_config() -> DACConfig:
    """Small S1-DAC for unit tests; same structure (hop 8, frame 32)."""
    return DACConfig(
        encoder_dim=16,
        encoder_rates=(2, 4),
        latent_dim=64,
        decoder_dim=64,
        decoder_rates=(4, 2),
        encoder_transformer_layers=(0, 2),
        n_codebooks=2,
        codebook_size=32,
        codebook_dim=4,
        semantic_codebook_size=64,
        downsample_factor=(2, 2),
        quantizer_transformer_layers=2,
    )


def dac44k_config(snake_approx: bool = False) -> DACConfig:
    """Descript's DAC 44 kHz (descript/dac_44khz), the codec Dia decodes
    with: S1-DAC's decoder widths and rates (latent 1024, decoder 1536,
    8 * 8 * 4 * 2 = 512 samples a frame) and nine residual codebooks of
    1024 x 8, without Fish's additions (no downsample, no transformers,
    no semantic codebook), and centred, not causal.  Only the decode from
    codes runs here (models/dac/dac.py, DAC44)."""
    return DACConfig(encoder_transformer_layers=(0, 0, 0, 0),
                     semantic_codebook_size=0, downsample_factor=(),
                     quantizer_transformer_layers=0,
                     snake_approx=snake_approx, causal=False)


def tiny_dac44k_config() -> DACConfig:
    """Small centred DAC for the Dia unit tests (hop 8, 3 codebooks of 32
    x 4), paired with tiny_dia_config."""
    return DACConfig(encoder_dim=16, encoder_rates=(2, 4), latent_dim=32,
                     decoder_dim=64, decoder_rates=(4, 2),
                     encoder_transformer_layers=(0, 0), n_codebooks=3,
                     codebook_size=32, codebook_dim=4,
                     semantic_codebook_size=0, downsample_factor=(),
                     quantizer_transformer_layers=0, causal=False)


@dataclasses.dataclass(frozen=True)
class DiaConfig:
    """Dia (Nari Labs), an encoder-decoder that generates DAC codes frame
    by frame.  Field names follow the published config.json
    (huggingface.co/nari-labs/Dia-1.6B): model.encoder.*, model.decoder.*,
    model.*_vocab_size and data.*; the defaults are Dia-1.6B's."""

    encoder_n_layer: int = 12
    encoder_n_embd: int = 1024
    encoder_n_hidden: int = 4096
    encoder_n_head: int = 16
    encoder_head_dim: int = 128

    decoder_n_layer: int = 18
    decoder_n_embd: int = 2048
    decoder_n_hidden: int = 8192
    gqa_query_heads: int = 16
    kv_heads: int = 4
    gqa_head_dim: int = 128
    cross_query_heads: int = 16
    cross_head_dim: int = 128

    src_vocab_size: int = 256
    tgt_vocab_size: int = 1028
    normalization_layer_epsilon: float = 1e-5
    rope_min_timescale: float = 1.0
    rope_max_timescale: float = 10000.0

    text_length: int = 1024
    audio_length: int = 3072
    channels: int = 9
    text_pad_value: int = 0
    audio_eos_value: int = 1024
    audio_pad_value: int = 1025
    audio_bos_value: int = 1026
    delay_pattern: Tuple[int, ...] = (0, 8, 9, 10, 11, 12, 13, 14, 15)

    @property
    def max_delay(self) -> int:
        return max(self.delay_pattern)


def tiny_dia_config() -> DiaConfig:
    """Small Dia for unit tests: 2 + 2 layers at width 64, 4 query heads
    over 2 K/V heads, three channels delayed [0, 2, 3]; its codes are
    those of tiny_dac44k_config (32 a codebook, then EOS, PAD, BOS)."""
    return DiaConfig(encoder_n_layer=2, encoder_n_embd=64,
                     encoder_n_hidden=96, encoder_n_head=4,
                     encoder_head_dim=16, decoder_n_layer=2,
                     decoder_n_embd=64, decoder_n_hidden=96,
                     gqa_query_heads=4, kv_heads=2, gqa_head_dim=16,
                     cross_query_heads=4, cross_head_dim=16,
                     tgt_vocab_size=36, text_length=64, audio_length=128,
                     channels=3, audio_eos_value=32, audio_pad_value=33,
                     audio_bos_value=34, delay_pattern=(0, 2, 3))


# Dia's sampler as published (dia/model.py generate(): cfg_scale 3.0,
# temperature 1.3, top_p 0.95, cfg_filter_top_k 35)
DIA_SAMPLER_DEFAULTS = dict(cfg_scale=3.0, temperature=1.3, top_p=0.95,
                            top_k=35)


# Sampler defaults shared by serving and demo layers
# (reference: handler.py:426-443).
SAMPLER_DEFAULTS = dict(
    num_steps=40,
    cfg_scale_text=3.0,
    cfg_scale_speaker=8.0,
    cfg_min_t=0.5,
    cfg_max_t=1.0,
    truncation_factor=None,
    rescale_k=None,
    rescale_sigma=None,
    speaker_kv_scale=None,
    speaker_kv_max_layers=None,
    speaker_kv_min_t=None,
    sequence_length=640,
)

MAX_TEXT_LENGTH = 768            # reference: inference.py:323
MAX_SPEAKER_LATENT_LENGTH = 6400  # reference: inference.py:322
AE_DOWNSAMPLE_FACTOR = 2048       # reference: inference.py:251
