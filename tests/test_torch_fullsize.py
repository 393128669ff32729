"""Full-size confidence for the port without the published weights: the
port's counterpart of tests/test_fullsize_confidence.py, held against the
JAX package where that file holds the JAX package against the reference.

  * Key coverage: the state-dict key names depend on the module structure
    (layer counts, rates, codebooks), not the widths.  The port's state
    dicts of a structure-full DiT (24/14/14 layers) and of a full-rate
    codec, at tiny widths, go through the JAX package's converters under a
    key-tracking dict: the converter reads every key and asks for none
    that is missing.  The JAX package's converters read exactly the
    published checkpoints' keys (tests/test_fullsize_confidence.py), so
    the published checkpoints load whole into the port.
  * Width: a DiT at the published widths (model 2048, 16 heads, inter
    5888, text and speaker encoders 1280) with 2 layers each runs one CFG
    forward in fp32 against the JAX package's dit_forward at the same
    weights (tools/bridge.py), within that file's bounds: MSE < 1e-8, rtol
    5e-3, atol 5e-4 (tests/test_fullsize_confidence.py:160-161).  It is
    built with blockwise=False: the forward reads no latent encoder.
  * tools/check_fullsize.check, the card's bf16-against-fp32 envelope, on
    a tiny bf16 DiT on the CPU (its code path; the card runs it at full
    size).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu import config as jconfig
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.tools.convert import convert_dit_state
from echo_tts_tpu.tools.convert_dac import convert_dac_state

from echo_tts_torch import config as tconfig
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.models.dac.init import init_dac
from echo_tts_torch.tools import bridge, check_fullsize

torch.set_num_threads(2)


class _Tracker(dict):
    """A state dict recording which keys the converter reads."""

    def __init__(self, state):
        super().__init__(state)
        self.accessed = set()

    def __getitem__(self, key):
        self.accessed.add(key)
        return super().__getitem__(key)


def _numpy_state(module):
    return {k: v.detach().float().numpy() for k, v in module.state_dict().items()}


LAYERS = dict(num_layers=24, text_num_layers=14, speaker_num_layers=14)
BLOCKWISE_KEY_MARKERS = ("latent_encoder.", "latent_norm.", ".wk_latent.",
                         ".wv_latent.")


@pytest.fixture(scope="module")
def struct_dit_state():
    """The port's state dict of a structure-full blockwise DiT, tiny widths."""
    cfg = dataclasses.replace(tconfig.tiny_dit_config(), **LAYERS)
    return _numpy_state(tdit.init_dit(cfg, device="cpu", dtype=torch.float32))


@pytest.mark.parametrize("blockwise", [True, False])
def test_dit_state_keys_are_the_checkpoints(struct_dit_state, blockwise):
    """blockwise=True: every key read, none missing; blockwise=False: the
    converter skips exactly the latent encoder's keys (the published
    checkpoint loaded into a model without them)."""
    state = _Tracker(struct_dit_state)
    convert_dit_state(state, dataclasses.replace(
        jconfig.tiny_dit_config(), blockwise=blockwise, **LAYERS))
    assert not state.accessed - set(state)
    skipped = set(state) - state.accessed
    if blockwise:
        assert not skipped, f"keys the converter never reads: {sorted(skipped)}"
    else:
        assert skipped == {k for k in state
                           if any(m in k for m in BLOCKWISE_KEY_MARKERS)}


def test_dac_state_keys_are_the_checkpoints():
    """Full structure (rates, 8-layer quantizer transformers, 9 codebooks,
    the encoder's 4-layer transformer), minimal widths."""
    fields = dict(
        encoder_dim=4, encoder_rates=(2, 4, 8, 8), latent_dim=64,
        decoder_dim=64, decoder_rates=(8, 8, 4, 2),
        encoder_transformer_layers=(0, 0, 0, 4), n_codebooks=9,
        codebook_size=16, codebook_dim=4, semantic_codebook_size=32,
        downsample_factor=(2, 2), quantizer_transformer_layers=8)
    dac = init_dac(tconfig.DACConfig(**fields), device="cpu")
    state = _Tracker(_numpy_state(dac))
    convert_dac_state(state, jconfig.DACConfig(**fields))
    assert not state.accessed - set(state)
    skipped = set(state) - state.accessed
    assert not skipped, f"keys the converter never reads: {sorted(skipped)}"


def test_dit_forward_at_full_width_matches_jax():
    """One CFG-batched forward (b = 1, g = 3, s = 64, 48 text tokens, 16
    speaker latents) at the published widths, fp32, against JAX's."""
    jcfg = dataclasses.replace(jconfig.base_dit_config(blockwise=False),
                               num_layers=2, text_num_layers=2,
                               speaker_num_layers=2, attention_impl="xla")
    tcfg = dataclasses.replace(tconfig.base_dit_config(blockwise=False),
                               num_layers=2, text_num_layers=2,
                               speaker_num_layers=2)
    params = jax.tree.map(np.asarray, jdit.init_dit_params(
        jax.random.PRNGKey(3), jcfg, dtype=jnp.float32))
    model = bridge.load_dit_state(bridge.dit_state_from_jax(params, tcfg),
                                  tcfg, device="cpu", dtype=torch.float32)

    rng = np.random.default_rng(17)
    b, g, s, tt, ts = 1, 3, 64, 48, 16
    x = rng.standard_normal((g * b, s, 80)).astype(np.float32)
    t = rng.uniform(0.1, 0.9, size=(g * b,)).astype(np.float32)
    ids = rng.integers(0, 256, size=(b, tt)).astype(np.int32)
    tmask_b = np.ones((b, tt), bool)
    tmask_b[:, 40:] = False
    spk = rng.standard_normal((b, ts, 80)).astype(np.float32)
    smask_b = np.ones((b, ts), bool)
    # CFG branches [cond, uncond text, uncond speaker]
    tmask = np.concatenate([tmask_b, ~tmask_b, tmask_b], axis=0)
    smask = np.concatenate([smask_b, smask_b, ~smask_b], axis=0)

    want = np.asarray(jax.jit(jdit.dit_forward, static_argnums=1)(
        params, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(tmask),
        jnp.asarray(smask),
        jdit.get_kv_cache_text(params, jcfg, jnp.asarray(ids),
                               jnp.asarray(tmask_b)),
        jdit.get_kv_cache_speaker(params, jcfg, jnp.asarray(spk))))
    del params
    with torch.no_grad():
        got = tdit.dit_forward(
            model, torch.from_numpy(x), torch.from_numpy(t),
            torch.from_numpy(tmask), torch.from_numpy(smask),
            tdit.get_kv_cache_text(model, torch.from_numpy(ids),
                                   torch.from_numpy(tmask_b)),
            tdit.get_kv_cache_speaker(model, torch.from_numpy(spk)))
    assert got.dtype == torch.float32
    got = got.numpy()
    mse = float(np.mean((got - want) ** 2))
    assert mse < 1e-8, f"full-width forward MSE {mse}"
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-4)


def test_check_fullsize_on_a_tiny_dit():
    """The tool's three forwards of a tiny bf16 DiT on the CPU (all
    attention plain here): within the envelope, the report complete."""
    dit = tdit.init_dit(tconfig.tiny_dit_config(), device="cpu",
                        dtype=torch.bfloat16, seed=1)
    report = check_fullsize.check(dit)
    assert report["failures"] == [], report
    assert report["shape"] == [3, 640, 80] and report["dtype"] == "float32"
    assert 0 < report["rel_rms_err"] < check_fullsize.ENVELOPE_REL_RMS
    assert 0 < report["int8_rel_rms_vs_bf16"] < check_fullsize.W8A8_REL_RMS_BOUND
    assert report["launches"] == {"joint_attention": 0, "int8_matmul": 0,
                                  "int8_matmul_partial": 0}
    # the given model is left in bf16
    assert next(dit.parameters()).dtype == torch.bfloat16
