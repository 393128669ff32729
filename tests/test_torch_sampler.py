"""The port's Euler CFG sampler against the JAX sampler on the same tiny
fp32 weights and the same injected initial noise (made with numpy).

Bound atol 1e-4 / rtol 1e-3: the per-forward error (2e-5 / 1e-4) grows
over the steps, and the CFG combination multiplies branch differences by
up to 1 + 3 + 8.

The int8 modes hold the same bound on fixed inputs.  int8 static K/V are
quantized once, and no K/V value sat within the frameworks' fp32
differences (~1e-7 relative) of a rounding tie.  The W8A8 DiT quantizes
every activation row on every step, so on most inputs some value does sit
that close, the two samplers round it one int8 step apart, and the CFG
steps carry the difference on: on 7 of the 9 other seeds tried (0-9) one
such flip moved the latents by up to 5.6e-2 max-abs (8.3e-3 relative
norm).  The W8A8 cases therefore run on inputs (seed 0; seed 5 with the
speaker-KV scale) where no flip occurs, so the bound checks that the port
takes every one of JAX's int8 decisions over the six steps;
tests/test_torch_dit.py holds one W8A8 forward on identical inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.config import tiny_dit_config as j_tiny_dit_config
from echo_tts_tpu.ops import quant as jq
from echo_tts_tpu.sampler.euler import (
    build_step_plan as j_plan,
    sample_euler_cfg_independent_guidances as j_sample)

from echo_tts_torch.config import tiny_dit_config
from echo_tts_torch.sampler.euler import (
    _segments, build_step_plan, sample_euler_cfg_independent_guidances)
from echo_tts_torch.tools import bridge

torch.set_num_threads(1)
CFG = tiny_dit_config()
CFG_J = j_tiny_dit_config()
BASE = dict(num_steps=6, cfg_scale_text=3.0, cfg_scale_speaker=8.0,
            cfg_min_t=0.5, cfg_max_t=1.0)


@pytest.fixture(scope="module")
def pair(tiny_models):
    params = jax.tree.map(np.asarray, tiny_models.dit_params)
    model = bridge.load_dit_state(bridge.dit_state_from_jax(params, CFG), CFG,
                                  device="cpu", dtype=torch.float32)
    return tiny_models.dit_params, model


@pytest.fixture(scope="module")
def quantized_pair(tiny_models):
    """The W8A8 DiT: the JAX package's quantize_dit_params, bridged."""
    qparams = jq.quantize_dit_params(tiny_models.dit_params)
    model = bridge.load_dit_state(
        bridge.dit_state_from_jax(jax.tree.map(np.asarray, qparams), CFG),
        CFG, device="cpu", dtype=torch.float32)
    return qparams, model


@pytest.mark.parametrize("kw", [
    {},                                                        # default
    dict(truncation_factor=0.8, rescale_k=1.2, rescale_sigma=3.0),
    dict(cfg_min_t=0.6, cfg_max_t=0.9, num_steps=8,            # CFG window
         speaker_kv_scale=1.5, speaker_kv_max_layers=1,       # inside, KV
         speaker_kv_min_t=0.4),                                # scale crossing
    dict(kv_quant=True),                                       # int8 K/V
    dict(kv_quant=True, quantized=True, seed=0),               # + W8A8
    dict(kv_quant=True, quantized=True, seed=5, speaker_kv_scale=1.5,
         speaker_kv_max_layers=1, speaker_kv_min_t=0.4),
], ids=["default", "truncation_rescale", "window_and_kv_scale", "kv8",
        "w8a8_kv8", "w8a8_kv8_kv_scale"])
def test_sampler_matches_jax(request, kw):
    kw = dict(BASE, **kw)
    params, model = request.getfixturevalue(
        "quantized_pair" if kw.pop("quantized", False) else "pair")
    rng = np.random.default_rng(kw.pop("seed", len(kw)))
    b, seq = 1, 16
    ids = rng.integers(0, 256, (b, 11)).astype(np.int32)
    tmask = np.ones((b, 11), bool)
    tmask[:, 9:] = False
    spk = rng.standard_normal((b, 8, 80)).astype(np.float32)
    smask = np.ones((b, 8), bool)
    noise = rng.standard_normal((b, seq, 80)).astype(np.float32)

    want = j_sample(params, CFG_J, jnp.asarray(spk),
                    jnp.asarray(smask), jnp.asarray(ids), jnp.asarray(tmask),
                    sequence_length=seq, dtype=jnp.float32,
                    initial_noise=jnp.asarray(noise), **kw)
    got = sample_euler_cfg_independent_guidances(
        model, torch.from_numpy(spk), torch.from_numpy(smask),
        torch.from_numpy(ids), torch.from_numpy(tmask), sequence_length=seq,
        dtype=torch.float32, initial_noise=torch.from_numpy(noise), **kw)
    assert got.dtype == torch.float32 and got.shape == (b, seq, 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)


def test_step_plan_is_the_jax_plan():
    args = (9, 0.6, 0.9, 1.2, 3.0, 1.5, 0.4)
    for got, want in zip(build_step_plan(*args), j_plan(*args)):
        np.testing.assert_array_equal(got, want)
    plan = build_step_plan(*args)
    segs = _segments(plan.has_cfg)
    assert [s[0] for s in segs] == [False, True, False]
    assert segs[-1][2] == 9


def test_noise_needs_a_source(pair):
    model = pair[1]
    z = torch.zeros((1, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="initial_noise or generator"):
        sample_euler_cfg_independent_guidances(
            model, torch.zeros((1, 4, 80)), z, torch.zeros((1, 4), dtype=torch.int32),
            z, **BASE)
