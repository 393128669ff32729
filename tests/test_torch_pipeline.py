"""The port's one-shot pipeline against the JAX package's on the same tiny
fp32 weights (tools/bridge.py), with the same numpy starting noise injected
into both samplers; the directory loader; and the port's entry points,
which refuse to run without a CUDA device unless device="cpu" is passed.

Bound atol 1e-4 / rtol 1e-3 on the audio: the sampler's bound
(tests/test_torch_sampler.py; the per-forward 2e-5 / 1e-4 grows over the
steps), through a codec that adds only its own few-ulp error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.pipeline import pipeline as jpl
from echo_tts_tpu.sampler.euler import (
    sample_euler_cfg_independent_guidances as j_sample)

from echo_tts_torch.config import tiny_dac_config, tiny_dit_config
from echo_tts_torch.models.dac.init import init_dac, init_pca_params
from echo_tts_torch.models.dit import init_dit
from echo_tts_torch.ops import cuda_build
from echo_tts_torch.pipeline import pipeline as tpl
from echo_tts_torch.sampler.euler import sample_euler_cfg_independent_guidances
from echo_tts_torch.tools import bridge

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-3)
DIT_CFG, DAC_CFG = tiny_dit_config(), tiny_dac_config()
SEQ = 16
KW = dict(num_steps=4, cfg_scale_text=3.0, cfg_scale_speaker=8.0,
          cfg_min_t=0.5, cfg_max_t=1.0, sequence_length=SEQ)
TEXT = "Hello there. This is the port."
# two chunks at max_chars_per_chunk=40
LONG_TEXT = "The first sentence is short. The second one is a bit longer."


def _noise(seed: int) -> np.ndarray:
    rng = np.random.default_rng(1000 + seed)
    return rng.standard_normal((1, SEQ, DIT_CFG.latent_size)).astype(np.float32)


def _j_sample_fn(models, spk, smask, ids, tmask, seed, **kw):
    return j_sample(models.dit_params, models.dit_cfg, spk, smask, ids, tmask,
                    dtype=jnp.float32, initial_noise=jnp.asarray(_noise(seed)),
                    **KW, **kw)


def _t_sample_fn(models, spk, smask, ids, tmask, seed, **kw):
    return sample_euler_cfg_independent_guidances(
        models.dit, spk, smask, ids, tmask, dtype=torch.float32,
        initial_noise=torch.from_numpy(_noise(seed)), **KW, **kw)


def _states(jm):
    return (bridge.dit_state_from_jax(jax.tree.map(np.asarray, jm.dit_params),
                                      DIT_CFG),
            bridge.dac_state_from_jax(jax.tree.map(np.asarray, jm.dac_params),
                                      DAC_CFG))


@pytest.fixture(scope="module")
def pair(tiny_models):
    dit_state, dac_state = _states(tiny_models)
    port = tpl.EchoModels(
        dit=bridge.load_dit_state(dit_state, DIT_CFG, device="cpu",
                                  dtype=torch.float32),
        dac=bridge.load_dac_state(dac_state, DAC_CFG, device="cpu"),
        pca=bridge.pca_state(jax.tree.map(np.asarray, tiny_models.pca),
                             device="cpu"),
        dtype=torch.float32)
    return tiny_models, port


def _voice(n: int = 30000) -> np.ndarray:
    """A speaker reference longer than one 640-latent encode chunk."""
    rng = np.random.default_rng(7)
    return np.tanh(0.3 * rng.standard_normal((1, n))).astype(np.float32)


@pytest.mark.parametrize("case", ["no_speaker", "speaker", "chunked"])
def test_pipeline_matches_jax(pair, case):
    jm, port = pair
    voice = None if case == "no_speaker" else _voice()
    if case == "chunked":
        kw = dict(max_chars_per_chunk=40)
        want, want_txt = jpl.sample_pipeline_chunked(
            jm, _j_sample_fn, LONG_TEXT, voice, 3, **kw)
        got, got_txt = tpl.sample_pipeline_chunked(
            port, _t_sample_fn, LONG_TEXT, voice, 3, **kw)
        assert got_txt.count("\n") == 1
    else:
        want, want_txt = jpl.sample_pipeline(jm, _j_sample_fn, TEXT, voice, 5)
        got, got_txt = tpl.sample_pipeline(port, _t_sample_fn, TEXT, voice, 5)
    assert got_txt == want_txt
    assert got.shape == want.shape and got.shape[1] > 0
    np.testing.assert_allclose(got, want, **TOL)


def test_pipeline_w8a8_kv8_matches_jax(tiny_models):
    """sample_pipeline with the W8A8 DiT (the JAX package's
    quantize_dit_params, bridged) and kv_quant=True in the sample_fn, on
    inputs where the two frameworks take the same int8 decisions (see
    tests/test_torch_sampler.py), against the JAX pipeline."""
    import dataclasses
    import functools

    from echo_tts_tpu.ops import quant as jq

    jm = dataclasses.replace(
        tiny_models, dit_params=jq.quantize_dit_params(tiny_models.dit_params))
    dit_state, dac_state = _states(jm)
    port = tpl.EchoModels(
        dit=bridge.load_dit_state(dit_state, DIT_CFG, device="cpu",
                                  dtype=torch.float32),
        dac=bridge.load_dac_state(dac_state, DAC_CFG, device="cpu"),
        pca=bridge.pca_state(jax.tree.map(np.asarray, jm.pca), device="cpu"),
        dtype=torch.float32)
    want, _ = jpl.sample_pipeline(
        jm, functools.partial(_j_sample_fn, kv_quant=True), TEXT, None, 0)
    got, _ = tpl.sample_pipeline(
        port, functools.partial(_t_sample_fn, kv_quant=True), TEXT, None, 0)
    assert got.shape == want.shape and got.shape[1] > 0
    np.testing.assert_allclose(got, want, **TOL)


def test_speaker_latent_matches_jax(pair):
    """Chunked AE encode of the reference, PCA-whitened, cropped to a
    patch multiple, with the true-length mask."""
    jm, port = pair
    voice = _voice()
    lat, mask = tpl.get_speaker_latent_and_mask(port, voice)
    jlat, jmask = jpl.get_speaker_latent_and_mask(jm, voice)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_allclose(lat, jlat, atol=2e-5, rtol=1e-4)


def test_load_models_from_dir(tiny_models, tmp_path):
    """The published file layout, written by the bridge, loads under its
    own keys and gives the modules the bridge's state."""
    from safetensors.numpy import save_file

    dit_state, dac_state = _states(tiny_models)
    save_file(dit_state, str(tmp_path / tpl.DIT_WEIGHTS))
    save_file(dac_state, str(tmp_path / tpl.DAC_WEIGHTS))
    pca = jax.tree.map(np.asarray, tiny_models.pca)
    save_file({"pca_components": pca["components"], "pca_mean": pca["mean"],
               "latent_scale": np.asarray([pca["latent_scale"]], np.float32)},
              str(tmp_path / tpl.PCA_WEIGHTS))
    models = tpl.load_models_from_dir(str(tmp_path), device="cpu",
                                      dtype=torch.float32, dit_cfg=DIT_CFG,
                                      dac_cfg=DAC_CFG)
    for module, state in ((models.dit, dit_state), (models.dac, dac_state)):
        got = module.state_dict()
        assert set(got) == set(state)
        for k, v in state.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    np.testing.assert_array_equal(models.pca["components"].numpy(),
                                  pca["components"])
    assert models.pca["latent_scale"] == float(pca["latent_scale"])
    assert next(models.dac.parameters()).dtype == torch.float32


def test_random_models_on_cpu_runs_end_to_end():
    """random_models(device='cpu') is the fp32, exact-sin codec; the whole
    path runs through the kernels' plain versions."""
    models = tpl.random_models(device="cpu", dtype=torch.float32,
                               dit_cfg=DIT_CFG, dac_cfg=DAC_CFG)
    assert not models.dac_cfg.snake_approx
    audio, _ = tpl.sample_pipeline(models, _t_sample_fn, TEXT, None, 0)
    assert audio.ndim == 2 and audio.shape[1] > 0 and np.isfinite(audio).all()


@pytest.mark.parametrize("entry", [
    lambda: tpl.random_models(dit_cfg=DIT_CFG, dac_cfg=DAC_CFG),
    lambda: tpl.load_models_from_dir("/nonexistent"),
    lambda: init_dit(DIT_CFG),
    lambda: init_dac(DAC_CFG),
    lambda: init_pca_params(),
    lambda: bridge.load_dit_state({}, DIT_CFG),
    lambda: bridge.pca_state({}),
    lambda: cuda_build.build(),
], ids=["random_models", "load_models_from_dir", "init_dit", "init_dac",
        "init_pca_params", "load_dit_state", "pca_state", "kernel_build"])
def test_entry_points_refuse_the_cpu_by_default(entry):
    """Every entry point defaults to the card and raises without one; it
    never runs on the CPU unless asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="(?i)cuda"):
        entry()


def test_ae_reconstruct_matches_jax(pair):
    """The debug round trip, ae_decode(ae_encode(audio)), against the JAX
    package's."""
    jm, port = pair
    audio = _voice(9 * DAC_CFG.frame_length + 11)
    got = tpl.ae_reconstruct(port, torch.from_numpy(audio))
    want = jpl.ae_reconstruct(jm, jnp.asarray(audio))
    assert got.shape == (1, 10 * DAC_CFG.frame_length) == tuple(want.shape)
    # the codec's bound (tests/test_torch_dac.py): no sampler in the loop
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)
