"""The port's micro-batch pass (serve/batcher.py) against the JAX package's
run_batch on the same tiny fp32 weights (tools/bridge.py), with the same
numpy starting noise injected into both (the JAX side through its
`_draw_noise`, the port's through `initial_noise`); and, in the port,
batched against single requests, negative and 64-bit seeds, and the
speaker bucket.

Bound atol 1e-4 / rtol 1e-3 on the audio, the sampler's bound
(tests/test_torch_pipeline.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.serve import batcher as jb

from echo_tts_torch.config import tiny_dac_config, tiny_dit_config
from echo_tts_torch.pipeline import pipeline as tpl
from echo_tts_torch.serve import batcher as tb
from echo_tts_torch.serve.handler import build_sample_fn
from echo_tts_torch.tools import bridge

torch.set_num_threads(1)
TOL = dict(atol=1e-4, rtol=1e-3)
DIT_CFG, DAC_CFG = tiny_dit_config(), tiny_dac_config()
FAST = {"num_steps": 2, "sequence_length": 8}


@pytest.fixture(scope="module")
def pair(tiny_models):
    jm = tiny_models
    port = tpl.EchoModels(
        dit=bridge.load_dit_state(
            bridge.dit_state_from_jax(jax.tree.map(np.asarray, jm.dit_params),
                                      DIT_CFG),
            DIT_CFG, device="cpu", dtype=torch.float32),
        dac=bridge.load_dac_state(
            bridge.dac_state_from_jax(jax.tree.map(np.asarray, jm.dac_params),
                                      DAC_CFG),
            DAC_CFG, device="cpu"),
        pca=bridge.pca_state(jax.tree.map(np.asarray, jm.pca), device="cpu"),
        dtype=torch.float32)
    return jm, port


def _speaker(seed: int, n: int = 400) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.tanh(rng.standard_normal((1, n))).astype(np.float32)


def test_group_compatible_splits_by_params_and_size():
    reqs = [(tb.BatchRequest("a", 0), {"num_steps": 2}),
            (tb.BatchRequest("b", 1), {"num_steps": 2}),
            (tb.BatchRequest("c", 2), {"num_steps": 4}),
            (tb.BatchRequest("d", 3), {"num_steps": 2}),
            (tb.BatchRequest("e", 4), {"num_steps": 2})]
    groups = tb.group_compatible(reqs, max_batch=2)
    assert groups == jb.group_compatible(
        [(jb.BatchRequest(r.text, r.seed), p) for r, p in reqs], max_batch=2)
    assert sorted(len(g) for g in groups) == [1, 2, 2]
    assert [2] in [sorted(g) for g in groups]


def test_run_batch_matches_jax(pair, monkeypatch):
    """Three requests (no speaker, speaker audio, a pre-encoded latent with
    a padded mask) in one pass through both packages, same injected
    noise."""
    jm, port = pair
    rng = np.random.default_rng(3)
    noise = rng.standard_normal((3, 8, DIT_CFG.latent_size)).astype(np.float32)
    monkeypatch.setattr(jb, "_draw_noise", lambda cfg, n: (
        lambda key_data: jnp.asarray(noise)))
    lat, mask = tpl.get_speaker_latent_and_mask(port, _speaker(8, 300))
    lat = np.pad(lat, ((0, 0), (0, 4), (0, 0)))
    mask = np.pad(mask, ((0, 0), (0, 4)))

    def reqs(mod):
        return [mod.BatchRequest("First batched utterance.", 11, request_id="a"),
                mod.BatchRequest("Second one with a voice.", 22,
                                 speaker_audio=_speaker(0), request_id="b"),
                mod.BatchRequest("Third, a cached voice.", 33,
                                 speaker_latent=lat, speaker_mask=mask,
                                 request_id="c")]

    want = jb.run_batch(jm, reqs(jb), FAST)
    got = tb.run_batch(port, reqs(tb), FAST,
                       initial_noise=torch.from_numpy(noise))
    assert [r.request_id for r in got] == ["a", "b", "c"]
    for g, w in zip(got, want):
        assert g.normalized_text == w.normalized_text
        assert g.audio.shape == w.audio.shape and g.audio.shape[1] > 0
        np.testing.assert_allclose(g.audio, np.asarray(w.audio), **TOL)


def test_run_batch_decodes_in_slices_and_matches_jax(pair, monkeypatch):
    """Five requests with decode_batch=2: three decode slices (the last
    ragged), the JAX package's result."""
    jm, port = pair
    noise = np.random.default_rng(4).standard_normal(
        (5, 8, DIT_CFG.latent_size)).astype(np.float32)
    monkeypatch.setattr(jb, "_draw_noise", lambda cfg, n: (
        lambda key_data: jnp.asarray(noise)))
    texts = [f"Request number {i}." for i in range(5)]
    calls = []
    real = tb.ae_decode
    monkeypatch.setattr(tb, "ae_decode", lambda m, lat: calls.append(
        lat.shape[0]) or real(m, lat))
    want = jb.run_batch(jm, [jb.BatchRequest(t, i) for i, t in
                             enumerate(texts)], FAST, decode_batch=2)
    got = tb.run_batch(port, [tb.BatchRequest(t, i) for i, t in
                              enumerate(texts)], FAST, decode_batch=2,
                       initial_noise=torch.from_numpy(noise))
    assert calls == [2, 2, 1]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.audio, np.asarray(w.audio), **TOL)


def test_batched_equals_single(pair):
    """Each request of a batch gives the audio it gives alone through
    sample_pipeline with the handler's sample_fn (same seed, so the same
    noise; the single run pads its speaker to the batch's bucket)."""
    _, port = pair
    spk = _speaker(0)
    reqs = [tb.BatchRequest("First batched utterance.", seed=11),
            tb.BatchRequest("Second one with a voice.", seed=22,
                            speaker_audio=spk),
            tb.BatchRequest("Third, default voice.", seed=33)]
    got = tb.run_batch(port, reqs, FAST)
    ps = DIT_CFG.speaker_patch_size
    bucket = -(-tpl.get_speaker_latent_and_mask(port, spk)[0].shape[1] // ps) * ps
    fn, _ = build_sample_fn(FAST)
    for g, r in zip(got, reqs):
        want, norm = tpl.sample_pipeline(
            port, fn, r.text, r.speaker_audio, r.seed,
            pad_to_max_speaker_latent_length=bucket)
        assert g.normalized_text == norm
        np.testing.assert_allclose(g.audio, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("seed", [-1, -(2 ** 40), 2 ** 40 + 17, 2 ** 63 + 5])
def test_negative_and_64bit_seeds(pair, monkeypatch, seed):
    """The batch's noise row for any 64-bit seed, negative ones included,
    is the single request's draw bit for bit, and the audio is the single
    request's."""
    _, port = pair
    seen = []
    real = tb.sample_euler_cfg_independent_guidances
    monkeypatch.setattr(tb, "sample_euler_cfg_independent_guidances",
                        lambda *a, **k: seen.append(k["initial_noise"])
                        or real(*a, **k))
    got = tb.run_batch(port, [tb.BatchRequest("Seed edge.", seed=0),
                              tb.BatchRequest("Seed edge.", seed=seed)], FAST)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    single = torch.randn((1, 8, DIT_CFG.latent_size), generator=gen)
    assert torch.equal(seen[0][1:], single)
    assert torch.equal(tb.draw_noise([seed], 8, DIT_CFG.latent_size, "cpu"),
                       single)
    fn, _ = build_sample_fn(FAST)
    want, _ = tpl.sample_pipeline(port, fn, "Seed edge.", None, seed)
    np.testing.assert_allclose(got[1].audio, want, atol=2e-5, rtol=1e-4)


def test_speaker_latent_or_audio_not_both(pair):
    _, port = pair
    spk = _speaker(7)
    lat, _ = tpl.get_speaker_latent_and_mask(port, spk)
    via_audio = tb.run_batch(port, [tb.BatchRequest("Latent injection.", 5,
                                                    speaker_audio=spk)], FAST)
    via_latent = tb.run_batch(port, [tb.BatchRequest("Latent injection.", 5,
                                                     speaker_latent=lat)], FAST)
    np.testing.assert_allclose(via_latent[0].audio, via_audio[0].audio,
                               atol=2e-5)
    with pytest.raises(ValueError, match="not both"):
        tb.run_batch(port, [tb.BatchRequest("x", 0, speaker_audio=spk,
                                            speaker_latent=lat)], FAST)


def test_speaker_bucket_too_small_raises(pair):
    _, port = pair
    with pytest.raises(ValueError, match="speaker_bucket"):
        tb.run_batch(port, [tb.BatchRequest("x", 0,
                                            speaker_audio=_speaker(1, 800))],
                     FAST, speaker_bucket=4)


def test_injected_noise_shape_checked_and_empty_batch(pair):
    _, port = pair
    assert tb.run_batch(port, [], FAST) == []
    with pytest.raises(ValueError, match="initial_noise"):
        tb.run_batch(port, [tb.BatchRequest("x", 0)], FAST,
                     initial_noise=torch.zeros((2, 8, DIT_CFG.latent_size)))
