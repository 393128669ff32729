"""The port's S1-DAC codec against the JAX package on the same tiny fp32
weights (tools/bridge.py): encode_zq, decode_zq (exact and polynomial
snake), the delay, PCA, and the weight bridge's round trip.

Bound atol 2e-5 / rtol 1e-4 (tests/test_res_stack_kernel.py:48); codes are
argmax indices and must agree exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.models.dac import dac as jdac
from echo_tts_tpu.tools.convert_dac import convert_dac_state

from echo_tts_torch.config import tiny_dac_config
from echo_tts_torch.models.dac import dac as tdac
from echo_tts_torch.models.dac.init import init_dac
from echo_tts_torch.tools import bridge

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)
CFG = tiny_dac_config()
# the JAX side runs jitted, as its pipeline does (pipeline.py:51-68); op by
# op it takes seconds a call on the CPU
_j_encode_codes = jax.jit(jdac.encode_codes, static_argnums=1)
_j_encode_zq = jax.jit(jdac.encode_zq, static_argnums=1)
_j_decode_zq = jax.jit(jdac.decode_zq, static_argnums=1)


@pytest.fixture(scope="module")
def pair(tiny_models):
    params = jax.tree.map(np.asarray, tiny_models.dac_params)
    state = bridge.dac_state_from_jax(params, CFG)
    return tiny_models, state


def _port(state, cfg=CFG):
    return bridge.load_dac_state(state, cfg, device="cpu")


def test_bridge_round_trip(pair):
    jm, state = pair
    back = convert_dac_state(state, jm.dac_cfg)
    for a, b in zip(jax.tree.leaves(jm.dac_params), jax.tree.leaves(back)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert set(state) == set(_port(state).state_dict())


def test_encode_codes_and_zq(pair):
    jm, state = pair
    model = _port(state)
    rng = np.random.default_rng(0)
    # not a frame_length multiple: the encoder right-pads
    audio = np.tanh(rng.standard_normal((1, 8 * CFG.frame_length + 5, 1))
                    ).astype(np.float32)
    with torch.no_grad():
        codes = tdac.encode_codes(model, torch.from_numpy(audio))
        zq = tdac.encode_zq(model, torch.from_numpy(audio))
    jcodes = _j_encode_codes(jm.dac_params, jm.dac_cfg, jnp.asarray(audio))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    want = _j_encode_zq(jm.dac_params, jm.dac_cfg, jnp.asarray(audio))
    assert zq.shape == (1, 9, CFG.latent_dim)
    np.testing.assert_allclose(zq.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("approx", [False, True])
def test_decode_zq(pair, approx):
    jm, state = pair
    cfg = dataclasses.replace(CFG, snake_approx=approx)
    model = _port(state, cfg)
    rng = np.random.default_rng(1)
    z_q = rng.standard_normal((1, 16, CFG.latent_dim)).astype(np.float32)
    with torch.no_grad():
        got = tdac.decode_zq(model, torch.from_numpy(z_q))
    want = _j_decode_zq(jm.dac_params,
                        dataclasses.replace(jm.dac_cfg, snake_approx=approx),
                        jnp.asarray(z_q))
    assert got.shape == (1, 16 * CFG.frame_length, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_codes_are_clamped(pair):
    jm, state = pair
    model = _port(state)
    codes = np.array([[[0, 5000, -3]] + [[1, 999, 7]] * CFG.n_codebooks],
                     dtype=np.int64)
    with torch.no_grad():
        got = tdac.zq_from_codes(model.quantizer, CFG, torch.from_numpy(codes))
    want = jdac.zq_from_codes(jm.dac_params["quantizer"], jm.dac_cfg,
                              jnp.asarray(codes.astype(np.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_delay_and_pca(pair):
    jm, _ = pair
    from echo_tts_tpu.config import base_dac_config as j_base
    from echo_tts_torch.config import base_dac_config
    assert tdac.get_delay(base_dac_config()) == jdac.get_delay(j_base())
    assert tdac.get_delay(CFG) == jdac.get_delay(jm.dac_cfg)
    pca = bridge.pca_state(jax.tree.map(np.asarray, jm.pca), device="cpu")
    rng = np.random.default_rng(2)
    z = rng.standard_normal((1, 5, CFG.latent_dim)).astype(np.float32)
    lat = tdac.pca_whiten(torch.from_numpy(z), pca)
    np.testing.assert_allclose(lat.numpy(), np.asarray(jdac.pca_whiten(
        jnp.asarray(z), jm.pca)), **TOL)
    np.testing.assert_allclose(
        tdac.pca_unwhiten(lat, pca).numpy(),
        np.asarray(jdac.pca_unwhiten(jnp.asarray(lat.numpy()), jm.pca)), **TOL)


def test_random_init_is_seeded_and_folds_to_w():
    a = init_dac(CFG, device="cpu", seed=5)
    b = init_dac(CFG, device="cpu", seed=5)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    conv = a.decoder.model[0].conv
    w = conv.parametrizations["weight"].original1
    torch.testing.assert_close(conv.torch_weight(), w, rtol=1e-6, atol=1e-7)


def test_decode_codes_and_length_plumbing(pair):
    """decode_codes (the lookup, then decode_zq) and encode_/
    decode_with_lengths against the JAX package: the same codes and
    lengths, the same audio."""
    jm, state = pair
    model = _port(state)
    rng = np.random.default_rng(3)
    audio = np.tanh(rng.standard_normal((2, 6 * CFG.frame_length + 9, 1))
                    ).astype(np.float32)
    lens = np.array([6 * CFG.frame_length + 9, 3 * CFG.frame_length - 1],
                    np.int32)
    with torch.no_grad():
        codes, ilens = tdac.encode_with_lengths(model, torch.from_numpy(audio),
                                                torch.from_numpy(lens))
        _, full = tdac.encode_with_lengths(model, torch.from_numpy(audio))
        got, alens = tdac.decode_with_lengths(model, codes, ilens)
        direct = tdac.decode_codes(model, codes)
    jcodes, jlens = jdac.encode_with_lengths(jm.dac_params, jm.dac_cfg,
                                             jnp.asarray(audio),
                                             jnp.asarray(lens))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(ilens.numpy(), np.asarray(jlens))
    assert ilens.dtype == torch.int32 and ilens.tolist() == [7, 3]
    assert full.tolist() == [7, 7]
    want, jalens = jdac.decode_with_lengths(jm.dac_params, jm.dac_cfg,
                                            jcodes, jlens)
    np.testing.assert_array_equal(alens.numpy(), np.asarray(jalens))
    assert got.shape == (2, codes.shape[-1] * CFG.frame_length, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(direct, got, rtol=0, atol=0)
