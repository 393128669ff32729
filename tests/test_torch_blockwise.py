"""The port's latent prefix (models/dit.py) and blockwise sampler
(sampler/blockwise.py) against the JAX package on the same tiny fp32
weights (tools/bridge.py), with the same per-block numpy noise injected
into both samplers.

Bounds: atol 2e-5 / rtol 1e-4 for the prefix pieces (the JAX suite's
per-op bound, tests/test_pallas_attention.py:80); 1e-5 / 1e-4 for the
incremental prefix against JAX's state and the full re-encode (the JAX
suite's, tests/test_blockwise_parity.py:158); atol 1e-4 / rtol 1e-3 for
sampler latents (tests/test_torch_sampler.py: the per-forward error grows
over the steps and the CFG combination).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.sampler.blockwise import (
    sample_blockwise_euler_cfg_independent_guidances as j_blockwise)
from echo_tts_tpu.sampler.euler import make_cfg_branch_masks as j_masks

from echo_tts_torch.config import tiny_dit_config
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.sampler.blockwise import (
    sample_blockwise_euler_cfg_independent_guidances as t_blockwise)
from echo_tts_torch.sampler.euler import make_cfg_branch_masks as t_masks
from echo_tts_torch.tools import bridge

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)
CFG = tiny_dit_config()
PS = CFG.speaker_patch_size
BASE = dict(num_steps=4, cfg_scale_text=3.0, cfg_scale_speaker=5.0,
            cfg_min_t=0.5, cfg_max_t=1.0, truncation_factor=0.8)
_j_kv_latent = jax.jit(jdit.get_kv_cache_latent, static_argnums=1)
_j_append = jax.jit(jdit.latent_kv_append_block, static_argnums=1)


@pytest.fixture(scope="module")
def pair(tiny_models):
    params = jax.tree.map(np.asarray, tiny_models.dit_params)
    model = bridge.load_dit_state(bridge.dit_state_from_jax(params, CFG), CFG,
                                  device="cpu", dtype=torch.float32)
    return tiny_models.dit_params, tiny_models.dit_cfg, model


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _conditioning(rng, b=1):
    ids = rng.integers(0, 256, (b, 10)).astype(np.int32)
    tmask = np.ones((b, 10), bool)
    tmask[:, 8:] = False
    spk = rng.standard_normal((b, 8, 80)).astype(np.float32)
    smask = np.ones((b, 8), bool)
    return ids, tmask, spk, smask


def test_latent_kv_cache_matches_jax(pair):
    params, jcfg, model = pair
    prefix = np.random.default_rng(1).standard_normal((2, 16, 80)).astype(np.float32)
    want = _j_kv_latent(params, jcfg, jnp.asarray(prefix))
    with torch.inference_mode():
        got = tdit.get_kv_cache_latent(model, _t(prefix))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (CFG.num_layers, 2, 16 // PS,
                                      CFG.num_heads, CFG.head_dim)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("start_pos", [0, 5, 8, 9, 40])
def test_latent_prefix_mask_matches_jax(start_pos):
    want = jdit.latent_prefix_mask(3, 10, start_pos, PS)
    got = tdit.latent_prefix_mask(3, 10, start_pos, PS, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_three_segment_static_kv_and_masks_match_jax():
    """[latent, text, speaker]: the K/V order, the speaker columns, the
    per-branch masks with the latent mask repeated for all three CFG
    branches; the two-segment calls are unchanged."""
    rng = np.random.default_rng(2)

    def kv(t):
        return tuple(rng.standard_normal((2, 1, t, 4, 16)).astype(np.float32)
                     for _ in range(2))

    kv_lat, kv_text, kv_spk = kv(4), kv(10), kv(2)
    tmask = rng.random((1, 10)) > 0.3
    smask = rng.random((1, 8)) > 0.3
    lmask = tdit.latent_prefix_mask(1, 4, 9, PS, device="cpu")
    for latent in (None, kv_lat):
        jkv, jcols = jdit.concat_static_kv(
            CFG, *(tuple(map(jnp.asarray, x)) for x in (kv_text, kv_spk)),
            None if latent is None else tuple(map(jnp.asarray, latent)))
        (k, v), cols = tdit.concat_static_kv(
            *(tuple(map(_t, x)) for x in (kv_text, kv_spk)),
            None if latent is None else tuple(map(_t, latent)))
        np.testing.assert_array_equal(k.numpy(), np.asarray(jkv[0]))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jkv[1]))
        np.testing.assert_array_equal(cols.numpy(), np.asarray(jcols))
        lm = None if latent is None else lmask
        want = j_masks(CFG, jnp.asarray(tmask), jnp.asarray(smask),
                       None if lm is None else jnp.asarray(lm.numpy()))
        got = t_masks(CFG, _t(tmask), _t(smask), lm)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[0].shape == (3, (4 if latent else 0) + 10 + 2)


def test_latent_kv_append_chained_matches_jax_and_reencode(pair):
    """Blocks of 8, 4 and 4 latents appended in turn: the state equals
    JAX's after each block, and the final DiT latent K/V equal the port's
    own full re-encode of the prefix."""
    params, jcfg, model = pair
    prefix = np.random.default_rng(21).standard_normal((1, 16, 80)).astype(np.float32)
    jstate = jdit.init_latent_inc_state(jcfg, 1, 16 // PS, jnp.float32)
    state = tdit.init_latent_inc_state(CFG, 1, 16 // PS, torch.float32, "cpu")
    with torch.inference_mode():
        for start, size in ((0, 8), (8, 4), (12, 4)):
            block = prefix[:, start:start + size]
            jstate = _j_append(params, jcfg, jstate, jnp.asarray(block))
            assert tdit.latent_kv_append_block(model, state, _t(block)) is state
            assert state["pos"] == int(jstate["pos"])
            for key in ("enc_k", "enc_v", "lat_k", "lat_v"):
                np.testing.assert_allclose(state[key].numpy(),
                                           np.asarray(jstate[key]),
                                           atol=1e-5, rtol=1e-4)
        full = tdit.get_kv_cache_latent(model, _t(prefix))
    np.testing.assert_allclose(state["lat_k"].numpy(), full[0].numpy(),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(state["lat_v"].numpy(), full[1].numpy(),
                               atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="divisible"):
        tdit.latent_kv_append_block(model, state, torch.zeros((1, 6, 80)))


@pytest.mark.parametrize("case", [
    dict(blocks=[8, 8, 4]),                                     # basic
    dict(blocks=[8, 4], speaker_kv_scale=1.5, speaker_kv_max_layers=1,
         speaker_kv_min_t=0.6, truncation_factor=None),
    dict(blocks=[4, 8, 12]),                                    # uneven
    dict(blocks=[8, 4], continuation=8),
    dict(blocks=[8, 8, 4], incremental_latent=True),
], ids=["basic", "speaker_kv_scale", "uneven", "continuation", "incremental"])
def test_blockwise_matches_jax(pair, case):
    params, jcfg, model = pair
    case = dict(case)
    blocks = case.pop("blocks")
    cont_len = case.pop("continuation", 0)
    rng = np.random.default_rng(sum(blocks) + cont_len)
    ids, tmask, spk, smask = _conditioning(rng)
    noises = [rng.standard_normal((1, b, 80)).astype(np.float32)
              for b in blocks]
    cont = (None if not cont_len else
            rng.standard_normal((1, cont_len, 80)).astype(np.float32))
    kw = dict(BASE, **case)
    want = j_blockwise(
        params, jcfg, jnp.asarray(spk), jnp.asarray(smask), jnp.asarray(ids),
        jnp.asarray(tmask), block_sizes=blocks, dtype=jnp.float32,
        initial_noises=[jnp.asarray(n) for n in noises],
        continuation_latent=None if cont is None else jnp.asarray(cont), **kw)
    got = t_blockwise(
        model, _t(spk), _t(smask), _t(ids), _t(tmask), block_sizes=blocks,
        dtype=torch.float32, initial_noises=[_t(n) for n in noises],
        continuation_latent=None if cont is None else _t(cont), **kw)
    assert got.dtype == torch.float32
    assert got.shape == (1, cont_len + sum(blocks), 80)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-3)
    if cont is not None:
        np.testing.assert_allclose(got[:, :cont_len].numpy(), cont, atol=1e-6)


def test_sampler_refuses_bad_calls(pair):
    """The sampler refuses a total off the patch grid, non-patch blocks in
    incremental mode, and a call with no noise source."""
    _, _, model = pair
    rng = np.random.default_rng(31)
    ids, tmask, spk, smask = _conditioning(rng)
    noises = [_t(rng.standard_normal((1, b, 80)).astype(np.float32))
              for b in (8, 8, 4)]
    args = (model, _t(spk), _t(smask), _t(ids), _t(tmask))
    common = dict(block_sizes=[8, 8, 4], dtype=torch.float32,
                  initial_noises=noises, **BASE)
    with pytest.raises(ValueError, match="divisible by speaker_patch_size"):
        t_blockwise(*args, **dict(common, block_sizes=[8, 6],
                                  initial_noises=noises[:2]))
    with pytest.raises(ValueError, match="incremental_latent requires"):
        t_blockwise(*args, incremental_latent=True,
                    **dict(common, block_sizes=[6, 6], initial_noises=noises[:2]))
    with pytest.raises(ValueError, match="initial_noises or generator"):
        t_blockwise(*args, **dict(common, initial_noises=None))
