"""The port's EchoDiT (prefill and dit_forward_static) against the JAX
package on the same tiny fp32 weights, moved over by tools/bridge.py.

Bound atol 2e-5 / rtol 1e-4: the JAX suite's bound for the fused path
against the einsum path (tests/test_pallas_attention.py:80).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.sampler.euler import make_cfg_branch_masks as j_masks
from echo_tts_tpu.tools.convert import convert_dit_state

from echo_tts_torch.config import tiny_dit_config
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.sampler.euler import make_cfg_branch_masks as t_masks
from echo_tts_torch.tools import bridge

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)
CFG = tiny_dit_config()
# the JAX side runs jitted, as its sampler does; op by op it takes seconds
# a call on the CPU
_j_kv_text = jax.jit(jdit.get_kv_cache_text, static_argnums=1)
_j_kv_speaker = jax.jit(jdit.get_kv_cache_speaker, static_argnums=1)
_j_forward = jax.jit(jdit.dit_forward_static, static_argnums=1,
                     static_argnames="start_pos")


@pytest.fixture(scope="module")
def pair(tiny_models):
    params = jax.tree.map(np.asarray, tiny_models.dit_params)
    state = bridge.dit_state_from_jax(params, CFG)
    model = bridge.load_dit_state(state, CFG, device="cpu", dtype=torch.float32)
    return tiny_models.dit_params, tiny_models.dit_cfg, model, state


def _inputs(b=1, s=16, t_text=24, t_spk=16, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (b, t_text)).astype(np.int32)
    tmask = np.ones((b, t_text), bool)
    tmask[:, 19:] = False
    spk = rng.standard_normal((b, t_spk, 80)).astype(np.float32)
    smask = np.ones((b, t_spk), bool)
    smask[:, 13:] = False
    x = rng.standard_normal((3 * b, s, 80)).astype(np.float32)
    t = np.full((3 * b,), 0.7, np.float32)
    return ids, tmask, spk, smask, x, t


def test_bridge_round_trip(pair):
    params, jcfg, _, state = pair
    back = convert_dit_state(state, jcfg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params),
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))
    assert set(state) == set(pair[2].state_dict())


def test_prefill_kv(pair):
    params, jcfg, model, _ = pair
    ids, tmask, spk, smask, *_ = _inputs()
    with torch.no_grad():
        kt = tdit.get_kv_cache_text(model, torch.from_numpy(ids), torch.from_numpy(tmask))
        ks = tdit.get_kv_cache_speaker(model, torch.from_numpy(spk))
    jkt = _j_kv_text(params, jcfg, jnp.asarray(ids), jnp.asarray(tmask))
    jks = _j_kv_speaker(params, jcfg, jnp.asarray(spk))
    for got, want in zip(kt + ks, jkt + jks):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_dit_forward_static_cfg_batch(pair):
    """GB = 3 CFG branches over one KV row, masks that blank whole
    segments, a per-layer speaker scale, and a non-zero RoPE offset."""
    params, jcfg, model, _ = pair
    ids, tmask, spk, smask, x, t = _inputs()
    scale = np.linspace(1.0, 1.8, CFG.num_layers).astype(np.float32)

    kvt = _j_kv_text(params, jcfg, jnp.asarray(ids), jnp.asarray(tmask))
    kvs = _j_kv_speaker(params, jcfg, jnp.asarray(spk))
    kv, cols = jdit.concat_static_kv(jcfg, kvt, kvs)
    mask_cfg, _ = j_masks(jcfg, jnp.asarray(tmask), jnp.asarray(smask))
    want = _j_forward(
        params, dataclasses.replace(jcfg, attention_impl="xla"),
        jnp.asarray(x), jnp.asarray(t), kv, cols, mask_cfg, start_pos=3,
        speaker_scale_by_layer=jnp.asarray(scale))

    with torch.no_grad():
        tkt = tdit.get_kv_cache_text(model, torch.from_numpy(ids), torch.from_numpy(tmask))
        tks = tdit.get_kv_cache_speaker(model, torch.from_numpy(spk))
        tkv, tcols = tdit.concat_static_kv(tkt, tks)
        tmc, _ = t_masks(CFG, torch.from_numpy(tmask), torch.from_numpy(smask))
        got = tdit.dit_forward_static(
            model, torch.from_numpy(x), torch.from_numpy(t), tkv, tcols, tmc,
            start_pos=3, speaker_scale_by_layer=torch.from_numpy(scale))
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(cols))
    np.testing.assert_array_equal(tmc.numpy(), np.asarray(mask_cfg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_patch_encoder_rejects_ragged_latent(pair):
    model = pair[2]
    with pytest.raises(ValueError, match="divisible"):
        tdit.get_kv_cache_speaker(model, torch.zeros((1, 6, 80)))


def test_random_init_scales():
    """init_dit draws the JAX init's scales: linears N(0, 1/fan_in), norms
    1, zero biases; and it refuses CUDA when there is none."""
    model = tdit.init_dit(CFG, device="cpu", dtype=torch.float32, seed=3)
    w = model.blocks[0].mlp.w2.weight
    assert abs(float(w.std()) * CFG.intermediate_size ** 0.5 - 1.0) < 0.1
    assert torch.all(model.blocks[1].attention.q_norm.weight == 1)
    assert torch.all(model.in_proj.bias == 0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdit.init_dit(CFG)
