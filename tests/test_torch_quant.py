"""The port's int8 quantization (echo_tts_torch/ops/quant.py) against the
JAX package's (echo_tts_tpu/ops/quant.py), and the port's model cache
(echo_tts_torch/serve/models.py) against serve/models.py's contract.

The quantizers are held bit for bit: the same fp32 arithmetic (abs-max,
divide, round half to even, clip) on the same numbers.  The port's weights
are (N, K), so its outputs are compared with the JAX ones transposed.
int8_dot is held at atol 1e-5, rtol 0 (tests/test_quant.py:68's bound):
the int32 accumulators are equal, and only the final rescale may differ
in the last bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.ops import quant as jq

from echo_tts_torch.config import tiny_dac_config, tiny_dit_config
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.ops import quant as tq
from echo_tts_torch.pipeline import pipeline as tpl
from echo_tts_torch.serve import models as serve_models
from echo_tts_torch.tools import bridge

torch.set_num_threads(1)
CFG = tiny_dit_config()


def _normal(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_weight_quantizers_are_bit_equal_to_jax():
    """int8 and K-halves int4, on a (K, N) JAX weight and its (N, K)
    transpose, with a zero column (the 1e-12 floor) and a half-step tie."""
    w = _normal(0, 96, 40, scale=96 ** -0.5)
    w[:, 3] = 0.0
    w[0, 5], w[1, 5] = 1.0, 0.5 / 127 * 1.0 + 1e-9   # near a rounding tie
    q8, s8 = tq.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    j8 = jq.quantize_weight_int8(jnp.asarray(w))
    np.testing.assert_array_equal(q8.numpy(), np.asarray(j8["q8"]).T)
    np.testing.assert_array_equal(s8.numpy(), np.asarray(j8["s"]))
    np.testing.assert_array_equal(
        tq.dequantize_weight(q8, s8).numpy(),
        np.asarray(jq.dequantize_weight(j8)).T)

    q4, s4 = tq.quantize_weight_int4(torch.from_numpy(w.T.copy()))
    j4 = jq.quantize_weight_int4(jnp.asarray(w))
    np.testing.assert_array_equal(q4.numpy(), np.asarray(j4["q4"]).T)
    np.testing.assert_array_equal(s4.numpy(), np.asarray(j4["s"]))
    np.testing.assert_array_equal(tq.unpack_weight_int4(q4).numpy(),
                                  np.asarray(jq.unpack_weight_int4(j4["q4"])).T)
    with pytest.raises(ValueError, match="even K"):
        tq.quantize_weight_int4(torch.zeros((4, 7)))


def test_kv_quantizer_is_bit_equal_to_jax():
    k, v = _normal(1, 2, 1, 30, 4, 128), _normal(2, 2, 1, 30, 4, 128, scale=3.0)
    k[0, 0, 5] = 0.0                          # an all-zero (token, head) row
    got = tq.quantize_kv_int8(torch.from_numpy(k), torch.from_numpy(v))
    want = jq.quantize_kv_int8(jnp.asarray(k), jnp.asarray(v))
    assert tq.kv_is_quantized(got) and not tq.kv_is_quantized((got["k8"],))
    for name in tq.KV_Q8_KEYS:
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]),
                                      err_msg=name)
    for a, b in zip(tq.dequantize_kv(got, torch.float32),
                    jq.dequantize_kv(want, jnp.float32)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
def test_int8_dot_matches_jax(int4):
    """Plain int8_dot (and int4_dot) against the JAX ones, (..., K) input
    with leading axes, at the shape of tests/test_quant.py:41."""
    w = _normal(3, 256, 96, scale=256 ** -0.5)
    x = _normal(4, 2, 32, 256)
    if int4:
        qw = jq.quantize_weight_int4(jnp.asarray(w))
        want = jq.int4_dot(jnp.asarray(x), qw["q4"], qw["s"])
        got = tq.int4_dot(torch.from_numpy(x),
                          *tq.quantize_weight_int4(torch.from_numpy(w.T.copy())))
    else:
        qw = jq.quantize_weight_int8(jnp.asarray(w))
        want = jq.int8_dot(jnp.asarray(x), qw["q8"], qw["s"])
        got = tq.int8_dot(torch.from_numpy(x),
                          *tq.quantize_weight_int8(torch.from_numpy(w.T.copy())))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_quantize_dit_touches_only_the_hot_linears():
    model = tdit.init_dit(CFG, device="cpu", dtype=torch.float32, seed=0)
    qm = tq.quantize_dit(model)
    assert qm is not model and not tq.dit_is_quantized(model)
    assert tq.dit_is_quantized(qm)
    hot = {f"blocks.{i}.{g}.{k}" for i in range(CFG.num_layers)
           for g, k in tq.DIT_BLOCK_QUANT_KEYS}
    assert len(hot) == 8 * CFG.num_layers
    old = dict(model.named_modules())
    for name, mod in qm.named_modules():
        if name in hot:
            assert isinstance(mod, tq.Int8Linear) and isinstance(old[name], torch.nn.Linear)
            q8, s = tq.quantize_weight_int8(old[name].weight)
            assert torch.equal(mod.weight, q8) and torch.equal(mod.scale, s)
        elif name and not any(h.startswith(name + ".") for h in hot):
            # shared by reference: every module with no hot leaf below it
            assert mod is old[name], name
    # the original is untouched, and a second pass changes nothing
    assert all(isinstance(old[n], torch.nn.Linear) for n in hot)
    qq = tq.quantize_dit(qm)
    assert all(dict(qq.named_modules())[n] is dict(qm.named_modules())[n]
               for n in hot)
    q4 = tq.quantize_dit_int4(model)
    assert isinstance(q4.blocks[0].mlp.w2, tq.Int4Linear)
    assert not tq.dit_is_quantized(q4)


def test_mixed_dit_raises():
    model = tdit.init_dit(CFG, device="cpu", dtype=torch.float32, seed=1)
    qm = tq.quantize_dit(model)
    qm.blocks[1].mlp._modules["w3"] = model.blocks[1].mlp.w3
    with pytest.raises(ValueError, match="partially quantized"):
        tq.dit_is_quantized(qm)


def test_bridged_jax_quantization_is_the_ports(tiny_models):
    """bridge(quantize_dit_params(params)) loads as the W8A8 model, equal
    leaf for leaf to quantize_dit of the bridged fp32 model."""
    params = jax.tree.map(np.asarray, tiny_models.dit_params)
    jqp = jax.tree.map(np.asarray, jq.quantize_dit_params(tiny_models.dit_params))
    from_jax = bridge.load_dit_state(bridge.dit_state_from_jax(jqp, CFG), CFG,
                                     device="cpu", dtype=torch.float32)
    ours = tq.quantize_dit(bridge.load_dit_state(
        bridge.dit_state_from_jax(params, CFG), CFG, device="cpu",
        dtype=torch.float32))
    assert tq.dit_is_quantized(from_jax)
    got, want = from_jax.state_dict(), ours.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    assert got["blocks.0.mlp.w2.weight"].dtype == torch.int8
    assert got["blocks.0.mlp.w2.scale"].dtype == torch.float32


def test_load_models_env_flag(monkeypatch):
    """ECHO_DIT_QUANT=int8 quantizes at load; the cache key includes the
    mode, so a later load in another mode raises instead of serving the
    wrong model (tests/test_quant.py:311-332); an unknown mode raises."""
    monkeypatch.setattr(tpl, "base_dit_config", lambda: CFG)
    monkeypatch.setattr(tpl, "base_dac_config", tiny_dac_config)
    monkeypatch.setenv("ECHO_DIT_QUANT", "int8")
    serve_models.clear_models()
    try:
        m = serve_models.load_models(None, device="cpu", dtype=torch.float32,
                                     allow_random=True)
        assert tq.dit_is_quantized(m.dit)
        assert serve_models.served_quant_mode() == "int8"
        assert serve_models.load_models(None, device="cpu", dtype=torch.float32,
                                        allow_random=True) is m
        monkeypatch.setenv("ECHO_DIT_QUANT", "none")
        assert serve_models.served_quant_mode() == "int8"
        with pytest.raises(RuntimeError, match="already loaded"):
            serve_models.load_models(None, device="cpu", dtype=torch.float32,
                                     allow_random=True)
        serve_models.clear_models()
        plain = serve_models.load_models(None, device="cpu",
                                         dtype=torch.float32, allow_random=True)
        assert not tq.dit_is_quantized(plain.dit)
        serve_models.clear_models()
        with pytest.raises(FileNotFoundError):
            serve_models.load_models(None, device="cpu")
        monkeypatch.setenv("ECHO_DIT_QUANT", "int4")
        with pytest.raises(ValueError, match="ECHO_DIT_QUANT"):
            serve_models.load_models(None, device="cpu", allow_random=True)
    finally:
        serve_models.clear_models()
