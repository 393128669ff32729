"""The port's plain ops and host modules against the JAX package's (fp32,
CPU).

Bound atol 2e-5 / rtol 1e-4: the JAX suite's own kernel-vs-twin bound
(tests/test_pallas_attention.py:80); fp32 ops reordered between XLA and
PyTorch differ by a few ulps.  Host modules (text, DSP) are copies and
must agree exactly.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from echo_tts_tpu.ops import activations as j_act
from echo_tts_tpu.ops import attention as j_attn
from echo_tts_tpu.ops import embeddings as j_emb
from echo_tts_tpu.ops import norms as j_norms
from echo_tts_tpu import native as j_native
from echo_tts_tpu.ops import rope as j_rope
from echo_tts_tpu.pipeline import audio_io as j_io
from echo_tts_tpu.pipeline import dsp as j_dsp
from echo_tts_tpu.pipeline import text as j_text

from echo_tts_torch.ops import activations as t_act
from echo_tts_torch.ops import attention as t_attn
from echo_tts_torch.ops import embeddings as t_emb
from echo_tts_torch.ops import norms as t_norms
from echo_tts_torch import native as t_native
from echo_tts_torch.ops import rope as t_rope
from echo_tts_torch.pipeline import audio_io as t_io
from echo_tts_torch.pipeline import dsp as t_dsp
from echo_tts_torch.pipeline import text as t_text

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, **kw):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(kw or TOL))


@pytest.mark.parametrize("half_heads", [False, True])
def test_rope(half_heads):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 12, 4, 16)
    table = j_rope.precompute_freqs_cis(16, 20)[3:15]
    np.testing.assert_array_equal(t_rope.precompute_freqs_cis(16, 20)[3:15], table)
    jf = (j_rope.apply_rotary_emb_half_heads if half_heads
          else j_rope.apply_rotary_emb)
    tf = (t_rope.apply_rotary_emb_half_heads if half_heads
          else t_rope.apply_rotary_emb)
    _close(tf(torch.from_numpy(x), torch.from_numpy(table)),
           jf(jnp.asarray(x), jnp.asarray(table)))


@pytest.mark.parametrize("weight_shape", [(16,), (4, 16)])
def test_rms_norm(weight_shape):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 5, 4, 16, scale=3.0)
    w = _rand(rng, *weight_shape)
    _close(t_norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           j_norms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))


def test_low_rank_adaln():
    rng = np.random.default_rng(2)
    m, r = 32, 8
    x, cond = _rand(rng, 3, 7, m), _rand(rng, 3, 1, 3 * m)
    mod = t_norms.LowRankAdaLN(m, r)
    jp = {}
    for name in ("shift", "scale", "gate"):
        down, up, bias = _rand(rng, m, r), _rand(rng, r, m), _rand(rng, m)
        getattr(mod, f"{name}_down").weight.data = torch.from_numpy(down.T.copy())
        getattr(mod, f"{name}_up").weight.data = torch.from_numpy(up.T.copy())
        getattr(mod, f"{name}_up").bias.data = torch.from_numpy(bias)
        jp[f"{name}_down"] = jnp.asarray(down)
        jp[f"{name}_up"] = {"kernel": jnp.asarray(up), "bias": jnp.asarray(bias)}
    with torch.no_grad():
        got = t_norms.low_rank_adaln(torch.from_numpy(x), torch.from_numpy(cond),
                                     mod, 1e-5)
    want = j_norms.low_rank_adaln(jnp.asarray(x), jnp.asarray(cond), jp, 1e-5)
    for g, w in zip(got, want):
        _close(g, w)


def test_timestep_embedding():
    t = np.linspace(0.0, 0.999, 7).astype(np.float32)
    _close(t_emb.get_timestep_embedding(torch.from_numpy(t), 16),
           j_emb.get_timestep_embedding(jnp.asarray(t), 16))


def test_sin2_poly_matches_jax_and_bound():
    z = np.concatenate([np.linspace(-50, 50, 20001),
                        np.random.default_rng(3).normal(0, 300, 2000)]
                       ).astype(np.float32)
    got = t_act.sin2_poly(torch.from_numpy(z)).numpy()
    _close(got, j_act.sin2_poly(jnp.asarray(z)), atol=1e-6, rtol=0)
    assert float(np.max(np.abs(got - np.sin(z.astype(np.float64)) ** 2))) < 3e-6


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa(causal):
    rng = np.random.default_rng(4)
    q, k, v = (_rand(rng, 2, 9, 3, 8) for _ in range(3))
    mask = rng.random((2, 9)) > 0.3
    mask[:, 0] = True
    tm = torch.from_numpy(mask)[:, None, None, :]
    jm = jnp.asarray(mask)[:, None, None, :]
    _close(t_attn.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), mask=tm,
                       is_causal=causal),
           j_attn.sdpa(*(jnp.asarray(a) for a in (q, k, v)), mask=jm,
                       is_causal=causal))


TEXTS = ["Hello world. This is a test!", "[S2] Already tagged; no prefix.",
         "Curly ’quotes” and ellipsis… plus a colon: dash—done",
         "Sentence one. Sentence two, with clause; and more: details. " * 12]


def test_text_host_stack_is_the_jax_one():
    for t in TEXTS:
        assert t_text.chunk_text(t, 120) == j_text.chunk_text(t, 120)
        assert (t_text.tokenizer_encode(t, return_normalized_text=True)[1]
                == j_text.tokenizer_encode(t, return_normalized_text=True)[1])
    for got, want in zip(t_text.get_text_input_ids_and_mask(TEXTS, 768),
                         j_text.get_text_input_ids_and_mask(TEXTS, 768)):
        np.testing.assert_array_equal(got, want)


def test_dsp_host_stack_is_the_jax_one():
    rng = np.random.default_rng(5)
    lat = _rand(rng, 60, 80)
    lat[40:] = 0.0
    assert t_dsp.find_flattening_point(lat) == j_dsp.find_flattening_point(lat) == 40
    chunks = [_rand(rng, 1, 30000, scale=0.1) for _ in range(3)]
    np.testing.assert_array_equal(t_dsp.normalize_chunk_boundaries(chunks),
                                  j_dsp.normalize_chunk_boundaries(chunks))


def test_audio_io_host_stack_is_the_jax_one(tmp_path):
    voice = os.path.join(os.path.dirname(__file__), "data", "voice.wav")
    np.testing.assert_array_equal(t_io.load_audio(voice), j_io.load_audio(voice))
    x = np.tanh(_rand(np.random.default_rng(6), 2, 4410))
    np.testing.assert_array_equal(t_io.resample(x, 44100, 24000),
                                  j_io.resample(x, 44100, 24000))
    t_io.write_wav(str(tmp_path / "x.wav"), x, 24000)
    got, sr = j_io.read_wav(str(tmp_path / "x.wav"))
    assert sr == 24000
    np.testing.assert_array_equal(got, t_io.read_wav(str(tmp_path / "x.wav"))[0])
    np.testing.assert_allclose(got, x, atol=1 / 32768)


def test_native_dsp_is_the_jax_one():
    """The copied C helpers (native/dsp.c) build and give the JAX package's
    answers."""
    assert t_native.available() == j_native.available()
    rng = np.random.default_rng(8)
    x = _rand(rng, 5000, scale=0.1)
    x[4000:] *= 1e-4
    assert t_native.trailing_silence(x, 1e-3) == j_native.trailing_silence(x, 1e-3)
    lat = _rand(rng, 60, 80)
    lat[33:] = 0.0
    assert t_native.flattening_point(lat) == j_native.flattening_point(lat)


def test_port_never_imports_jax():
    """echo_tts_torch and chip_smoke.py import neither jax nor echo_tts_tpu,
    at any level (the card's machine runs them without JAX)."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = sorted((root / "echo_tts_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "echo_tts_tpu"), \
                    f"{path.relative_to(root)} imports {name}"
