"""The port's streaming codec (models/dac/streaming.py, the pipeline's
block encode/decode), `stream_synthesize` and its block schedules, against
the JAX package on the same tiny fp32 weights (tools/bridge.py), and
streamed output against the port's own one-shot decode.

Bounds: atol 2e-5 / rtol 1e-4 for single ops and the encode chain (the JAX
suite's per-op bound, tests/test_res_stack_kernel.py:48); atol 1e-5 for a
streamed decode against a one-shot decode or JAX's chain (the JAX suite's
streamed-against-one-shot bound, tests/test_streaming.py:61).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.models.dac import conv as jconv
from echo_tts_tpu.models.dac import streaming as jstream
from echo_tts_tpu.pipeline import pipeline as jpl
from echo_tts_tpu.serve import presets as jpresets

from echo_tts_torch.config import (MAX_TEXT_LENGTH, tiny_dac_config,
                                   tiny_dit_config)
from echo_tts_torch.models.dac import conv as tconv
from echo_tts_torch.models.dac import streaming as tstream
from echo_tts_torch.pipeline import pipeline as tpl
from echo_tts_torch.pipeline.text import get_text_input_ids_and_mask
from echo_tts_torch.sampler.blockwise import (
    sample_blockwise_euler_cfg_independent_guidances as t_blockwise)
from echo_tts_torch.serve import presets as tpresets
from echo_tts_torch.serve import streaming as tstreaming
from echo_tts_torch.serve.streaming import stream_synthesize
from echo_tts_torch.tools import bridge

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)
DIT_CFG, DAC_CFG = tiny_dit_config(), tiny_dac_config()
SPL = DAC_CFG.frame_length
FAST = dict(num_steps=2, cfg_scale_text=3.0, cfg_scale_speaker=8.0,
            cfg_min_t=0.5, cfg_max_t=1.0)


@pytest.fixture(scope="module")
def pair(tiny_models):
    port = tpl.EchoModels(
        dit=bridge.load_dit_state(
            bridge.dit_state_from_jax(jax.tree.map(np.asarray,
                                                   tiny_models.dit_params),
                                      DIT_CFG), DIT_CFG, device="cpu",
            dtype=torch.float32),
        dac=bridge.load_dac_state(
            bridge.dac_state_from_jax(jax.tree.map(np.asarray,
                                                   tiny_models.dac_params),
                                      DAC_CFG), DAC_CFG, device="cpu"),
        pca=bridge.pca_state(jax.tree.map(np.asarray, tiny_models.pca),
                             device="cpu"),
        dtype=torch.float32)
    return tiny_models, port


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("kind,k,stride,dil,groups", [
    ("conv", 7, 1, 3, 1), ("conv", 7, 1, 1, 6), ("conv", 4, 2, 1, 1),
    ("convt", 8, 4, 1, 1), ("convt", 2, 2, 1, 1)])
def test_conv_history_matches_jax(kind, k, stride, dil, groups):
    """A block convolved after its history (dense, depthwise, strided and
    transpose convs, a width-0 history among them) equals the JAX op; a
    history of the wrong width raises."""
    rng = np.random.default_rng(k * 10 + stride + dil + groups)
    c_in = 6
    x = rng.standard_normal((2, 8, c_in)).astype(np.float32)
    b = rng.standard_normal(5 if groups == 1 else 6).astype(np.float32)
    if kind == "conv":
        c_out = 5 if groups == 1 else 6
        w = rng.standard_normal((k, c_in // groups, c_out)).astype(np.float32)
        hist = rng.standard_normal((2, (k - 1) * dil + 1 - stride, c_in)
                                   ).astype(np.float32)
        kw = dict(stride=stride, dilation=dil, groups=groups)
        want = jconv.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b), history=jnp.asarray(hist),
                                   **kw)
        got = tconv.causal_conv1d(_t(x), _t(w), _t(b), history=_t(hist), **kw)
        bad = lambda: tconv.causal_conv1d(_t(x), _t(w), _t(b),  # noqa: E731
                                          history=_t(hist[:, 1:]), **kw)
    else:
        w = rng.standard_normal((k, 5, c_in)).astype(np.float32)
        hist = rng.standard_normal((2, k // stride - 1, c_in)).astype(np.float32)
        want = jconv.causal_conv_transpose1d(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
            history=jnp.asarray(hist))
        got = tconv.causal_conv_transpose1d(_t(x), _t(w), _t(b),
                                            stride=stride, history=_t(hist))
        bad = lambda: tconv.causal_conv_transpose1d(  # noqa: E731
            _t(x), _t(w), _t(b), stride=stride,
            history=torch.zeros((2, k // stride, c_in)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="history"):
        bad()


@pytest.mark.parametrize("length", [40, 6])
def test_residual_unit_history_matches_jax(length):
    """The unrolled unit's history form (the codec's path above the
    kernel's widths) against JAX's `_residual_unit_s`: output and new
    state, also for a block shorter than the history (6 < 6 * 3)."""
    rng = np.random.default_rng(length)
    c, dil = 8, 3
    p = {"snake1": 1.0 + 0.1 * rng.standard_normal(c),
         "conv1": {"kernel": rng.standard_normal((7, c, c)) * 0.2,
                   "bias": rng.standard_normal(c) * 0.1},
         "snake2": 1.0 + 0.1 * rng.standard_normal(c),
         "conv2": {"kernel": rng.standard_normal((1, c, c)) * 0.3,
                   "bias": rng.standard_normal(c) * 0.1}}
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    x = rng.standard_normal((1, length, c)).astype(np.float32)
    hist = rng.standard_normal((1, 6 * dil, c)).astype(np.float32)
    jst, jout = jstream._residual_unit_s(
        jax.tree.map(jnp.asarray, p), {"conv1": jnp.asarray(hist)},
        jnp.asarray(x), dil)
    out, new = tconv.residual_unit(
        _t(x), _t(p["snake1"]), _t(p["conv1"]["kernel"]),
        _t(p["conv1"]["bias"]), _t(p["snake2"]), _t(p["conv2"]["kernel"]),
        _t(p["conv2"]["bias"]), dil, history=_t(hist))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(new.numpy(), np.asarray(jst["conv1"]), **TOL)


def test_transformer_decode_block_matches_jax(pair):
    """Two blocks through the quantizer's post transformer with a carried
    rolling K/V against JAX's chain: outputs and the new state; a block
    past the RoPE bound raises."""
    jm, port = pair
    tcfg = DAC_CFG.quantizer_transformer_config()
    jparams = jm.dac_params["quantizer"]["post"]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 12, DAC_CFG.latent_dim)).astype(np.float32)
    jst = jstream.init_decode_state(DAC_CFG)["post"]
    st = tstream.init_decode_state(DAC_CFG, device="cpu")["post"]
    with torch.inference_mode():
        for s in (slice(0, 8), slice(8, 12)):
            jout, jst = jstream.transformer_decode_block(
                jparams, tcfg, jst, jnp.asarray(x[:, s]), 64)
            out, st = tstream.transformer_decode_block(
                port.dac.quantizer.post_module, tcfg, st, _t(x[:, s]), 64)
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
            np.testing.assert_allclose(st["k"].numpy(), np.asarray(jst["k"]),
                                       **TOL)
            assert st["pos"] == int(jst["pos"])
    # the bound is checked on the host mirror of the position, before the
    # block decode's program runs (the state's own position is a device
    # tensor, which a captured program cannot read back)
    with pytest.raises(ValueError, match="RoPE bound"):
        tpl.ae_decode_block(port, {"inner": None, "pos": 12},
                            torch.zeros((1, 4, 80)), max_positions=14)


def test_transformer_decode_block_past_the_window(pair):
    """300 positions in blocks of 100, 150 and 50 through the post
    transformer (window 128), so that the rolling K/V drops old positions
    and a block is longer than the window: against the one-shot
    transformer_forward and against JAX's chain."""
    from echo_tts_torch.models.dac.transformer import transformer_forward

    jm, port = pair
    tcfg = DAC_CFG.quantizer_transformer_config()
    assert tcfg.window_size < 150
    jparams = jm.dac_params["quantizer"]["post"]
    post = port.dac.quantizer.post_module
    x = np.random.default_rng(6).standard_normal(
        (1, 300, DAC_CFG.latent_dim)).astype(np.float32)
    jst = jstream.init_decode_state(DAC_CFG)["post"]
    st = tstream.init_decode_state(DAC_CFG, device="cpu")["post"]
    parts = []
    with torch.inference_mode():
        one_shot = transformer_forward(post, tcfg, _t(x)).numpy()
        for s in (slice(0, 100), slice(100, 250), slice(250, 300)):
            jout, jst = jstream.transformer_decode_block(
                jparams, tcfg, jst, jnp.asarray(x[:, s]), 512)
            out, st = tstream.transformer_decode_block(post, tcfg, st,
                                                       _t(x[:, s]), 512)
            np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
            parts.append(out.numpy())
    np.testing.assert_allclose(np.concatenate(parts, 1), one_shot, **TOL)


def test_decode_chain_matches_jax_and_one_shot(pair):
    """ae_decode_block over uneven blocks (6, 4, 4 latents) against JAX's
    chain and against the port's one-shot ae_decode; the first block also
    through decode_zq_block directly.  The shared zero state is not
    written."""
    jm, port = pair
    lat = np.random.default_rng(3).standard_normal((1, 14, 80)).astype(np.float32)
    jstate, state = jpl.ae_decode_stream_init(jm), tpl.ae_decode_stream_init(port)
    template = jax.tree.map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
        state["inner"])
    parts, jparts = [], []
    for start, size in ((0, 6), (6, 4), (10, 4)):
        block = lat[:, start:start + size]
        audio, state = tpl.ae_decode_block(port, state, _t(block))
        jaudio, jstate = jpl.ae_decode_block(jm, jstate, jnp.asarray(block))
        assert state["pos"] == jstate["pos"] == start + size
        parts.append(audio.numpy())
        jparts.append(np.asarray(jaudio))
    streamed = np.concatenate(parts, axis=-1)
    np.testing.assert_allclose(streamed, np.concatenate(jparts, -1), atol=1e-5)
    one_shot = tpl.ae_decode(port, _t(lat)).numpy()
    np.testing.assert_allclose(streamed, one_shot, atol=1e-5)
    fresh = tpl.ae_decode_stream_init(port)["inner"]
    for a, b in zip(jax.tree.leaves(fresh), jax.tree.leaves(template)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    with torch.inference_mode():
        z_q = tpl.tdac.pca_unwhiten(_t(lat[:, :6]), port.pca)
        audio0, _ = tstream.decode_zq_block(port.dac, fresh, z_q)
    np.testing.assert_allclose(audio0[..., 0].numpy(), parts[0], atol=1e-6)


@pytest.mark.parametrize("case", ["bf16", "above_kernel_widths"])
def test_decode_chain_other_codecs(case, monkeypatch):
    """Chained decode_zq_block against one-shot decode_zq on two codecs the
    bridged pair does not cover.  bf16 with the polynomial snake, the
    serving codec's setting: within the JAX package's bf16 bound, max-abs
    0.05 (tests/test_streaming.py:108); the one-shot path takes the
    residual-stack kernel's plain version here, as both paths take the
    kernel on the card (the unrolled units round elsewhere in bf16).  fp32
    with decoder_dim 1024, whose first decoder block (C = 512) is wider
    than the kernel's widths, so its residual stack carries its history
    through the unrolled units, as the base decoder's first block
    (C = 768) does on the card; bound 2e-5 / 1e-4."""
    import dataclasses

    from echo_tts_torch.models.dac import dac as tdac
    from echo_tts_torch.models.dac.init import init_dac

    monkeypatch.setattr(tdac, "res_stack_eligible",
                        lambda x: x.shape[2] <= 384)
    if case == "bf16":
        cfg, dtype = dataclasses.replace(DAC_CFG, snake_approx=True), torch.bfloat16
    else:
        cfg, dtype = dataclasses.replace(DAC_CFG, decoder_dim=1024), torch.float32
        assert cfg.decoder_dim // 2 > 384
    dac = init_dac(cfg, device="cpu", dtype=dtype, seed=1)
    z = torch.randn((1, 12, cfg.latent_dim),
                    generator=torch.Generator().manual_seed(12)).to(dtype)
    with torch.inference_mode():
        one_shot = tdac.decode_zq(dac, z).float()
        state = tstream.init_decode_state(cfg, 1, dtype, "cpu")
        parts = []
        for s in (slice(0, 4), slice(4, 10), slice(10, 12)):
            audio, state = tstream.decode_zq_block(dac, state, z[:, s])
            parts.append(audio.float())
    streamed = torch.cat(parts, dim=1)
    if case == "bf16":
        assert float((streamed - one_shot).abs().max()) < 0.05
    else:
        np.testing.assert_allclose(streamed.numpy(), one_shot.numpy(), **TOL)


def test_encode_chain_matches_jax(pair):
    """ae_encode_block over blocks of 4, 2 and 6 frames against JAX's
    chain and the port's one-shot ae_encode; a block off the frame grid
    raises."""
    jm, port = pair
    rng = np.random.default_rng(8)
    audio = np.tanh(rng.standard_normal((1, 12 * SPL))).astype(np.float32)
    jstate, state = jpl.ae_encode_stream_init(jm), tpl.ae_encode_stream_init(port)
    parts, jparts = [], []
    for start_f, size in ((0, 4), (4, 2), (6, 6)):
        block = audio[:, start_f * SPL:(start_f + size) * SPL]
        lat, state = tpl.ae_encode_block(port, state, _t(block))
        jlat, jstate = jpl.ae_encode_block(jm, jstate, jnp.asarray(block))
        assert state["pos"] == jstate["pos"]
        parts.append(lat.numpy())
        jparts.append(np.asarray(jlat))
    streamed = np.concatenate(parts, axis=1)
    np.testing.assert_allclose(streamed, np.concatenate(jparts, 1), **TOL)
    np.testing.assert_allclose(streamed, tpl.ae_encode(port, _t(audio)).numpy(),
                               **TOL)
    with pytest.raises(ValueError, match="multiple of"):
        tpl.ae_encode_block(port, tpl.ae_encode_stream_init(port),
                            torch.zeros((1, SPL + 1)))


def test_stream_rope_bound_guards(pair):
    _, port = pair
    state = tpl.ae_decode_stream_init(port)
    state["pos"] = tstream.MAX_POSITIONS - 2
    with pytest.raises(ValueError, match="RoPE bound"):
        tpl.ae_decode_block(port, state, torch.zeros((1, 4, 80)))
    st = tpl.ae_encode_stream_init(port)
    st["pos"] = tstream.MAX_ENC_POSITIONS - 2
    with pytest.raises(ValueError, match="RoPE bound"):
        tpl.ae_encode_block(port, st, torch.zeros((1, 4 * SPL)))
    with pytest.raises(ValueError, match="RoPE bound"):
        next(stream_synthesize(port, "x", chunk_sizes=[tstream.MAX_POSITIONS, 4],
                               sampler_params=FAST))


def _one_shot_latents(port, text, blocks, seed, speaker_latent=None, **kw):
    """The stream's latents, drawn again in the same generator order, with
    the latent prefix in the form stream_synthesize takes (carried on the
    patch grid, the buffer padded to the stream-total bucket)."""
    ids, mask = get_text_input_ids_and_mask([text], max_length=MAX_TEXT_LENGTH)
    ps = DIT_CFG.speaker_patch_size
    cont = kw.get("continuation_latent")
    cont_len = 0 if cont is None else cont.shape[1]
    kw["incremental_latent"] = all(n % ps == 0 for n in [cont_len] + blocks[:-1])
    kw["total_len_bucket"] = tpresets.pick_stream_total_bucket(
        cont_len + sum(blocks))
    if speaker_latent is None:
        spk, smask = np.zeros((1, ps, 80), np.float32), np.zeros((1, ps), bool)
    else:
        spk, smask = speaker_latent, np.ones(speaker_latent.shape[:2], bool)
    return t_blockwise(
        port.dit, _t(spk), _t(smask), _t(ids), _t(mask), block_sizes=blocks,
        dtype=torch.float32, generator=torch.Generator().manual_seed(seed),
        **FAST, **kw)


@pytest.mark.parametrize("case", [
    dict(chunk_size=4, num_chunks=3, seed=5),
    dict(chunk_sizes=[4, 8, 4], seed=2),
    dict(chunk_size=4, num_chunks=2, seed=3, speaker=True),
    dict(chunk_size=4, num_chunks=2, seed=1, continuation=4),
], ids=["uniform", "mixed_sizes", "speaker_latent", "continuation"])
def test_stream_synthesize(pair, case):
    """Chunk metadata, and the concatenated chunks against the port's
    one-shot ae_decode of the same blockwise latents (the continuation's
    own samples dropped)."""
    _, port = pair
    case = dict(case)
    seed = case.pop("seed")
    rng = np.random.default_rng(seed)
    kw, extra = {}, {}
    if case.pop("speaker", False):
        kw["speaker_latent"] = extra["speaker_latent"] = (
            rng.standard_normal((1, 8, 80)).astype(np.float32))
    cont_len = case.pop("continuation", 0)
    if cont_len:
        cont = (0.1 * rng.standard_normal((1, cont_len, 80))).astype(np.float32)
        kw["continuation_latent"] = cont
        extra["continuation_latent"] = _t(cont)
    blocks = case.get("chunk_sizes") or [case["chunk_size"]] * case["num_chunks"]
    text = "Streamed speech."
    chunks = list(stream_synthesize(port, text, seed=seed, sampler_params=FAST,
                                    **case, **kw))
    assert [c.index for c in chunks] == list(range(len(blocks)))
    ends = list(np.cumsum(blocks) + cont_len)
    assert [(c.latent_start, c.latent_end) for c in chunks] == list(
        zip([cont_len] + ends[:-1], ends))
    assert [c.is_last for c in chunks] == [False] * (len(blocks) - 1) + [True]
    for c, b in zip(chunks, blocks):
        assert c.audio.shape == (1, b * SPL) and c.audio.dtype == np.float32
        assert np.isfinite(c.audio).all()
    latents = _one_shot_latents(port, text, blocks, seed, **extra)
    full = tpl.ae_decode(port, latents).numpy()[:, cont_len * SPL:]
    streamed = np.concatenate([c.audio for c in chunks], axis=-1)
    np.testing.assert_allclose(streamed, full, atol=1e-5)


def test_stream_rejects_speaker_audio_and_latent(pair):
    _, port = pair
    with pytest.raises(ValueError, match="not both"):
        next(stream_synthesize(port, "x", np.zeros((1, 1000), np.float32),
                               speaker_latent=np.zeros((1, 4, 80), np.float32),
                               chunk_size=4, num_chunks=1, sampler_params=FAST))
    with pytest.raises(ValueError, match="non-empty positive"):
        next(stream_synthesize(port, "x", chunk_sizes=[4, 0]))


@pytest.mark.parametrize("blocks,cont,want", [
    ([4, 8, 4], 0, True),              # short, on the patch grid
    ([2552, 4], 0, True),              # 2556 latents
    ([2556, 4], 0, True),              # 2560 latents
    ([4, 6], 0, True),                 # only the last block off the grid
    ([6, 4], 0, False),                # a block off the grid
    ([4, 4], 2, False),                # the continuation off the grid
    ([4, 4], 8, True),                 # the continuation on it
], ids=["short", "2556", "2560", "last_off_grid", "block_off_grid",
        "continuation_off_grid", "continuation_on_grid"])
def test_stream_latent_prefix_rule(pair, monkeypatch, blocks, cont, want):
    """The form stream_synthesize picks, seen by the blockwise sampler:
    the prefix carried wherever every block but the last, and the
    continuation, lie on the patch grid, at every stream length (the
    module docstring gives the H100 readings behind it); else
    re-encoded."""
    _, port = pair
    seen = []

    def spy(*a, **k):
        seen.append(k["incremental_latent"])
        return iter(())

    def fused(models, block_size, *a):
        # a fresh stream's first block and decode, as zeros of their shapes
        return lambda *inputs: (torch.zeros((1, block_size * SPL)),
                                torch.zeros((1, block_size, 80)), None, None,
                                inputs[-1])

    monkeypatch.setattr(tstreaming.bw,
                        "iter_blockwise_euler_cfg_independent_guidances", spy)
    monkeypatch.setattr(tstreaming, "_fused_first_core", fused)
    cont_latent = np.zeros((1, cont, 80), np.float32) if cont else None
    # a fresh stream yields its fused first chunk before the iterator's
    chunks = list(stream_synthesize(port, "x", chunk_sizes=blocks,
                                    continuation_latent=cont_latent,
                                    sampler_params=FAST))
    assert [c.index for c in chunks] == ([] if cont else [0])
    assert seen == [want]


def test_schedules_match_jax():
    """growing_schedule and pick_stream_total_bucket over totals 40-5120,
    with the same errors (off the 40 grid; more than MAX_STREAM_CHUNKS
    blocks)."""
    assert tpresets.STREAM_CHUNK_SIZES == jpresets.STREAM_CHUNK_SIZES
    assert tpresets.MAX_STREAM_CHUNKS == jpresets.MAX_STREAM_CHUNKS
    assert tpresets.STREAM_TOTAL_BUCKETS == jpresets.STREAM_TOTAL_BUCKETS
    for total in list(range(40, 5121, 40)) + [1, 50, 999, 5200, 6000]:
        assert (tpresets.pick_stream_total_bucket(total)
                == jpresets.pick_stream_total_bucket(total))
        try:
            want = jpresets.growing_schedule(total)
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tpresets.growing_schedule(total)
            assert str(got.value) == str(e)
        else:
            assert tpresets.growing_schedule(total) == want
    assert tpresets.growing_schedule(640) == [40, 80, 160, 320, 40]
