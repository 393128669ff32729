"""The streaming path as captured programs (sampler/blockwise.py,
pipeline._decode_block_core / _encode_block_core, serve/streaming.py's
fused first block and drain) on the CPU, where the programs' plumbing runs
without a capture (utils/programs.py): static buffers, the copy in, the
body, the clone out.

Against the JAX package on the same tiny fp32 weights (tools/bridge.py):
the block bodies at the sampler tests' atol 1e-4 / rtol 1e-3
(tests/test_torch_sampler.py), the bucketed stream at the JAX suite's
bucket bound 1e-5 / 1e-4 (tests/test_blockwise_parity.py:232), the block
decode at 1e-5 and the encode at 2e-5 / 1e-4 (tests/test_torch_streaming.py).
A tensor position against a host-int one, the fused first block against
the unfused one, the drain against the unpipelined chain and a program's
replay plumbing against its miss run, bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.pipeline import pipeline as jpl
from echo_tts_tpu.sampler import blockwise as jbw

from echo_tts_torch.config import (MAX_TEXT_LENGTH, tiny_dac_config,
                                   tiny_dit_config)
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.models.dac import streaming as tstream
from echo_tts_torch.pipeline import pipeline as tpl
from echo_tts_torch.pipeline.text import get_text_input_ids_and_mask
from echo_tts_torch.sampler import blockwise as tbw
from echo_tts_torch.serve import handler as th
from echo_tts_torch.serve import presets as tpresets
from echo_tts_torch.serve import streaming as tstreaming
from echo_tts_torch.tools import bridge, stream_checks
from echo_tts_torch.utils import programs

torch.set_num_threads(1)
DIT_CFG, DAC_CFG = tiny_dit_config(), tiny_dac_config()
PS, SPL = DIT_CFG.speaker_patch_size, DAC_CFG.frame_length
BASE = dict(num_steps=4, cfg_scale_text=3.0, cfg_scale_speaker=5.0,
            cfg_min_t=0.5, cfg_max_t=1.0, truncation_factor=0.8)
FAST = dict(num_steps=2, cfg_scale_text=3.0, cfg_scale_speaker=8.0,
            cfg_min_t=0.5, cfg_max_t=1.0)
SAMPLER = dict(atol=1e-4, rtol=1e-3)


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


@pytest.fixture(autouse=True)
def fresh_programs():
    programs.clear_all()
    for cache in programs.caches():
        cache.misses = cache.hits = 0
    yield
    programs.clear_all()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _conditioning(seed: int):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 256, (1, 10)).astype(np.int32)
    tmask = np.ones((1, 10), bool)
    tmask[:, 8:] = False
    spk = rng.standard_normal((1, 8, 80)).astype(np.float32)
    smask = np.ones((1, 8), bool)
    return rng, ids, tmask, spk, smask


def _statics(dtype):
    sampler_statics = jbw.sampler_statics if dtype is jnp.float32 else \
        tbw.sampler_statics
    return sampler_statics(dtype=dtype, **BASE)


@pytest.mark.parametrize("mode,start", [
    ("first", 0), ("reencode", 8), ("reencode", 20), ("carried", 8),
    ("carried", 20)])
def test_block_bodies_match_jax(pair, mode, start):
    """The first-block and later-block programs (re-encoded and carried
    latent prefix, two start positions) against JAX `_block_core(...)` on
    the same injected noise, prefix and conditioning; the later block's
    prefix comes back with the block written at its start."""
    jm, port = pair
    total, size = 32, 8
    rng, ids, tmask, spk, smask = _conditioning(40 + start)
    noise = rng.standard_normal((1, size, 80)).astype(np.float32)
    prefix = np.zeros((1, total, 80), np.float32)
    prefix[:, :start] = rng.standard_normal((1, start, 80))
    jkv = jbw._prefill_core(jm.dit_cfg, jnp.dtype(jnp.float32))(
        jm.dit_params, jnp.asarray(ids), jnp.asarray(tmask), jnp.asarray(spk))
    kv = tbw._prefill_core(port.dit, torch.float32)(_t(ids), _t(tmask), _t(spk))
    conditioning = (tmask, smask)
    first, external = mode == "first", mode == "carried"
    jcore = jbw._block_core(jm.dit_cfg, size if first else total, size,
                            *_statics(jnp.float32), external, first)
    core = tbw._block_core(port.dit, size if first else total, size,
                           *_statics(torch.float32), external, first)
    if first:
        want = jcore(jm.dit_params, jnp.asarray(noise), *jkv,
                     *map(jnp.asarray, conditioning))
        got = core(_t(noise), *kv, *map(_t, conditioning))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLER)
        return
    jlat, lat = (), ()
    if external:
        jlat = jdit.get_kv_cache_latent(jm.dit_params, jm.dit_cfg,
                                        jnp.asarray(prefix))
        with torch.inference_mode():
            lat = tdit.get_kv_cache_latent(port.dit, _t(prefix))
    want_x, want_prefix = jcore(
        jm.dit_params, jnp.asarray(prefix), jnp.asarray(noise),
        jnp.int32(start), *jkv, *map(jnp.asarray, conditioning), *jlat)
    got_x, got_prefix = core(_t(prefix), _t(noise),
                             torch.tensor(start, dtype=torch.long), *kv,
                             *map(_t, conditioning), *lat)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), **SAMPLER)
    np.testing.assert_allclose(got_prefix.numpy(), np.asarray(want_prefix),
                               **SAMPLER)
    assert torch.equal(got_prefix[:, start:start + size], got_x)
    assert torch.equal(got_prefix[:, :start], _t(prefix[:, :start]))


@pytest.mark.parametrize("incremental", [False, True],
                         ids=["reencode", "carried"])
def test_total_len_bucket(pair, incremental):
    """total_len_bucket=32 on blocks [8, 8, 4]: the port's latents against
    its own unbucketed run and against JAX's bucketed run at 1e-5 / 1e-4,
    the padding cropped off; a bucket below the stream or off the patch
    grid raises."""
    jm, port = pair
    rng, ids, tmask, spk, smask = _conditioning(50)
    blocks = [8, 8, 4]
    noises = [rng.standard_normal((1, b, 80)).astype(np.float32)
              for b in blocks]
    common = dict(block_sizes=blocks, incremental_latent=incremental, **BASE)
    args = (port.dit, *map(_t, (spk, smask, ids, tmask)))

    def port_run(**kw):
        return tbw.sample_blockwise_euler_cfg_independent_guidances(
            *args, dtype=torch.float32, initial_noises=list(map(_t, noises)),
            **common, **kw)

    base, bucketed = port_run(), port_run(total_len_bucket=32)
    want = jbw.sample_blockwise_euler_cfg_independent_guidances(
        jm.dit_params, jm.dit_cfg, *map(jnp.asarray, (spk, smask, ids, tmask)),
        dtype=jnp.float32, initial_noises=list(map(jnp.asarray, noises)),
        total_len_bucket=32, **common)
    assert bucketed.shape == base.shape == (1, 20, 80)
    np.testing.assert_allclose(bucketed.numpy(), base.numpy(), atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(bucketed.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    with pytest.raises(ValueError, match="smaller than"):
        port_run(total_len_bucket=16)
    with pytest.raises(ValueError, match="divisible by speaker_patch_size"):
        port_run(total_len_bucket=30)


@pytest.mark.parametrize("incremental", [False, True],
                         ids=["reencode", "carried"])
def test_one_later_block_program_per_block_size(pair, incremental):
    """A stream of [8, 8, 8] misses two block programs, the first block's
    and one later block's for both starts; a second stream of another seed
    and text on the same schedule misses none (JAX
    test_one_program_per_block_size); the carried prefix's append is one
    program too."""
    _, port = pair
    for seed in (1, 2):
        _, ids, tmask, spk, smask = _conditioning(60 + seed)
        tbw.sample_blockwise_euler_cfg_independent_guidances(
            port.dit, *map(_t, (spk, smask, ids, tmask)), block_sizes=[8] * 3,
            dtype=torch.float32, generator=torch.Generator().manual_seed(seed),
            incremental_latent=incremental, **BASE)
        assert (tbw.BLOCK_PROGRAMS.misses, tbw.BLOCK_PROGRAMS.hits) == (
            2, 1 if seed == 1 else 4)
    keys = tbw.BLOCK_PROGRAMS.keys()
    assert sorted(k[-1] for k in keys) == [False, True]     # later, first
    assert tbw.LATENT_INC_PROGRAMS.misses == int(incremental)
    assert tbw.PREFILL_PROGRAMS.misses == 1


@pytest.mark.parametrize("form", ["forward", "mask", "append", "window"])
def test_tensor_positions_equal_host_int_forms(pair, form):
    """A 0-d int tensor position, as the programs take it, gives the host-int
    position's result bit for bit: the DiT forward's query RoPE (_embed),
    the latent prefix mask, the carried prefix's append and the codec's
    window transformer."""
    _, port = pair
    rng = np.random.default_rng(70)
    if form == "mask":
        for start in (0, 5, 8, 9, 40):
            assert torch.equal(
                tdit.latent_prefix_mask(3, 10, start, PS, device="cpu"),
                tdit.latent_prefix_mask(3, 10, torch.tensor(start), PS))
        return
    with torch.inference_mode():
        if form == "forward":
            kv_t = tdit.get_kv_cache_text(port.dit, _t(rng.integers(
                0, 256, (1, 10)).astype(np.int32)), None)
            kv_s = tdit.get_kv_cache_speaker(port.dit, _t(
                rng.standard_normal((1, 8, 80)).astype(np.float32)))
            kv, cols = tdit.concat_static_kv(kv_t, kv_s)
            mask = torch.ones((2, kv[0].shape[2]), dtype=torch.bool)
            x = _t(rng.standard_normal((2, 8, 80)).astype(np.float32))
            t = torch.full((2,), 0.7)
            want = tdit.dit_forward_static(port.dit, x, t, kv, cols, mask,
                                           start_pos=12)
            got = tdit.dit_forward_static(port.dit, x, t, kv, cols, mask,
                                          start_pos=torch.tensor(12),
                                          max_pos=32)
            assert torch.equal(got, want)
        elif form == "append":
            block = _t(rng.standard_normal((1, 16, 80)).astype(np.float32))
            states = [tdit.init_latent_inc_state(DIT_CFG, 1, 8, torch.float32,
                                                 "cpu") for _ in range(2)]
            states[0]["pos"] = 0
            for s in (slice(0, 8), slice(8, 12), slice(12, 16)):
                for st in states:
                    tdit.latent_kv_append_block(port.dit, st, block[:, s])
            for key in ("enc_k", "enc_v", "lat_k", "lat_v"):
                assert torch.equal(states[0][key], states[1][key])
            assert states[0]["pos"] == 4 and int(states[1]["pos"]) == 4
        else:
            tcfg = DAC_CFG.quantizer_transformer_config()
            post = port.dac.quantizer.post_module
            x = _t(rng.standard_normal((1, 12, DAC_CFG.latent_dim)).astype(
                np.float32))
            sts = [tstream.init_decode_state(DAC_CFG, device="cpu")["post"]
                   for _ in range(2)]
            sts[0]["pos"] = 0
            for s in (slice(0, 8), slice(8, 12)):
                outs = []
                for i, st in enumerate(sts):
                    out, sts[i] = tstream.transformer_decode_block(
                        post, tcfg, st, x[:, s], 64)
                    outs.append(out)
                assert torch.equal(outs[0], outs[1])
                assert torch.equal(sts[0]["k"], sts[1]["k"])
            assert sts[0]["pos"] == 12 and int(sts[1]["pos"]) == 12


@pytest.mark.parametrize("kind", ["decode", "encode"])
def test_block_codec_cores_match_jax(pair, kind):
    """ae_decode_block / ae_encode_block chains through their programs
    against JAX's chains, at the codec tests' bounds; a block shape seen
    before is a hit, and the host mirror advances."""
    jm, port = pair
    rng = np.random.default_rng(80)
    if kind == "decode":
        sizes, cache = (4, 4, 6), tpl.DECODE_BLOCK_PROGRAMS
        data = rng.standard_normal((1, 14, 80)).astype(np.float32)
        blocks = [data[:, a:a + n] for a, n in zip((0, 4, 8), sizes)]
        state, jstate = tpl.ae_decode_stream_init(port), jpl.ae_decode_stream_init(jm)
        step, jstep, tol = tpl.ae_decode_block, jpl.ae_decode_block, dict(atol=1e-5)
    else:
        sizes, cache = (2, 2, 4), tpl.ENCODE_BLOCK_PROGRAMS
        data = np.tanh(rng.standard_normal((1, 8 * SPL))).astype(np.float32)
        blocks = [data[:, a * SPL:(a + n) * SPL] for a, n in zip((0, 2, 4), sizes)]
        state, jstate = tpl.ae_encode_stream_init(port), jpl.ae_encode_stream_init(jm)
        step, jstep, tol = tpl.ae_encode_block, jpl.ae_encode_block, dict(
            atol=2e-5, rtol=1e-4)
    for block in blocks:
        out, state = step(port, state, _t(block))
        jout, jstate = jstep(jm, jstate, jnp.asarray(block))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol)
        assert state["pos"] == jstate["pos"]
    assert (cache.misses, cache.hits, len(cache)) == (2, 1, 2)


@pytest.mark.parametrize("bound,raises", [(12, False), (11, True)])
def test_direct_block_decode_checks_the_bound(pair, monkeypatch, bound,
                                              raises):
    """A caller that streams through decode_zq_block itself, as
    tools/stream_checks.decode_pair does, checks the RoPE bound on its host
    position (check_positions) before each block: the state's position
    lies on the device, and a gather past the table would be a device-side
    assert on a card.  Blocks of 8 and 4 fit a bound of 12, not of 11."""
    _, port = pair
    monkeypatch.setattr(tstream, "MAX_POSITIONS", bound)
    z_q = _t(np.random.default_rng(85).standard_normal(
        (1, 12, DAC_CFG.latent_dim)).astype(np.float32))
    with torch.inference_mode():
        if raises:
            with pytest.raises(ValueError, match="RoPE bound 11"):
                stream_checks.decode_pair(port.dac, z_q, [8, 4], plain=True)
        else:
            one, streamed, _, _ = stream_checks.decode_pair(
                port.dac, z_q, [8, 4], plain=True)
            np.testing.assert_allclose(streamed.numpy(), one.numpy(),
                                       atol=1e-5)
    tstream.check_positions(8, 4, 12, "decode")
    with pytest.raises(ValueError, match="position 8 \\+ block 5"):
        tstream.check_positions(8, 5, 12, "decode")


def test_fused_first_block(pair):
    """_fused_first_core against the unfused prefill, first block and first
    decode bit for bit, and its latents against JAX's iterator on the same
    injected noise."""
    jm, port = pair
    rng, ids, tmask, spk, smask = _conditioning(90)
    noise = rng.standard_normal((1, 8, 80)).astype(np.float32)
    statics = _statics(torch.float32)
    init = tpl.ae_decode_stream_init(port)
    fused = tstreaming._fused_first_core(port, 8, statics, tstream.MAX_POSITIONS)
    audio, x_t, kv_text, kv_speaker, inner = fused(
        *map(_t, (ids, tmask, spk, smask, noise)), init["inner"])
    kv = tbw._prefill_core(port.dit, torch.float32)(_t(ids), _t(tmask), _t(spk))
    x_ref = tbw._block_core(port.dit, 8, 8, *statics, False, True)(
        _t(noise), *kv, _t(tmask), _t(smask))
    audio_ref, state = tpl.ae_decode_block(port, init, x_ref)
    assert torch.equal(x_t, x_ref) and torch.equal(audio, audio_ref)
    for a, b in zip(kv_text + kv_speaker, kv[0] + kv[1]):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(inner), jax.tree.leaves(state["inner"])):
        assert torch.equal(a, b)
    _, want, _ = next(jbw.iter_blockwise_euler_cfg_independent_guidances(
        jm.dit_params, jm.dit_cfg, *map(jnp.asarray, (spk, smask, ids, tmask)),
        block_sizes=[8], dtype=jnp.float32,
        initial_noises=[jnp.asarray(noise)], **BASE))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(want), **SAMPLER)
    assert tstreaming.FUSED_FIRST_PROGRAMS.misses == 1


def test_drain_order_and_chunks(pair, monkeypatch):
    """The pipelined drain: chunk 0 leaves before the block iterator is
    advanced, chunk i after the iterator has run block i + 1; the chunks
    are bit for bit the unpipelined chain's (the iterator's blocks, from
    the same generator, decoded in turn)."""
    _, port = pair
    blocks, seed, text = [8, 8, 4], 3, "Drained in order."
    events = []
    iterate = tstreaming.bw.iter_blockwise_euler_cfg_independent_guidances

    def logged(*a, **k):
        for out in iterate(*a, **k):
            events.append(f"block {len(events) - events.count('chunk')}")
            yield out

    monkeypatch.setattr(tstreaming.bw,
                        "iter_blockwise_euler_cfg_independent_guidances",
                        logged)
    chunks = []
    for c in tstreaming.stream_synthesize(port, text, chunk_sizes=blocks,
                                          seed=seed, sampler_params=FAST):
        events.append("chunk")
        chunks.append(c)
    assert events == ["chunk", "block 0", "block 1", "block 2", "chunk",
                      "chunk"]
    monkeypatch.setattr(tstreaming.bw,
                        "iter_blockwise_euler_cfg_independent_guidances",
                        iterate)
    ids, mask = get_text_input_ids_and_mask([text], max_length=MAX_TEXT_LENGTH)
    state = tpl.ae_decode_stream_init(port)
    want = []
    for _, x_t, _ in iterate(
            port.dit, torch.zeros((1, PS, 80)), torch.zeros((1, PS), dtype=bool),
            _t(ids), _t(mask), block_sizes=blocks, dtype=torch.float32,
            generator=torch.Generator().manual_seed(seed),
            incremental_latent=True,
            total_len_bucket=tpresets.pick_stream_total_bucket(sum(blocks)),
            **FAST):
        audio, state = tpl.ae_decode_block(port, state, x_t)
        want.append(audio.numpy())
    assert [c.index for c in chunks] == [0, 1, 2]
    for c, w in zip(chunks, want):
        np.testing.assert_array_equal(c.audio, w)


def test_warmup_compile_leaves_the_stream_programs(pair, monkeypatch):
    """warmup_compile over a one-stream manifest ([8, 8, 4] at its bucket)
    leaves that stream's programs: the fused first block (8), the later
    blocks 8 and 4 of the bucket, the append after an 8-latent block, the
    block decodes of 8 and 4 latents, and the voice encode; a second pass
    makes none, and the report carries the static inputs' bytes."""
    _, port = pair
    monkeypatch.setattr(th, "SAMPLER_DEFAULTS", {**th.SAMPLER_DEFAULTS, **FAST})
    entry = {"kind": "stream", "speaker_bucket": None, "chunk_sizes": [8, 8, 4],
             "total_bucket": tpresets.pick_stream_total_bucket(20)}
    report = th.warmup_compile(port, FAST, manifest=[entry])
    assert [r["entry"] for r in report[1:]] == [entry]
    assert report[-1]["static_bytes"] > 0
    lengths = {c.name: len(c) for c in programs.caches() if len(c)}
    assert lengths == {"encode": 1, "fused_first": 1, "block": 2,
                       "latent_inc": 1, "decode_block": 2}
    later = sorted(k[2] for k in tbw.BLOCK_PROGRAMS.keys())
    assert later == [4, 8] and {k[1] for k in tbw.BLOCK_PROGRAMS.keys()} == {
        entry["total_bucket"]}
    misses = {c.name: c.misses for c in programs.caches()}
    th.warmup_compile(port, FAST, manifest=[entry])
    assert {c.name: c.misses for c in programs.caches()} == misses


def test_static_inputs_are_shared(pair):
    """Two programs of one cache whose inputs have equal shapes hold one
    static buffer per input slot; the first program's result is unchanged
    after the second runs, and replaying the first gives it again.  The
    later-block programs of one bucket share their text K/V buffer."""
    _, port = pair
    cache = programs.ProgramCache("test-shared", 4)
    try:
        def body(scale):
            return lambda: lambda owner, x, y: (x * scale + y, y)
        a, b = torch.arange(4.0), torch.ones(4)
        first = cache(("x2",), port.dit, [a, b], body(2.0))
        kept = first[0].clone()
        second = cache(("x3",), port.dit, [b, a], body(3.0))
        p1, p2 = cache.entries.values()
        assert all(s is t for s, t in zip(p1.static_in, p2.static_in))
        assert len(cache.buffers()) == 2
        assert torch.equal(first[0], kept)
        assert torch.equal(second[0], b * 3.0 + a)
        again = cache(("x2",), port.dit, [a, b], body(2.0))
        assert torch.equal(again[0], kept) and cache.hits == 1
        # the second output does not alias the buffer it passed through
        assert again[1].data_ptr() != p1.static_in[1].data_ptr()
    finally:
        programs._CACHES.remove(cache)

    _, ids, tmask, spk, smask = _conditioning(100)
    tbw.sample_blockwise_euler_cfg_independent_guidances(
        port.dit, *map(_t, (spk, smask, ids, tmask)), block_sizes=[8, 8, 4],
        dtype=torch.float32, generator=torch.Generator().manual_seed(4),
        total_len_bucket=32, **BASE)
    later = [p for k, p in tbw.BLOCK_PROGRAMS.entries.items() if not k[0][-1]]
    assert len(later) == 2
    kv_text = later[0].static_in[3]     # prefix, noise, start, kv_text k...
    assert kv_text.shape[2] == 10 and later[1].static_in[3] is kv_text
    assert programs.static_bytes("cpu") >= kv_text.numel() * 4
