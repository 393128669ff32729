"""Dia on the port (models/dia.py, sampler/ar.py, serve/batcher.py's Dia
pass) against the plain float32 reference (models/dia_reference.py) at a
seeded tiny configuration: 2 + 2 layers at width 64, 4 query heads over 2
K/V heads, three channels delayed [0, 2, 3].

Tolerances, all in float32 on the CPU:
  * atol 1e-5 on the encoder's output and the logits (values O(1)): the
    port and the reference differ only in summation order (fused SDPA
    against explicit softmax, the cache's read against the full causal
    pass), about 1e-6 at these widths;
  * atol 1e-4 on audio in [-1, 1]: the codec's sixteen convolutions as
    shifted-slice products against F.conv1d, about 2e-5 where the random
    decoder drives the closing tanh hard;
  * codes compared exactly, since the seeded draws depend on nothing but
    the request's seed, the position and the channel, and a batch changes
    the logits only by rounding far below any draw's distance to a bin
    edge at these sizes;
  * the sampler against the reference's rewrite of Dia's, in float64,
    exactly except on draws within 1e-5 of an edge (fp32 rounding of the
    guidance, the softmax and the cumulative sums is about 1e-6 there),
    which must stay under 5 % of the draws.
"""
import dataclasses

import numpy as np
import pytest
import torch

from echo_tts_torch.config import tiny_dac44k_config, tiny_dia_config
from echo_tts_torch.models import dia
from echo_tts_torch.models import dia_reference as ref
from echo_tts_torch.sampler import ar
from echo_tts_torch.serve.batcher import BatchRequest, run_batch
from echo_tts_torch.serve.server import MicroBatchServer

torch.set_num_threads(2)
ATOL = 1e-5
CFG = tiny_dia_config()
DAC = tiny_dac44k_config()
TOP_K = {"top_k": 8}


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    m = dia.random_dia_models("cpu", torch.float32, 3, cfg=CFG, dac_cfg=DAC,
                              keep_logits=2)
    ar.ATTN_BUCKET, saved = 16, ar.ATTN_BUCKET
    yield m
    ar.ATTN_BUCKET = saved


def _weights(m):
    return {k: v.float() for k, v in m.dia.state_dict().items()}


def _cfg():
    return dataclasses.asdict(CFG)


def _texts():
    return ["[S1] a short line. [S2] and its answer!",
            "[S1] another one, longer than the first, with more words."]


def test_encoder_matches_reference(models):
    ids = torch.from_numpy(np.stack([ref.text_ids(t, _cfg())
                                     for t in _texts()]))
    valid = ids != 0
    with torch.inference_mode():
        got = dia.encode(models.dia, ids, valid)
    with ref.fp32():
        want = ref.encode(_weights(models), _cfg(), ids, valid)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("prompts", [(5, 5), (3, 9)])
def test_prefill_then_cached_decode_matches_full_forward(models, prompts):
    """Two rows with these prompt lengths: the prefill's logits at every
    prompt position and each decode step's at its row's own position,
    against the reference's full causal forward over the same tokens."""
    rng = np.random.default_rng(sum(prompts))
    n = 12
    seqs = [ref.delayed_sequence(_cfg(), rng.integers(0, 32, (p, 3)),
                                 rng.integers(0, 32, (n, 3)))
            for p in prompts]
    length = min(len(s) for s in seqs)
    tokens = torch.from_numpy(np.stack([s[:length] for s in seqs]))
    ids = torch.from_numpy(np.stack([ref.text_ids(t, _cfg())
                                     for t in _texts()]))
    with ref.fp32():
        want_c, want_u = ref.forward(_weights(models), _cfg(), ids, tokens)
    want = torch.cat([want_c, want_u])
    m = models.dia
    with torch.inference_mode():
        st = ar.FrameState(m, 2, 0, 40, 16, torch.float32, "cpu")
        valid = torch.cat([ids != 0, ids != 0])
        st.text_valid.copy_(valid)
        enc = dia.encode(m, torch.cat([ids, torch.zeros_like(ids)]), valid)
        dia.cross_kv(m, enc, st.k_cross, st.v_cross)
        p0 = max(prompts)
        both = torch.cat([tokens, tokens])
        h = dia.prefill(m, both[:, :p0], st.k_self, st.v_self, st.k_cross,
                        st.v_cross, st.text_valid)
        torch.testing.assert_close(dia.logits(m, h), want[:, :p0],
                                   atol=ATOL, rtol=0)
        start = torch.tensor(prompts * 2)
        for s in range(length - max(prompts)):
            pos = start + s
            x = dia.embed(m, both[torch.arange(4), pos])
            got = dia.decode_step(m, x, pos, st.k_self, st.v_self,
                                  st.k_cross, st.v_cross, st.text_valid,
                                  st.attn_len(int(pos.max())))
            torch.testing.assert_close(got, want[torch.arange(4), pos],
                                       atol=ATOL, rtol=0)


def test_delay_applied_then_undone():
    """Prompt and codes delayed by the frame loop's delay_tokens agree with
    the reference's delayed sequence wherever a frame is known, and
    undelay gives the codes back."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 32, (p, 3)) for p in (4, 7)]
    codes = [rng.integers(0, 32, (6, 3)) for _ in prompts]
    tokens = ar.delay_tokens(
        [np.concatenate(pc) for pc in zip(prompts, codes)], CFG, 30)
    for b, (p, c) in enumerate(zip(prompts, codes)):
        seq = ref.delayed_sequence(_cfg(), p, c)
        head = tokens[b, :len(seq)]
        known = head != -1
        np.testing.assert_array_equal(head[known], seq[known])
        # unknown exactly where the reference has the flush's EOS and PAD
        assert set(seq[~known].tolist()) <= {CFG.audio_eos_value,
                                              CFG.audio_pad_value}
    got = ar.undelay(torch.from_numpy(tokens), torch.tensor([4, 7]), 6,
                     torch.tensor(CFG.delay_pattern))
    for b, c in enumerate(codes):
        np.testing.assert_array_equal(got[b].numpy(), c)


SAMPLER = {"cfg_scale": 3.0, "temperature": 1.3, "top_p": 0.95, "top_k": 35}
EDGE = 1e-5


@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 + 7, 2 ** 40 + 3,
                                  2 ** 64 - 1])
def test_uniforms_are_the_reference_draws(seed):
    pos = torch.arange(0, 3100, 7)
    lo, hi = ar.split_seed(seed)
    got = ar.uniforms(torch.full((len(pos),), lo), torch.full((len(pos),), hi),
                      pos, 9)
    want = ref.uniforms(seed, pos.numpy(), 9)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < want.min() and want.max() < 1.0


def _draws(bf16: bool):
    """Guided-sampler inputs at Dia's published vocabulary: 64 rows x 9
    channels of conditional and unconditional logits and their uniforms."""
    g = torch.Generator().manual_seed(21)
    lc = 2.0 * torch.randn(64, 9, 1028, generator=g)
    lu = lc + 0.5 * torch.randn(64, 9, 1028, generator=g)
    if bf16:    # the served head's values: ties become possible
        lc, lu = lc.bfloat16().float(), lu.bfloat16().float()
    u = torch.from_numpy(ref.uniforms(99, np.arange(64), 9))
    return lc, lu, u


def _sample(lc, lu, u, **changed):
    p = {**SAMPLER, **changed}
    return ar.sample_codes(lc, lu, u, dia.DiaConfig(), p["cfg_scale"],
                           p["temperature"], p["top_p"], p["top_k"])


@pytest.mark.parametrize("bf16", [False, True])
def test_sampler_is_dia_sampling_at_fixed_uniforms(bf16):
    """The step's guidance, EOS/PAD/BOS mask, temperature, top-k, top-p
    and inverse-CDF draw against the reference's plain rewrite of Dia's
    _sample_next_token at the same uniforms."""
    lc, lu, u = _draws(bf16)
    got = _sample(lc, lu, u)
    off, edge = ref.off_draw(lc.double(), lu.double(), u, got,
                             dataclasses.asdict(dia.DiaConfig()), SAMPLER,
                             EDGE)
    assert not off.any()
    assert edge.float().mean() < 0.05
    assert got.max() < dia.DiaConfig().audio_eos_value
    if not bf16:    # no ties: the draw itself
        want, _ = ref.sample_next_token(lc.double(), lu.double(), u,
                                        dataclasses.asdict(dia.DiaConfig()),
                                        SAMPLER)
        assert ((got == want) | edge).all()


@pytest.mark.parametrize("changed", [{"cfg_scale": 0.0},
                                     {"temperature": 1.0},
                                     {"top_p": 1.0}, {"top_k": 20}])
def test_each_sampler_setting_moves_the_draw(changed):
    """A sampler that dropped or changed one setting differs from the
    reference off the edges: the draw check sees each setting."""
    lc, lu, u = _draws(True)
    got = _sample(lc, lu, u, **changed)
    off, _ = ref.off_draw(lc.double(), lu.double(), u, got,
                          dataclasses.asdict(dia.DiaConfig()), SAMPLER, EDGE)
    assert off.sum() >= 5


def _requests(rng, n, keep=()):
    return [BatchRequest(text=_texts()[i % 2], seed=1000 + 7 * i,
                         prompt_codes=rng.integers(0, 32, (4 + 3 * i, 3)),
                         prompt_text="[S1] ok. ", frames=9 + 5 * i,
                         keep_logits=i in keep, request_id=str(i))
            for i in range(n)]


def test_request_alone_and_in_batch_give_the_same_codes(models):
    reqs = _requests(np.random.default_rng(2), 3)
    batch = run_batch(models, reqs, TOP_K)
    alone = run_batch(models, [reqs[1]], TOP_K)[0]
    np.testing.assert_array_equal(alone.codes, batch[1].codes)
    np.testing.assert_allclose(alone.audio, batch[1].audio, atol=1e-5)
    for r, out in zip(reqs, batch):
        assert out.codes.shape == (r.frames, 3)
        assert out.codes.min() >= 0 and out.codes.max() < 32


def test_served_logits_match_the_reference_forward(models):
    """The logits the frame loop recorded for kept requests against the
    reference's teacher-forced forward over the prompt and the emitted
    codes, and the audio against its decode of them."""
    reqs = _requests(np.random.default_rng(3), 3, keep=(0, 2))
    out = run_batch(models, reqs, TOP_K)
    W = _weights(models)
    Wc = {k: v.float() for k, v in models.dac.state_dict().items()}
    for i in (0, 2):
        r, o = reqs[i], out[i]
        seq = ref.delayed_sequence(_cfg(), r.prompt_codes, o.codes)
        ids = torch.from_numpy(ref.text_ids(r.prompt_text + r.text,
                                            _cfg()))[None]
        with ref.fp32():
            lc, lu = ref.forward(W, _cfg(), ids, torch.from_numpy(seq)[None])
            audio = ref.codec_decode(Wc, dataclasses.asdict(DAC),
                                     torch.from_numpy(o.codes.T.copy())[None])
        p = len(r.prompt_codes)
        want = torch.stack([lc[0, p:], lu[0, p:]])
        assert o.logits.shape == want.shape
        torch.testing.assert_close(o.logits, want, atol=ATOL, rtol=0)
        np.testing.assert_allclose(o.audio[0], audio[0].numpy(), atol=1e-4)
    assert out[1].logits is None


def test_flush_puts_eos_at_each_delay_then_pad(models):
    """After a pass, each row's delayed tokens are the reference's
    delayed sequence of its prompt and codes (BOS, the prompt, the codes,
    EOS at each channel's delay past its last frame, PAD after), and so on
    to the last position the pass's steps wrote: the public loop's flush
    runs max_delay steps from channel 0's EOS, so the longest request's
    most delayed channel ends on its last code."""
    reqs = _requests(np.random.default_rng(6), 3)
    out = run_batch(models, reqs, TOP_K)
    st = models.dia._frame_state[1]
    tokens = st.tokens.numpy()
    steps = max(r.frames for r in reqs) + CFG.max_delay
    for b, (r, o) in enumerate(zip(reqs, out)):
        p = len(r.prompt_codes)
        seq = ref.delayed_sequence(_cfg(), r.prompt_codes, o.codes)
        np.testing.assert_array_equal(tokens[b, :len(seq)], seq)
        for c, d in enumerate(CFG.delay_pattern):
            eos, last = 1 + p + r.frames + d, p + steps
            assert (tokens[b, 1 + p + d:min(eos, last + 1), c]
                    < CFG.audio_eos_value).all()
            if r.frames + d < steps:
                assert tokens[b, eos, c] == CFG.audio_eos_value
                assert (tokens[b, eos + 1:last + 1, c]
                        == CFG.audio_pad_value).all()
            else:
                assert eos == last + 1 and d == CFG.max_delay


def test_step_counter_counts_each_step(models):
    reqs = _requests(np.random.default_rng(4), 2)
    run_batch(models, reqs, TOP_K)      # the state's warm-up steps too
    steps, frames = ar.generate.steps, ar.generate.frames
    run_batch(models, reqs, TOP_K)
    assert ar.generate.steps - steps == max(r.frames for r in reqs) + 3
    assert ar.generate.frames - frames == sum(r.frames for r in reqs)


def test_server_returns_audio_of_the_requested_length(models):
    server = MicroBatchServer(models, max_batch=4, max_wait_s=0.2)
    try:
        reqs = _requests(np.random.default_rng(5), 3)
        futs = [server.submit(r, TOP_K) for r in reqs]
        outs = [f.result(timeout=120) for f in futs]
    finally:
        server.shutdown()
    hop = DAC.hop_length
    for r, o in zip(reqs, outs):
        assert o.audio.shape == (1, r.frames * hop)
        assert np.isfinite(o.audio).all()
        assert o.request_id == r.request_id


def test_text_bytes_and_speaker_tags():
    from echo_tts_torch.pipeline.text import dia_text_ids
    ids = dia_text_ids(["[S1] hi [S2] yo"], 16)
    assert ids[0, :5].tolist() == [1, 32, 104, 105, 32]
    assert ids[0, 5] == 2 and (ids[0, 9:] == 0).all()
    assert (dia_text_ids(["x" * 40], 16)[0] == ord("x")).all()
    np.testing.assert_array_equal(ids[0], ref.text_ids("[S1] hi [S2] yo",
                                                       {"text_length": 16}))


def test_load_models_takes_the_architecture_in_its_key(tmp_path, monkeypatch):
    from echo_tts_torch.serve import models as smodels
    monkeypatch.delenv("ECHO_DIT_QUANT", raising=False)
    smodels.clear_models()
    with pytest.raises(ValueError):
        smodels.load_models(None, device="cpu", architecture="bogus")
    # the published-weight loader waits for the files
    with pytest.raises(NotImplementedError):
        smodels.load_models(str(tmp_path), device="cpu", architecture="dia")
    with pytest.raises(FileNotFoundError):
        smodels.load_models(None, device="cpu", architecture="dia")
    monkeypatch.setattr("echo_tts_torch.models.dia.random_dia_models",
                        lambda *a, **k: "dia bundle")
    assert smodels.load_models(None, device="cpu", allow_random=True,
                               architecture="dia") == "dia bundle"
    # the cached Dia bundle is never served for the Echo key
    with pytest.raises(RuntimeError):
        smodels.load_models(None, device="cpu", allow_random=True)
    smodels.clear_models()
