"""The port's shape buckets and warm-up manifest (echo_tts_torch/serve/
presets.py) against the JAX package's (echo_tts_tpu/serve/presets.py):
the manifest entry for entry, the later-block cover schedule, the batch
buckets; and the properties of tests/test_warmup_manifest.py, each held
by both packages' presets (the `pkg` parameter)."""
import types

import pytest

from echo_tts_tpu.config import SAMPLER_DEFAULTS as J_DEFAULTS
from echo_tts_tpu.config import EchoDiTConfig as JEchoDiTConfig
from echo_tts_tpu.models.dac.streaming import MAX_POSITIONS as J_MAX_POSITIONS
from echo_tts_tpu.serve import presets as jp
from echo_tts_tpu.serve.streaming import INCREMENTAL_LATENT_MIN_TOTAL as J_INC

from echo_tts_torch.config import SAMPLER_DEFAULTS as T_DEFAULTS
from echo_tts_torch.config import EchoDiTConfig as TEchoDiTConfig
from echo_tts_torch.models.dac.streaming import MAX_POSITIONS as T_MAX_POSITIONS
from echo_tts_torch.serve import presets as tp

PKGS = {
    "jax": types.SimpleNamespace(P=jp, defaults=J_DEFAULTS, inc=J_INC,
                                 patch=JEchoDiTConfig.speaker_patch_size,
                                 max_positions=J_MAX_POSITIONS),
    "port": types.SimpleNamespace(P=tp, defaults=T_DEFAULTS,
                                  inc=tp.INCREMENTAL_LATENT_MIN_TOTAL,
                                  patch=TEchoDiTConfig.speaker_patch_size,
                                  max_positions=T_MAX_POSITIONS),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _streams(manifest):
    return [e for e in manifest if e["kind"] == "stream"]


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("batch_sizes", [(), (8,), jp.batch_size_buckets(8)],
                         ids=["none", "8", "buckets8"])
@pytest.mark.parametrize("default_seq", [None, 320])
def test_manifest_equals_jax(full, batch_sizes, default_seq):
    got = tp.warmup_manifest(batch_sizes, full=full,
                             default_sequence_length=default_seq)
    want = jp.warmup_manifest(batch_sizes, full=full,
                              default_sequence_length=default_seq)
    assert got == want


@pytest.mark.parametrize("min_total", [0, J_INC])
@pytest.mark.parametrize("tb", jp._parse_buckets(jp.STREAM_TOTAL_BUCKETS))
def test_later_cover_schedule_equals_jax(tb, min_total):
    try:
        want = jp._later_cover_schedule(tb, min_total=min_total)
    except ValueError:
        with pytest.raises(ValueError):
            tp._later_cover_schedule(tb, min_total=min_total)
        return
    assert tp._later_cover_schedule(tb, min_total=min_total) == want


@pytest.mark.parametrize("max_batch", range(1, 17))
def test_batch_buckets_equal_jax(max_batch):
    assert tp.batch_size_buckets(max_batch) == jp.batch_size_buckets(max_batch)
    for n in range(1, max_batch + 1):
        assert (tp.pick_batch_bucket(n, max_batch)
                == jp.pick_batch_bucket(n, max_batch))


def test_constants_equal_jax():
    for name in ("TEXT_BUCKETS", "SPEAKER_BUCKETS", "SEQUENCE_BUCKETS",
                 "STREAM_CHUNK_SIZES", "MAX_STREAM_CHUNKS",
                 "STREAM_TOTAL_BUCKETS"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert tp.INCREMENTAL_LATENT_MIN_TOTAL == J_INC


# ---------------------------------------------------------------------------
# tests/test_warmup_manifest.py's properties, held by both packages
# ---------------------------------------------------------------------------

def test_pick_stream_total_bucket(pkg):
    P = pkg.P
    buckets = P._parse_buckets(P.STREAM_TOTAL_BUCKETS)
    assert P.pick_stream_total_bucket(1) == min(buckets)
    assert P.pick_stream_total_bucket(min(buckets)) == min(buckets)
    assert P.pick_stream_total_bucket(min(buckets) + 1) == buckets[1]
    assert P.pick_stream_total_bucket(max(buckets)) == max(buckets)
    # past the top bucket: None (run unbucketed), not a clamp to the top
    assert P.pick_stream_total_bucket(max(buckets) + 1) is None


def test_total_buckets_cover_accepted_stream_surface(pkg):
    P = pkg.P
    max_total = max(P.STREAM_CHUNK_SIZES) * P.MAX_STREAM_CHUNKS
    buckets = P._parse_buckets(P.STREAM_TOTAL_BUCKETS)
    assert max(buckets) >= max_total
    assert all(b % pkg.patch == 0 for b in buckets)
    # the decode's RoPE bound: bucketing stays inside what streaming allows
    assert max(buckets) <= pkg.max_positions


def test_stream_entries_pass_serving_validation(pkg):
    P = pkg.P
    for manifest in (P.warmup_manifest(batch_sizes=(8,)),
                     P.warmup_manifest(full=True)):
        for e in _streams(manifest):
            sizes = e["chunk_sizes"]
            assert 1 <= len(sizes) <= P.MAX_STREAM_CHUNKS, e
            assert all(c in P.STREAM_CHUNK_SIZES for c in sizes), e
            assert e["total_bucket"] == P.pick_stream_total_bucket(sum(sizes)), e


def test_default_manifest_is_high_traffic_subset(pkg):
    P = pkg.P
    m = P.warmup_manifest(batch_sizes=(8,))
    smallest = P._parse_buckets(P.SPEAKER_BUCKETS)[0]
    ones = [e for e in m if e["kind"] == "oneshot"]
    assert {e["speaker_bucket"] for e in ones} == {None, smallest}
    assert {e["sequence_length"] for e in ones} == {
        pkg.defaults["sequence_length"]}
    scheds = {tuple(e["chunk_sizes"]) for e in _streams(m)}
    assert (160, 160, 160, 160) in scheds                # default schedule
    assert tuple(P.STREAM_CHUNK_SIZES) in scheds         # growing ramp
    assert {e["batch_size"] for e in m if e["kind"] == "batch"} == {8}


def test_full_manifest_covers_every_program(pkg):
    P = pkg.P
    m = P.warmup_manifest(full=True)
    speakers = [None] + P._parse_buckets(P.SPEAKER_BUCKETS)
    totals = P._parse_buckets(P.STREAM_TOTAL_BUCKETS)
    smallest = min(P.STREAM_CHUNK_SIZES)
    ones = [e for e in m if e["kind"] == "oneshot"]
    assert {e["speaker_bucket"] for e in ones} == set(speakers)
    want_seqs = (set(P._parse_buckets(P.SEQUENCE_BUCKETS))
                 | {pkg.defaults["sequence_length"]})
    for s in speakers:
        assert {e["sequence_length"] for e in ones
                if e["speaker_bucket"] == s} == want_seqs
        streams = [e for e in _streams(m) if e["speaker_bucket"] == s]
        # every size is some stream's first block, and every reachable
        # (total bucket, later size) pair is warmed
        assert {e["chunk_sizes"][0] for e in streams} == set(P.STREAM_CHUNK_SIZES)
        later = {(e["total_bucket"], c)
                 for e in streams for c in e["chunk_sizes"][1:]}
        for tb in totals:
            for c in P.STREAM_CHUNK_SIZES:
                if smallest + c <= tb:
                    assert (tb, c) in later, (tb, c)


def test_later_cover_schedule_lands_in_its_bucket(pkg):
    P = pkg.P
    for tb in P._parse_buckets(P.STREAM_TOTAL_BUCKETS):
        sched = P._later_cover_schedule(tb)
        assert len(sched) <= P.MAX_STREAM_CHUNKS
        assert all(c in P.STREAM_CHUNK_SIZES for c in sched)
        assert P.pick_stream_total_bucket(sum(sched)) == tb


def test_full_manifest_batch_entries(pkg):
    P = pkg.P
    m = P.warmup_manifest(batch_sizes=(4, 8), full=True)
    speakers = {None} | set(P._parse_buckets(P.SPEAKER_BUCKETS))
    seqs = (set(P._parse_buckets(P.SEQUENCE_BUCKETS))
            | {pkg.defaults["sequence_length"]})
    assert {(e["batch_size"], e["speaker_bucket"], e["sequence_length"])
            for e in m if e["kind"] == "batch"} == {
        (b, s, q) for b in (4, 8) for s in speakers for q in seqs}
    m0 = P.warmup_manifest(batch_sizes=(8,))
    assert {e["sequence_length"] for e in m0 if e["kind"] == "batch"} == {
        pkg.defaults["sequence_length"]}


def test_full_manifest_covers_incremental_kv_paths(pkg):
    P = pkg.P
    m = P.warmup_manifest(full=True)
    totals = P._parse_buckets(P.STREAM_TOTAL_BUCKETS)
    for s in [None] + P._parse_buckets(P.SPEAKER_BUCKETS):
        streams = [e for e in _streams(m) if e["speaker_bucket"] == s]
        for i, tb in enumerate(totals):
            prev = totals[i - 1] if i else 0
            if tb >= pkg.inc:
                assert any(e["total_bucket"] == tb
                           and sum(e["chunk_sizes"]) >= pkg.inc
                           for e in streams), (s, tb)
            if prev < pkg.inc:
                assert any(e["total_bucket"] == tb
                           and sum(e["chunk_sizes"]) < pkg.inc
                           for e in streams), (s, tb)


def test_batch_size_buckets(pkg):
    P = pkg.P
    assert P.batch_size_buckets(8) == (1, 2, 4, 8)
    assert P.batch_size_buckets(6) == (1, 2, 4, 6)
    assert P.batch_size_buckets(1) == (1,)
    assert P.pick_batch_bucket(3, 8) == 4
    assert P.pick_batch_bucket(5, 6) == 6
    assert P.pick_batch_bucket(8, 8) == 8
    with pytest.raises(ValueError):
        P.pick_batch_bucket(9, 8)
    with pytest.raises(ValueError):
        P.batch_size_buckets(0)


def test_manifest_respects_default_sequence_override(pkg):
    m = pkg.P.warmup_manifest(default_sequence_length=320)
    assert {e["sequence_length"] for e in m if e["kind"] == "oneshot"} == {320}
