"""The port's train and distill steps as captured programs
(echo_tts_torch/train/step.py TRAIN_PROGRAMS, train/distill.py
DISTILL_PROGRAMS, examples/bench_train_step.py GRAD_PROGRAMS) on the CPU,
where the programs' plumbing runs without a capture: static buffers, the
copy in, the body, the clone out.

A step through its program is held bit for bit against the same body
called eagerly (`step.eager`) from an identical state: losses,
parameters and EMA.  The device clip is held against optax on both sides
of the threshold and, in bf16, bit for bit against the host-float clip
it replaces; the learning rate, now an input of the program, against
optax's warmup-cosine schedule.  The key's fields each separate
programs, and a freed owner's programs are dropped before the next call.
The JAX comparisons of whole steps (tests/test_torch_train.py,
test_torch_distill.py) run through the same programs.
"""
import contextlib
import gc

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from echo_tts_torch.config import tiny_dit_config
from echo_tts_torch.examples import bench_train_step
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.models.plain import plain_kernels
from echo_tts_torch.train import distill as tdistill
from echo_tts_torch.train import step as tstep
from echo_tts_torch.utils import programs

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    """A seeded random tiny DiT, fp32 (blockwise=False)."""
    return tdit.init_dit(tiny_dit_config(blockwise=False), device="cpu",
                         dtype=torch.float32, seed=3)


@pytest.fixture(autouse=True)
def fresh_programs():
    programs.clear_all()
    for cache in programs.caches():
        cache.misses = cache.hits = 0
    yield
    programs.clear_all()


def _batch(seed: int = 7, latent_mask: bool = True, b: int = 2, s: int = 16,
           t_text: int = 12, t_spk: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    text_mask = np.ones((b, t_text), bool)
    text_mask[0, 9:] = False
    batch = {
        "latents": (rng.standard_normal((b, s, 80)) * 0.1).astype(np.float32),
        "text_ids": rng.integers(0, 256, (b, t_text)).astype(np.int32),
        "text_mask": text_mask,
        "speaker_latent": rng.standard_normal((b, t_spk, 80)).astype(np.float32),
        "speaker_mask": np.ones((b, t_spk), bool),
    }
    if latent_mask:
        batch["latent_mask"] = np.ones((b, s), bool)
        batch["latent_mask"][1, 11:] = False      # a padded window tail
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_same(a: torch.nn.Module, b: torch.nn.Module) -> None:
    for (k, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), k


def _run(step, state, batch, n: int, seed: int = 5, **kw) -> list:
    gen = torch.Generator().manual_seed(seed)
    return [step(state, batch, gen, **kw)[1] for _ in range(n)]


# ---------------------------------------------------------------------------
# (a) the train step through TRAIN_PROGRAMS against its body
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", tdit.REMAT_MODES)
@pytest.mark.parametrize("latent_mask", [False, True])
@pytest.mark.parametrize("ema", [False, True])
def test_train_step_program_matches_its_body(model, remat, latent_mask, ema):
    """Three steps: one miss (the eager run), then two hits; losses,
    parameters and EMA bit for bit three eager calls of the body from an
    identical state, on the same draws."""
    tx = tstep.make_optimizer(lr=1e-3, grad_clip=0.5)
    step = tstep.make_train_step(tx, ema_decay=0.9, remat=remat)
    batch = _batch(latent_mask=latent_mask)
    state = tstep.create_train_state(model, tx, ema=ema)
    got = _run(step, state, batch, 3)
    cache = tstep.TRAIN_PROGRAMS
    assert (len(cache), cache.misses, cache.hits) == (1, 1, 2)
    ref = tstep.create_train_state(model, tx, ema=ema)
    want = _run(step.eager, ref, batch, 3)
    assert (cache.misses, cache.hits) == (1, 2)
    assert state.step == ref.step == 3
    assert all(torch.equal(a, b) for a, b in zip(got, want)), (got, want)
    assert not torch.equal(got[0], got[2])
    _assert_same(state.model, ref.model)
    if ema:
        _assert_same(state.ema, ref.ema)
    # the steps moved the parameters
    assert not torch.equal(next(state.model.parameters()),
                           next(model.parameters()))


# ---------------------------------------------------------------------------
# (b) what separates programs, and freed states
# ---------------------------------------------------------------------------

KEY_FIELDS = ("remat", "ema", "ema_decay", "route", "latent_mask", "state")


@pytest.mark.parametrize("field", KEY_FIELDS)
def test_train_program_key_fields(model, field):
    """A call that differs from the first in one field (the remat mode,
    the EMA's presence or decay, the attention route, the batch's
    structure, the train state) is a second program; the same call again
    replays the first."""
    tx = tstep.make_optimizer(lr=1e-3)
    state = first = tstep.create_train_state(model, tx, ema=True)
    batch = _batch()
    _run(tstep.make_train_step(tx, ema_decay=0.9, remat="attn"), first,
         batch, 2)
    cache = tstep.TRAIN_PROGRAMS
    assert (len(cache), cache.misses, cache.hits) == (1, 1, 1)
    kw = dict(ema_decay=0.9, remat="attn")
    if field == "remat":
        kw["remat"] = "full"
    elif field == "ema_decay":
        kw["ema_decay"] = 0.5
    elif field == "ema":
        state.ema = None
    elif field == "latent_mask":
        batch = _batch(latent_mask=False)
    elif field == "state":
        state = tstep.create_train_state(model, tx, ema=True)
    route = plain_kernels() if field == "route" else contextlib.nullcontext()
    with route:
        _run(tstep.make_train_step(tx, **kw), state, batch, 2)
    assert (len(cache), cache.misses, cache.hits) == (2, 2, 2)
    assert first.step == 2 + 2 * (state is first)


def test_freed_state_drops_its_program(model):
    """A freed state's program is dropped before the next program call
    (and by programs.purge), with no other state's program."""
    tx = tstep.make_optimizer(lr=1e-3)
    step = tstep.make_train_step(tx)
    batch = _batch()
    kept = tstep.create_train_state(model, tx)
    _run(step, kept, batch, 1)
    freed = tstep.create_train_state(model, tx)
    _run(step, freed, batch, 1)
    assert len(tstep.TRAIN_PROGRAMS) == 2
    del freed
    gc.collect()
    programs.purge()
    assert len(tstep.TRAIN_PROGRAMS) == 1
    freed = tstep.create_train_state(model, tx)
    _run(step, freed, batch, 1)
    del freed
    gc.collect()
    _run(step, kept, batch, 1)                  # the next call purges
    cache = tstep.TRAIN_PROGRAMS
    assert (len(cache), cache.misses, cache.hits) == (1, 3, 1)


def test_grad_step_is_a_program(model):
    """bench_train_step.grad_step: one program per remat mode, attention
    route and batch shape, its replay bit for bit its miss run."""
    trained = tdit.trainable_copy(model)
    batch = _batch(latent_mask=False)
    gen = torch.Generator().manual_seed(7)
    first = bench_train_step.grad_step(trained, batch, gen, "attn")
    gen = torch.Generator().manual_seed(7)
    again = bench_train_step.grad_step(trained, batch, gen, "attn")
    with plain_kernels():
        bench_train_step.grad_step(trained, batch, gen, "attn")
    bench_train_step.grad_step(trained, batch, gen, "full")
    cache = bench_train_step.GRAD_PROGRAMS
    assert (len(cache), cache.misses, cache.hits) == (3, 3, 1)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert all(torch.isfinite(x) for x in first)


# ---------------------------------------------------------------------------
# (c) the clip on the device, (d) the learning rate as an input
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [1.0, 0.5])
@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_device_clip_matches_optax(max_norm, scale):
    """Below the threshold the gradients are themselves, bit for bit;
    above it optax's (g / norm) * max_norm at fp32 (rtol 1e-6: the two
    norms sum their squares in different orders)."""
    rng = np.random.default_rng(4)
    arrays = [(rng.standard_normal(s) * scale).astype(np.float32)
              for s in ((7, 5), (11,), (3, 4, 2))]
    grads = [torch.from_numpy(a.copy()) for a in arrays]
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)).float())
    tstep.clip_by_global_norm_(grads, norm, max_norm)
    tx = optax.clip_by_global_norm(max_norm)
    want, _ = tx.update([jnp.asarray(a) for a in arrays], tx.init(arrays))
    below = float(norm) < max_norm
    assert below == (scale < 1)
    for g, w, a in zip(grads, want, arrays):
        if below:
            assert np.array_equal(g.numpy(), a)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0)


@pytest.mark.parametrize("max_norm", [1.0, 0.5])
def test_device_clip_bf16_matches_host_float_clip(max_norm):
    """bf16 gradients past the clip: bit for bit the clip the port ran
    before, division and multiplication by the host float at fp32, each
    rounded once to bf16."""
    rng = np.random.default_rng(5)
    grads = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 3)
             .bfloat16() for s in ((64, 48), (97,), (5, 6, 7))]
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)).float())
    assert float(norm) > max_norm
    want = [g.clone() for g in grads]
    torch._foreach_div_(want, float(norm))
    torch._foreach_mul_(want, max_norm)
    tstep.clip_by_global_norm_(grads, norm, max_norm)
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def test_learning_rate_is_an_input(model):
    """Five steps through one program under warmup-cosine: AdamW's tensor
    learning rate at each is optax's schedule at the update count (the
    float32 values bit for bit the schedule's); the first update, at lr
    0, leaves the parameters where they were."""
    tx = tstep.make_optimizer(lr=1e-3, warmup_steps=2, total_steps=5)
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-3, warmup_steps=2, decay_steps=5,
        end_value=1e-4)
    state = tstep.create_train_state(model, tx)
    step = tstep.make_train_step(tx)
    batch, gen = _batch(), torch.Generator().manual_seed(1)
    lrs = []
    for n in range(5):
        step(state, batch, gen)
        lr = state.optimizer.param_groups[0]["lr"]
        assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
        assert float(lr) == np.float32(tx.schedule(n))
        lrs.append(float(lr))
        if n == 0:
            _assert_same(state.model, model)
    np.testing.assert_allclose(lrs, [float(want(n)) for n in range(5)],
                               rtol=1e-6, atol=0)
    cache = tstep.TRAIN_PROGRAMS
    assert (len(cache), cache.misses, cache.hits) == (1, 1, 4)


# ---------------------------------------------------------------------------
# (e) the distill step, (f) two owners
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant_aware", [False, True])
def test_distill_step_program_matches_its_body(model, quant_aware):
    """Three distill steps (4 student steps of 2 substeps) through
    DISTILL_PROGRAMS, one miss then hits, bit for bit the body called
    eagerly from an identical state (EMA on); freeing the teacher drops
    the program."""
    teacher = tdit.init_dit(tiny_dit_config(blockwise=False), device="cpu",
                            dtype=torch.float32, seed=4)
    tx = tstep.make_optimizer(lr=1e-3)
    kw = dict(num_student_steps=4, substeps=2, quant_aware=quant_aware)
    step = tdistill.make_distill_step(tx, ema_decay=0.9, **kw)
    batch = _batch()
    state = tstep.create_train_state(model, tx, ema=True)
    ref = tstep.create_train_state(model, tx, ema=True)
    got, want = [], []
    for fn, st, out in ((step, state, got), (step.eager, ref, want)):
        gen = torch.Generator().manual_seed(2)
        out += [fn(st, teacher, batch, gen)[1] for _ in range(3)]
    cache = tdistill.DISTILL_PROGRAMS
    assert (len(cache), cache.misses, cache.hits) == (1, 1, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), (got, want)
    _assert_same(state.model, ref.model)
    _assert_same(state.ema, ref.ema)
    del teacher
    gc.collect()
    programs.purge()
    assert len(cache) == 0


class _Owner:
    def __init__(self, w: float):
        self.w = torch.full((3,), w)


def test_program_with_two_owners():
    """A toy body over two owners: it receives them as a tuple; the key
    holds both identities; freeing either drops the program."""
    cache = programs.ProgramCache("test-owners", 4)
    seen = []

    def make_body():
        def body(owners, x):
            seen.append([id(o) for o in owners])     # no reference kept
            a, b = owners
            return a.w * x + b.w
        return body

    try:
        a, b, c = _Owner(2.0), _Owner(1.0), _Owner(-1.0)
        x = torch.arange(3.0)
        out = cache((), (a, b), (x,), make_body)
        assert torch.equal(out, 2 * x + 1) and seen[-1] == [id(a), id(b)]
        cache((), (a, b), (x,), make_body)
        assert (len(cache), cache.misses, cache.hits) == (1, 1, 1)
        assert torch.equal(cache((), (a, c), (x,), make_body), 2 * x - 1)
        assert torch.equal(cache((), (c, b), (x,), make_body), -x + 1)
        assert (len(cache), cache.misses) == (3, 3)
        del b
        gc.collect()
        programs.purge()
        assert len(cache) == 1                 # (a, c) alone
        del c
        gc.collect()
        programs.purge()
        assert len(cache) == 0
    finally:
        programs._CACHES.remove(cache)
