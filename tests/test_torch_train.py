"""The port's training slice (echo_tts_torch/models/dit.dit_forward and
echo_tts_torch/train/step, loop, data) against the JAX package on the same
tiny fp32 weights, moved over by tools/bridge.py; gradient and optimizer
trees map onto the port's parameters the same way.

Bounds are the JAX suite's: atol 2e-5 / rtol 1e-4 for a forward
(tests/test_pallas_attention.py:80); the loss at rtol 1e-6 and gradients
at atol 1e-5 / rtol 1e-4 (tests/test_train_loop.py:63-69); parameters
after optimizer steps at atol 1e-6, 1 % of one step at lr 1e-4.  The JAX
side runs its XLA attention, the port its plain version (CPU tensors).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from echo_tts_tpu.config import tiny_dit_config as j_tiny_dit_config
from echo_tts_tpu.models import dit as jdit
from echo_tts_tpu.train import data as jdata
from echo_tts_tpu.train import step as jstep

from echo_tts_torch.config import tiny_dit_config
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.tools import bridge
from echo_tts_torch.train import data as tdata
from echo_tts_torch.train import loop as tloop
from echo_tts_torch.train import step as tstep

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pair(params, blockwise: bool):
    cfg = j_tiny_dit_config(blockwise=blockwise)
    tcfg = tiny_dit_config(blockwise=blockwise)
    model = bridge.load_dit_state(
        bridge.dit_state_from_jax(jax.tree.map(np.asarray, params), tcfg),
        tcfg, device="cpu", dtype=torch.float32)
    return params, cfg, model


@pytest.fixture(scope="module")
def pair_blockwise(tiny_models):
    """The session's tiny fp32 DiT (blockwise=True) in both packages."""
    return _pair(tiny_models.dit_params, blockwise=True)


@pytest.fixture(scope="module")
def pair(tiny_models):
    """The same weights without the latent encoder (blockwise=False)."""
    params = {k: v for k, v in tiny_models.dit_params.items()
              if k not in ("latent_encoder", "latent_norm")}
    attn = {k: v for k, v in params["blocks"]["attn"].items()
            if k not in ("wk_latent", "wv_latent")}
    params["blocks"] = {**params["blocks"], "attn": attn}
    return _pair(params, blockwise=False)


def _batch(seed=7, b=2, s=16, t_text=12, t_spk=8):
    rng = np.random.default_rng(seed)
    latent_mask = np.ones((b, s), bool)
    latent_mask[1, 11:] = False            # a padded window tail
    text_mask = np.ones((b, t_text), bool)
    text_mask[0, 9:] = False
    return {
        "latents": (rng.standard_normal((b, s, 80)) * 0.1).astype(np.float32),
        "text_ids": rng.integers(0, 256, (b, t_text)).astype(np.int32),
        "text_mask": text_mask,
        "speaker_latent": rng.standard_normal((b, t_spk, 80)).astype(np.float32),
        "speaker_mask": np.ones((b, t_spk), bool),
        "latent_mask": latent_mask,
    }


def _t_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jax_draws(rng, shape):
    """t and eps as the JAX package's flow_matching_loss draws them."""
    k_t, k_eps = jax.random.split(rng)
    t = jax.random.uniform(k_t, (shape[0],), dtype=jnp.float32)
    eps = jax.random.normal(k_eps, shape, dtype=jnp.float32)
    return (torch.from_numpy(np.array(t)), torch.from_numpy(np.array(eps)))


def _grads_by_key(model):
    return {k: p.grad.numpy() for k, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# dit_forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("latent", [False, True])
def test_dit_forward_matches_jax(pair_blockwise, latent):
    """The four-segment forward at GB = 3 over a KV batch of 1: masks that
    blank whole segments, a per-layer speaker scale, the latent prefix
    with its own mask, a non-zero RoPE offset."""
    params, cfg, model = pair_blockwise
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 256, (1, 12)).astype(np.int32)
    tmask = np.ones((1, 12), bool)
    tmask[:, 9:] = False
    spk = rng.standard_normal((1, 16, 80)).astype(np.float32)
    smask = np.ones((1, 16), bool)
    smask[:, 13:] = False
    x = rng.standard_normal((3, 8, 80)).astype(np.float32)
    t = np.array([0.9, 0.9, 0.9], np.float32)
    # the CFG branches: cond, uncond text, uncond speaker
    tm3 = np.concatenate([tmask, 0 * tmask, tmask]).astype(bool)
    sm3 = np.concatenate([smask, smask, 0 * smask]).astype(bool)
    scale = np.linspace(1.0, 1.8, cfg.num_layers).astype(np.float32)
    start = 8 if latent else 0
    prefix = rng.standard_normal((1, 8, 80)).astype(np.float32)
    lmask = np.broadcast_to(np.arange(2) * 4 < 5, (3, 2)).copy()

    jkw = dict(speaker_scale_by_layer=jnp.asarray(scale))
    tkw = dict(speaker_scale_by_layer=torch.from_numpy(scale))
    if latent:
        jkw.update(kv_latent=jdit.get_kv_cache_latent(params, cfg,
                                                      jnp.asarray(prefix)),
                   latent_mask=jnp.asarray(lmask))
    want = jax.jit(jdit.dit_forward, static_argnums=1,
                   static_argnames="start_pos")(
        params, dataclasses.replace(cfg, attention_impl="xla"),
        jnp.asarray(x), jnp.asarray(t), jnp.asarray(tm3), jnp.asarray(sm3),
        jdit.get_kv_cache_text(params, cfg, jnp.asarray(ids),
                               jnp.asarray(tmask)),
        jdit.get_kv_cache_speaker(params, cfg, jnp.asarray(spk)),
        start_pos=start, **jkw)
    with torch.no_grad():
        if latent:
            tkw.update(kv_latent=tdit.get_kv_cache_latent(
                model, torch.from_numpy(prefix)),
                latent_mask=torch.from_numpy(lmask))
        got = tdit.dit_forward(
            model, torch.from_numpy(x), torch.from_numpy(t),
            torch.from_numpy(tm3), torch.from_numpy(sm3),
            tdit.get_kv_cache_text(model, torch.from_numpy(ids),
                                   torch.from_numpy(tmask)),
            tdit.get_kv_cache_speaker(model, torch.from_numpy(spk)),
            start_pos=start, **tkw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_remat_rejects_unknown_mode(pair):
    with pytest.raises(ValueError, match="remat"):
        tdit.remat_mode("everything")
    assert tdit.remat_mode(True) == "full" and tdit.remat_mode(False) == "none"
    # the int8 static K/V serve and never train: no remat with them
    from echo_tts_torch.ops.quant import quantize_kv_int8
    model = pair[2]
    cfg = model.cfg
    kv = torch.ones((cfg.num_layers, 1, 4, cfg.num_heads, cfg.head_dim))
    with pytest.raises(ValueError, match="int8"):
        tdit.dit_forward_static(
            model, torch.zeros((1, 8, 80)), torch.zeros((1,)),
            quantize_kv_int8(kv, kv), torch.zeros((4,), dtype=torch.bool),
            torch.ones((1, 4), dtype=torch.bool), remat="attn")


# ---------------------------------------------------------------------------
# flow_matching_loss, each remat mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", tdit.REMAT_MODES)
def test_flow_matching_loss_and_grads_match_jax(pair, remat):
    """The loss and every gradient, with t and eps from the JAX package's
    own draws, against jax.value_and_grad of its flow_matching_loss under
    the same remat mode; and the attention forward runs once per layer
    under "none", "attn" and "dots_all", twice under "full" and "dots"
    (the plain version's calls: one more per layer is the backward's
    recompute)."""
    params, cfg, model = pair
    batch = _batch()
    rng = jax.random.PRNGKey(3)
    lj, gj = jax.jit(jax.value_and_grad(jstep.flow_matching_loss),
                     static_argnums=(1, 4, 5))(
        params, cfg, jax.tree.map(jnp.asarray, batch), rng, jnp.float32,
        remat)
    want = bridge.dit_state_from_jax(jax.tree.map(np.asarray, gj),
                                     tiny_dit_config(blockwise=False))

    from echo_tts_torch.ops import joint_attention as ja
    calls = []
    plain = ja.joint_attention_plain
    trained = tdit.trainable_copy(model)
    t, eps = _jax_draws(rng, batch["latents"].shape)
    try:
        ja.joint_attention_plain = lambda *a, **k: calls.append(1) or plain(*a, **k)
        loss = tstep.flow_matching_loss(trained, _t_batch(batch), t=t,
                                        eps=eps, remat=remat)
        n_forward = len(calls)
        loss.backward()
    finally:
        ja.joint_attention_plain = plain
    layers = cfg.num_layers
    assert n_forward == layers
    assert len(calls) == (3 if remat in ("full", "dots") else 2) * layers
    np.testing.assert_allclose(float(loss.detach()), float(lj), rtol=1e-6)
    got = _grads_by_key(trained)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **GRAD_TOL)


def test_training_after_sampling_in_one_process(pair):
    """The RoPE and timestep tables are cached per shape and device; one
    first built under the sampler's inference mode must still enter
    autograd when training runs next in the same process (the recipe's
    evaluation then distillation): it used to raise 'Inference tensors
    cannot be saved for backward'."""
    from echo_tts_torch.ops import embeddings, rope
    from echo_tts_torch.sampler.euler import (
        sample_euler_cfg_independent_guidances)
    rope._freqs_on.cache_clear()
    embeddings._freqs.cache_clear()
    model = pair[2]
    batch = _t_batch(_batch())
    sample_euler_cfg_independent_guidances(
        model, batch["speaker_latent"], batch["speaker_mask"],
        batch["text_ids"], batch["text_mask"], num_steps=2,
        cfg_scale_text=3.0, cfg_scale_speaker=8.0, cfg_min_t=0.5,
        cfg_max_t=1.0, sequence_length=16, dtype=torch.float32,
        generator=torch.Generator().manual_seed(0))
    trained = tdit.trainable_copy(model)
    tstep.flow_matching_loss(trained, batch, torch.Generator().manual_seed(1),
                             remat="none").backward()
    assert trained.in_proj.weight.grad is not None


def _rel_rms(got: dict, want: dict) -> float:
    """Rel-RMS over every parameter's gradient together."""
    num = sum(float(np.sum((np.float32(got[k]) - want[k]) ** 2)) for k in want)
    return float(np.sqrt(num / sum(float(np.sum(want[k] ** 2)) for k in want)))


def test_bf16_step_gradients_as_near_fp32_as_jax_bf16(pair):
    """The port's bf16 training step against the JAX package's: one
    step's gradients in bf16 from each, both held against the fp32 step
    at the timestep the bf16 step sees (t rounded to bf16; the timestep
    embedding's frequencies reach 1000 per unit t, so that rounding alone
    moves the fp32 gradients by more than bf16 arithmetic does).  The
    port's bf16 rounding may not sit farther from that step than 1.25x
    the JAX package's, nor farther from JAX's bf16 step than the two
    distances together.  The two roundings differ op by op, so the ratio
    scatters: 1.18 on these weights and batch, 0.90-1.06 on six other
    seeded ones."""
    params, cfg, model = pair
    batch = _batch()
    rng = jax.random.PRNGKey(3)
    p16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    gj = jax.jit(jax.grad(jstep.flow_matching_loss),
                 static_argnums=(1, 4, 5))(
        p16, cfg, jax.tree.map(jnp.asarray, batch), rng, jnp.bfloat16,
        "none")
    jax16 = bridge.dit_state_from_jax(
        jax.tree.map(lambda x: np.asarray(x, np.float32), gj),
        tiny_dit_config(blockwise=False))
    t, eps = _jax_draws(rng, batch["latents"].shape)

    def port_grads(dtype, t):
        trained = tdit.trainable_copy(model).to(dtype)
        tstep.flow_matching_loss(trained, _t_batch(batch), t=t, eps=eps,
                                 remat="none").backward()
        return {k: p.grad.float().numpy()
                for k, p in trained.named_parameters()}

    port16 = port_grads(torch.bfloat16, t)
    ref = port_grads(torch.float32, t.bfloat16().float())
    exact_t = port_grads(torch.float32, t)
    d_jax, d_port = _rel_rms(jax16, ref), _rel_rms(port16, ref)
    d_between = _rel_rms(port16, jax16)
    print(f"bf16 step from the fp32 step at bf16 t: JAX {d_jax:.4e}, port "
          f"{d_port:.4e}; port from JAX {d_between:.4e}; fp32 at exact t "
          f"{_rel_rms(exact_t, ref):.4e}")
    assert d_port <= 1.25 * d_jax
    assert d_between <= d_jax + d_port


def test_train_checks_timestep_rounding_dominates_on_cpu():
    """tools/train_checks.py on the tiny bf16 DiT at the DataConfig
    shapes: the fp32 step moves farther when t goes unrounded than the
    bf16 step sits from the fp32 step at the rounded t (on CPU tensors
    the plain version stands in kernel A's place, so the two bf16 steps
    are one)."""
    from echo_tts_torch.tools import train_checks
    model = tdit.init_dit(tiny_dit_config(blockwise=False), device="cpu",
                          seed=0)
    batch, t, eps = train_checks.train_draws(model.cfg, 0, device="cpu")
    gaps = train_checks.precision_gaps(model, batch, t, eps)
    assert gaps["kernel_vs_plain"] == 0.0 and gaps["ratio"] == 1.0
    assert 0.0 < gaps["plain_vs_fp32"] < 1e-2
    assert gaps["fp32_exact_t"] > 10 * gaps["plain_vs_fp32"]


def test_flow_matching_loss_needs_draws(pair):
    with pytest.raises(ValueError, match="generator"):
        tstep.flow_matching_loss(pair[2], _t_batch(_batch()))


# ---------------------------------------------------------------------------
# The optimizer
# ---------------------------------------------------------------------------

def test_schedule_matches_optax():
    """warmup-cosine, value by value, against optax's, evaluated at the
    update count before its increment (the first update's lr is 0)."""
    want = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=1e-4, warmup_steps=3, decay_steps=10,
        end_value=1e-5)
    tx = tstep.make_optimizer(lr=1e-4, warmup_steps=3, total_steps=10)
    got = [tx.schedule(n) for n in range(14)]
    assert got[0] == 0.0
    np.testing.assert_allclose(got, [float(want(n)) for n in range(14)],
                               rtol=1e-6, atol=0)
    assert tstep.make_optimizer(lr=3e-4).schedule(7) == 3e-4
    with pytest.raises(ValueError, match="total_steps"):
        tstep.make_optimizer(warmup_steps=2)


def test_three_optimizer_steps_match_optax(pair_blockwise):
    """Three updates from fixed gradients whose global norm is past the
    clip (scaled by max_norm / norm, as optax does), warmup-cosine (the
    first update at lr 0), AdamW's decay reaching the parameters that have
    no gradient (the latent encoder's, left at zero), and the EMA in fp32:
    parameters and EMA within atol 1e-6 of optax plus the JAX package's
    EMA rule."""
    params, cfg, model = pair_blockwise
    tcfg = tiny_dit_config(blockwise=True)
    rng = np.random.default_rng(11)
    lr, decay = 1e-4, 0.5
    jtx = jstep.make_optimizer(lr=lr, weight_decay=0.5, warmup_steps=1,
                               total_steps=5)
    ttx = tstep.make_optimizer(lr=lr, weight_decay=0.5, warmup_steps=1,
                               total_steps=5)
    state = tstep.create_train_state(model, ttx, ema=True)
    names = dict(state.model.named_parameters())
    jparams, jema = params, params
    opt_state = jtx.init(params)

    @jax.jit
    def j_update(gtree, opt_state, jparams, jema):
        upd, opt_state = jtx.update(gtree, opt_state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        d = jnp.float32(decay)
        jema = jax.tree.map(lambda e, p: (d * e + (1 - d) * p).astype(e.dtype),
                            jema, jparams)
        return opt_state, jparams, jema

    for _ in range(3):
        gtree = jax.tree.map(
            lambda a: jnp.asarray(rng.standard_normal(a.shape)
                                  .astype(np.float32)), params)
        gtree["latent_encoder"] = jax.tree.map(jnp.zeros_like,
                                               gtree["latent_encoder"])
        opt_state, jparams, jema = j_update(gtree, opt_state, jparams, jema)
        for k, g in bridge.dit_state_from_jax(
                jax.tree.map(np.asarray, gtree), tcfg).items():
            names[k].grad.copy_(torch.tensor(g))
        norm = ttx.update(state.optimizer, state.step)
        assert norm > ttx.grad_clip                # clipping triggers
        state.step += 1
        tstep.update_ema(state.ema, state.model, decay)
    for tree, mod in ((jparams, state.model), (jema, state.ema)):
        want = bridge.dit_state_from_jax(jax.tree.map(np.asarray, tree), tcfg)
        for k, p in mod.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k],
                                       atol=1e-6, rtol=0, err_msg=k)
    # the input model is untouched; the latent encoder was decayed
    w0 = model.latent_encoder.in_proj.weight
    w3 = state.model.latent_encoder.in_proj.weight
    assert not torch.equal(w0, w3)
    assert state.model.latent_encoder.in_proj.weight.requires_grad
    assert not model.latent_encoder.in_proj.weight.requires_grad


def test_train_step_matches_jax(pair_blockwise):
    """One whole train step (loss, gradients, clipping, AdamW with its
    decay, EMA) against the JAX package's, t and eps injected from JAX's
    draws; at blockwise=True the latent encoder, which the loss does not
    reach, keeps a zero gradient and is decayed as optax decays it (the
    blockwise=False gradients and updates are held above).

    Parameters within atol 1e-6 where JAX's gradient is above 1e-5 in
    magnitude.  Adam's first update is g / (|g| + 1e-8) in each element:
    for |g| > 1e-5 the gradients' bound (atol 1e-5 / rtol 1e-4, held
    above) moves it by less than 1 % of a step; below that it can move
    it by up to the whole step, so there the bound is two steps (lr, 2 lr
    in the EMA's lag) beside the decay."""
    params, cfg, model = pair_blockwise
    tcfg = tiny_dit_config(blockwise=True)
    batch = _batch(seed=9)
    rng = jax.random.PRNGKey(5)
    lr, wd = 1e-4, 10.0
    jtx = jstep.make_optimizer(lr=lr, weight_decay=wd)

    @jax.jit
    def j_step(params, batch):
        loss, g = jax.value_and_grad(jstep.flow_matching_loss)(
            params, cfg, batch, rng, jnp.float32, "full")
        upd, _ = jtx.update(g, jtx.init(params), params)
        new = optax.apply_updates(params, upd)
        d = jnp.float32(0.9)
        return loss, g, new, jax.tree.map(lambda e, p: d * e + (1 - d) * p,
                                          params, new)

    loss_j, g, jparams, jema = j_step(params, jax.tree.map(jnp.asarray, batch))

    ttx = tstep.make_optimizer(lr=lr, weight_decay=wd)
    state = tstep.create_train_state(model, ttx, ema=True)
    step = tstep.make_train_step(ttx, ema_decay=0.9, remat="full")
    t, eps = _jax_draws(rng, batch["latents"].shape)
    state, loss = step(state, batch, t=t, eps=eps)
    assert state.step == 1
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-6)
    steady = {k: np.abs(v) > 1e-5 for k, v in bridge.dit_state_from_jax(
        jax.tree.map(np.asarray, g), tcfg).items()}
    for tree, mod in ((jparams, state.model), (jema, state.ema)):
        want = bridge.dit_state_from_jax(jax.tree.map(np.asarray, tree), tcfg)
        for k, p in mod.named_parameters():
            got = p.detach().numpy()
            np.testing.assert_allclose(got[steady[k]], want[k][steady[k]],
                                       atol=1e-6, rtol=0, err_msg=k)
            np.testing.assert_allclose(got, want[k], atol=2 * lr + 1e-6,
                                       rtol=0, err_msg=k)
    for p0, p1 in zip(model.latent_encoder.parameters(),
                      state.model.latent_encoder.parameters()):
        assert torch.count_nonzero(p1.grad) == 0
        torch.testing.assert_close(p1.detach(), p0 * (1 - lr * wd),
                                   rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# The loop and the data
# ---------------------------------------------------------------------------

def test_train_loop_descends_and_checkpoints(pair, tmp_path):
    """Six steps on one batch with fresh draws: the loss descends, the
    loop checkpoints the parameters and the EMA as safetensors every three
    steps, and the model it was given is left as it was; exhausted
    batches raise."""
    import itertools

    from safetensors.torch import load_file

    model = pair[2]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses = []
    state = tloop.train(
        model, itertools.repeat(_batch()), num_steps=6, lr=1e-3,
        ema_decay=0.5, checkpoint_dir=str(tmp_path), checkpoint_every=3,
        log_every=100, on_step=lambda i, v: losses.append(v), remat="attn")
    assert state.step == 6 and len(losses) == 6 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    for step in (3, 6):
        d = tmp_path / f"step_{step:08d}"
        assert set(os.listdir(d)) == {"params.safetensors", "ema.safetensors"}
    saved = load_file(str(tmp_path / "step_00000006" / "params.safetensors"))
    for k, v in state.model.state_dict().items():
        assert torch.equal(saved[k], v)
    for k, v in model.state_dict().items():
        assert torch.equal(before[k], v)
    with pytest.raises(ValueError, match="exhausted after 1 of 2"):
        tloop.train(model, [_batch()], num_steps=2)


def test_fixed_noise_repeats_the_step(pair):
    """fixed_noise gives every step the same t and eps: at lr 0 each
    step's loss is the first's, bit for bit."""
    import itertools
    batch = _batch()
    gen = torch.Generator().manual_seed(1)
    t = torch.rand((2,), generator=gen)
    eps = torch.randn((2, 16, 80), generator=gen)
    losses = []
    tloop.train(pair[2], itertools.repeat(batch), num_steps=2, lr=0.0,
                fixed_noise=(t, eps), on_step=lambda i, v: losses.append(v))
    assert losses[0] == losses[1]


@pytest.fixture(scope="module")
def torch_models(tiny_models):
    from echo_tts_torch.config import tiny_dac_config
    from echo_tts_torch.pipeline.pipeline import EchoModels
    return EchoModels(
        dit=bridge.load_dit_state(bridge.dit_state_from_jax(
            jax.tree.map(np.asarray, tiny_models.dit_params),
            tiny_dit_config()), tiny_dit_config(), device="cpu",
            dtype=torch.float32),
        dac=bridge.load_dac_state(bridge.dac_state_from_jax(
            jax.tree.map(np.asarray, tiny_models.dac_params),
            tiny_dac_config()), tiny_dac_config(), device="cpu",
            dtype=torch.float32),
        pca=bridge.pca_state(jax.tree.map(np.asarray, tiny_models.pca),
                             device="cpu"),
        dtype=torch.float32)


def test_shards_and_batches_match_jax(tiny_models, torch_models, tmp_path):
    """write_shards through the port's codec keeps the JAX package's .npz
    layout: its load_shard reads the port's shards, and iter_batches
    yields the JAX package's batches bit for bit from them (the same
    numpy draws); a short utterance is dropped; the speaker clip and the
    target window do not overlap; one train step takes the batch."""
    spl = torch_models.dac_cfg.frame_length
    rng = np.random.default_rng(0)
    items = [(np.tanh(rng.standard_normal((1, (16 + 8 * i) * spl)))
              .astype(np.float32), f"Utterance number {i}.")
             for i in range(5)]
    items.append((np.tanh(rng.standard_normal((1, 2 * spl))).astype(
        np.float32), "Too short, dropped."))
    dcfg = tdata.DataConfig(sequence_length=16, text_length=32,
                            speaker_length=8, min_latents=8)
    shards = tdata.write_shards(torch_models, items, str(tmp_path / "shards"),
                                shard_size=3, cfg=dcfg)
    assert len(shards) == 2
    utts = jdata.load_shard(shards[0])
    assert len(utts) == 3 and utts[0][0].shape == (16, 80)
    jcfg = jdata.DataConfig(sequence_length=16, text_length=32,
                            speaker_length=8, min_latents=8)
    want = jdata.iter_batches(shards, tiny_models, batch_size=2, cfg=jcfg,
                              seed=1)
    got = tdata.iter_batches(shards, torch_models, batch_size=2, cfg=dcfg,
                             seed=1)
    for _ in range(5):
        w, g = next(want), next(got)
        assert set(w) == set(g)
        for k in w:
            assert g[k].dtype == np.asarray(w[k]).dtype, k
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
    assert (g["latents"][~g["latent_mask"]] == 0).all()
    for i in range(2):
        assert not np.allclose(g["speaker_latent"][i, 0], g["latents"][i, 0])
    one_epoch = list(tdata.iter_batches(shards, torch_models, batch_size=2,
                                        cfg=dcfg, seed=1, loop=False))
    assert len(one_epoch) == 2
    with pytest.raises(ValueError, match="batch_size"):
        next(tdata.iter_batches(shards, torch_models, batch_size=4, cfg=dcfg))

    model = tdit.init_dit(tiny_dit_config(), device="cpu",
                          dtype=torch.float32)
    state = tloop.train(model, tdata.iter_batches(
        shards, torch_models, batch_size=2, cfg=dcfg), num_steps=1, lr=1e-3)
    assert state.step == 1


def test_train_entry_points_refuse_cuda_without_a_card(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdit.init_dit(tiny_dit_config(), device="cuda")


def test_port_imports_no_jax():
    """The training, checkpoint, hub and demo modules import neither jax
    nor the JAX package."""
    code = ("import sys\n"
            "import echo_tts_torch.train, echo_tts_torch.train.loop\n"
            "import echo_tts_torch.train.recipe, echo_tts_torch.tools.checkpoint\n"
            "import echo_tts_torch.tools.hub, echo_tts_torch.demo\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.split('.')[0] in ('echo_tts_tpu', 'optax', 'orbax')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout + out.stderr
