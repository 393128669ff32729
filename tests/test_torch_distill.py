"""The port's few-step distillation (echo_tts_torch/train/distill.py) and
its QAT fake-quant (ops/quant.qat_dot, qat_tag_dit_params) against the
JAX package on the same tiny fp32 weights (tools/bridge.py), with the
JAX package's own draws of the grid index i and eps injected.

Bounds: the plain loss at rtol 1e-6 and the student's gradients at atol
1e-5 / rtol 1e-4, the JAX suite's bounds for the flow-matching loss
(tests/test_train_loop.py:63-69); qat_dot at atol 1e-5 on inputs away
from rounding ties; the QAT loss at the bound stated in its test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.ops import quant as jq
from echo_tts_tpu.train import distill as jdistill

from echo_tts_torch.config import tiny_dit_config
from echo_tts_torch.models import dit as tdit
from echo_tts_torch.ops import quant as tq
from echo_tts_torch.tools import bridge
from echo_tts_torch.train import distill as tdistill

torch.set_num_threads(1)
CFG = tiny_dit_config()
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
N_STUDENT, SUBSTEPS = 8, 2


@pytest.fixture(scope="module")
def pair(tiny_models):
    params = tiny_models.dit_params
    model = bridge.load_dit_state(
        bridge.dit_state_from_jax(jax.tree.map(np.asarray, params), CFG),
        CFG, device="cpu", dtype=torch.float32)
    return params, tiny_models.dit_cfg, model


def _batch(seed=5, b=2):
    rng = np.random.default_rng(seed)
    tmask = np.ones((b, 12), bool)
    tmask[1, 7:] = False
    lmask = np.ones((b, 16), bool)
    lmask[0, 12:] = False
    return {"latents": (rng.standard_normal((b, 16, 80)) * 0.5).astype(np.float32),
            "text_ids": rng.integers(0, 256, (b, 12)).astype(np.int32),
            "text_mask": tmask,
            "speaker_latent": rng.standard_normal((b, 8, 80)).astype(np.float32),
            "speaker_mask": np.ones((b, 8), bool),
            "latent_mask": lmask}


def _jax_draws(rng, b, shape):
    k_i, k_eps = jax.random.split(rng)
    i = jax.random.randint(k_i, (b,), 0, N_STUDENT)
    eps = jax.random.normal(k_eps, shape, dtype=jnp.float32)
    return torch.from_numpy(np.array(i)), torch.from_numpy(np.array(eps))


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "qat"])
def losses(request, pair):
    """(JAX loss, JAX student gradients by state key, port loss, port
    student) for one distill_loss, plain or quant-aware: one JAX
    value-and-grad per mode."""
    params, cfg, model = pair
    quant_aware = request.param
    batch = _batch()
    rng = jax.random.PRNGKey(4)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda s, t, b: jdistill.distill_loss(
            s, t, cfg, b, rng, num_student_steps=N_STUDENT,
            substeps=SUBSTEPS, dtype=jnp.float32, quant_aware=quant_aware)))(
        params, params, jax.tree.map(jnp.asarray, batch))
    want = bridge.dit_state_from_jax(jax.tree.map(np.asarray, gj), CFG)
    student = tdit.trainable_copy(model)
    i, eps = _jax_draws(rng, 2, batch["latents"].shape)
    loss = tdistill.distill_loss(
        student, model, {k: torch.from_numpy(v) for k, v in batch.items()},
        i=i, eps=eps, num_student_steps=N_STUDENT, substeps=SUBSTEPS,
        quant_aware=quant_aware)
    loss.backward()
    return float(lj), want, float(loss.detach()), student


def test_distill_loss_and_grads_match_jax(losses, request):
    """The teacher's substeps with dual CFG (3B rows, the sampler's branch
    masks, no grad), the student's one forward under grad; the loss and
    every gradient of the student against JAX's.

    Quant-aware: the forward rounds each activation row to int8 through
    qat_dot.  An element that sits within the two frameworks' fp32
    difference of a rounding tie rounds one int8 step apart (ROADMAP
    queue 3, "Not faults"); one such step moves the product by
    x_scale * w_scale * |w_q| in one term.  The QAT loss is held at rtol
    1e-3 and its gradients at atol 1e-3 / rtol 1e-2, bounds that a
    handful of such steps stay inside and a wrong scale, clip or
    straight-through rule (an error of the order of the values) breaks;
    the plain case holds the tight bounds."""
    lj, want, lt, student = losses
    qat = "qat" in request.node.callspec.id
    # the latent encoder is not reached: no gradient here, zeros in JAX
    got = {k: np.zeros(p.shape, np.float32) if p.grad is None
           else p.grad.numpy() for k, p in student.named_parameters()}
    assert set(got) == set(want)
    if qat:
        np.testing.assert_allclose(lt, lj, rtol=1e-3)
        tol = dict(atol=1e-3, rtol=1e-2)
    else:
        np.testing.assert_allclose(lt, lj, rtol=1e-6)
        tol = GRAD_TOL
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _away_from_ties(a, axis, rng):
    """Redraw the elements of `a` whose a / (abs-max / 127) lies within
    1e-3 of a rounding tie, until none does."""
    while True:
        scale = np.maximum(np.abs(a).max(axis=axis, keepdims=True),
                           1e-12) / np.float32(127.0)
        v = a / scale
        near = np.abs(np.abs(v - np.floor(v)) - 0.5) < 1e-3
        if not near.any():
            return a
        a[near] = rng.standard_normal(int(near.sum())).astype(np.float32)


def test_qat_dot_matches_jax():
    """qat_dot's value and its straight-through gradients for x and w
    against JAX's, on inputs away from rounding ties."""
    rng = np.random.default_rng(0)
    x = _away_from_ties(rng.standard_normal((3, 5, 32)).astype(np.float32),
                        -1, rng)
    w = _away_from_ties(rng.standard_normal((32, 24)).astype(np.float32),
                        -2, rng)          # JAX's (K, N)
    ct = rng.standard_normal((3, 5, 24)).astype(np.float32)
    out_j, vjp = jax.vjp(jq.qat_dot, jnp.asarray(x), jnp.asarray(w))
    gx_j, gw_j = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    out = tq.qat_dot(xt, wt)
    out.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(gw_j),
                               atol=1e-5, rtol=0)
    # its values are int8_dot's quantization decisions in fp32
    w8, ws = tq.quantize_weight_int8(wt.detach())
    np.testing.assert_allclose(
        out.detach().numpy(), tq.int8_dot(xt.detach(), w8, ws).numpy(),
        rtol=1e-5, atol=1e-5)


def test_qat_view_shares_parameters(pair):
    """qat_tag_dit_params runs the hot-loop leaves through qat_dot over the
    plain model's own Parameters (the optimizer keeps seeing those); it
    refuses a W8A8 model (kernel C has no gradient)."""
    student = tdit.trainable_copy(pair[2])
    view = tq.qat_tag_dit_params(student)
    for i, blk in enumerate(view.blocks):
        for group, key in tq.DIT_BLOCK_QUANT_KEYS:
            leaf = blk._modules[group]._modules[key]
            assert isinstance(leaf, tq.QATLinear)
            plain = student.blocks[i]._modules[group]._modules[key]
            assert leaf.weight is plain.weight
    assert {k: v.data_ptr() for k, v in view.state_dict().items()} == {
        k: v.data_ptr() for k, v in student.state_dict().items()}
    with pytest.raises(TypeError, match="nn.Linear"):
        tq.qat_tag_dit_params(tq.quantize_dit(pair[2]))


def test_distill_loop_and_few_step_params(pair):
    """Two distill steps: the student starts as a copy of the teacher and
    moves, the teacher does not; the loss is finite; exhausted batches
    raise; few_step_sampler_params empties the CFG window."""
    import itertools
    model = pair[2]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    losses = []
    state = tdistill.distill(model, itertools.repeat(_batch()), num_steps=2,
                             num_student_steps=4, substeps=2, lr=1e-3,
                             ema_decay=0.5, quant_aware=True,
                             on_step=lambda i, v: losses.append(v))
    assert state.step == 2 and np.isfinite(losses).all()
    assert state.ema is not None
    for k, v in model.state_dict().items():
        assert torch.equal(before[k], v), k
    assert not torch.equal(state.model.blocks[0].mlp.w1.weight,
                           model.blocks[0].mlp.w1.weight)
    with pytest.raises(ValueError, match="exhausted after 1 of 2"):
        tdistill.distill(model, [_batch()], num_steps=2, substeps=1)
    p = tdistill.few_step_sampler_params(8)
    assert p == jdistill.few_step_sampler_params(8)
    assert p["cfg_min_t"] > 1.0
