"""The card's AdamW against optax, at full width in bf16.

On a card the train programs run AdamW in its capturable form
(echo_tts_torch/train/step.py `Optimizer.init`): its step count and bias
corrections are device tensors, and it divides by them, which rounds the
corrections to the parameters' dtype.  The CPU tests hold the other form,
the CPU's, against optax (tests/test_torch_train.py).  This test holds
both against optax's clip_by_global_norm then adamw, the JAX package's
`make_optimizer` (echo_tts_tpu/train/step.py:117-118), on the host CPU:
one update of the published DiT cut to 4 DiT layers (2 in each encoder,
chip_smoke.py's TRAIN_DEPTH) from the same bf16 parameters and the same
gradients, those of one flow-matching step on the card.  optax keeps its
moments in the parameters' dtype and casts its bias corrections to it
too.  It prints each form's rel-RMS from optax's update and gates the
capturable form's at 1.1 times the CPU form's.

It needs a CUDA card and is marked slow:

    python -m pytest tests/test_torch_adamw_optax.py -m slow -q -s
"""
import json
import math

import numpy as np
import pytest
import torch

LR, WEIGHT_DECAY = 1e-4, 0.01
CAPTURABLE_RATIO = 1.1


def _update_distance(got, want, before) -> float:
    """rel-RMS of one form's update (got - before) from optax's (want -
    before), over every parameter, in float64."""
    num = den = 0.0
    for g, w, b in zip(got, want, before):
        b = b.double()
        du, dw = g.double() - b, w.double() - b
        num += float((du - dw).pow(2).sum())
        den += float(dw.pow(2).sum())
    return math.sqrt(num / den)


@pytest.mark.slow
def test_capturable_adamw_against_optax():
    if not torch.cuda.is_available():
        pytest.skip("the capturable AdamW runs on a CUDA card")
    import jax.numpy as jnp
    import optax

    from echo_tts_tpu.train import step as jstep
    from echo_tts_torch.device import card_name
    from echo_tts_torch.models import dit as tdit
    from echo_tts_torch.tools.parallel_checks import cut_config
    from echo_tts_torch.tools.train_checks import step_grads, train_draws
    from echo_tts_torch.train import step as tstep

    cfg = cut_config(4)
    model = tdit.init_dit(cfg, device="cuda", seed=1)
    batch, t, eps = train_draws(cfg, seed=0, device="cuda")
    _, grads = step_grads(model, batch, t, eps)
    before = [p.detach().cpu() for p in model.parameters()]
    host_grads = [g.cpu() for g in grads]

    tx = tstep.make_optimizer(lr=LR, weight_decay=WEIGHT_DECAY)
    after = {}
    for form, device in (("capturable", "cuda"), ("cpu", "cpu")):
        trained = tdit.trainable_copy(model).to(device)
        params = list(trained.parameters())
        opt = tx.init(params)
        assert opt.defaults["capturable"] == (device == "cuda")
        for p, g in zip(params, grads):
            p.grad.copy_(g)
        norm = float(tx.update(opt, 0))
        after[form] = [p.detach().cpu() for p in params]
        del trained, params, opt

    def jx(x):
        return jnp.asarray(x.float().numpy(), dtype=jnp.bfloat16)

    jtx = jstep.make_optimizer(lr=LR, weight_decay=WEIGHT_DECAY)
    jparams = [jx(p) for p in before]
    updates, _ = jtx.update([jx(g) for g in host_grads],
                            jtx.init(jparams), jparams)
    new = optax.apply_updates(jparams, updates)
    assert all(p.dtype == jnp.bfloat16 for p in new)
    optax_after = [torch.from_numpy(np.asarray(p, dtype=np.float32))
                   for p in new]
    del new

    dist = {form: _update_distance(a, optax_after, before)
            for form, a in after.items()}
    dist["capturable_vs_cpu"] = _update_distance(after["capturable"],
                                                 after["cpu"], before)
    print(json.dumps({"card": card_name(), "params": sum(
        p.numel() for p in before), "grad_norm": norm,
        "update_rel_rms": dist}), flush=True)
    assert dist["capturable"] <= CAPTURABLE_RATIO * dist["cpu"], dist
