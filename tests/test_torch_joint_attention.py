"""The joint-attention kernel's plain version (what its wrapper runs for
CPU tensors) against the JAX package's Pallas kernel in interpret mode,
at the shapes of tests/test_pallas_attention.py.

Bound atol 2e-5 / rtol 1e-4 (fp32): the JAX suite's kernel-vs-twin bound
(tests/test_pallas_attention.py:80).  The CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py (bf16,
rel-RMS <= 1e-2).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from echo_tts_tpu.ops.pallas.joint_attention import fused_joint_attention as j_fused

from echo_tts_torch.ops import joint_attention as ja

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)


def _inputs(seed, gb, b, s, t, h, dh, col_scale):
    rng = np.random.default_rng(seed)

    def arr(*sh):
        return rng.standard_normal(sh).astype(np.float32)

    q, ks, vs = arr(gb, s, h, dh), arr(gb, s, h, dh), arr(gb, s, h, dh)
    kt, vt = arr(b, t, h, dh), arr(b, t, h, dh)
    mask = rng.random((gb, t)) > 0.3
    mask[:, 0] = True
    cs = (1.0 + 0.5 * rng.random(t)).astype(np.float32) if col_scale else None
    return q, ks, vs, kt, vt, mask, cs


@pytest.mark.parametrize("gb,b,s,t,h,dh,col_scale,flash", [
    (6, 2, 16, 72, 2, 128, False, False),    # G-broadcast, T not a lane multiple
    (2, 1, 150, 300, 2, 128, True, True),    # flash tiles, ragged, col scale
    (3, 1, 40, 80, 1, 128, True, False),     # CFG batch over one KV row
])
def test_plain_matches_pallas_interpret(gb, b, s, t, h, dh, col_scale, flash):
    q, ks, vs, kt, vt, mask, cs = _inputs(gb + s, gb, b, s, t, h, dh, col_scale)
    sm = dh ** -0.5
    kw = dict(flash=True, block_q=64, block_kv=64) if flash else {}
    want = j_fused(*(jnp.asarray(a) for a in (q, ks, vs, kt, vt, mask)),
                   None if cs is None else jnp.asarray(cs), sm_scale=sm,
                   interpret=True, **kw)
    got = ja.fused_joint_attention(
        *(torch.from_numpy(a) for a in (q, ks, vs, kt, vt, mask)),
        None if cs is None else torch.from_numpy(cs), sm_scale=sm)
    assert got.shape == (gb, s, h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fully_masked_cfg_segment_is_finite():
    """An uncond branch whose static columns are ALL masked attends to self
    only: finite, and equal to plain self-attention."""
    q, ks, vs, kt, vt, mask, cs = _inputs(7, 3, 1, 24, 40, 2, 64, True)
    mask[1] = False
    got = ja.fused_joint_attention(
        *(torch.from_numpy(a) for a in (q, ks, vs, kt, vt, mask)),
        torch.from_numpy(cs), sm_scale=0.125)
    assert torch.isfinite(got).all()
    qt, kt_, vt_ = (torch.from_numpy(a)[1].transpose(0, 1) for a in (q, ks, vs))
    w = torch.softmax(qt @ kt_.transpose(1, 2) * 0.125, dim=-1)
    np.testing.assert_allclose(got[1].numpy(), (w @ vt_).transpose(0, 1).numpy(),
                               **TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    q, ks, vs, kt, vt, mask, _ = _inputs(8, 2, 1, 8, 16, 1, 64, False)
    args = [torch.from_numpy(a) for a in (q, ks, vs, kt, vt, mask)]
    with pytest.raises(TypeError, match="int8"):
        ja.fused_joint_attention(*args[:3], args[3].to(torch.int8),
                                 args[4].to(torch.int8), args[5], sm_scale=0.1)
    with pytest.raises(ValueError, match="multiple"):
        ja.fused_joint_attention(*args[:5], args[5][:1], sm_scale=0.1)


def test_kernel_launch_needs_cuda():
    """The kernel path never runs on the CPU: launching it without a CUDA
    device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, ks, vs, kt, vt, mask, _ = _inputs(9, 1, 1, 8, 16, 1, 128, False)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, ks, vs, kt, vt)]
    before = ja.fused_joint_attention.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        ja._launch(*t, torch.from_numpy(mask), torch.ones((16,)), 0.125)
    assert ja.fused_joint_attention.launches == before
