"""The joint-attention kernel's plain version (what its wrapper runs for
CPU tensors) against the JAX package's Pallas kernel in interpret mode,
at the shapes of tests/test_pallas_attention.py.

Bound atol 2e-5 / rtol 1e-4 (fp32): the JAX suite's kernel-vs-twin bound
(tests/test_pallas_attention.py:80).  The CUDA kernel itself is held
against the same plain version on the card by chip_smoke.py (bf16,
rel-RMS <= 1e-2).

Gradients: the autograd Function that carries the CUDA kernel
(`_KernelWithPlainGrad`) runs here with a stand-in forward that returns
the plain output without a graph, as the kernel's launch does; its
backward (a recompute through the plain version) is held against JAX's
gradient through the Pallas kernel's custom VJP (`_fused_fn`, interpret
mode) at the bound of tests/test_pallas_attention.py:119,249 (atol 3e-5,
rtol 1e-3).
"""
import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from echo_tts_tpu.ops import quant as jq
from echo_tts_tpu.ops.pallas.joint_attention import fused_joint_attention as j_fused

from echo_tts_torch.ops import cuda_build
from echo_tts_torch.ops import joint_attention as ja
from echo_tts_torch.ops import quant as tq

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


@pytest.mark.parametrize("flash", [False, True], ids=["whole_row", "flash"])
def test_plain_int8_kv_matches_pallas_interpret(flash):
    """int8 static K/V with kv_scales (the port's quantizer, held bit-equal
    to the JAX one in tests/test_torch_quant.py) at the shape of
    tests/test_pallas_attention.py:190, against both Pallas kernels."""
    gb, b, s, t, h, dh = 2, 1, 96, 260, 2, 128
    q, ks, vs, kt, vt, mask, cs = _inputs(11, gb, b, s, t, h, dh, True)
    sm = dh ** -0.5
    jkv = jq.quantize_kv_int8(jnp.asarray(kt), jnp.asarray(vt))
    want = j_fused(*(jnp.asarray(a) for a in (q, ks, vs)), jkv["k8"], jkv["v8"],
                   jnp.asarray(mask), jnp.asarray(cs), sm_scale=sm,
                   interpret=True, flash=flash, block_q=64, block_kv=64,
                   kv_scales=(jkv["ks"], jkv["vs"]))
    kv = tq.quantize_kv_int8(torch.from_numpy(kt), torch.from_numpy(vt))
    got = ja.fused_joint_attention(
        *(torch.from_numpy(a) for a in (q, ks, vs)), kv["k8"], kv["v8"],
        torch.from_numpy(mask), torch.from_numpy(cs), sm_scale=sm,
        kv_scales=(kv["ks"], kv["vs"]))
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
    scales = (torch.ones((1, 16, 1)), torch.ones((1, 16, 1)))
    with pytest.raises(TypeError, match="kv_scales"):
        ja.fused_joint_attention(*args, sm_scale=0.1, kv_scales=scales)
    with pytest.raises(ValueError, match="kv_scales"):
        ja.fused_joint_attention(*args[:3], args[3].to(torch.int8),
                                 args[4].to(torch.int8), args[5], sm_scale=0.1,
                                 kv_scales=(scales[0][:, :8], scales[1]))


@pytest.mark.parametrize("gb", [1, 3])
@pytest.mark.parametrize("t", [778, 2368])
@pytest.mark.parametrize("s", [640, 1280])
def test_tile_plan_covers_and_fills(gb, t, s):
    """Kernel A's query tile at the main path's shapes (H = 16; GB = 3 on
    CFG steps, 1 else; T = 778 for a short prompt with a 2 s voice, 2368
    for the longest; S = 640 latents, 1280 for two): a tile the kernel
    takes (T does not enter the plan: every block walks all of [self |
    static]); the (q-tile, h, gb) blocks cover every output row exactly
    once; a plan with fewer blocks than SMs runs in one partial wave, and
    halving its tile would give more blocks than SMs (the source note's
    reason)."""
    h = 16
    bq = ja._tile_plan(gb, s, h)
    assert bq == ja.QUERY_TILE
    cover = np.zeros((gb, s, h), dtype=int)
    for g in range(gb):
        for start in range(0, s, bq):
            for head in range(h):
                cover[g, start:start + bq, head] += 1
    assert (cover == 1).all()
    blocks = -(-s // bq) * h * gb
    if blocks < cuda_build.SMS:
        assert -(-s // (bq // 2)) * h * gb > cuda_build.SMS


def test_kernel_launch_needs_cuda():
    """The kernel path never runs on the CPU: launching it without a CUDA
    device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    q, ks, vs, kt, vt, mask, _ = _inputs(9, 1, 1, 8, 16, 1, 128, False)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, ks, vs, kt, vt)]
    before = (ja.fused_joint_attention.launches,
              ja.fused_joint_attention.launches_kv8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ja._launch(*t, torch.from_numpy(mask), torch.ones((16,)), 0.125)
    kv = tq.quantize_kv_int8(t[3], t[4])
    with pytest.raises(RuntimeError, match="CUDA"):
        ja._launch(*t[:3], kv["k8"], kv["v8"], torch.from_numpy(mask), None,
                   0.125, (kv["ks"], kv["vs"]))
    assert (ja.fused_joint_attention.launches,
            ja.fused_joint_attention.launches_kv8) == before


def _graphless_plain(q, ks, vs, kt, vt, mask, cs, sm_scale):
    """A stand-in for the kernel's launch: the plain output, no graph."""
    with torch.no_grad():
        return ja.joint_attention_plain(q, ks, vs, kt, vt, mask, cs,
                                        sm_scale=sm_scale)


@pytest.mark.parametrize("gb,b,s,t,h,flash", [
    (3, 1, 40, 80, 1, False),   # a CFG batch over one KV row
    (2, 1, 40, 80, 1, True),    # the flash forward (test_pallas_attention:249)
    (6, 2, 16, 72, 2, False),   # G-broadcast over a KV batch of 2
])
def test_kernel_grad_matches_jax_custom_vjp(gb, b, s, t, h, flash):
    dh = 128
    q, ks, vs, kt, vt, mask, cs = _inputs(30 + gb, gb, b, s, t, h, dh, True)
    ct = np.random.default_rng(31).standard_normal((gb, s, h, dh)).astype(
        np.float32)
    sm = dh ** -0.5
    jmask = jnp.asarray(mask)

    def loss(q, ks, vs, kt, vt, cs):
        out = j_fused(q, ks, vs, kt, vt, jmask, cs, sm_scale=sm,
                      interpret=True, flash=flash, block_q=16, block_kv=64)
        return jnp.sum(out * jnp.asarray(ct))

    want = jax.grad(loss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in (q, ks, vs, kt, vt, cs)))
    leaves = [torch.from_numpy(a).requires_grad_()
              for a in (q, ks, vs, kt, vt, cs)]
    out = ja._KernelWithPlainGrad.apply(
        _graphless_plain, sm, *leaves[:5], torch.from_numpy(mask), leaves[5])
    assert out.grad_fn is not None
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(j_fused(*(jnp.asarray(a) for a in (q, ks, vs, kt, vt)),
                           jmask, jnp.asarray(cs), sm_scale=sm,
                           interpret=True)), **TOL)
    out.backward(torch.from_numpy(ct))
    for name, leaf, w in zip(("q", "k_self", "v_self", "k_static",
                              "v_static", "col_scale"), leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w),
                                   atol=3e-5, rtol=1e-3, err_msg=name)


def test_kernel_grad_only_where_asked():
    """Inputs that do not require grad get none, and the Function's
    gradients equal those of autograd through the plain version (the
    wrapper's CPU path)."""
    q, ks, vs, kt, vt, mask, cs = _inputs(33, 3, 1, 24, 40, 2, 64, True)
    sm = 0.125
    a = [torch.from_numpy(x) for x in (q, ks, vs, kt, vt)]
    a[0].requires_grad_()
    a[4].requires_grad_()
    m, c = torch.from_numpy(mask), torch.from_numpy(cs)
    out = ja._KernelWithPlainGrad.apply(_graphless_plain, sm, *a, m, c)
    g_fn = torch.autograd.grad(out.sum(), [a[0], a[4]])
    assert a[1].grad is None and a[3].grad is None
    ref = ja.fused_joint_attention(*a, m, c, sm_scale=sm)
    g_ref = torch.autograd.grad(ref.sum(), [a[0], a[4]])
    for x, y in zip(g_fn, g_ref):
        torch.testing.assert_close(x, y)


def test_int8_kv_has_no_gradient():
    """The int8 static K/V form raises under grad (the JAX package gives
    it none), and runs without grad."""
    q, ks, vs, kt, vt, mask, cs = _inputs(34, 2, 1, 16, 40, 1, 128, True)
    kv = tq.quantize_kv_int8(torch.from_numpy(kt), torch.from_numpy(vt))
    qt = torch.from_numpy(q).requires_grad_()
    args = (qt, torch.from_numpy(ks), torch.from_numpy(vs), kv["k8"],
            kv["v8"], torch.from_numpy(mask), torch.from_numpy(cs))
    kw = dict(sm_scale=0.1, kv_scales=(kv["ks"], kv["vs"]))
    with pytest.raises(RuntimeError, match="no gradient"):
        ja.fused_joint_attention(*args, **kw)
    with torch.no_grad():
        assert ja.fused_joint_attention(*args, **kw).shape == q.shape
