"""The residual-stack kernel's plain version (what its wrapper runs for CPU
tensors) against the JAX package's Pallas kernel in interpret mode, at the
shapes of tests/test_res_stack_kernel.py, exact sin and sin2_poly.

Bound atol 2e-5 / rtol 1e-4 (fp32): the JAX suite's own bound
(tests/test_res_stack_kernel.py:48).  The CUDA kernel is held against the
same plain version on the card by chip_smoke.py (bf16, rel-RMS <= 1e-2).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from echo_tts_tpu.ops.pallas.res_stack import fused_res_stack as j_fused

from echo_tts_torch.ops import res_stack as rs

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)


def _units(rng, c):
    def conv(k):
        return {"kernel": (rng.standard_normal((k, c, c)).astype(np.float32)
                           * (k * c) ** -0.5),
                "bias": rng.standard_normal(c).astype(np.float32) * 0.01}
    return [{"snake1": 1.0 + 0.1 * rng.standard_normal(c).astype(np.float32),
             "conv1": conv(7),
             "snake2": 1.0 + 0.1 * rng.standard_normal(c).astype(np.float32),
             "conv2": conv(1)} for _ in range(3)]


def _stacked(units):
    """(w1, b1, a1, w2, b2, a2), the wrapper's weights, from the JAX unit
    dicts."""
    def st(fn):
        return torch.from_numpy(np.stack([fn(u) for u in units]))
    return (st(lambda u: u["conv1"]["kernel"]), st(lambda u: u["conv1"]["bias"]),
            st(lambda u: u["snake1"]), st(lambda u: u["conv2"]["kernel"][0]),
            st(lambda u: u["conv2"]["bias"]), st(lambda u: u["snake2"]))


@pytest.mark.parametrize("c,length,block_l,approx", [
    (128, 512, 128, False),    # several tiles
    (96, 300, 128, False),     # channel padding + ragged final tile
    (96, 300, 128, True),      # the serving decoder's polynomial snake
    (192, 96, 256, True),      # one tile longer than the sequence
])
def test_plain_matches_pallas_interpret(c, length, block_l, approx):
    rng = np.random.default_rng(c + length)
    units = _units(rng, c)
    x = rng.standard_normal((1, length, c)).astype(np.float32) * 0.3
    jt = [{k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
               if isinstance(v, dict) else jnp.asarray(v))
           for k, v in u.items()} for u in units]
    want = j_fused(jt, jnp.asarray(x), block_l=block_l, interpret=True,
                   approx_snake=approx)
    got = rs.fused_res_stack(torch.from_numpy(x),
                             rs.ResStackWeights(*_stacked(units)),
                             approx_snake=approx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_batch_rows_are_independent():
    rng = np.random.default_rng(9)
    units = _units(rng, 64)
    x = rng.standard_normal((2, 200, 64)).astype(np.float32) * 0.3
    w = rs.ResStackWeights(*_stacked(units))
    both = rs.fused_res_stack(torch.from_numpy(x), w)
    for i in range(2):
        one = rs.fused_res_stack(torch.from_numpy(x[i:i + 1]), w)
        np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(), **TOL)


def test_gate_and_block_length():
    """The kernel gate (C <= 384, any length) only opens for CUDA tensors,
    and every instantiated width fits its tile + 78-frame context twice in
    a block's shared memory."""
    assert not rs.res_stack_eligible(torch.zeros((1, 8192, 96)))
    assert not rs.res_stack_eligible(torch.zeros((1, 300, 96)))
    # what the gate reads of a CUDA tensor: a short block at C = 96 takes
    # the kernel, a width without a kernel does not
    assert rs.res_stack_eligible(SimpleNamespace(is_cuda=True, shape=(1, 300, 96)))
    assert not rs.res_stack_eligible(
        SimpleNamespace(is_cuda=True, shape=(1, 8192, 512)))
    for c in rs.KERNEL_WIDTHS:
        bl = rs.block_length(c)
        assert bl >= 64 and bl % 16 == 0
        assert 2 * (bl + rs.HALO) * (c + 8) * 2 <= rs.SMEM_LIMIT


@pytest.mark.parametrize("c,length,approx", [(96, 300, True), (384, 40, False)])
def test_first_tile_bound_sees_a_nonzero_context(c, length, approx):
    """chip_smoke.py holds the kernel's first tile to rel-RMS 1e-2 of the
    plain version at these short blocks, with its weight scales.  A kernel
    that did not force the positions before the sequence start back to
    zero after each unit would compute the units over a 78-frame context
    that starts at zero and then drifts (bias, snake of the bias): that
    fault must miss the bound by a wide margin."""
    rng = np.random.default_rng(c + length)

    def arr(shape, std, mean=0.0):
        return torch.from_numpy(
            (mean + std * rng.standard_normal(shape)).astype(np.float32)
        ).to(torch.bfloat16)

    x = arr((1, length, c), 0.5)
    w = (arr((3, 7, c, c), (7 * c) ** -0.5), arr((3, c), 0.1),
         arr((3, c), 0.1, 1.0), arr((3, c, c), c ** -0.5), arr((3, c), 0.1),
         arr((3, c), 0.1, 1.0))
    want = rs.res_stack_plain(x, *w, approx).float()
    padded = torch.nn.functional.pad(x, (0, 0, rs.HALO, 0))
    fault = rs.res_stack_plain(padded, *w, approx)[:, rs.HALO:].float()
    rel = float((fault - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    assert rel > 3e-2


def test_kernel_launch_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rng = np.random.default_rng(3)
    units = _units(rng, 64)
    x = torch.from_numpy(rng.standard_normal((1, 64, 64)).astype(np.float32))
    w = rs.ResStackWeights(*(a.to(torch.bfloat16) for a in _stacked(units)))
    before = rs.fused_res_stack.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        rs._launch(x.to(torch.bfloat16), w, False)
    assert rs.fused_res_stack.launches == before
