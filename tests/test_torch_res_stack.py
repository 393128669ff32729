"""The residual-stack kernel's plain version (what its wrapper runs for CPU
tensors) against the JAX package's Pallas kernel in interpret mode, at the
shapes of tests/test_res_stack_kernel.py, exact sin and sin2_poly.

The history form (streaming) is held against three calls of the JAX
package's streaming unit, `_residual_unit_s`.

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
    and the kernel's tile plan holds at every instantiated width and
    dilation: every row of a unit is produced by exactly one block, each
    block reads 6 * d rows of context, and a block's shared memory (weight
    ring, tile and context, barriers) fits the 232 448 bytes of an sm_90
    block."""
    assert not rs.res_stack_eligible(torch.zeros((1, 8192, 96)))
    assert not rs.res_stack_eligible(torch.zeros((1, 300, 96)))
    # what the gate reads of a CUDA tensor: a short block at C = 96 takes
    # the kernel, a width without a kernel does not
    assert rs.res_stack_eligible(SimpleNamespace(is_cuda=True, shape=(1, 300, 96)))
    assert not rs.res_stack_eligible(
        SimpleNamespace(is_cuda=True, shape=(1, 8192, 512)))
    for c in rs.KERNEL_WIDTHS:
        plan = rs.tile_plan(c)
        # two consumer warpgroups of 64 rows; each holds at most 128 fp32
        # accumulators a thread (64 x C / ns)
        assert plan["bm"] * plan["ns"] == 128 and c // plan["ns"] <= 256
        assert plan["kp"] % 64 == 0 and 0 <= plan["kp"] - c < 64
        assert 2 <= plan["stages"] <= 4
        length = 5 * plan["bm"] + 7
        for d in rs.DILATIONS:
            assert rs.smem_bytes(c, d) <= plan["smem_budget"] <= rs.SMEM_LIMIT
            assert (plan["blocks_per_sm"] * (plan["smem_budget"] + 1024)
                    <= rs.SMEM_SM)
            produced = np.zeros(length, dtype=int)
            for first, r0, rows in rs.unit_blocks(c, length, d):
                produced[r0:r0 + rows] += 1
                assert r0 - first == 6 * d and rows <= plan["bm"]
            assert (produced == 1).all()
    with pytest.raises(ValueError):
        rs.tile_plan(80)


@pytest.mark.parametrize("length", [40, 300, 163840])
@pytest.mark.parametrize("c", rs.KERNEL_WIDTHS)
def test_tile_plan_covers_ragged_lengths(c, length):
    """The grid covers [0, L) once at the lengths the codec and short
    streaming blocks give, the last block ragged where L is not a multiple
    of bm; that block's rows >= L are the ones the kernel masks."""
    bm = rs.tile_plan(c)["bm"]
    blocks = rs.unit_blocks(c, length, 9)
    assert len(blocks) == -(-length // bm)
    assert [r0 for _, r0, _ in blocks] == list(range(0, length, bm))
    assert sum(rows for _, _, rows in blocks) == length
    assert all(rows == bm for _, _, rows in blocks[:-1])
    assert blocks[-1][2] == length - bm * (len(blocks) - 1)


@pytest.mark.parametrize("approx", [False, True])
def test_plain_stack_is_three_single_unit_calls(approx):
    """The plain version is split per unit as the kernel is (one launch
    each): the stack equals the three units applied in turn."""
    rng = np.random.default_rng(11)
    c, length = 64, 150
    w1, b1, a1, w2, b2, a2 = _stacked(_units(rng, c))
    x = torch.from_numpy(rng.standard_normal((1, length, c)).astype(np.float32))
    want = x
    for u, d in enumerate(rs.DILATIONS):
        want = rs.residual_unit_plain(want, w1[u], b1[u], a1[u], w2[u], b2[u],
                                      a2[u], d, approx)
    got = rs.res_stack_plain(x, w1, b1, a1, w2, b2, a2, approx)
    assert torch.equal(got, want)


@pytest.mark.parametrize("c,length,approx", [(96, 300, True), (384, 40, False)])
def test_first_tile_bound_sees_a_nonzero_context(c, length, approx):
    """chip_smoke.py holds the kernel's first row tile (`tile_plan`'s bm
    rows, or all of a shorter block) to rel-RMS 1e-2 of the plain version
    at these short blocks, with its weight scales.  A kernel whose
    positions before the sequence start were not zero at every unit's k7
    input (say, one that ran the three units over one shared 78-frame
    context without forcing it back to zero, where a bias and the snake of
    a bias drift) would miss that bound by a wide margin there."""
    rng = np.random.default_rng(c + length)

    def arr(shape, std, mean=0.0):
        return torch.from_numpy(
            (mean + std * rng.standard_normal(shape)).astype(np.float32)
        ).to(torch.bfloat16)

    x = arr((1, length, c), 0.5)
    w = (arr((3, 7, c, c), (7 * c) ** -0.5), arr((3, c), 0.1),
         arr((3, c), 0.1, 1.0), arr((3, c, c), c ** -0.5), arr((3, c), 0.1),
         arr((3, c), 0.1, 1.0))
    head = rs.tile_plan(c)["bm"]
    want = rs.res_stack_plain(x, *w, approx).float()[:, :head]
    padded = torch.nn.functional.pad(x, (0, 0, rs.HALO, 0))
    fault = rs.res_stack_plain(padded, *w, approx)[:, rs.HALO:].float()[:, :head]
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


# ---------------------------------------------------------------------------
# The history form (streaming decode and encode)
# ---------------------------------------------------------------------------

def _histories(rng, c, batch=1):
    return [torch.from_numpy(rng.standard_normal((batch, 6 * d, c))
                             .astype(np.float32) * 0.5) for d in rs.DILATIONS]


@pytest.mark.parametrize("c,length,approx", [
    (64, 150, False), (96, 40, True), (128, 300, False)])
def test_plain_history_form_matches_jax_units(c, length, approx):
    """The plain history form against three calls of JAX's streaming unit
    (`_residual_unit_s`, streaming.py:139-147), each carrying its conv1
    state: the output and every unit's new state."""
    from echo_tts_tpu.models.dac.streaming import _residual_unit_s

    rng = np.random.default_rng(c + length)
    units = _units(rng, c)
    x = rng.standard_normal((2, length, c)).astype(np.float32) * 0.3
    hist = _histories(rng, c, batch=2)
    want = jnp.asarray(x)
    want_hist = []
    for u, d, h in zip(units, rs.DILATIONS, hist):
        st, want = _residual_unit_s(
            {k: ({kk: jnp.asarray(vv) for kk, vv in v.items()}
                 if isinstance(v, dict) else jnp.asarray(v))
             for k, v in u.items()},
            {"conv1": jnp.asarray(h.numpy())}, want, d, approx_snake=approx)
        want_hist.append(st["conv1"])
    got, got_hist = rs.fused_res_stack(
        torch.from_numpy(x), rs.ResStackWeights(*_stacked(units)),
        approx_snake=approx, history=hist)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for g, w, d in zip(got_hist, want_hist, rs.DILATIONS):
        assert g.shape == (2, 6 * d, c)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("approx", [False, True])
def test_zero_history_is_the_one_shot_stack(approx):
    """Zero history is the causal zero pad: the output equals the one-shot
    plain stack exactly, in bf16 too, and the new history holds the last
    6 * d rows of snake1 of each unit's input."""
    rng = np.random.default_rng(5)
    c, length = 64, 100
    w = [a.to(torch.bfloat16) for a in _stacked(_units(rng, c))]
    x = torch.from_numpy(rng.standard_normal((1, length, c))
                         .astype(np.float32)).to(torch.bfloat16)
    zeros = [torch.zeros((1, 6 * d, c), dtype=torch.bfloat16)
             for d in rs.DILATIONS]
    got, hist = rs.res_stack_plain(x, *w, approx, history=zeros)
    assert torch.equal(got, rs.res_stack_plain(x, *w, approx))
    xu = x
    for u, d in enumerate(rs.DILATIONS):
        assert torch.equal(hist[u], rs._snake_f32(xu, w[2][u], approx)[:, -6 * d:])
        xu = rs.residual_unit_plain(xu, *(a[u] for a in w), d, approx)


def test_short_block_keeps_older_history_rows():
    """A block shorter than the history (L = 40 < 54 at d = 9) keeps the
    older rows: the new history is [history rows 40..54 | snake1(x)], and
    chaining two blocks of 40 equals one block of 80."""
    rng = np.random.default_rng(40)
    c = 64
    w = rs.ResStackWeights(*_stacked(_units(rng, c)))
    x = torch.from_numpy(rng.standard_normal((1, 80, c)).astype(np.float32))
    hist = _histories(rng, c)
    _, new = rs.fused_res_stack(x[:, :40], w, history=hist)
    np.testing.assert_array_equal(new[2][:, :14].numpy(), hist[2][:, 40:].numpy())
    snake1 = rs._snake_f32(x[:, :40], w.a1[0], False)
    np.testing.assert_array_equal(new[0].numpy(), snake1[:, -6:].numpy())
    out_a, hist_a = rs.fused_res_stack(x[:, :40], w, history=hist)
    out_b, hist_b = rs.fused_res_stack(x[:, 40:], w, history=hist_a)
    out, hist_ab = rs.fused_res_stack(x, w, history=hist)
    np.testing.assert_allclose(torch.cat([out_a, out_b], 1).numpy(),
                               out.numpy(), **TOL)
    for g, want in zip(hist_b, hist_ab):
        np.testing.assert_allclose(g.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("length", [1, 40, 300, 163840])
@pytest.mark.parametrize("c", [96, 384])
def test_last_block_holds_the_new_history(c, length):
    """The kernel writes the new history from its last block's tile: for
    every unit, rows [L - 6d, L) lie in the rows that block reads (from
    r0 - 6d, history rows before 0 included)."""
    for d in rs.DILATIONS:
        first, r0, rows = rs.unit_blocks(c, length, d)[-1]
        assert first <= length - 6 * d and r0 + rows == length


def test_history_shapes_are_checked():
    rng = np.random.default_rng(2)
    w = rs.ResStackWeights(*_stacked(_units(rng, 64)))
    x = torch.zeros((1, 50, 64))
    hist = _histories(rng, 64)
    with pytest.raises(ValueError, match="holds 2"):
        rs.fused_res_stack(x, w, history=hist[:2])
    with pytest.raises(ValueError, match="must be"):
        rs.fused_res_stack(x, w, history=[hist[0], hist[2], hist[1]])
    with pytest.raises(ValueError, match="must be"):
        rs.fused_res_stack(x, w, history=[h.double() for h in hist])


def test_history_launch_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rng = np.random.default_rng(3)
    w = rs.ResStackWeights(*(a.to(torch.bfloat16)
                             for a in _stacked(_units(rng, 64))))
    x = torch.zeros((1, 64, 64), dtype=torch.bfloat16)
    hist = [h.to(torch.bfloat16) for h in _histories(rng, 64)]
    before = (rs.fused_res_stack.launches, rs.fused_res_stack.launches_stream)
    with pytest.raises(RuntimeError, match="CUDA"):
        rs._launch(x, w, False, hist)
    assert (rs.fused_res_stack.launches,
            rs.fused_res_stack.launches_stream) == before


@pytest.mark.parametrize("which", ["x", "weights", "history"])
def test_wrapper_raises_under_grad(which):
    """Kernel B has no backward (the JAX package never differentiates
    it): with grad on and an input that requires grad the wrapper raises,
    on every device, rather than hand back an output cut from the graph;
    without grad the same call runs."""
    rng = np.random.default_rng(40)
    c = 64
    args = list(_stacked(_units(rng, c)))
    x = torch.from_numpy(rng.standard_normal((1, 40, c)).astype(np.float32))
    hist = [torch.zeros((1, 6 * d, c)) for d in rs.DILATIONS]
    if which == "x":
        x.requires_grad_()
    elif which == "weights":
        args[0].requires_grad_()
    else:
        hist[2].requires_grad_()
    w = rs.ResStackWeights(*args)
    kw = {"history": hist} if which == "history" else {}
    with pytest.raises(RuntimeError, match="no gradient"):
        rs.fused_res_stack(x, w, **kw)
    with torch.no_grad():
        out = rs.fused_res_stack(x, w, **kw)
    assert (out[0] if kw else out).shape == x.shape
