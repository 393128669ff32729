"""Kernel C's plain version (what `int8_matmul_fused` runs for CPU tensors)
against the JAX package's Pallas W8A8 kernel in interpret mode, its shape
gate, and its refusal to launch without a card; and the plain version of
its row-parallel instance (given row scale, int32 sums) against the
whole product.

Bound atol 1e-5, rtol 0: tests/test_quant.py:68's bound for the Pallas
kernel against the XLA path (the int32 accumulators are equal).  The CUDA
kernel is held against the same plain version on the card by
chip_smoke.py (fp32 output within 1e-5, bf16 rel-RMS <= 1e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from echo_tts_tpu.ops import quant as jq
from echo_tts_tpu.ops.pallas.int8_matmul import int8_matmul_fused as j_fused

from echo_tts_torch.ops import cuda_build
from echo_tts_torch.ops import int8_matmul as im
from echo_tts_torch.ops import quant as tq

torch.set_num_threads(1)


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((2, m // 2, k)).astype(np.float32)
    x[0, 0] = 0.0                  # an all-zero row: the 1e-12 scale floor
    return x, w


@pytest.mark.parametrize("parts", [2, 4])
def test_k_slices_summed_in_int32_equal_one_product(parts):
    """The row-parallel form over the whole K: each K-slice quantized with
    the whole row's scale (int8_matmul_partial's plain version), the
    slices' int32 sums added and rescaled once, equal int8_matmul_plain
    bit for bit (also through int8_matmul_partial's CPU path)."""
    x, w = _operands(21, 128, 256, 192)
    x = torch.from_numpy(x)
    w8, s = tq.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    _, x_scale = im.quantize_last(x, 127.0)
    step = 256 // parts
    slices = [slice(i, i + step) for i in range(0, 256, step)]
    acc = sum(im.int8_matmul_partial_plain(x[..., k], w8[:, k], x_scale)
              for k in slices)
    assert acc.dtype == torch.int32
    want = im.int8_matmul_plain(x, w8, s, torch.float32)
    torch.testing.assert_close(im.int8_rescale(acc, x_scale, s, torch.float32),
                               want, rtol=0, atol=0)
    acc2 = sum(im.int8_matmul_partial(x[..., k], w8[:, k], x_scale)
               for k in slices)
    torch.testing.assert_close(acc2, acc, rtol=0, atol=0)


def test_partial_checks_its_scale():
    x = torch.zeros((4, 32))
    w8 = torch.zeros((16, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="x_scale"):
        im.int8_matmul_partial(x, w8, torch.ones((3,)))


def test_plain_matches_pallas_interpret():
    """(2, 64, 256) x (256, 256), as tests/test_quant.py:52-69."""
    x, w = _operands(20, 128, 256, 256)
    qw = jq.quantize_weight_int8(jnp.asarray(w))
    want = j_fused(jnp.asarray(x), qw["q8"], qw["s"], interpret=True,
                   out_dtype=jnp.float32)
    w8, s = tq.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    got = im.int8_matmul_fused(torch.from_numpy(x), w8, s, torch.float32)
    assert got.shape == (2, 64, 256) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(
        got.numpy(), im.int8_matmul_plain(torch.from_numpy(x), w8, s).numpy())


def test_prepass_then_int32_product_equals_plain():
    """Kernel C's two stages in plain form: the pre-pass (`quantize_last`:
    x quantized once, its row scales), then the exact integer product and
    the rescale in the kernel's order, equal `int8_matmul_plain` bit for
    bit and the JAX Pallas kernel in interpret mode within 1e-5.  Rows: the
    shapes of test_plain_matches_pallas_interpret, with an all-zero row
    (the 1e-12 scale floor) and a row of rounding ties (amax 127, so the
    scale is 1 and x / scale lands on k + 1/2: half to even)."""
    x, w = _operands(21, 128, 256, 256)
    ties = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5],
                    dtype=np.float32)
    x[1, 0] = np.resize(ties, 256)
    x[1, 0, 0] = 127.0
    w8, ws = tq.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    xt = torch.from_numpy(x)

    xq, x_scale = im.quantize_last(xt, 127.0)
    assert float(x_scale[1, 0]) == 1.0
    assert float(x_scale[0, 0]) == float(np.float32(1e-12) / np.float32(127))
    assert not xq[0, 0].any()
    np.testing.assert_array_equal(xq[1, 0, 1:9].numpy(),
                                  [2, 2, 0, -2, -2, 4, -4, 0])
    acc = xq.to(torch.int64) @ w8.to(torch.int64).t()
    assert acc.abs().max() < 2 ** 31          # the kernel's int32 is exact
    got = acc.float() * x_scale[..., None] * ws
    np.testing.assert_array_equal(
        got.numpy(), im.int8_matmul_plain(xt, w8, ws, torch.float32).numpy())

    qw = jq.quantize_weight_int8(jnp.asarray(w))
    want = j_fused(jnp.asarray(x), qw["q8"], qw["s"], interpret=True,
                   out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# every (M, K, N) the full-width W8A8 DiT gives kernel C (chip_smoke.py)
MAIN_PATH_SHAPES = [(1920, 2048, 5888), (1920, 2048, 2048), (1920, 5888, 2048),
                    (640, 2048, 5888), (640, 2048, 2048), (640, 5888, 2048)]


@pytest.mark.parametrize("m,k,n", MAIN_PATH_SHAPES)
def test_tile_plan_covers_and_fills(m, k, n):
    """Kernel C's tile plan at each main-path shape: a tile the kernel
    takes; its blocks, one per tile, cover every output row and column
    exactly once (K is not split).  A plan with fewer blocks than SMs runs
    in one partial wave, and halving its tile in either direction would
    give more blocks than SMs (the source note's reason)."""
    bm, bn = im._tile_plan(m, k, n)
    assert bm == im.TILE_M and bn in (128, 256)
    for size, tile in ((m, bm), (n, bn)):
        cover = np.zeros(size, dtype=int)
        for start in range(0, size, tile):
            cover[start:start + tile] += 1
        assert (cover == 1).all()
    tiles = -(-m // bm) * -(-n // bn)
    if tiles < cuda_build.SMS:
        assert min(-(-m // (bm // 2)) * -(-n // bn),
                   -(-m // bm) * -(-n // (bn // 2))) > cuda_build.SMS


@pytest.mark.parametrize("m,k,n", [
    (1, 16, 8), (640, 2048, 5888), (1920, 5888, 2048), (37, 96, 64),
    (0, 64, 64), (4, 24, 64), (4, 64, 12), (4, 8, 8),
])
def test_supported_agrees_with_the_wrapper(m, k, n):
    """The wrapper refuses exactly the shapes supported() refuses, on the
    CPU as on the card (the main path's and the tiny config's all pass)."""
    x = torch.zeros((m, k))
    w8 = torch.zeros((n, k), dtype=torch.int8)
    s = torch.ones((n,))
    if im.supported(m, k, n):
        if m * k * n < 1e6:
            assert im.int8_matmul_fused(x, w8, s).shape == (m, n)
    else:
        with pytest.raises(ValueError, match="unsupported"):
            im.int8_matmul_fused(x, w8, s)


def test_wrapper_checks_the_weight():
    x = torch.zeros((4, 32))
    with pytest.raises(ValueError, match="int8"):
        im.int8_matmul_fused(x, torch.zeros((16, 32)), torch.ones((16,)))
    with pytest.raises(ValueError, match="w_scale"):
        im.int8_matmul_fused(x, torch.zeros((16, 32), dtype=torch.int8),
                             torch.ones((8,)))


def test_kernel_launch_needs_cuda():
    """The kernel path never runs on the CPU: launching it without a CUDA
    device raises instead of falling back, and counts nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = torch.zeros((4, 32), dtype=torch.bfloat16)
    before = im.int8_matmul_fused.launches
    with pytest.raises(RuntimeError, match="CUDA"):
        im._launch(x, torch.zeros((16, 32), dtype=torch.int8),
                   torch.ones((16,)), torch.bfloat16)
    assert im.int8_matmul_fused.launches == before


def test_wrapper_raises_under_grad():
    """Kernel C has no backward (the JAX package never differentiates
    it): with grad on and x requiring grad the wrapper raises, on every
    device, rather than hand back an output cut from the graph; under
    inference mode the same call runs."""
    x, w = _operands(41, 32, 64, 64)
    w8, s = tq.quantize_weight_int8(torch.from_numpy(w.T.copy()))
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(RuntimeError, match="no gradient"):
        im.int8_matmul_fused(xt, w8, s)
    with pytest.raises(RuntimeError, match="no gradient"):
        tq.Int8Linear(w8, s)(xt)
    with torch.inference_mode():
        assert im.int8_matmul_fused(xt, w8, s).shape == (2, 16, 64)
