"""Kernel C's plain version (what `int8_matmul_fused` runs for CPU tensors)
against the JAX package's Pallas W8A8 kernel in interpret mode, its shape
gate, and its refusal to launch without a card.

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

from echo_tts_torch.ops import int8_matmul as im
from echo_tts_torch.ops import quant as tq

torch.set_num_threads(1)


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    x = rng.standard_normal((2, m // 2, k)).astype(np.float32)
    x[0, 0] = 0.0                  # an all-zero row: the 1e-12 scale floor
    return x, w


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
