"""The centred ("same") codec of Descript's DAC 44 kHz on the port: the
centred convolutions, the residual stack's centred plain version (what
kernel B's centred instance is held to on the card) and the DAC44 decoder,
against F.conv1d / F.conv_transpose1d with DAC's paddings and the plain
reference (models/dia_reference.py codec_decode).

Tolerance atol 1e-5 (fp32 on the CPU): the port's shifted-slice products
against the library convolutions, summation order only (about 1e-6 on
values O(1)).  Ragged batches (each item's `lengths`) are held to each
item decoded alone at its own length, at the same bound.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from echo_tts_torch.config import tiny_dac44k_config
from echo_tts_torch.models import dia_reference as ref
from echo_tts_torch.models.dac import dac as tdac
from echo_tts_torch.models.dac.conv import (centred_conv1d,
                                            centred_conv_transpose1d,
                                            residual_unit)
from echo_tts_torch.ops import res_stack as rs

torch.set_num_threads(2)
ATOL = 1e-5


@pytest.mark.parametrize("dilation", [1, 3, 9])
def test_centred_conv_matches_same_padding(dilation):
    g = torch.Generator().manual_seed(dilation)
    x = torch.randn(2, 50, 6, generator=g)
    w = torch.randn(5, 6, 7, generator=g) * 0.2        # (C_out, C_in, K)
    b = torch.randn(5, generator=g)
    got = centred_conv1d(x, w.permute(2, 1, 0), b, dilation=dilation)
    want = F.conv1d(x.transpose(1, 2), w, b, padding=3 * dilation,
                    dilation=dilation).transpose(1, 2)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_centred_transpose_conv_matches_dac_padding(stride):
    g = torch.Generator().manual_seed(stride)
    x = torch.randn(2, 13, 6, generator=g)
    w = torch.randn(6, 4, 2 * stride, generator=g) * 0.2   # (C_in, C_out, K)
    b = torch.randn(4, generator=g)
    got = centred_conv_transpose1d(x, w.permute(2, 1, 0), b, stride=stride)
    want = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride,
                              padding=-(-stride // 2)).transpose(1, 2)
    assert got.shape == (2, 13 * stride, 4)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def _stack(c, seed):
    g = torch.Generator().manual_seed(seed)
    w1 = torch.randn(3, 7, c, c, generator=g) * (7 * c) ** -0.5
    w2 = torch.randn(3, c, c, generator=g) * c ** -0.5
    b1, b2 = torch.randn(3, c, generator=g) * 0.1, torch.randn(
        3, c, generator=g) * 0.1
    a1 = 1.0 + 0.1 * torch.randn(3, c, generator=g)
    a2 = 1.0 + 0.1 * torch.randn(3, c, generator=g)
    return g, (w1, b1, a1, w2, b2, a2)


def _dac_unit(x, w1, b1, a1, w2, b2, a2, d):
    """DAC's ResidualUnit on (B, L, C), written with F.conv1d."""
    def snake(v, a):
        return v + (1.0 / (a + 1e-9)) * torch.sin(a * v) ** 2
    y = snake(x, a1).transpose(1, 2)
    y = F.conv1d(y, w1.permute(2, 1, 0), b1, padding=3 * d, dilation=d)
    y = F.conv1d(snake(y.transpose(1, 2), a2).transpose(1, 2),
                 w2.t()[:, :, None], b2)
    return x + y.transpose(1, 2)


@pytest.mark.parametrize("c,length,approx", [(16, 90, False), (24, 40, True),
                                             (8, 300, False)])
def test_centred_plain_stack_matches_dac_units(c, length, approx):
    g, args = _stack(c, c + length)
    x = torch.randn(2, length, c, generator=g) * 0.5
    got = rs.res_stack_plain(x, *args, approx_snake=approx, centred=True)
    w1, b1, a1, w2, b2, a2 = args
    unrolled = x
    for u, d in enumerate(rs.DILATIONS):
        unrolled = residual_unit(unrolled, a1[u], w1[u], b1[u], a2[u],
                                 w2[u][None], b2[u], d, approx_snake=approx,
                                 centred=True)
    torch.testing.assert_close(got, unrolled, atol=ATOL, rtol=0)
    if not approx:
        want = x
        for u, d in enumerate(rs.DILATIONS):
            want = _dac_unit(want, w1[u], b1[u], a1[u], w2[u], b2[u],
                             a2[u], d)
        torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    # through the wrapper (the CPU runs the plain version)
    fused = rs.fused_res_stack(x, rs.ResStackWeights(*args),
                               approx_snake=approx, centred=True)
    torch.testing.assert_close(fused, got, atol=0, rtol=0)


def test_centred_plain_stack_ragged_batch_is_each_alone():
    g, args = _stack(16, 7)
    lengths = [120, 37, 81]
    x = torch.randn(3, 120, 16, generator=g)
    got = rs.res_stack_plain(x, *args, centred=True,
                             lengths=torch.tensor(lengths))
    for i, n in enumerate(lengths):
        alone = rs.res_stack_plain(x[i:i + 1, :n], *args, centred=True)
        torch.testing.assert_close(got[i:i + 1, :n], alone, atol=ATOL,
                                   rtol=0)
        assert (got[i, n:] == 0).all()


@pytest.fixture(scope="module")
def codec():
    """A tiny DAC44 drawn as the reference's codec_specs list it (the
    convolutions N(0, 0.02^2), DAC's init scale)."""
    cfg = tiny_dac44k_config()
    model = tdac.DAC44(cfg).eval()
    own = dict(model.named_parameters())
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for p in own.values():
            p.zero_()
        for name, shape, init in ref.codec_specs(dataclasses.asdict(cfg)):
            if init[0] == "normal":
                own[name].copy_(torch.randn(shape, generator=g) * init[1])
            elif init[0] == "norm_of":
                v = own[init[1]]
                own[name].copy_(v.square().sum((1, 2), keepdim=True).sqrt())
            elif init[0] == "ones":
                own[name].fill_(1.0)
    return model


def test_dac44_decoder_matches_reference(codec):
    cfg = codec.cfg
    g = torch.Generator().manual_seed(6)
    codes = torch.randint(0, cfg.codebook_size, (2, cfg.n_codebooks, 21),
                          generator=g)
    with torch.no_grad():
        got = tdac.dac44_decode_codes(codec, codes)
    W = {k: v.float() for k, v in codec.state_dict().items()}
    with ref.fp32():
        want = ref.codec_decode(W, dataclasses.asdict(cfg), codes)
    assert got.shape == (2, 21 * cfg.hop_length)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_dac44_ragged_batch_decodes_each_alone(codec):
    cfg = codec.cfg
    g = torch.Generator().manual_seed(7)
    lengths = [17, 9, 24]
    codes = torch.randint(0, cfg.codebook_size, (3, cfg.n_codebooks, 24),
                          generator=g)
    with torch.no_grad():
        got = tdac.dac44_decode_codes(codec, codes, torch.tensor(lengths))
        for i, n in enumerate(lengths):
            alone = tdac.dac44_decode_codes(codec, codes[i:i + 1, :, :n])
            hop = n * cfg.hop_length
            np.testing.assert_allclose(got[i, :hop].numpy(),
                                       alone[0].numpy(), atol=ATOL)
            assert (got[i, hop:] == 0).all()


def test_s1dac_stays_causal():
    """The S1-DAC configuration keeps its causal decoder: DAC44 refuses a
    causal configuration, and a causal config's decoder runs no mask."""
    from echo_tts_torch.config import tiny_dac_config
    assert tiny_dac_config().causal
    with pytest.raises(ValueError):
        tdac.DAC44(tiny_dac_config())


def test_centred_form_refuses_a_history_and_stray_lengths():
    _, args = _stack(8, 9)
    w = rs.ResStackWeights(*args)
    x = torch.zeros(1, 20, 8)
    hist = [torch.zeros(1, 6 * d, 8) for d in rs.DILATIONS]
    with pytest.raises(ValueError):
        rs.fused_res_stack(x, w, centred=True, history=hist)
    with pytest.raises(ValueError):
        rs.fused_res_stack(x, w, lengths=torch.tensor([5]))
