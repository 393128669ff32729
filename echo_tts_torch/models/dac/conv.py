"""Causal 1-D conv machinery for the S1-DAC codec, NLC layout, and the
centred ("same") forms that Descript's DAC decoder takes.

Counterpart of echo_tts_tpu/models/dac/conv.py (reference:
autoencoder.py:38-109, 264-373).  Tensors are (batch, time, channels) and
conv kernels (K, C_in // groups, C_out), as in the JAX package; the hot
cases lower to shifted-slice matrix products like there:

  * stride-1 dense conv  -> sum over K of shifted-slice matmuls
  * depthwise (groups=C) -> sum over K of shifted elementwise multiplies
  * strided conv         -> fold the stride into channels, one matmul per
                            tap group
Other cases use torch's conv1d on the NCL view.  Snake keeps the tensor's
dtype flow (bf16 stays bf16), as the JAX XLA path does.

Weight norm: the modules hold the checkpoint's pair
(`<conv>.parametrizations.weight.original0` = g, `original1` = v) and fold
w = g * v / ||v|| in fp32 on every call (ConvWeights.torch_weight), so the
published state dict loads as it is.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.activations import sin2_poly


def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor], *, stride: int = 1,
                  dilation: int = 1, groups: int = 1,
                  history: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CausalConvNet.forward (reference: autoencoder.py:285-289).

    x (B, L, C_in); kernel (K, C_in // groups, C_out).  Left-pad
    (k_eff - stride), right-pad so strides cover the length; output length
    ceil(L / stride).

    `history` (B, k_eff - stride, C_in), the previous block's raw input
    tail, replaces the zero left pad (the streaming state,
    models/dac/streaming.py; conv.py:27-60); zeros give the one-shot op."""
    k = kernel.shape[0]
    k_eff = (k - 1) * dilation + 1
    pad_left = k_eff - stride
    length = x.shape[1]
    extra = math.ceil(length / stride) * stride - length
    if history is not None:
        if history.shape[1] != pad_left or extra != 0:
            raise ValueError(
                f"streaming conv needs history length {pad_left} (got "
                f"{history.shape[1]}) and block length % stride == 0")
        x = torch.cat([history.to(x.dtype), x], dim=1)
    else:
        x = F.pad(x, (0, 0, pad_left, extra))
    out_len = (length + extra) // stride

    if groups == 1 and stride == 1:
        out = x[:, 0:out_len] @ kernel[0]
        for kk in range(1, k):
            out = out + x[:, kk * dilation: kk * dilation + out_len] @ kernel[kk]
    elif groups == x.shape[-1] and kernel.shape[1] == 1 and stride == 1:
        out = x[:, 0:out_len] * kernel[0, 0]
        for kk in range(1, k):
            out = out + x[:, kk * dilation: kk * dilation + out_len] * kernel[kk, 0]
    elif groups == 1 and dilation == 1 and k % stride == 0:
        b, lp, c = x.shape
        xs = x.reshape(b, lp // stride, stride * c)
        w = kernel.reshape(k // stride, stride * c, kernel.shape[2])
        out = xs[:, 0:out_len] @ w[0]
        for gi in range(1, k // stride):
            out = out + xs[:, gi: gi + out_len] @ w[gi]
    else:
        out = F.conv1d(x.transpose(1, 2), kernel.permute(2, 1, 0),
                       stride=stride, dilation=dilation,
                       groups=groups).transpose(1, 2)
    if bias is not None:
        out = out + bias
    return out


def causal_conv_transpose1d(x: torch.Tensor, kernel: torch.Tensor,
                            bias: Optional[torch.Tensor], *, stride: int,
                            history: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """CausalTransConvNet.forward (reference: autoencoder.py:310-316).

    kernel (K, C_out, C_in); output length L * stride.  With K % stride == 0
    output position n = i*s + j receives x[i - g] @ W[j + g*s] for each tap
    group g < K/s: K/s matmuls of (L, C_in) @ (C_in, s*C_out).

    `history` (B, K/stride - 1, C_in): the previous block's raw input tail
    for streaming decode (needs K % stride == 0; conv.py:100-110); zeros
    give the one-shot op."""
    k = kernel.shape[0]
    b, length, c_in = x.shape
    c_out = kernel.shape[1]
    if history is not None and (k % stride != 0
                                or history.shape[1] != k // stride - 1):
        raise ValueError(
            f"streaming transpose conv needs K % stride == 0 and history "
            f"length {k // stride - 1}, got K={k} s={stride} "
            f"hist={history.shape[1]}")
    if k % stride == 0:
        n_hist = k // stride - 1
        if history is not None and n_hist > 0:
            xfull = torch.cat([history.to(x.dtype), x], dim=1)
        else:
            xfull = F.pad(x, (0, 0, n_hist, 0)) if n_hist else x
        out = None
        for gi in range(k // stride):
            w_g = (kernel[gi * stride:(gi + 1) * stride]   # (s, C_out, C_in)
                   .permute(2, 0, 1).reshape(c_in, stride * c_out))
            term = xfull[:, n_hist - gi: n_hist - gi + length] @ w_g
            out = term if out is None else out + term
        out = out.reshape(b, length * stride, c_out)
    else:
        out = F.conv_transpose1d(x.transpose(1, 2), kernel.permute(2, 1, 0),
                                 stride=stride).transpose(1, 2)
        pad = k - stride
        if pad > 0:
            out = out[:, :-pad]
    if bias is not None:
        out = out + bias
    return out


def centred_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                   bias: Optional[torch.Tensor], *,
                   dilation: int = 1) -> torch.Tensor:
    """A stride-1 conv with (k_eff - 1) / 2 zeros on each side, so that the
    output has x's length (DAC's WNConv1d(padding=(k - 1) * d // 2),
    dac/model/dac.py).  x (B, L, C_in), kernel (K, C_in, C_out), K odd:
    the causal form on x padded on the right by half the window, its
    first half-window of outputs dropped."""
    k_eff = (kernel.shape[0] - 1) * dilation + 1
    if k_eff % 2 != 1:
        raise ValueError(f"a centred conv needs an odd window, got {k_eff}")
    half = (k_eff - 1) // 2
    out = causal_conv1d(F.pad(x, (0, 0, 0, half)), kernel, bias,
                        dilation=dilation)
    return out[:, half:]


def centred_conv_transpose1d(x: torch.Tensor, kernel: torch.Tensor,
                             bias: Optional[torch.Tensor], *,
                             stride: int) -> torch.Tensor:
    """DAC's WNConvTranspose1d(kernel 2s, stride s, padding ceil(s / 2)):
    the full transposed conv of x, ((L + 1) * s samples for K = 2s), with
    ceil(s / 2) cut from each end, L * s samples for an even stride.
    kernel (K, C_out, C_in)."""
    k = kernel.shape[0]
    pad = -(-stride // 2)
    full = causal_conv_transpose1d(F.pad(x, (0, 0, 0, k // stride - 1)),
                                   kernel, bias, stride=stride)
    out_len = (x.shape[1] - 1) * stride + k - 2 * pad
    return full[:, pad:pad + out_len]


def mask_tail(x: torch.Tensor,
              lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, L, C) with the rows at or past each item's length zeroed:
    ahead of a centred conv this is the zero pad an item of that length
    alone would see, so that a batch of ragged items decodes as each alone.
    lengths (B,) int, or None (x as it is)."""
    if lengths is None:
        return x
    keep = torch.arange(x.shape[1], device=x.device)[None] < lengths[:, None]
    return x * keep[..., None].to(x.dtype)


def snake(x: torch.Tensor, alpha: torch.Tensor,
          approx: bool = False) -> torch.Tensor:
    """x + (1/(a+1e-9)) sin^2(a x) (reference: autoencoder.py:96-109);
    alpha (C,).  approx=True uses sin2_poly, cast back to x's dtype."""
    if approx:
        s2 = sin2_poly(alpha * x).to(x.dtype)
        return x + (1.0 / (alpha + 1e-9)) * s2
    return x + (1.0 / (alpha + 1e-9)) * torch.square(torch.sin(alpha * x))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def roll_history(hist: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A streaming conv's new history: the last hist.shape[1] rows of
    [hist | x], in hist's dtype (streaming.py:103-112 `_roll`; blocks
    shorter than the history keep its older rows).  Always a new tensor,
    so a shared zero state is never written and no block's activations
    are kept alive."""
    width = hist.shape[1]
    if width == 0:
        return hist
    if x.shape[1] >= width:
        return x[:, x.shape[1] - width:].to(hist.dtype, copy=True)
    return torch.cat([hist, x.to(hist.dtype)], dim=1)[:, x.shape[1]:]


def residual_unit(x: torch.Tensor, alpha1: torch.Tensor, w1: torch.Tensor,
                  b1: torch.Tensor, alpha2: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, dilation: int,
                  approx_snake: bool = False,
                  history: Optional[torch.Tensor] = None,
                  centred: bool = False,
                  lengths: Optional[torch.Tensor] = None):
    """Snake -> causal k7 dilated conv -> Snake -> causal k1 conv, residual
    (reference: autoencoder.py:879-900).  w1 (7, C, C), w2 (1, C, C).

    With `history` (B, 6 * dilation, C), the previous block's tail of
    snake1(x), in place of the k7 conv's zero pad, returns (out, new
    history) (streaming.py:139-147 `_residual_unit_s`).

    `centred`: the k7 conv pads 3 * dilation on each side (DAC's
    ResidualUnit, dac/model/dac.py); `lengths` (B,) then zeroes each
    item's rows from its length on, at the conv's input and in the
    output (`mask_tail`)."""
    if centred:
        y = mask_tail(snake(x, alpha1, approx=approx_snake), lengths)
        y = centred_conv1d(y, w1, b1, dilation=dilation)
        y = snake(y, alpha2, approx=approx_snake)
        return mask_tail(x + causal_conv1d(y, w2, b2), lengths)
    y = snake(x, alpha1, approx=approx_snake)
    new_hist = None if history is None else roll_history(history, y)
    y = causal_conv1d(y, w1, b1, dilation=dilation, history=history)
    y = snake(y, alpha2, approx=approx_snake)
    y = causal_conv1d(y, w2, b2)
    return x + y if history is None else (x + y, new_hist)


# ---------------------------------------------------------------------------
# Modules (reference module tree, autoencoder.py:38-109, 264-373, 879-900)
# ---------------------------------------------------------------------------

class WeightNormPair(nn.Module):
    """The checkpoint's weight-norm pair: original0 = g (norm over every
    axis but 0), original1 = v."""

    def __init__(self, shape):
        super().__init__()
        self.original0 = nn.Parameter(torch.ones((shape[0],) + (1,) * (len(shape) - 1)))
        self.original1 = nn.Parameter(torch.empty(shape))


class ConvWeights(nn.Module):
    """A conv's parameters in torch layout: (C_out, C_in/groups, K), or
    (C_in, C_out, K) when `transposed`.  With weight norm the parameters
    are `parametrizations.weight.original0/1`, as the checkpoint stores
    them, and `kernel()` folds w = g * v / ||v|| on every call."""

    def __init__(self, shape, bias_size: int, *, transposed: bool = False,
                 weight_norm: bool = True):
        super().__init__()
        self.transposed = transposed
        self.weight_norm = weight_norm
        if weight_norm:
            self.parametrizations = nn.ModuleDict({"weight": WeightNormPair(shape)})
        else:
            self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(bias_size))

    @property
    def fan_in(self) -> int:
        w = self.torch_weight_shape
        return w[0] * w[2] if self.transposed else w[1] * w[2]

    @property
    def torch_weight_shape(self):
        if self.weight_norm:
            return tuple(self.parametrizations["weight"].original1.shape)
        return tuple(self.weight.shape)

    def torch_weight(self) -> torch.Tensor:
        if not self.weight_norm:
            return self.weight
        pair = self.parametrizations["weight"]
        v = pair.original1
        vf = v.float()
        norm = torch.sqrt(torch.sum(vf * vf, dim=tuple(range(1, v.ndim)),
                                    keepdim=True))
        return (pair.original0.float() * vf / norm).to(v.dtype)

    def kernel(self) -> torch.Tensor:
        """(K, C_in/groups, C_out), or (K, C_out, C_in) when transposed:
        the JAX package's layout."""
        return self.torch_weight().permute(2, 1, 0)


class Snake1d(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(1, channels, 1))

    def vec(self) -> torch.Tensor:
        return self.alpha.reshape(-1)


class CausalConv(nn.Module):
    """CausalConvNet: the weights sit under `.conv` as in the reference."""

    def __init__(self, cin: int, cout: int, k: int, *, stride: int = 1,
                 dilation: int = 1, groups: int = 1, weight_norm: bool = True):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.conv = ConvWeights((cout, cin // groups, k), cout,
                                weight_norm=weight_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return causal_conv1d(x, self.conv.kernel(), self.conv.bias,
                             stride=self.stride, dilation=self.dilation,
                             groups=self.groups)


class CausalConvTranspose(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, *, stride: int,
                 weight_norm: bool = True):
        super().__init__()
        self.stride = stride
        self.conv = ConvWeights((cin, cout, k), cout, transposed=True,
                                weight_norm=weight_norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return causal_conv_transpose1d(x, self.conv.kernel(), self.conv.bias,
                                       stride=self.stride)


class ResidualUnit(nn.Module):
    """block = [Snake, conv k7 dilated, Snake, conv k1]."""

    def __init__(self, dim: int, dilation: int):
        super().__init__()
        self.dilation = dilation
        self.block = nn.ModuleList([
            Snake1d(dim), CausalConv(dim, dim, 7, dilation=dilation),
            Snake1d(dim), CausalConv(dim, dim, 1)])

    def forward(self, x: torch.Tensor, approx_snake: bool = False,
                history: Optional[torch.Tensor] = None,
                centred: bool = False,
                lengths: Optional[torch.Tensor] = None):
        s1, c1, s2, c2 = self.block
        return residual_unit(x, s1.vec(), c1.conv.kernel(), c1.conv.bias,
                             s2.vec(), c2.conv.kernel(), c2.conv.bias,
                             self.dilation, approx_snake=approx_snake,
                             history=history, centred=centred,
                             lengths=lengths)


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = CausalConv(dim, dim, 7, groups=dim, weight_norm=False)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """1D ConvNeXt block (reference: autoencoder.py:333-373)."""
        inp = x
        x = self.dwconv(x)
        x = layer_norm(x, self.norm.weight, self.norm.bias, 1e-6)
        x = self.pwconv2(F.gelu(self.pwconv1(x), approximate="none"))
        return inp + self.gamma * x
