"""Plain PyTorch reference of what the benchmark's cells serve.

Written from the published Echo-TTS description (EchoDiT, the Euler
sampler with independent text and speaker guidance, the Fish S1-DAC
decoder), with no kernel, cache, program or batching, and importing
nothing of the system under test.  Weights are dicts of tensors keyed by
the published checkpoint's names; `specs` lists them with their shapes
and the scale each is drawn at, so that the benchmark can make one set of
weights from a seed and hand the same to the program and to this
reference.  Every matmul and convolution runs in float32 with TF32 off
(`fp32`).

`lowered` computes every product (each linear, convolution and the two
products of each attention) on operands rounded to a lower precision, the
correctness check's control: `rest` for every product, `hot` for the
DiT blocks' eight hot linears (HOT) where it is given.
"""
from __future__ import annotations

import contextlib
import re
from typing import Optional

import torch

HOT = re.compile(r"^blocks\.\d+\.(attention\.(wq|wk|wv|wo|gate)|mlp\.w[123])$")
_LOWERED = {"rest": None, "hot": None}


@contextlib.contextmanager
def fp32():
    """Full float32 products: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@contextlib.contextmanager
def lowered(rest: Optional[str], hot: Optional[str] = None):
    """Products on operands of precision `rest` ("fp8", "int8", "int4" or
    None), the DiT's hot linears on `hot` (default `rest`)."""
    saved = dict(_LOWERED)
    _LOWERED.update(rest=rest, hot=hot or rest)
    try:
        yield
    finally:
        _LOWERED.update(saved)


def q(x: torch.Tensor, dims, name: str = "") -> torch.Tensor:
    """x as a product's operand: rounded to the lowered precision on a
    scale of its absolute maximum over `dims`, back in float32; as it is
    outside `lowered`."""
    mode = _LOWERED["hot" if HOT.match(name) else "rest"]
    if mode is None:
        return x
    amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-30)
    if mode in ("int8", "int4"):
        top = 127.0 if mode == "int8" else 7.0
        scale = amax / top
        return torch.round(x / scale).clamp(-top, top) * scale
    if mode == "fp8":
        scale = amax / 448.0
        return (x / scale).to(torch.float8_e4m3fn).float() * scale
    raise ValueError(f"precision {mode!r}")
