"""Activation math shared by the codec (models/dac/conv.py) and the
residual-stack kernel's plain version (ops/res_stack.py).

Counterpart of echo_tts_tpu/ops/activations.py.  sin2_poly approximates
sin(z)^2, the transcendental inside the S1-DAC snake
(reference: autoencoder.py:96-109); csrc/res_stack.cu carries the same
constants.
"""
from __future__ import annotations

import numpy as np
import torch

# Degree-4 near-minimax polynomial for sin^2(pi*u) = v*P(v), v = u^2,
# u in [-1/2, 1/2]; max abs error 1.6e-6 over the full period.
SIN2_COEFFS = (9.869597907896603, -32.46839063007976, 42.686220577408491,
               -29.642546184449031, 10.952207549847412)

# Cody-Waite split of pi: PI_HI has 12 mantissa bits, so k*PI_HI is exact
# in f32 for |k| <= 2^12.
_PI_HI = float(np.float32(3.140625))
_PI_LO = float(np.float32(np.pi - 3.140625))
_INV_PI = float(np.float32(1.0 / np.pi))


def sin2_poly(z: torch.Tensor) -> torch.Tensor:
    """sin(z)^2 via a range-reduced degree-4 polynomial (f32 math)."""
    z = z.float()
    k = torch.round(z * _INV_PI)
    r = (z - k * _PI_HI) - k * _PI_LO      # r in ~[-pi/2, pi/2]
    u = r * _INV_PI                         # u in ~[-1/2, 1/2]
    v = u * u
    c = [float(np.float32(ci)) for ci in SIN2_COEFFS]
    p = c[0] + v * (c[1] + v * (c[2] + v * (c[3] + v * c[4])))
    return v * p
