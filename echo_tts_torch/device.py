"""Device resolution shared by the port's entry points.

Every entry point defaults to `device="cuda"` and raises when no CUDA
device is present: the port never falls back to the CPU on its own.  Tests
and CPU runs pass `device="cpu"` explicitly.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return device
