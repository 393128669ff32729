"""Device resolution shared by the port's entry points.

Every entry point defaults to `device="cuda"` and raises when no CUDA
device is present: the port never falls back to the CPU on its own.  Tests
and CPU runs pass `device="cpu"` explicitly.
"""
from __future__ import annotations

import subprocess
from typing import List

import torch


def resolve_device(device="cuda") -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return device


def card_names() -> List[str]:
    """Each card's name and power limit, one line a card, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (the
    hardware a timing is given with)."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()


def card_name(device="cuda") -> str:
    """`device`'s line of card_names(), or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    return card_names()[device.index or 0]
