"""Loading the published weights from the Hugging Face hub.

Counterpart of echo_tts_tpu/tools/hub.py (reference: inference.py:14-47,
56-76, 92-99): the same repositories and files, downloaded and loaded
under their own state-dict keys (pipeline.load_models_from_files).  Needs
the network, and HF_TOKEN for gated repositories; where there is no
network, fill a directory with the files and use serve.models.load_models.
`huggingface_hub` is imported only when a file is downloaded.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import base_dit_config
from ..device import resolve_device
from ..pipeline.pipeline import EchoModels, load_models_from_files

DIT_REPO = "jordand/echo-tts-base"          # reference: inference.py:25
DAC_REPO = "jordand/fish-s1-dac-min"        # reference: inference.py:62
DIT_FILE = "pytorch_model.safetensors"
DAC_FILE = "pytorch_model.safetensors"  # reference: inference.py:61
PCA_FILE = "pca_state.safetensors"      # reference: inference.py:92


def _download(repo: str, filename: str, token: Optional[str]) -> str:
    from huggingface_hub import hf_hub_download

    return hf_hub_download(repo, filename, token=token)


def load_models_from_hf(token: Optional[str] = None, device="cuda",
                        dtype=torch.bfloat16,
                        dac_dtype: Optional[torch.dtype] = None,
                        blockwise: bool = True) -> EchoModels:
    """Download and load the whole bundle (DiT, S1-DAC, PCA state) on
    `device`; the codec with the serving decoder snake (polynomial on the
    card, exact on the CPU) in `dac_dtype`, by default the serving one
    (bf16 on the card, fp32 on the CPU).
    Raises without CUDA unless device='cpu'."""
    device = resolve_device(device)     # before any download
    return load_models_from_files(
        _download(DIT_REPO, DIT_FILE, token),
        _download(DAC_REPO, DAC_FILE, token),
        _download(DIT_REPO, PCA_FILE, token), device, dtype,
        dit_cfg=base_dit_config(blockwise=blockwise), dac_dtype=dac_dtype)
