"""Serving configuration from environment variables.

Counterpart of echo_tts_tpu/serve/config.py.  Mirrors the reference
worker's Config (reference: handler.py:244-319): validated env vars, the
voices-directory scan and the accelerator report, here from torch.cuda.

The JAX package picks its device through JAX_PLATFORMS; here the device
the models load on is `ServeConfig.device`, from ECHO_DEVICE (default
"cuda"; "cpu" runs the plain versions, as the tests do).  Without a card
the default raises when the models load (device.resolve_device): nothing
here picks a device on its own.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
from typing import Dict, List, Optional

from ..device import card_names

AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".ogg", ".m4a", ".opus")


@dataclasses.dataclass
class ServeConfig:
    hf_token: Optional[str]
    s3_bucket: Optional[str]
    s3_region: Optional[str]
    s3_access_key: Optional[str]
    s3_secret_key: Optional[str]
    s3_endpoint: Optional[str]
    voices_dir: str
    output_dir: str
    model_dir: Optional[str]
    issues: List[str]
    # JSON metrics snapshot written after each handled job when set
    # (ECHO_METRICS_FILE; serve/metrics.py)
    metrics_file: Optional[str] = None
    # the torch device the models load on (ECHO_DEVICE)
    device: str = "cuda"

    @property
    def s3_configured(self) -> bool:
        return bool(self.s3_bucket and self.s3_access_key
                    and self.s3_secret_key)

    def validate(self) -> List[str]:
        return list(self.issues)


def load_config(env: Optional[Dict[str, str]] = None) -> ServeConfig:
    """Read + validate env (reference: handler.py:252-316)."""
    env = dict(os.environ if env is None else env)
    issues: List[str] = []

    voices_dir = env.get("AUDIO_VOICES_DIR", "/runpod-volume/voices")
    output_dir = env.get("OUTPUT_AUDIO_DIR", "/tmp/echo_tts_out")
    model_dir = env.get("ECHO_MODEL_DIR")

    if not env.get("HF_TOKEN") and not model_dir:
        issues.append("HF_TOKEN not set and no ECHO_MODEL_DIR provided")

    s3_bucket = env.get("S3_BUCKET_NAME") or env.get("S3_BUCKET")
    if s3_bucket:
        for k in ("S3_ACCESS_KEY_ID", "S3_SECRET_ACCESS_KEY"):
            if not env.get(k):
                issues.append(f"S3 bucket set but {k} missing")

    if not os.path.isdir(voices_dir):
        issues.append(f"voices dir does not exist: {voices_dir}")

    return ServeConfig(
        hf_token=env.get("HF_TOKEN"),
        s3_bucket=s3_bucket,
        s3_region=env.get("S3_REGION", "us-east-1"),
        s3_access_key=env.get("S3_ACCESS_KEY_ID"),
        s3_secret_key=env.get("S3_SECRET_ACCESS_KEY"),
        s3_endpoint=env.get("S3_ENDPOINT_URL"),
        voices_dir=voices_dir,
        output_dir=output_dir,
        model_dir=model_dir,
        issues=issues,
        metrics_file=env.get("ECHO_METRICS_FILE"),
        device=env.get("ECHO_DEVICE", "cuda"),
    )


def scan_voices(voices_dir: str) -> List[str]:
    """Available voice files (reference: handler.py:300-316)."""
    if not os.path.isdir(voices_dir):
        return []
    return sorted(
        f for f in os.listdir(voices_dir)
        if f.lower().endswith(AUDIO_EXTENSIONS))


def _power_limits() -> Optional[List[str]]:
    """Each card's power limit as nvidia-smi prints it (device.card_names,
    the last field of each line), or None without nvidia-smi or when it
    fails."""
    if shutil.which("nvidia-smi") is None:
        return None
    try:
        lines = card_names()
    except (OSError, subprocess.SubprocessError):
        return None
    return [line.rsplit(",", 1)[-1].strip() for line in lines if line.strip()]


def device_info() -> Dict[str, object]:
    """Accelerator report (reference: handler.py:269-286): "cuda" with the
    cards' names (and power limits, where nvidia-smi runs) when torch sees
    a card, else "cpu".  It reports; it never picks the serving device."""
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "device_count": 0, "devices": [],
                "torch": torch.__version__}
    n = torch.cuda.device_count()
    out: Dict[str, object] = {
        "platform": "cuda",
        "device_count": n,
        "devices": [torch.cuda.get_device_name(i) for i in range(n)],
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    limits = _power_limits()
    if limits is not None:
        out["power_limits"] = limits
    return out
