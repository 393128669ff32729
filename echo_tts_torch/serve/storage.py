"""Output encoding + upload.

Counterpart of echo_tts_tpu/serve/storage.py, copied as it is.  Mirrors
_save_and_upload_audio (reference: handler.py:482-606): write the
waveform as WAV, transcode to 24 kHz / 128 kbps VBR Opus via ffmpeg, then
upload to S3 (presigned 3600 s URL) when configured, else keep the local
file.  boto3 and ffmpeg are both optional — absence degrades to local WAV.
"""
from __future__ import annotations

import logging
import os
import re
import time
import uuid
from typing import Dict, Optional

import numpy as np

from ..pipeline import audio_io
from .config import ServeConfig

log = logging.getLogger("echo_tts_torch.serve")

PRESIGNED_URL_TTL = 3600  # reference: handler.py:581

_SAFE_COMPONENT = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}\Z")


def sanitize_component(name: str, what: str) -> str:
    """Reject path separators / traversal in user-controlled filename parts
    (session_id, request_id) — the analog of the voice path check
    (reference: handler.py:711-718).  Returns the validated name."""
    if not isinstance(name, str) or not _SAFE_COMPONENT.match(name):
        raise ValueError(
            f"invalid {what}: must match [A-Za-z0-9][A-Za-z0-9._-]*, "
            "max 64 chars (no path components)")
    return name


def _s3_client(cfg: ServeConfig):
    import boto3  # optional dependency

    return boto3.client(
        "s3",
        region_name=cfg.s3_region,
        endpoint_url=cfg.s3_endpoint,
        aws_access_key_id=cfg.s3_access_key,
        aws_secret_access_key=cfg.s3_secret_key,
    )


def save_and_upload_audio(
    audio: np.ndarray,
    sample_rate: int,
    cfg: ServeConfig,
    request_id: str,
    session_id: Optional[str] = None,
) -> Dict[str, object]:
    """audio: (channels, samples) float32 in [-1, 1]."""
    os.makedirs(cfg.output_dir, exist_ok=True)
    request_id = sanitize_component(request_id, "request_id")
    if session_id is not None:
        session_id = sanitize_component(session_id, "session_id")
    stem = f"{session_id or 'session'}_{request_id}_{uuid.uuid4().hex[:8]}"
    wav_path = os.path.join(cfg.output_dir, stem + ".wav")
    audio_io.write_wav(wav_path, audio, sample_rate)

    out_path, codec = wav_path, "wav"
    if audio_io.ffmpeg_available():
        ogg_path = os.path.join(cfg.output_dir, stem + ".ogg")
        try:
            t0 = time.time()
            audio_io.encode_opus(wav_path, ogg_path)
            log.info("opus encode %.2fs", time.time() - t0)
            out_path, codec = ogg_path, "opus"
            os.remove(wav_path)
        except Exception as exc:  # keep the WAV on transcode failure
            log.warning("opus encode failed (%s); keeping WAV", exc)

    result: Dict[str, object] = {
        "filename": os.path.basename(out_path),
        "local_path": out_path,
        "codec": codec,
    }

    if cfg.s3_configured:
        try:
            client = _s3_client(cfg)
            key = f"audio/{os.path.basename(out_path)}"
            with open(out_path, "rb") as f:
                client.put_object(Bucket=cfg.s3_bucket, Key=key,
                                  Body=f.read())
            url = client.generate_presigned_url(
                "get_object",
                Params={"Bucket": cfg.s3_bucket, "Key": key},
                ExpiresIn=PRESIGNED_URL_TTL)
            result.update(s3_key=key, url=url)
        except Exception as exc:
            log.warning("S3 upload failed: %s", exc)
            result["s3_error"] = str(exc)
    return result
