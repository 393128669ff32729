#!/usr/bin/env bash
# Worker bootstrap for the PyTorch/CUDA port (reference: bootstrap.sh:1-43):
# log tee, warmup, exec.
set -euo pipefail

LOG_DIR="${LOG_DIR:-/tmp/echo_tts_logs}"
mkdir -p "$LOG_DIR"
exec > >(tee -a "$LOG_DIR/bootstrap.log") 2>&1

echo "[bootstrap] $(date -u +%FT%TZ) starting echo-tts-torch worker"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader || true
python - <<'PY'
import torch
print("[bootstrap] cuda:", torch.cuda.is_available(),
      torch.cuda.get_device_name(0) if torch.cuda.is_available() else "-")
PY

# Load the models, build the three kernels (nvcc, once per build
# directory), capture the warm-up manifest's programs and serve in that
# process, where the captured programs live; if it fails or ends, serve
# without them.
python -m echo_tts_torch.serve.handler --warmup-compile || \
    echo "[bootstrap] warmup failed; starting anyway"

exec python -m echo_tts_torch.serve.handler
