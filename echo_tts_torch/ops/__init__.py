"""Port of echo_tts_tpu/ops: plain PyTorch ops and the wrappers of the
hand-written CUDA kernels (csrc/)."""
