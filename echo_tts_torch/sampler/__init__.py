"""Port of echo_tts_tpu/sampler (Euler CFG sampler)."""
