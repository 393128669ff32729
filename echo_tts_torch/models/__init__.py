"""Port of echo_tts_tpu/models."""
