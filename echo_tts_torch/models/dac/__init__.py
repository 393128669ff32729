"""Port of echo_tts_tpu/models/dac: the Fish S1-DAC codec."""
