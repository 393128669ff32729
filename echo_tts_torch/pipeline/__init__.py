"""Port of echo_tts_tpu/pipeline: host text, DSP, audio IO and the
text -> audio orchestration."""
