"""Runnable entry points of the port, the counterparts of examples/:

  generate          text to a WAV file (the reference's `python -m inference`)
  streaming_demo    block-by-block synthesis to a WAV file
  distill_few_step  the few-step distillation recipe end to end
  soak_long_stream  one stream at the largest serving schedule, gated

Run each as `python -m echo_tts_torch.examples.<name>`; each has
`main(argv=None, *, models=None) -> int`, so that a caller holding loaded
models can pass them in.  They run on the card unless `--device cpu` or
ECHO_DEVICE=cpu is given.
"""
