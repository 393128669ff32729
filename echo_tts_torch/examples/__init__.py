"""Runnable entry points of the port, the counterparts of examples/:

  generate          text to a WAV file (the reference's `python -m inference`)
  streaming_demo    block-by-block synthesis to a WAV file
  distill_few_step  the few-step distillation recipe end to end
  soak_long_stream  one stream at the largest serving schedule, gated

and the measurement modules, the counterparts of examples/bench_*.py,
each printing one JSON line with the card's name and power limit:

  bench_kv_quant               the sampler with bf16 against int8 static
                               K/V, B = 1 and 8 (--long-speaker: the
                               6400-latent bucket), --w4a8 the M = 120
                               scan in bf16, W8A8 and W4A8
  bench_int8_surfaces          the W8A8 DiT: p50 at seq 224, one B = 8
                               run_batch pass
  bench_train_step             the value-and-grad step; --sweep doubles B
                               per remat policy until out of memory
  bench_long_reference         encode, prefill and sampler per speaker
                               bucket (640, 2816, 6400)
  bench_few_step               the 8-step sampler, its W8A8 form, the
                               40-step one, with prefill and decode
  bench_stream_int8            TTFA and streamed RTF, bf16 and W8A8
  bench_ttfa_breakdown         the stages of a stream's first audio
  bench_incremental_crossover  a whole stream's latent prefix re-encoded
                               or carried
  bench_attention              kernel A, its plain version and SDPA over
                               (S, T, GB)
  bench_int8                   24-layer MLP and projection scans: bf16,
                               W8A8 (kernel C), int8-pure, w8-dequant

(`stages` holds what they share.)  Run each as `python -m
echo_tts_torch.examples.<name>`; each has `main(argv=None, *, models=None)
-> int`, so that a caller holding loaded models can pass them in.  They
run on the card unless `--device cpu` or ECHO_DEVICE=cpu is given; the
bench modules' `--tiny` (the tiny config at short lengths, with `--device
cpu`) is what their CPU test, tests/test_torch_bench_examples.py, runs.
"""
