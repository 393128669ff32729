"""echo_tts_torch — the PyTorch/CUDA port of echo_tts_tpu for one NVIDIA H100.

Layer map (each module mirrors its namesake in echo_tts_tpu/):

  models/    EchoDiT + text/speaker encoders, Fish S1-DAC codec
  ops/       plain PyTorch ops; wrappers of the hand-written CUDA kernels
             (csrc/joint_attention.cu, csrc/res_stack.cu,
             csrc/int8_matmul.cu) with their plain versions and launch
             counters; the int8 quantization of the DiT and static K/V
  sampler/   Euler CFG sampler, blockwise (streaming) sampler
  pipeline/  host text stack, DSP, audio IO, text->audio orchestration,
             streaming (block) encode and decode
  serve/     the queue-worker handler (voice cache, metrics, storage,
             config), the micro-batching server and its batched pass, the
             model cache and its quant mode (ECHO_DIT_QUANT), presets and
             buckets; stream_synthesize and its block schedules
  train/     the flow-matching step and loop (AdamW, EMA, remat modes),
             latent shards and batches, few-step distillation (plain or
             QAT) and its end-to-end recipe
  tools/     weight bridge from the JAX package's parameter trees; the
             port's checkpoint bundles; the hub loader; the device-time
             profile of the main path and of a train step
  demo/      the demo's session and presets, gradio optional
  utils/     the span recorder (server queue, gather and pass, the
             batch pass's host stages, program builds), StageTimer
             and trace() (torch.profiler over every thread, spans
             beside it); captured programs (CUDA graphs)

Entry points default to device="cuda" and raise without a CUDA device;
pass device="cpu" to run the plain PyTorch path.  Nothing here imports JAX.
"""
from .config import (DACConfig, EchoDiTConfig, SAMPLER_DEFAULTS,
                     base_dac_config, base_dit_config, tiny_dac_config,
                     tiny_dit_config)
from .pipeline.pipeline import (EchoModels, ae_decode, ae_encode,
                                euler_sample_fn, load_models_from_dir,
                                random_models, sample_pipeline,
                                sample_pipeline_chunked)
from .sampler.euler import sample_euler_cfg_independent_guidances
from .serve.presets import growing_schedule
from .serve.streaming import StreamChunk, stream_synthesize

__all__ = [
    "DACConfig", "EchoDiTConfig", "EchoModels", "SAMPLER_DEFAULTS",
    "StreamChunk", "ae_decode", "ae_encode", "base_dac_config",
    "base_dit_config", "euler_sample_fn", "growing_schedule",
    "load_models_from_dir", "random_models",
    "sample_euler_cfg_independent_guidances",
    "sample_pipeline", "sample_pipeline_chunked", "stream_synthesize",
    "tiny_dac_config", "tiny_dit_config",
]
