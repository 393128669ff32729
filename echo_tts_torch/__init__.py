"""echo_tts_torch — the PyTorch/CUDA port of echo_tts_tpu for one NVIDIA H100.

Layer map (each module mirrors its namesake in echo_tts_tpu/):

  models/    EchoDiT + text/speaker encoders, Fish S1-DAC codec
  ops/       plain PyTorch ops; wrappers of the hand-written CUDA kernels
             (csrc/joint_attention.cu, csrc/res_stack.cu) with their plain
             versions and launch counters
  sampler/   Euler CFG sampler
  pipeline/  host text stack, DSP, audio IO, text->audio orchestration
  tools/     weight bridge from the JAX package's parameter trees; the
             device-time profile of the main path

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

__all__ = [
    "DACConfig", "EchoDiTConfig", "EchoModels", "SAMPLER_DEFAULTS",
    "ae_decode", "ae_encode", "base_dac_config", "base_dit_config",
    "euler_sample_fn", "load_models_from_dir", "random_models",
    "sample_euler_cfg_independent_guidances",
    "sample_pipeline", "sample_pipeline_chunked", "tiny_dac_config",
    "tiny_dit_config",
]
