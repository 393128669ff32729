"""Port of echo_tts_tpu/train: the flow-matching step and loop, the data
shards, few-step distillation and its end-to-end recipe, on one card."""
from .data import DataConfig, encode_utterance, iter_batches, write_shards
# the distill loop is echo_tts_torch.train.distill.distill: re-exporting it
# here would shadow the submodule of the same name
from .distill import distill_loss, few_step_sampler_params, make_distill_step
from .step import (TrainState, create_train_state, flow_matching_loss,
                   make_optimizer, make_train_step)

__all__ = ["TrainState", "create_train_state", "flow_matching_loss",
           "make_optimizer", "make_train_step",
           "DataConfig", "encode_utterance", "iter_batches", "write_shards",
           "distill_loss", "few_step_sampler_params", "make_distill_step"]
