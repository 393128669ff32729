"""plain_kernels(): the DiT's joint attention and norm islands and the
codec's residual stacks through their plain versions, for fp32 models on
the card (kernels A, B and D take bf16 only) and for the fp32 oracles the
checks hold the kernels' models against."""
from __future__ import annotations

import contextlib

from ..ops.dit_norm import dit_adaln_plain, qk_norm_rope_plain
from ..ops.joint_attention import joint_attention_plain
from ..ops.res_stack import res_stack_plain
from . import dit
from .dac import dac


def _plain_stack(x, weights, *, approx_snake=False, history=None,
                 centred=False, lengths=None):
    return res_stack_plain(x, *weights.plain_args(), approx_snake, history,
                           centred=centred, lengths=lengths)


@contextlib.contextmanager
def plain_kernels():
    """Every DiT forward's joint attention, AdaLN and Q/K norm, and every
    one-shot or streamed residual stack through its plain version: nothing
    launches kernel A, B or D inside."""
    saved = (dit.fused_joint_attention, dit.dit_adaln, dit.qk_norm_rope,
             dac.fused_res_stack)
    dit.fused_joint_attention = joint_attention_plain
    dit.dit_adaln, dit.qk_norm_rope = dit_adaln_plain, qk_norm_rope_plain
    dac.fused_res_stack = _plain_stack
    try:
        yield
    finally:
        (dit.fused_joint_attention, dit.dit_adaln, dit.qk_norm_rope,
         dac.fused_res_stack) = saved
