"""Scale-out: the (data, model) mesh and the DiT's tensor-parallel layout
(mesh), sharded inference (inference), sequence-parallel speaker prefill
(sp) and the multi-host join (distributed)."""
from .mesh import (DATA_AXIS, MODEL_AXIS, batch_spec, dit_param_specs,
                   kv_cache_spec, make_mesh, shard_params, to_named)

__all__ = ["DATA_AXIS", "MODEL_AXIS", "batch_spec", "dit_param_specs",
           "kv_cache_spec", "make_mesh", "shard_params", "to_named"]
