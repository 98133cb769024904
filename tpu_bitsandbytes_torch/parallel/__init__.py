"""Multi-device parallelism over ``torch.distributed``: (dp, tp) meshes,
the sharding rules, the tensor-parallel serving steps, and the QLoRA
training step (single-device; its sharded form is not ported)."""

from .distributed import initialize, make_pod_mesh
from .mesh import make_mesh, replicated, shard
from .sharding import (build_sharded_int4_cache, kv_cache_spec,
                       llama_param_specs, shard_params, spec_tree)
from .tp import (make_tp_decode_chunk, make_tp_decode_step,
                 make_tp_final_logits, make_tp_prefill_chunk,
                 make_tp_prefill_step, make_tp_verify_step)
from .train import make_qlora_train_step, qlora_loss_and_grads

__all__ = [
    "make_mesh", "replicated", "shard",
    "llama_param_specs", "shard_params", "kv_cache_spec", "spec_tree",
    "make_tp_decode_step", "make_tp_decode_chunk", "make_tp_prefill_step",
    "make_tp_prefill_chunk", "make_tp_final_logits", "make_tp_verify_step",
    "build_sharded_int4_cache",
    "make_qlora_train_step", "qlora_loss_and_grads", "initialize",
    "make_pod_mesh",
]
