"""Multi-device serving: the mesh of rank processes, partition rules,
tensor-parallel layouts, and pipelined decoding over ``torch.distributed``.

Counterpart of ``starpu_inference_server_tpu/parallel/`` for its
pipelined path (``configs/llama_pipelined.yml``) and its GSPMD mode: a
``shard_map`` body becomes the program each rank runs on its shard,
``lax.psum`` an all-reduce on an axis's process group, ``lax.ppermute``
a point-to-point hop (``collectives.py``); where GSPMD inserts a
collective around a sharded leaf (``sharded_forward``, the batch and
generation engines on a mesh without a pipe axis), the family's body
calls it itself (``ops/nn.py``'s ``mesh`` arguments). Sequence
parallelism is ``ring_attention.py``.
"""

from .mesh import MeshAxes, make_device_mesh
from .partition import batch_sharding, partition_rules_for, shard_params, sharded_forward
from .pipeline import pipeline_forward, pipelined_decoder_logits, stack_layers
from .ring_attention import ring_causal_attention, sequence_parallel_decoder_logits

__all__ = [
    "MeshAxes",
    "batch_sharding",
    "make_device_mesh",
    "partition_rules_for",
    "pipeline_forward",
    "pipelined_decoder_logits",
    "ring_causal_attention",
    "sequence_parallel_decoder_logits",
    "shard_params",
    "sharded_forward",
    "stack_layers",
]
