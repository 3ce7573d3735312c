"""Multi-device serving: the mesh of rank processes, partition rules,
tensor-parallel layouts, and pipelined decoding over ``torch.distributed``.

Counterpart of ``starpu_inference_server_tpu/parallel/`` for its
pipelined path (``configs/llama_pipelined.yml``): a ``shard_map`` body
becomes the program each rank runs on its shard, ``lax.psum`` an
all-reduce on an axis's process group, ``lax.ppermute`` over ``pipe``
a point-to-point hop (``collectives.py``). The GSPMD mode without a
pipe axis (``sharded_forward``, the slot-sharded engine) and
``ring_attention.py`` are not ported yet.
"""

from .mesh import MeshAxes, make_device_mesh
from .partition import partition_rules_for, shard_params
from .pipeline import pipeline_forward, pipelined_decoder_logits, stack_layers

__all__ = [
    "MeshAxes",
    "make_device_mesh",
    "partition_rules_for",
    "pipeline_forward",
    "pipelined_decoder_logits",
    "shard_params",
    "stack_layers",
]
