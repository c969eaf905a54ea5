"""Parallelism: the ``(data, model)`` mesh over ``torch.distributed``, the
shard rules, the distributed top-k, process-group set-up (counterpart of
``whisper_sae_tpu/parallel``).  One process per GPU, launched by
``torchrun``; without a launch environment nothing here runs."""

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh, make_mesh, mesh_from_config
from .multihost import initialize_if_needed, is_primary
from .tp_topk import topk_mask_sharded, topk_threshold_sharded

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "Mesh",
    "initialize_if_needed",
    "is_primary",
    "make_mesh",
    "mesh_from_config",
    "topk_mask_sharded",
    "topk_threshold_sharded",
]
