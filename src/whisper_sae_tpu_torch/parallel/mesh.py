"""The ``(data, model)`` mesh over ``torch.distributed`` (counterpart of
``whisper_sae_tpu/parallel/mesh.py``).

The JAX package drives every device from one process and reshapes
``jax.devices()`` into the mesh.  The port runs one process per GPU (the
PyTorch idiom, launched by ``torchrun``): the mesh is the world's ranks
reshaped row-major into ``(data, model)``, so rank ``r`` sits at
``(r // model, r % model)`` as device ``r`` does in the JAX mesh.  It is
built on ``init_device_mesh`` and keeps the groups a step needs:

- ``data_group``: the ranks of this rank's column (same model index), over
  which gradients are all-reduced;
- ``model_group``: the ranks of this rank's row (same data index), over
  which the feature-sharded collectives run;
- ``cpu_group``: a gloo group over every rank, made once, for the gathers
  of host tensors (checkpoints, extraction rows, full parameters).

Device tensors go through ``all_reduce`` and ``broadcast`` only, which
gloo also carries for CUDA tensors (two ranks may then share one card).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..config import MeshConfig

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's view of the ``(data, model)`` mesh.

    ``shape`` is ``{DATA_AXIS: n, MODEL_AXIS: m}``, as a JAX mesh's is;
    ``coords`` this rank's ``(data index, model index)``; ``size`` the
    number of ranks."""

    def __init__(self, data: int, model: int):
        backend = dist.get_backend()
        device_type = "cuda" if backend == "nccl" else "cpu"
        self.device_mesh = init_device_mesh(device_type, (data, model),
                                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
        self.shape = {DATA_AXIS: data, MODEL_AXIS: model}
        self.size = data * model
        self.rank = dist.get_rank()
        self.coords = (self.rank // model, self.rank % model)
        self.data_group = self.device_mesh.get_group(DATA_AXIS)
        self.model_group = self.device_mesh.get_group(MODEL_AXIS)
        self.cpu_group = dist.group.WORLD if backend == "gloo" else dist.new_group(backend="gloo")

    @property
    def data_index(self) -> int:
        return self.coords[0]

    @property
    def model_index(self) -> int:
        return self.coords[1]

    def row_block(self, rows: int) -> slice:
        """This rank's contiguous block of ``rows`` split over ``data``
        (the block ``P(DATA_AXIS, ...)`` gives device ``(d, *)`` in JAX)."""
        n = self.shape[DATA_AXIS]
        if rows % n:
            raise ValueError(f"{rows} rows do not split over a data axis of {n}")
        per = rows // n
        return slice(self.data_index * per, (self.data_index + 1) * per)

    def feature_block(self, width: int) -> slice:
        """This rank's contiguous block of ``width`` features split over
        ``model``."""
        m = self.shape[MODEL_AXIS]
        if width % m:
            raise ValueError(f"{width} features do not split over a model axis of {m}")
        per = width // m
        return slice(self.model_index * per, (self.model_index + 1) * per)

    def __repr__(self) -> str:
        return f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, rank={self.rank})"


def make_mesh(data: int = -1, model: int = 1) -> Mesh:
    """Build a ``(data, model)`` mesh over the initialised process group.

    ``data=-1`` takes every rank left after the model axis."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised: launch under torchrun "
                           "or call parallel.initialize_if_needed first")
    n = dist.get_world_size()
    if model < 1 or n % model != 0:
        raise ValueError(f"model axis {model} does not divide device count {n}")
    if data == -1:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(data, model)


def mesh_from_config(cfg: MeshConfig) -> Mesh:
    return make_mesh(data=cfg.data, model=cfg.model)
