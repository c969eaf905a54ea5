"""Data-parallel activation extraction (counterpart of
``whisper_sae_tpu/parallel/extraction.py``).

The capture forward is batch-parallel (a clip's activations depend only
on its own mel), so each data rank runs the single-device forward -- the
encoder kernels included -- on its contiguous block of each batch, with
no collective in the forward.  The extraction loop
(``data/feature_cache.py``) gathers the blocks to rank 0 over the mesh's
CPU group, which writes the cache.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.whisper import WhisperArch, extract_activations
from .mesh import Mesh
from .sharding import batch_sharding


def place_mel(mesh: Mesh, mel: torch.Tensor) -> torch.Tensor:
    """This rank's block of a ``[B, n_mels, T]`` mel batch over ``data``
    (B must split evenly: the extraction loop pads ragged batches)."""
    return mel[batch_sharding(mesh, mel.shape[0])]


@torch.no_grad()
def replicate_params(mesh: Mesh, params: dict) -> dict:
    """Every rank's Whisper parameters made rank 0's, by a broadcast of
    each tensor (once per run); returns ``params``, updated in place."""

    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            elif isinstance(v, torch.Tensor):
                dist.broadcast(v, src=0)

    walk(params)
    return params


def extract_activations_shard_map(
    params: dict,
    mel: torch.Tensor,
    arch: WhisperArch,
    mesh: Mesh,
    apply_layer_norm: bool = True,
    with_decoder: bool = True,
    compute_dtype=None,
    with_mlp: bool = False,
    capture_dtype=None,
) -> dict[str, torch.Tensor]:
    """``extract_activations`` on this rank's block of the global batch
    ``mel``: each rank runs the full single-device forward (the fused
    encoder kernels included) on its rows, so its captures are bit for
    bit those of a single-device run on the same rows."""
    return extract_activations(params, place_mel(mesh, mel), arch,
                               apply_layer_norm=apply_layer_norm, with_decoder=with_decoder,
                               compute_dtype=compute_dtype, with_mlp=with_mlp,
                               capture_dtype=capture_dtype)


def extract_activations_sharded(params: dict, mel: torch.Tensor, arch: WhisperArch, mesh: Mesh,
                                apply_layer_norm: bool = True, with_decoder: bool = True,
                                compute_dtype=None) -> dict[str, torch.Tensor]:
    """The JAX package's GSPMD form; with one process per rank it is the
    same per-block forward as :func:`extract_activations_shard_map`."""
    return extract_activations_shard_map(params, mel, arch, mesh, apply_layer_norm,
                                         with_decoder, compute_dtype)


def gather_rows(mesh: Mesh, host: torch.Tensor, dim: int = 1) -> torch.Tensor | None:
    """Rank 0 gets every data rank's block of ``host`` (on the CPU, equal
    shapes on every rank), concatenated along ``dim`` in data order (the
    ranks of model index 0); the other ranks get ``None``.  bf16 goes
    through as its bytes (gloo has no 16-bit types), bit for bit; ``dim``
    is not the last."""
    host = host.contiguous()
    if host.dtype == torch.bfloat16:
        got = gather_rows(mesh, host.view(torch.uint8), dim)
        return None if got is None else got.view(torch.bfloat16)
    parts = [torch.empty_like(host) for _ in range(mesh.size)] if mesh.rank == 0 else None
    dist.gather(host, parts, dst=0, group=mesh.cpu_group)
    if mesh.rank != 0:
        return None
    m = mesh.shape["model"]
    return torch.cat(parts[::m], dim=dim)
