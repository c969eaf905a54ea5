"""Sharding rules and the data-parallel step (counterpart of
``whisper_sae_tpu/parallel/sharding.py``).

Shape rules for a parameter dict (its roles have distinct shapes), as in
the JAX package; a rule names the dimension a leaf splits on over the
``model`` ranks, ``None`` for a replicated leaf:

    [D, H]  w_enc (and its AdamW moments)   -> 1 (columns)
    [H, D]  w_dec                           -> 0 (rows)
    [H]     b_enc, feature_last_activated   -> 0
    [D], scalars, anything else             -> None (replicated)

The dp step: each data rank takes its contiguous block of the global
batch (:func:`batch_sharding`), takes local gradients, and one
``all_reduce(SUM)`` over the data group of every gradient flattened into
one buffer, divided by the data-axis size, gives each rank the
gradient of the global batch (:func:`reduce_gradients`).  The trainer
takes gradients of a parameter dict, not of an ``nn.Module``, so this is
written out rather than wrapped in DDP.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, Mesh


def axis_sizes(params: dict) -> tuple[int, int]:
    """(d, h) for the shape rules -- the 2-D ``w_enc`` when present, else
    (-1, -1) (no rule matches: everything replicates)."""
    w_enc = params.get("w_enc") if isinstance(params, dict) else None
    if w_enc is not None and w_enc.ndim == 2:
        d, h = w_enc.shape
        return int(d), int(h)
    return -1, -1


def leaf_pspec(shape: tuple[int, ...], d: int, h: int) -> int | None:
    """The dimension a leaf of ``shape`` splits on over ``model``, or
    ``None`` (replicated)."""
    shape = tuple(shape)
    if shape == (d, h):
        return 1
    if shape == (h, d):
        return 0
    if shape == (h,):
        return 0
    return None


def shard_leaf(mesh: Mesh, leaf: torch.Tensor, dim: int | None) -> torch.Tensor:
    """This rank's slice of ``leaf`` along ``dim`` (contiguous, its own
    storage), or ``leaf`` itself when replicated."""
    if dim is None:
        return leaf
    block = mesh.feature_block(leaf.shape[dim])
    return leaf.narrow(dim, block.start, block.stop - block.start).contiguous().clone()


def place_tree(mesh: Mesh, tree: dict, d: int, h: int) -> dict:
    """A full dict -> this rank's slices by the shape rules."""
    return {k: shard_leaf(mesh, v, leaf_pspec(tuple(v.shape), d, h)) for k, v in tree.items()}


def _gather(mesh: Mesh, t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), on the CPU, in rank order."""
    host = t.detach().cpu().contiguous()
    if host.dtype == torch.bfloat16:  # its bytes: gloo has no 16-bit types
        parts = _gather(mesh, host.view(torch.uint8))
        return [p.view(torch.bfloat16) for p in parts]
    parts = [torch.empty_like(host) for _ in range(mesh.size)]
    dist.all_gather(parts, host, group=mesh.cpu_group)
    return parts


def gather_leaf(mesh: Mesh, leaf: torch.Tensor, dim: int | None) -> torch.Tensor:
    """The inverse of :func:`shard_leaf`: the full leaf on every rank (on
    the leaf's device), concatenated over this rank's model row through
    the CPU group.  A replicated leaf is returned as it is."""
    if dim is None or mesh.shape["model"] == 1:
        return leaf
    parts = _gather(mesh, leaf)
    m = mesh.shape["model"]
    row = parts[mesh.data_index * m:(mesh.data_index + 1) * m]
    return torch.cat(row, dim=dim).to(leaf.device)


def gather_tree(mesh: Mesh, tree: dict, specs: dict) -> dict:
    """:func:`gather_leaf` over a dict whose leaves split as ``specs``
    names (by key; missing keys are replicated)."""
    return {k: gather_leaf(mesh, v, specs.get(k)) for k, v in tree.items()}


def batch_sharding(mesh: Mesh, rows: int) -> slice:
    """This rank's rows of a ``rows``-row global batch: the contiguous
    block ``P(DATA_AXIS, ...)`` gives it in the JAX mesh."""
    return mesh.row_block(rows)


def reduce_gradients(mesh: Mesh, grads: dict[str, torch.Tensor], extra: torch.Tensor | None = None
                     ) -> tuple[dict[str, torch.Tensor], torch.Tensor | None]:
    """The dp gradient all-reduce: every gradient (and ``extra``, the
    step's metric sums) flattened into one f32 buffer, one
    ``all_reduce(SUM)`` over the data group; the gradients come back
    divided by the data-axis size, ``extra`` summed.  A one-rank data axis
    reduces nothing."""
    if mesh.shape[DATA_AXIS] == 1:
        return grads, extra
    names = list(grads)
    flat = [grads[k].reshape(-1).float() for k in names]
    if extra is not None:
        flat.append(extra.reshape(-1).float())
    buf = torch.cat(flat)
    dist.all_reduce(buf, group=mesh.data_group)
    n = mesh.shape[DATA_AXIS]
    out, at = {}, 0
    for k in names:
        size = grads[k].numel()
        out[k] = (buf[at:at + size] / n).view(grads[k].shape).to(grads[k].dtype)
        at += size
    return out, (buf[at:] if extra is not None else None)


def shard_train_step(step: Callable, mesh: Mesh) -> Callable:
    """Wrap ``step(batch)`` for the mesh: the wrapped step takes a global
    batch (a tensor or a tuple of them) and hands ``step`` this rank's
    block of its rows.  The step itself all-reduces its gradients
    (:func:`reduce_gradients`)."""

    def wrapped(batch):
        rows = (batch[0] if isinstance(batch, tuple) else batch).shape[0]
        block = batch_sharding(mesh, rows)
        if isinstance(batch, tuple):
            return step(tuple(a[block] for a in batch))
        return step(batch[block])

    return wrapped
