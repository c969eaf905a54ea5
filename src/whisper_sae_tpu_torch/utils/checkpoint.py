"""Checkpoint files (counterpart of ``whisper_sae_tpu/utils/checkpoint.py``).

A checkpoint is one ``.npz`` whose keys are the paths of a nested dict
joined by ``::`` (``params::w_enc``), with optional JSON metadata under
``__meta__`` -- the JAX package's format, so either package reads the
other's parameter files.  ``sae_final.pt`` is the reference torch
``state_dict`` layout.  ``params_from_jax``/``params_to_jax`` carry any
family's parameters across the two packages in the same layout: the
SAEs' ``[D, H]`` matrices, the Skip transcoder's ``w_skip``/``b_skip``,
the crosscoder's 3-D ``w_enc [L, D, S]`` and ``w_dec [S, L, D]``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

_SEP = "::"


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    items = tree.items() if isinstance(tree, dict) else tree._asdict().items()
    for key, value in items:
        path = f"{prefix}{_SEP}{key}" if prefix else str(key)
        if isinstance(value, dict) or hasattr(value, "_asdict"):
            flat.update(_flatten(value, path))
        else:
            flat[path] = _to_numpy(value)
    return flat


def save_pytree(path: str | Path, tree, meta: dict | None = None) -> Path:
    """Save a nested dict (or NamedTuple) of tensors/arrays to one ``.npz``,
    atomically (tmp -> rename)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".tmp")
    flat = _flatten(tree)
    if meta is not None:
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"), dtype=np.uint8).copy()
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    tmp.replace(path)
    return path


def load_pytree(path: str | Path) -> tuple[dict, dict | None]:
    """-> (nested dict of numpy arrays, metadata or None)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    meta = None
    if "__meta__" in flat:
        meta = json.loads(bytes(flat.pop("__meta__")).decode("utf-8"))
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(_SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree, meta


# ---------------------------------------------------------------------------
# parameters across packages and the reference torch layout
# ---------------------------------------------------------------------------


def params_from_jax(np_params: dict, device=None) -> dict[str, torch.Tensor]:
    """JAX-package parameters (numpy arrays, any float dtype) -> f32 tensors
    in the same layout."""
    return {
        k: torch.from_numpy(np.asarray(v, dtype=np.float32).copy()).to(device)
        for k, v in np_params.items()
    }


def params_to_jax(params: dict) -> dict[str, np.ndarray]:
    """Inverse of :func:`params_from_jax`: f32 numpy arrays."""
    return {k: _to_numpy(v).astype(np.float32) for k, v in params.items()}


def load_jax_params(path: str | Path, device=None) -> dict[str, torch.Tensor]:
    """Parameters from a ``sae_final.npz`` written by the JAX package."""
    tree, _ = load_pytree(path)
    return params_from_jax(tree, device)


# Our layout -> the reference torch state_dict (encoder.weight [H, D],
# decoder.weight [D, H], b_pre [D]).
_TORCH_EXPORT_TOPK = {
    "encoder.weight": ("w_enc", lambda a: a.T),
    "encoder.bias": ("b_enc", lambda a: a),
    "decoder.weight": ("w_dec", lambda a: a.T),
    "decoder.bias": ("b_dec", lambda a: a),
    "b_pre": ("b_pre", lambda a: a),
}


def export_torch_state_dict(params: dict, state=None, path: str | Path | None = None) -> dict:
    """Parameters (and dead-feature state) as a reference ``state_dict``;
    ``torch.save``d to ``path`` when given (the ``sae_final.pt`` file)."""
    sd = {}
    for torch_key, (our_key, fn) in _TORCH_EXPORT_TOPK.items():
        if our_key in params:
            sd[torch_key] = torch.from_numpy(np.ascontiguousarray(fn(_to_numpy(params[our_key]))))
    if state is not None:
        sd["feature_last_activated"] = torch.from_numpy(
            _to_numpy(state.feature_last_activated).astype(np.int64)
        )
        sd["step_count"] = torch.tensor(int(state.step_count), dtype=torch.int64)
    if path is not None:
        torch.save(sd, str(path))
    return sd


def import_torch_state_dict(sd) -> dict[str, torch.Tensor]:
    """Inverse of :func:`export_torch_state_dict`: a reference ``state_dict``
    (tensors or numpy arrays) -> CPU parameter tensors in our layout."""
    return {
        our_key: torch.from_numpy(np.ascontiguousarray(fn(_to_numpy(sd[torch_key]))))
        for torch_key, (our_key, fn) in _TORCH_EXPORT_TOPK.items()
        if torch_key in sd
    }
