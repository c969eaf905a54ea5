"""Per-layer activation cache (counterpart of
``whisper_sae_tpu/data/feature_cache.py:46-336``), read and write side.

The on-disk format is the JAX package's: ``.npy`` shards named
``{model_short}_{component}_layer{N}_shard{i:04d}.npy`` and a
``{model_short}_{component}_layer{N}_meta.json`` sidecar listing them,
with the element type in ``dtype``.  A bf16 shard's ``.npy`` header says
void-2 (numpy has no bf16), so the metadata's dtype decides how its bytes
are read; here bf16 rows become a ``torch.bfloat16`` tensor without any
third-party dtype package.

A cache loads into memory whole, multi-shard caches included (there is
no out-of-core reader yet).
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from datetime import datetime
from pathlib import Path

import numpy as np
import torch

from ..config import DataConfig, WhisperConfig
from .loader import ActivationLoader

DEFAULT_SHARD_TOKENS = 1 << 21

_BF16 = "bfloat16"


@dataclass
class CacheMetadata:
    """Per-layer cache metadata (same fields and JSON as the JAX package)."""

    model_name: str
    component: str
    layer_idx: int
    hidden_dim: int
    num_samples: int
    num_tokens: int
    created_at: str
    data_config: dict
    shards: list[str] | None = None
    dtype: str = "float32"

    def to_json(self) -> str:
        data = {
            k: ({kk: str(vv) if isinstance(vv, Path) else vv for kk, vv in v.items()}
                if isinstance(v, dict) else str(v) if isinstance(v, Path) else v)
            for k, v in asdict(self).items()
        }
        return json.dumps(data, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "CacheMetadata":
        return cls(**json.loads(s))


def _to_stored(tokens, dtype: str) -> np.ndarray:
    """Rows -> the array written to a shard (bf16 as void-2 bit patterns)."""
    if dtype == _BF16:
        t = tokens if isinstance(tokens, torch.Tensor) else torch.from_numpy(np.asarray(tokens, np.float32))
        bits = t.detach().cpu().to(torch.bfloat16).view(torch.int16).numpy()
        return bits.view(np.dtype("V2"))
    if isinstance(tokens, torch.Tensor):
        tokens = tokens.detach().cpu().float().numpy()
    return np.asarray(tokens, np.dtype(dtype))


def _view_stored_dtype(arr: np.ndarray, dtype_name: str | None) -> torch.Tensor:
    """A loaded shard as a tensor of its metadata dtype."""
    if dtype_name == _BF16:
        if arr.dtype.itemsize != 2:
            raise ValueError(
                f"cache metadata dtype bfloat16 does not match shard dtype {arr.dtype} "
                "-- mixed-dtype or corrupt cache"
            )
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    want = np.dtype(dtype_name or arr.dtype)
    if arr.dtype != want:
        if arr.dtype.itemsize != want.itemsize:
            raise ValueError(
                f"cache metadata dtype {want} does not match shard dtype {arr.dtype} "
                "-- mixed-dtype or corrupt cache"
            )
        arr = arr.view(want)
    return torch.from_numpy(np.ascontiguousarray(arr))


class CacheWriter:
    """Incremental shard writer for one (component, layer)."""

    def __init__(self, cache: "FeatureCache", component: str, layer_idx: int,
                 shard_tokens: int = DEFAULT_SHARD_TOKENS, dtype: str = "float32"):
        if dtype not in ("float32", _BF16):
            raise ValueError(f"cache dtype must be float32 or bfloat16 (got {dtype})")
        self.cache = cache
        self.component = component
        self.layer_idx = layer_idx
        self.shard_tokens = shard_tokens
        self.dtype = dtype
        self._buf: list[np.ndarray] = []
        self._buf_tokens = 0
        self._shards: list[str] = []
        self.num_tokens = 0
        self.hidden_dim: int | None = None

    def append(self, tokens) -> None:
        rows = _to_stored(tokens, self.dtype)
        self.hidden_dim = rows.shape[-1]
        self._buf.append(rows)
        self._buf_tokens += rows.shape[0]
        self.num_tokens += rows.shape[0]
        if self._buf_tokens >= self.shard_tokens:
            self._flush()

    def _flush(self) -> None:
        if not self._buf:
            return
        shard = np.concatenate(self._buf, axis=0)
        path = self.cache._shard_path(self.component, self.layer_idx, len(self._shards))
        tmp = path.with_suffix(".tmp.npy")
        np.save(tmp, shard)
        tmp.replace(path)
        self._shards.append(path.name)
        self._buf, self._buf_tokens = [], 0

    def finalize(self, num_samples: int) -> CacheMetadata:
        self._flush()
        meta = CacheMetadata(
            model_name=self.cache.whisper_config.model_name,
            component=self.component,
            layer_idx=self.layer_idx,
            hidden_dim=int(self.hidden_dim or 0),
            num_samples=num_samples,
            num_tokens=self.num_tokens,
            created_at=datetime.now().isoformat(),
            data_config=json.loads(self.cache.data_config.model_dump_json()),
            shards=self._shards,
            dtype=self.dtype,
        )
        self.cache._write_meta(self.component, self.layer_idx, meta)
        return meta


class FeatureCache:
    """Per-layer activation cache."""

    def __init__(self, cache_dir: Path | str, whisper_config: WhisperConfig,
                 data_config: DataConfig):
        self.cache_dir = Path(cache_dir)
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self.whisper_config = whisper_config
        self.data_config = data_config
        self.model_short = whisper_config.model_name.split("/")[-1]

    def _stem(self, component: str, layer_idx: int) -> str:
        return f"{self.model_short}_{component}_layer{layer_idx}"

    def _shard_path(self, component: str, layer_idx: int, shard: int) -> Path:
        return self.cache_dir / f"{self._stem(component, layer_idx)}_shard{shard:04d}.npy"

    def _meta_path(self, component: str, layer_idx: int) -> Path:
        return self.cache_dir / f"{self._stem(component, layer_idx)}_meta.json"

    def _write_meta(self, component: str, layer_idx: int, meta: CacheMetadata) -> None:
        self._meta_path(component, layer_idx).write_text(meta.to_json())

    def has_cache(self, component: str, layer_idx: int) -> bool:
        mp = self._meta_path(component, layer_idx)
        if not mp.exists():
            return False
        meta = CacheMetadata.from_json(mp.read_text())
        return bool(meta.shards) and all((self.cache_dir / s).exists() for s in meta.shards)

    def load_metadata(self, component: str, layer_idx: int) -> CacheMetadata:
        return CacheMetadata.from_json(self._meta_path(component, layer_idx).read_text())

    def load(self, component: str, layer_idx: int) -> tuple[torch.Tensor, CacheMetadata]:
        """-> (CPU tensor [num_tokens, hidden_dim] of the stored dtype, metadata)."""
        meta = self.load_metadata(component, layer_idx)
        parts = [_view_stored_dtype(np.load(self.cache_dir / s), meta.dtype) for s in meta.shards or []]
        return (parts[0] if len(parts) == 1 else torch.cat(parts)), meta

    def writer(self, component: str, layer_idx: int, **kw) -> CacheWriter:
        return CacheWriter(self, component, layer_idx, **kw)

    def get_dataloader(self, component: str, layer_idx: int, batch_size: int,
                       shuffle: bool = True, seed: int = 0) -> ActivationLoader:
        features, _ = self.load(component, layer_idx)
        return ActivationLoader(features, batch_size=batch_size, shuffle=shuffle, seed=seed)
