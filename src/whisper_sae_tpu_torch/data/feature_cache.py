"""Per-layer activation cache and the extraction loop (counterpart of
``whisper_sae_tpu/data/feature_cache.py``).

The on-disk format is the JAX package's: ``.npy`` shards named
``{model_short}_{component}_layer{N}_shard{i:04d}.npy`` and a
``{model_short}_{component}_layer{N}_meta.json`` sidecar listing them,
with the element type in ``dtype``.  A bf16 shard's ``.npy`` header says
void-2 (numpy has no bf16), so the metadata's dtype decides how its bytes
are read; here bf16 rows become a ``torch.bfloat16`` tensor without any
third-party dtype package.

A single-shard cache loads into memory whole; a cache of more than one
shard streams from disk (``get_dataloader(out_of_core=None)``: a
:class:`~..runtime.shard_reader.PrefetchLoader`, batch by batch, or chunked epochs
from its reader when the trainer is asked for them), and ``load_rows``
gives row access over its shards without reading them whole (the
launcher's coder jobs).

``extract_and_cache_features`` runs Whisper over an audio loader and
streams the requested layers into such caches, on one device or, with a
``mesh``, with each data rank capturing its block of every batch.
"""

from __future__ import annotations

import json
from collections.abc import Callable
from dataclasses import asdict, dataclass
from datetime import datetime
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np
import torch
import torch.distributed as dist

from ..config import DataConfig, WhisperConfig
from ..runtime.shard_reader import PrefetchLoader, ShardReader
from .loader import ActivationLoader

if TYPE_CHECKING:
    from ..models.whisper import WhisperArch

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

    def state(self) -> dict:
        """Resumable-extraction cut: flush the buffer to a (possibly short)
        shard and return what a restarted run needs to append after it."""
        self._flush()
        return {"shards": list(self._shards), "num_tokens": self.num_tokens,
                "hidden_dim": self.hidden_dim}

    def restore(self, state: dict) -> None:
        """Continue from a :meth:`state` snapshot (its shards are on disk)."""
        self._shards = list(state["shards"])
        self.num_tokens = int(state["num_tokens"])
        self.hidden_dim = state["hidden_dim"]
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


class _LazyShardRows:
    """Row access over several ``.npy`` shards (a memmap each), never
    concatenated: a gather reads only the shards that hold its rows
    (``feature_cache.py:167-230`` of the JAX package).  Rows come back as
    a CPU tensor of the cache's dtype."""

    def __init__(self, paths: list[Path], dtype: str | None = None):
        self._reader = ShardReader(paths, dtype)
        self.dtype_name = self._reader.dtype_name
        self.shape = (self._reader.num_rows, self._reader.dim)

    @property
    def nbytes(self) -> int:
        return self._reader.num_rows * self._reader.row_bytes

    def __len__(self) -> int:
        return self.shape[0]

    def __getitem__(self, idx) -> torch.Tensor:
        n = self.shape[0]
        if isinstance(idx, slice):
            idx = np.arange(*idx.indices(n))
        if isinstance(idx, torch.Tensor):
            idx = idx.numpy()
        scalar = isinstance(idx, (int, np.integer))
        idx = np.atleast_1d(np.asarray(idx))
        if idx.dtype == bool:
            idx = np.nonzero(idx)[0]
        idx = np.where(idx < 0, idx + n, idx)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"row indices out of range for {n} rows")
        rows = self._reader.gather(idx)
        return rows[0] if scalar else rows

    def mean0(self, chunk_rows: int = 1 << 20) -> torch.Tensor:
        """Mean over the rows, one chunk at a time, summed in f64."""
        total = torch.zeros(self.shape[1], dtype=torch.float64)
        for lo in range(0, self.shape[0], chunk_rows):
            total += self[lo:min(lo + chunk_rows, self.shape[0])].double().sum(dim=0)
        return (total / self.shape[0]).float()


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

    def load_rows(self, component: str, layer_idx: int
                  ) -> tuple[torch.Tensor | _LazyShardRows, CacheMetadata]:
        """Like :meth:`load`, but a multi-shard cache is never read whole:
        it comes back as :class:`_LazyShardRows` (``:286-301`` of the JAX
        package; there a single shard is a memmap, here it loads)."""
        meta = self.load_metadata(component, layer_idx)
        shards = meta.shards or []
        if len(shards) == 1:
            return self.load(component, layer_idx)[0], meta
        return _LazyShardRows([self.cache_dir / s for s in shards], meta.dtype), meta

    def save(self, features, component: str, layer_idx: int, num_samples: int,
             shard_tokens: int = DEFAULT_SHARD_TOKENS) -> CacheMetadata:
        """One-shot save of f32 rows (reference feature_cache.py:136-167)."""
        w = self.writer(component, layer_idx, shard_tokens=shard_tokens)
        w.append(features)
        return w.finalize(num_samples)

    def writer(self, component: str, layer_idx: int, **kw) -> CacheWriter:
        return CacheWriter(self, component, layer_idx, **kw)

    def get_dataloader(self, component: str, layer_idx: int, batch_size: int,
                       shuffle: bool = True, seed: int = 0, out_of_core: bool | None = None):
        """Batch loader over a cached layer.  ``out_of_core=None`` streams a
        cache of more than one shard from disk (a :class:`PrefetchLoader`
        over a :class:`ShardReader`; the trainer then runs chunked epochs)
        and loads a single-shard cache whole (``:313-336`` of the JAX
        package)."""
        meta = self.load_metadata(component, layer_idx)
        if out_of_core is None:
            out_of_core = len(meta.shards or []) > 1
        if out_of_core:
            reader = ShardReader([self.cache_dir / s for s in meta.shards], dtype=meta.dtype)
            return PrefetchLoader(reader, batch_size=batch_size, shuffle=shuffle, seed=seed)
        features, _ = self.load(component, layer_idx)
        return ActivationLoader(features, batch_size=batch_size, shuffle=shuffle, seed=seed)


def _start_pull(stack: torch.Tensor, copy_stream) -> Callable[[], torch.Tensor]:
    """Start the device->host copy of ``stack`` on ``copy_stream`` (into
    pinned memory, so it overlaps the next batch's forward); returns a
    function that waits for it and gives the host tensor."""
    if stack.device.type != "cuda":
        return lambda: stack
    host = torch.empty(stack.shape, dtype=stack.dtype, pin_memory=True)
    copy_stream.wait_stream(torch.cuda.current_stream(stack.device))
    with torch.cuda.stream(copy_stream):
        host.copy_(stack, non_blocking=True)
    stack.record_stream(copy_stream)
    done = torch.cuda.Event()
    done.record(copy_stream)

    def wait() -> torch.Tensor:
        done.synchronize()
        return host

    return wait


def extract_and_cache_features(
    whisper_params: dict,
    arch: WhisperArch,
    audio_dataloader,
    cache: FeatureCache,
    encoder_layers: list[int],
    decoder_layers: list[int],
    max_samples: int | None = None,
    apply_layer_norm: bool = True,
    progress: bool = True,
    compute_dtype: torch.dtype | None = None,
    mesh=None,
    capture_mlp: bool = False,
    checkpoint_every: int | None = None,
    resume: bool = False,
    cache_dtype: str | None = None,
    device: str | torch.device | None = None,
) -> None:
    """Extraction loop: one ``extract_activations`` per batch, the
    requested layers flattened to ``[B*T, D]`` and streamed to shards
    (the JAX ``extract_and_cache_features``, same files and metadata).

    - Only the requested layers leave the device.  With
      ``compute_dtype=torch.bfloat16`` the transfer is bf16 and is widened
      to f32 on the host, unless ``cache_dtype="bfloat16"`` stores it as
      bf16 shards; the mels are uploaded in bf16 too.
    - The host copy of batch i runs on a side stream while batch i+1's
      forward runs, and is written after that forward is launched.
    - ``checkpoint_every`` (samples) writes the writers' progress to
      ``extraction_progress.json`` at shard-consistent cuts; ``resume``
      restores them and skips the samples already written, giving a
      cache identical to an uninterrupted run (same loader, same batch).
    - ``device``: where the forward runs (default: where the parameters
      are).
    - ``mesh`` (``parallel.make_mesh``, one process per GPU, every rank
      with the same loader): each data rank captures its contiguous block
      of each batch (a ragged batch padded with repeats of its last row,
      as the JAX package pads it); rank 0 gathers the blocks over the
      mesh's CPU group, drops the padding and writes the cache, the same
      files and rows as one process would.
    """
    # imported here: ``models.whisper`` imports this package (``data.mel``)
    from ..models.whisper import cast_params, extract_activations, params_to

    if mesh is not None:
        from ..parallel.mesh import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), not {type(mesh).__name__}")
    primary = mesh is None or mesh.rank == 0
    n_data = 1 if mesh is None else mesh.shape["data"]
    transfer_bf16 = compute_dtype == torch.bfloat16
    cache_dtype = cache_dtype or "float32"
    if cache_dtype not in ("float32", _BF16):
        raise ValueError(f"unsupported cache_dtype {cache_dtype!r}")
    if cache_dtype == _BF16 and not transfer_bf16:
        raise ValueError("cache_dtype='bfloat16' requires bf16 compute "
                         "(compute_dtype=torch.bfloat16)")
    store_bf16 = cache_dtype == _BF16
    if device is None:
        device = next(iter(whisper_params["encoder"].values())).device
    device = torch.device(device)
    params = params_to(whisper_params, device)
    if compute_dtype is not None:
        params = cast_params(params, compute_dtype)  # once, not per batch
    if mesh is not None:
        from ..parallel.extraction import gather_rows, place_mel, replicate_params

        params = replicate_params(mesh, params)

    # only rank 0 writes: the other ranks' writer tables stay empty
    writers_e = {l: cache.writer("encoder", l, dtype=cache_dtype)
                 for l in encoder_layers if primary}
    writers_d = {l: cache.writer("decoder", l, dtype=cache_dtype)
                 for l in decoder_layers if primary}
    writers_mlp: dict[str, dict[int, CacheWriter]] = {}
    if capture_mlp:
        for comp, layers in (("encoder", encoder_layers), ("decoder", decoder_layers)):
            for kind in ("mlp_in", "mlp_out"):
                writers_mlp[f"{comp}_{kind}"] = {
                    l: cache.writer(f"{comp}_{kind}", l, dtype=cache_dtype)
                    for l in layers if primary
                }

    def flat_writers() -> dict[str, CacheWriter]:
        flat = {f"encoder:{l}": w for l, w in writers_e.items()}
        flat.update({f"decoder:{l}": w for l, w in writers_d.items()})
        for comp_kind, ws in writers_mlp.items():
            flat.update({f"{comp_kind}:{l}": w for l, w in ws.items()})
        return flat

    progress_path = cache.cache_dir / "extraction_progress.json"

    def write_progress(samples_done: int) -> None:
        snap = {
            "model_name": cache.whisper_config.model_name,
            "cache_dtype": cache_dtype,
            "num_samples": samples_done,
            "writers": {k: w.state() for k, w in flat_writers().items()},
        }
        tmp = progress_path.with_suffix(".tmp")
        tmp.write_text(json.dumps(snap))
        tmp.rename(progress_path)

    skip_samples = 0
    if resume and primary and progress_path.exists():
        snap = json.loads(progress_path.read_text())
        flat = flat_writers()
        compatible = (
            snap.get("model_name") == cache.whisper_config.model_name
            and snap.get("cache_dtype", "float32") == cache_dtype
            and set(snap.get("writers", {})) == set(flat)
            and all((cache.cache_dir / s).exists()
                    for st in snap["writers"].values() for s in st["shards"])
        )
        if compatible:
            for k, w in flat.items():
                w.restore(snap["writers"][k])
            skip_samples = int(snap["num_samples"])
            if progress:
                print(f"resuming extraction at sample {skip_samples}", flush=True)
        elif progress:
            print("extraction progress file incompatible; starting fresh", flush=True)
    if mesh is not None:  # every rank skips what rank 0 restored
        box = [skip_samples]
        dist.broadcast_object_list(box, src=0, group=mesh.cpu_group)
        skip_samples = box[0]
        progress = progress and primary

    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

    def select(stack: torch.Tensor, layers: list[int]) -> torch.Tensor:
        if len(layers) < stack.shape[0]:
            stack = stack[torch.tensor(sorted(layers), device=stack.device)]
        return stack.to(torch.bfloat16) if transfer_bf16 else stack

    def drain(pulled, rows: int) -> None:
        for fetch, layers, writers in pulled:
            host = fetch()  # one device->host copy per component per batch
            if mesh is not None:  # rank 0 takes every block; the padding goes
                host = gather_rows(mesh, host)
                if host is None:
                    continue
                host = host[:, :rows]
            if host.dtype != torch.float32 and not store_bf16:
                host = host.float()
            for j, l in enumerate(sorted(layers)):
                writers[l].append(host[j].reshape(-1, host.shape[-1]))

    num_samples = 0
    target = max_samples if max_samples is not None else float("inf")
    pending = None
    pending_rows = 0
    pending_upto = 0  # samples covered once `pending` drains
    last_ckpt = skip_samples
    for batch in audio_dataloader:
        if num_samples >= target:
            break
        if isinstance(batch, (tuple, list)):
            batch = batch[0]
        rows = int(np.asarray(batch).shape[0])
        if skip_samples > 0:
            if rows > skip_samples:
                raise ValueError(
                    f"resume cut ({skip_samples} samples left to skip) falls inside a "
                    f"{rows}-row batch; rerun with the original batch size so checkpoint "
                    "cuts align with batches")
            skip_samples -= rows
            num_samples += rows
            continue
        mel = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
        if rows % n_data:  # repeat the last row until the batch splits over data
            mel = torch.cat([mel, mel[-1:].expand(n_data - rows % n_data, *mel.shape[1:])])
        if mesh is not None:
            mel = place_mel(mesh, mel)
        if transfer_bf16:
            mel = mel.to(torch.bfloat16)  # the forward's first cast, done before the upload
        mel = mel.to(device)
        acts = extract_activations(
            params, mel, arch, apply_layer_norm=apply_layer_norm,
            with_decoder=bool(decoder_layers), compute_dtype=compute_dtype,
            with_mlp=capture_mlp, capture_dtype=torch.bfloat16 if transfer_bf16 else None,
        )
        pulled = []
        if encoder_layers:
            pulled.append((_start_pull(select(acts["encoder"], encoder_layers), copy_stream),
                           encoder_layers, writers_e))
        if decoder_layers:
            pulled.append((_start_pull(select(acts["decoder"], decoder_layers), copy_stream),
                           decoder_layers, writers_d))
        for comp_kind, writers in writers_mlp.items():
            layers = encoder_layers if comp_kind.startswith("encoder") else decoder_layers
            if layers:
                pulled.append((_start_pull(select(acts[comp_kind], layers), copy_stream),
                               layers, writers))
        del acts
        if pending is not None:
            drain(pending, pending_rows)
            if checkpoint_every and pending_upto - last_ckpt >= checkpoint_every and primary:
                write_progress(pending_upto)
                last_ckpt = pending_upto
        pending, pending_rows = pulled, rows
        num_samples += rows
        pending_upto = num_samples
        if progress and num_samples % (rows * 8) == 0:
            print(f"extracted {num_samples} samples", flush=True)
    if pending is not None:
        drain(pending, pending_rows)

    for w in flat_writers().values():
        w.finalize(num_samples)
    if primary:
        progress_path.unlink(missing_ok=True)
    if mesh is not None:  # the cache is whole before any rank reads it
        dist.barrier(group=mesh.cpu_group)
