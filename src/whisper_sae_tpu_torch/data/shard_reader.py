"""The shard reader under its earlier module name: a re-export of
:mod:`whisper_sae_tpu_torch.runtime.shard_reader` (the native gather with
its memmap fallback, and the prefetch loader)."""

from ..runtime.shard_reader import PrefetchLoader, ShardReader, build_native, native_available

__all__ = ["PrefetchLoader", "ShardReader", "build_native", "native_available"]
