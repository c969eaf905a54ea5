"""Native runtime of the port (counterpart of ``whisper_sae_tpu/runtime``):
the out-of-core shard reader.  Importing it builds and loads nothing."""

from .shard_reader import PrefetchLoader, ShardReader, build_native, native_available

__all__ = ["PrefetchLoader", "ShardReader", "build_native", "native_available"]
