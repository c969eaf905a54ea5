"""Out-of-core shard reader: a native row gather and a prefetch thread (the
port's copy of ``whisper_sae_tpu/runtime/shard_reader.py``).

The gather is ``wstio.cpp`` (this directory), compiled with the host C++
compiler (``$CXX``, else ``g++`` or ``c++`` on ``PATH``) into
``build/libwstio_<hash>.so`` at first use, never at import; the hash
covers the source and the flags, so an edit builds a new library.  The
native gather releases the GIL (a plain ctypes call), so
:class:`PrefetchLoader`'s worker thread overlaps batch assembly with the
device's steps.  Where no compiler is found the reader falls back to a
numpy memmap gather; ``ShardReader.native`` says which path is in use.
The flags are the JAX package's Makefile's without ``-march=native``: a
memory-bound copy gains nothing from it, and a ``build/`` carried to
another host would hold a binary for the wrong CPU.

Rows come back as a CPU tensor of the cache's dtype: bf16 shards (void-2
in their ``.npy`` headers) are read as their 16-bit patterns and viewed
as ``torch.bfloat16``, without a third-party dtype package.  Indices
outside ``[0, num_rows)`` raise ``IndexError`` on both paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import queue
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
_SRC = Path(__file__).with_name("wstio.cpp")
_BF16 = "bfloat16"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_attempted = False
last_build_log: str = ""


def _compiler() -> str | None:
    return os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libwstio_{h.hexdigest()[:16]}.so"


def _compile() -> Path | None:
    """Build the library for the current source if it is missing; a
    temporary file is renamed into place, so processes building at once
    each leave a whole library.  Returns its path, or None when no
    compiler is found or the build fails (the log in ``last_build_log``)."""
    global last_build_log
    out = library_path()
    if out.exists():
        return out
    cxx = _compiler()
    if cxx is None:
        last_build_log = "no C++ compiler on PATH"
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(_SRC)],
                              capture_output=True, text=True)
    except OSError as e:
        last_build_log = str(e)
        return None
    last_build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load_lib() -> ctypes.CDLL | None:
    """The loaded library, built at its first use in a process; None (the
    memmap fallback) when it cannot be built.  A failed build is tried
    once a process, not once a call."""
    global _lib, _build_attempted
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists() and not _build_attempted:
                _build_attempted = True
                path = _compile() or path
            if not path.exists():
                return None
            lib = ctypes.CDLL(str(path))
            p64 = ctypes.POINTER(ctypes.c_int64)
            lib.wstio_open.restype = ctypes.c_void_p
            lib.wstio_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, p64, p64,
                                       ctypes.c_int64]
            lib.wstio_total_rows.restype = ctypes.c_int64
            lib.wstio_total_rows.argtypes = [ctypes.c_void_p]
            lib.wstio_gather.restype = None
            lib.wstio_gather.argtypes = [ctypes.c_void_p, p64, ctypes.c_int64, ctypes.c_void_p]
            lib.wstio_close.restype = None
            lib.wstio_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


def build_native(quiet: bool = True) -> bool:
    """Build the library (retried even after a failed build at first use);
    returns whether the native gather is available.  ``quiet=False``
    prints the compiler's output."""
    global _build_attempted
    if native_available():
        return True
    with _lock:
        _build_attempted = True
        _compile()
    if not quiet and last_build_log:
        print(last_build_log)
    return native_available()


def _npy_header_info(path: Path) -> tuple[int, tuple[int, ...], np.dtype]:
    """(data offset, shape, dtype) of a ``.npy`` file from a memmap open,
    which reads its header and no data page."""
    m = np.load(path, mmap_mode="r")
    if not m.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{path}: fortran-order arrays unsupported")
    return int(m.offset), m.shape, m.dtype


def _torch_dtype(dtype_name: str) -> torch.dtype:
    if dtype_name == _BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(dtype_name))).dtype


class ShardReader:
    """Row gather over a set of 2-D ``.npy`` shards forming one ``[N, dim]``
    dataset.  ``dtype`` is the cache metadata's element type (the shards'
    own for bf16 caches is void-2)."""

    def __init__(self, shard_paths: list[Path | str], dtype: str | None = None):
        self.paths = [Path(p) for p in shard_paths]
        offsets, rows, parsed = [], [], None
        self.dim = None
        for p in self.paths:
            off, shape, dt = _npy_header_info(p)
            if len(shape) != 2:
                raise ValueError(f"{p}: expected a 2-D shard, got {shape}")
            if self.dim is None:
                self.dim, parsed = int(shape[1]), dt
            elif shape[1] != self.dim or dt != parsed:
                raise ValueError(f"{p}: inconsistent shard shape/dtype ({shape}, {dt})")
            offsets.append(off)
            rows.append(int(shape[0]))
        self.dtype_name = dtype or parsed.name
        if self.dtype_name == _BF16 and parsed.itemsize != 2:
            raise ValueError(f"cache dtype bfloat16 does not match shard dtype {parsed}")
        self.torch_dtype = _torch_dtype(self.dtype_name)
        if self.torch_dtype.itemsize != parsed.itemsize:
            raise ValueError(f"cache dtype {self.dtype_name} does not match shard dtype {parsed}")
        self.rows_per_shard = rows
        self.num_rows = int(sum(rows))
        self.row_bytes = self.dim * parsed.itemsize

        self._handle = None
        self._mmaps = None
        lib = _load_lib()
        if lib is not None:
            c_paths = (ctypes.c_char_p * len(self.paths))(*[str(p).encode() for p in self.paths])
            self._handle = lib.wstio_open(c_paths, len(self.paths),
                                          (ctypes.c_int64 * len(offsets))(*offsets),
                                          (ctypes.c_int64 * len(rows))(*rows), self.row_bytes)
        if self._handle is None:
            # the memmap gather, in the shards' bytes (bf16 as int16 patterns)
            store = np.int16 if self.dtype_name == _BF16 else np.dtype(self.dtype_name)
            self._mmaps = [np.load(p, mmap_mode="r").view(store) for p in self.paths]
            self._cum = np.cumsum([0] + rows)

    @property
    def native(self) -> bool:
        return self._handle is not None

    def gather(self, indices, out: torch.Tensor | None = None) -> torch.Tensor:
        """Rows ``indices`` (any order, repeats allowed) as a CPU tensor
        ``[len, dim]`` of the cache's dtype, written into ``out`` (a
        contiguous CPU tensor of that shape and dtype) when given."""
        indices = np.ascontiguousarray(indices, np.int64)
        if indices.size and (indices.min() < 0 or indices.max() >= self.num_rows):
            raise IndexError(f"row indices out of range for {self.num_rows} rows")
        shape = (len(indices), self.dim)
        if out is None:
            out = torch.empty(shape, dtype=self.torch_dtype)
        elif (tuple(out.shape) != shape or out.dtype != self.torch_dtype
              or out.device.type != "cpu" or not out.is_contiguous()):
            raise ValueError(f"out must be a contiguous CPU {self.torch_dtype} tensor {shape}, "
                             f"not {out.dtype} {tuple(out.shape)} on {out.device}")
        if self._handle is not None:
            _lib.wstio_gather(self._handle,
                              indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                              len(indices), out.data_ptr())
        elif self._mmaps is not None:
            dst = (out.view(torch.int16) if self.dtype_name == _BF16 else out).numpy()
            shard_ids = np.searchsorted(self._cum, indices, side="right") - 1
            local = indices - self._cum[shard_ids]
            for s in range(len(self.paths)):
                m = shard_ids == s
                if m.any():
                    dst[m] = self._mmaps[s][local[m]]
        else:
            raise ValueError("the reader is closed")
        return out

    def close(self) -> None:
        if self._handle is not None:
            _lib.wstio_close(self._handle)
            self._handle = None
        self._mmaps = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


class PrefetchLoader:
    """Shuffling batch loader over a :class:`ShardReader`: a new order each
    epoch, the final partial batch included, the next batch gathered on a
    worker thread while the caller uses the current one.  Asked for fused
    epochs (``SAETrainer.train(loader, fused=True)``), the trainer gathers
    chunks from ``reader`` instead (``train_epoch_out_of_core``)."""

    def __init__(self, reader: ShardReader, batch_size: int, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2):
        self.reader = reader
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)

    @property
    def num_tokens(self) -> int:
        return self.reader.num_rows

    def __len__(self) -> int:
        return math.ceil(self.reader.num_rows / self.batch_size)

    def __iter__(self):
        n = self.reader.num_rows
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)

        def worker():
            try:
                for start in range(0, n, self.batch_size):
                    q.put(self.reader.gather(order[start:start + self.batch_size]))
            finally:
                q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is None:
                break
            yield batch
        t.join()
