"""The port's native shard reader (``whisper_sae_tpu_torch/runtime``)
against its memmap fallback and the JAX package's ``ShardReader``, on the
CPU: the library built under ``build/`` by the host compiler (also by two
processes at once), the gather bit for bit on f32 and bf16 shards
(shuffled, repeated and sorted indices, with and without ``out=``),
``close`` twice, out-of-range indices, ``PrefetchLoader``'s batches
against JAX's at the same seed, and nothing of the JAX package's runtime
loaded or built by the port.  Tolerance: none, every row bit for bit.
"""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from whisper_sae_tpu.runtime.shard_reader import PrefetchLoader as JPrefetchLoader
from whisper_sae_tpu.runtime.shard_reader import ShardReader as JShardReader
from whisper_sae_tpu_torch.data import shard_reader as data_shard_reader
from whisper_sae_tpu_torch.runtime import shard_reader as sr

REPO = Path(__file__).resolve().parent.parent
D = 48
SHARDS = (300, 257, 143)  # 700 rows
N = sum(SHARDS)

needs_compiler = pytest.mark.skipif(sr._compiler() is None, reason="no host C++ compiler")


def _write_shards(root: Path, dtype: str) -> tuple[list[Path], np.ndarray]:
    """Three shards of f32 rows, or their bf16 bit patterns as void-2 (the
    caches' on-disk form); returns the paths and the rows as stored."""
    rows = np.random.default_rng(0).standard_normal((N, D)).astype(np.float32)
    if dtype == "bfloat16":
        rows = torch.from_numpy(rows).bfloat16().view(torch.int16).numpy()
    paths, start = [], 0
    for i, n in enumerate(SHARDS):
        p = root / f"shard{i}.npy"
        part = rows[start:start + n]
        np.save(p, part.view(np.dtype("V2")) if dtype == "bfloat16" else part)
        paths.append(p)
        start += n
    return paths, rows


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


def _memmap_reader(monkeypatch, paths, dtype) -> sr.ShardReader:
    with monkeypatch.context() as m:
        m.setattr(sr, "_load_lib", lambda: None)
        return sr.ShardReader(paths, dtype)


INDICES = {
    "shuffled": lambda rng: rng.permutation(N),
    "repeated": lambda rng: rng.integers(0, N, 1000),
    "sorted": lambda rng: np.sort(rng.choice(N, 333, replace=False)),
    "empty": lambda rng: np.zeros(0, np.int64),
}


@needs_compiler
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("order", list(INDICES))
def test_native_gather_matches_memmap_and_jax(tmp_path, monkeypatch, dtype, order):
    paths, rows = _write_shards(tmp_path, dtype)
    native = sr.ShardReader(paths, dtype)
    plain = _memmap_reader(monkeypatch, paths, dtype)
    assert native.native and not plain.native
    assert (native.num_rows, native.dim, native.rows_per_shard) == (N, D, list(SHARDS))
    assert native.row_bytes == plain.row_bytes == D * (2 if dtype == "bfloat16" else 4)
    idx = INDICES[order](np.random.default_rng(1))
    got = native.gather(idx)
    want_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    assert got.dtype == want_dtype and tuple(got.shape) == (len(idx), D)
    np.testing.assert_array_equal(_bits(got), rows[idx])
    np.testing.assert_array_equal(_bits(got), _bits(plain.gather(idx)))
    np.testing.assert_array_equal(_bits(got), _bits(JShardReader(paths, dtype=dtype).gather(idx)))
    for reader in (native, plain):
        out = torch.full((len(idx), D), 7.0, dtype=want_dtype)
        assert reader.gather(idx, out=out) is out
        np.testing.assert_array_equal(_bits(out), rows[idx])


@needs_compiler
def test_out_must_fit(tmp_path):
    paths, _ = _write_shards(tmp_path, "float32")
    reader = sr.ShardReader(paths)
    idx = np.arange(10)
    for bad in (torch.empty(10, D + 1), torch.empty(10, D, dtype=torch.bfloat16),
                torch.empty(D, 10).t()):
        with pytest.raises(ValueError):
            reader.gather(idx, out=bad)


@pytest.mark.parametrize("native", [True, False], ids=["native", "memmap"])
def test_out_of_range_raises_and_close_twice(tmp_path, monkeypatch, native):
    if native and sr._compiler() is None:
        pytest.skip("no host C++ compiler")
    paths, rows = _write_shards(tmp_path, "float32")
    reader = sr.ShardReader(paths) if native else _memmap_reader(monkeypatch, paths, None)
    assert reader.native == native
    for bad in ([N], [0, -1], [N + 5, 3]):
        with pytest.raises(IndexError):
            reader.gather(np.array(bad))
    np.testing.assert_array_equal(reader.gather([N - 1, 0]).numpy(), rows[[N - 1, 0]])
    reader.close()
    reader.close()
    assert not reader.native
    with pytest.raises(ValueError):
        reader.gather([0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_prefetch_loader_gives_the_jax_batches(tmp_path, dtype, shuffle):
    paths, _ = _write_shards(tmp_path, dtype)
    port = sr.PrefetchLoader(sr.ShardReader(paths, dtype), batch_size=64, shuffle=shuffle, seed=5)
    jax_loader = JPrefetchLoader(JShardReader(paths, dtype=dtype), batch_size=64,
                                 shuffle=shuffle, seed=5)
    assert len(port) == len(jax_loader) == -(-N // 64) and port.num_tokens == N
    for _ in range(2):  # a new order each epoch
        got, want = list(port), list(jax_loader)
        assert len(got) == len(want) == len(port) and got[-1].shape[0] == N % 64
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def test_data_module_reexports_runtime():
    assert data_shard_reader.ShardReader is sr.ShardReader
    assert data_shard_reader.PrefetchLoader is sr.PrefetchLoader


_BUILD = """
import sys, time
from pathlib import Path
from whisper_sae_tpu_torch.runtime import shard_reader as sr
root = Path(sys.argv[1])
sr.BUILD_DIR = root / "build"
(root / f"ready{sys.argv[2]}").touch()
while not (root / "go").exists():  # both processes start their build together
    time.sleep(0.01)
ok = sr.build_native()
print(ok, sr.library_path())
sys.exit(0 if ok else 1)
"""


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO / "src")
    return env


@needs_compiler
def test_two_processes_build_at_once(tmp_path):
    """The library lands under ``build/``; two processes that build it at
    once both load a whole library and leave one file, no temporary."""
    import time

    assert sr.library_path().parent == REPO / "build"
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD, str(tmp_path), str(i)], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    deadline = time.monotonic() + 120
    while not all((tmp_path / f"ready{i}").exists() for i in range(2)):
        assert time.monotonic() < deadline and all(p.poll() is None for p in procs)
        time.sleep(0.01)
    (tmp_path / "go").touch()
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert [f.name for f in (tmp_path / "build").iterdir()] == [sr.library_path().name]


_ISOLATED = """
import sys
from pathlib import Path
import numpy as np
import whisper_sae_tpu_torch.runtime as rt
import whisper_sae_tpu_torch.data, whisper_sae_tpu_torch.models
import whisper_sae_tpu_torch.ops, whisper_sae_tpu_torch.training
from whisper_sae_tpu_torch.runtime import shard_reader as sr
maps = lambda: open("/proc/self/maps").read()
assert sr._lib is None and "libwstio" not in maps()
reader = rt.ShardReader([Path(p) for p in sys.argv[1:]])
assert reader.native
reader.gather(np.arange(5))
loaded = {line.split()[-1] for line in maps().splitlines() if "libwstio" in line}
jax_runtime = "whisper_sae_tpu/runtime"
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "whisper_sae_tpu"))
print(sorted(loaded), bad)
sys.exit(0 if loaded == {str(sr.library_path())} and not bad
         and not any(jax_runtime in p for p in loaded) else 1)
"""


@needs_compiler
def test_port_loads_and_builds_nothing_of_the_jax_runtime(tmp_path):
    """In a process of its own: importing the port's packages loads no
    ``libwstio``; a reader loads the port's library from ``build/`` and no
    path of the JAX package's runtime, with no module of that package
    imported.  The port's sources never name the JAX package's library
    or its Makefile."""
    paths, _ = _write_shards(tmp_path, "float32")
    proc = subprocess.run([sys.executable, "-c", _ISOLATED, *map(str, paths)], env=_env(),
                          cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    src = (REPO / "src" / "whisper_sae_tpu_torch" / "runtime" / "shard_reader.py").read_text()
    assert '"make"' not in src and "libwstio.so" not in src
