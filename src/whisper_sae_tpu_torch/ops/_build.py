"""Build and load the port's CUDA kernels.

The sources under ``ops/csrc/`` are compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, named by a hash of the
sources and flags, under ``build/`` at the repository root, and loaded
with ``ctypes``.  The build happens at the first kernel launch (or an
explicit :func:`load_library` call); a changed source gets a new hash
and so a new build.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("sae_kernels.cu",)
_HEADERS = ("topk_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "wst_max_row_width": ([], _I),
    "wst_max_d": ([], _I),
    "wst_rows_per_cta": ([], _I),
    "wst_sae_fused_loss_fwd": (
        [_P, _I, ctypes.c_longlong, _I, _I, _I, _I,   # x, x_bf16, off, rows, d, h, k
         _P, _P, _P, _P, _P,                         # w_enc_t, b_enc, b_pre, w_dec, b_out
         _P, _P, _P, _P, _P, _P, _P, _P],            # hid, resid, xc, partial, counts, loss, l0, stream
        _I,
    ),
    "wst_sae_topk_encode_fwd": (
        [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P], _I,
    ),
    "wst_topk_mask_fwd": ([_P, _P, _I, _I, _I, _P], _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build_log: str = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built with nvcc for sm_90a "
            "(set CUDA_HOME or put nvcc on PATH)"
        )
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libwst_kernels_{source_hash()}.so"


def build(force: bool = False) -> Path:
    """Compile the kernels if the library for the current sources is
    missing.  Returns its path; the compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept in ``last_build_log``."""
    global last_build_log
    out = library_path()
    if out.exists() and not force:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{_CSRC}", "-o", str(tmp),
           *[str(_CSRC / s) for s in _SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{last_build_log}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
