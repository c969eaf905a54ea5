"""Build and load the port's CUDA kernels.

The sources under ``ops/csrc/`` are compiled by ``nvcc`` for ``sm_90a``,
one ``nvcc`` per source, all started together, and linked into a shared
library with a plain C interface, named by a hash of the
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
_SOURCES = ("sae_kernels.cu", "encoder_kernels.cu", "attention_kernel.cu", "encoder_gemm.cu",
            "coder_kernels.cu", "blocked_encode.cu")
_HEADERS = ("topk_common.cuh", "hopper_common.cuh", "encoder_gemm.cuh", "select_decode.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# The kernels' compile-time limits, kept here as Python constants because
# the CPU cannot load the library to ask it (tests/test_torch_port_cuda.py
# pins them to wst_max_d(), wst_max_row_width(), wst_max_wide_row_width()
# and wst_rows_per_cta()).
MAX_D = 384  # kernel A's decode keeps D/32 f32 sums a lane
SEL_ROWS = 4  # rows (one a warp) a CTA of the select-and-decode kernels: one sq partial each
MAX_ROW = 3072  # one warp holds a row in registers: kernels A, B, C and the coder kernel
MAX_WIDE_ROW = 40960  # one CTA holds a row in registers: the blocked encode, wide kernel C
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "wst_max_row_width": ([], _I),
    "wst_max_d": ([], _I),
    "wst_rows_per_cta": ([], _I),
    "wst_sae_fused_loss_fwd": (
        [_P, _I, ctypes.c_longlong, _I, _I, _I, _I,   # x, x_bf16, off, rows, d, h, k
         _P, _P, _P, _P, _P,                         # w_enc_t, b_enc, b_pre, w_dec, b_out
         _P, _P, _P, _P, _P, _P, _P, _P, _P],        # hid, resid, xc, pre, partial, counts, loss, l0, stream
        _I,
    ),
    "wst_sae_topk_encode_fwd": (
        [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P], _I,
    ),
    "wst_topk_mask_fwd": ([_P, _P, _I, _I, _I, _P], _I),
    "wst_max_wide_row_width": ([], _I),
    "wst_topk_mask_wide_fwd": ([_P, _P, _I, _I, _I, _P], _I),
    "wst_blocked_chunk_rows": ([], _I),
    "wst_blocked_workspace_bytes": ([_I, _I, _I], _L),  # rows, d, h
    "wst_blocked_encode_fwd": (
        [_P, _I, _I, _I, _I, _I,          # x, x_bf16, rows, d, h, k
         _P, _P, _P, _P, _I, _P, _P],     # w_enc_t, b_enc, b_pre, out, out_f32, ws, stream
        _I,
    ),
    "wst_enc_head_dim": ([], _I),
    "wst_enc_narrow_max": ([], _I),
    "wst_enc_wide_max": ([], _I),
    "wst_ln_rows_fwd": ([_P, _L, _I, _P, _P, _P, _P], _I),  # x, n, d, g, b, out, stream
    "wst_enc_gemm_fwd": (
        [_I, _P, _P, _L, _I, _I,                    # epi, a, b, m, n, k
         _P, ctypes.c_float, _I, _P, _P, _P,        # bias, q_scale, d, out0, out1, out2
         _P, _P],                                   # res, stream
        _I,
    ),
    "wst_attention_fwd": ([_P, _P, _P, _I, _I, _I, _I, _I, _P, _P], _I),
    "wst_mlp_block_fwd": (
        [_P, _L, _I, _I, _P, _P, _P, _P, _P, _P,    # x, n, d, f, g, b, w1t, b1, w2t, b2
         _P, _P, _I, _P, _P, _P, _P, _P, _P],       # fg, fb, cap_mode, out, cap, xln, hid, mlp_out, stream
        _I,
    ),
    "wst_conv_stem_fwd": ([_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P], _I),
    "wst_coder_fwd": (
        [_P, _I, _P, _I, _L, _I, _I, _I, _I, _I,   # x, x_bf16, y, y_bf16, off, rows, d, h, dout, k
         _I, _I, _P, _P, _P, _P, _P,               # use_skip, y_is_x, w_enc_t, b_enc, w_dec, b_out, w_skip_t
         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],  # hid, resid, xc, pre, sq/hsum partials, counts, sums, hsum, stream
        _I,
    ),
    "wst_coder_gemm_fwd": (
        [_I, _P, _P, _L, _I, _I, _P,               # epi, a, b, m, n, k, bias
         _P, _P, _P, _P, _I, _L, _P],              # out, partial, l0, x, x_bf16, row_offset, stream
        _I,
    ),
    "wst_gemm_tile": ([], _I),
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
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in _SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, f"-I{_CSRC}", "-c", "-o", str(obj), str(_CSRC / src)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(_SOURCES, objs)
    ]
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{tag}.tmp.so")
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    last_build_log = "".join(logs)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{last_build_log}")
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
