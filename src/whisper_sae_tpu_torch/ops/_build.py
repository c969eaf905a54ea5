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
            "coder_kernels.cu", "blocked_encode.cu", "sae_backward.cu")
_HEADERS = ("topk_common.cuh", "hopper_common.cuh", "encoder_gemm.cuh", "select_decode.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
# The kernels' compile-time limits, kept here as Python constants because
# the CPU cannot load the library to ask it (tests/test_torch_port_cuda.py
# pins them to wst_max_d(), wst_max_row_width(), wst_max_wide_row_width(),
# wst_max_group_row_width(), wst_max_blocked_row_width(),
# wst_max_mask_row_width(), wst_rows_per_cta(), wst_select_form(),
# wst_cluster_ctas() and wst_sae_topk_encode_chunk_rows()).
MAX_D = 384  # kernel A's warp form decodes D in one pass, D/32 f32 sums a lane
SEL_ROWS = 4  # rows (one a warp) a CTA of the select-and-decode kernels: one sq partial each
MAX_ROW = 3072  # one warp holds a row in registers: kernels A, B, C and the coder kernel
MAX_WIDE_ROW = 40960  # one CTA holds a row in registers: kernel A's and the coder's wide routes
MAX_GROUP_ROW = 8192  # a warp group holds a row in registers: the group forms
# the top-k encode's widest row, kernel B's and the blocked encode's: the
# TPU's blocked encode's, ``pallas_sae.py:_MAX_H``
MAX_BLOCKED_ROW = 1 << 20
MAX_MASK_ROW = 262144  # kernel C's: ``pallas_topk.py:supported`` (8 rows of f32 + int32 in 16 MiB)
# the cluster select (past MAX_WIDE_ROW): values a CTA holds on chip, and
# its compaction's candidates at most (``csrc/topk_common.cuh``)
CLUSTER_SLICE = 40960
CLUSTER_CAND = 8192
PRE_BUDGET = 2048 * MAX_WIDE_ROW * 4  # bytes of a chunk's f32 pre at most (335 MB)
GEMM_TILE_ROWS = 128


def topk_encode_chunk_rows(h: int) -> int:
    """Rows of a chunk of the top-k encode (kernel B and the blocked
    encode: one C entry) at width ``h``: those whose f32 pre
    fits ``PRE_BUDGET``, rounded down to a multiple of 128 (the GEMM's
    tile rows) where that leaves a tile or more (H <= 655,360), else as
    they are (80 at H = 2^20), and at least one."""
    rows = PRE_BUDGET // (4 * h)
    if rows >= GEMM_TILE_ROWS:
        return rows // GEMM_TILE_ROWS * GEMM_TILE_ROWS
    return max(rows, 1)


# The forms of the select by row width, in the order of their index in the
# library's counts (``wst_encode_select_launches(form)``, ``wst_select_form(h)``)
SELECT_FORMS = ("warp", "group", "cta", "cluster")


def select_form(h: int) -> str:
    """The select the top-k encode launches at row width ``h``
    (``csrc/blocked_encode.cu:select_form``): ``"warp"`` (kernel C's warp
    select, a warp a row) up to ``MAX_ROW``, ``"group"`` (a warp group a
    row, persistent CTAs) up to ``MAX_GROUP_ROW``, ``"cta"`` (a CTA a
    row, the row in registers) up to ``MAX_WIDE_ROW``, else ``"cluster"``
    (a thread-block cluster of :func:`cluster_ctas` CTAs a row)."""
    if h <= MAX_ROW:
        return "warp"
    return wide_form(h)


def wide_form(h: int) -> str:
    """:func:`select_form` past the warp select: the select-and-decode the
    wide routes (kernel A's and the coder's TopK modes') launch at row
    width ``h`` -- ``"group"`` (``*_select_decode_group_kernel``) up to
    ``MAX_GROUP_ROW``, else ``"cta"`` (``*_select_decode_wide_kernel``) --
    and the select-only forms of the top-k encode past 3072, ``"cluster"``
    past ``MAX_WIDE_ROW``, where no wide route runs."""
    return "group" if h <= MAX_GROUP_ROW else "cta" if h <= MAX_WIDE_ROW else "cluster"


def cluster_ctas(h: int) -> int:
    """The cluster select's CTAs for a row of ``h`` values
    (``csrc/topk_common.cuh:cluster_ctas``): the fewest of 2, 4 and 8 whose
    slices of ``CLUSTER_SLICE`` values hold the row, else 8 (past 327,680
    values each slice's rest is read again each pass)."""
    return 2 if h <= 2 * CLUSTER_SLICE else 4 if h <= 4 * CLUSTER_SLICE else 8


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
    "wst_sae_fused_loss_wide_fwd": (
        [_P, _I, ctypes.c_longlong, _I, _I, _I, _I,   # x, x_bf16, off, rows, d, h, k
         _P, _P, _P, _P, _P,                         # w_enc_t, b_enc, b_pre, w_dec, b_out
         _P, _P, _P, _P, _P, _P, _P, _P, _P],        # hid, resid, xc, pre, partial, counts, loss, l0, stream
        _I,
    ),
    "wst_sae_topk_encode_chunk_rows": ([_I], _I),  # h
    "wst_sae_topk_encode_workspace_bytes": ([_I, _I, _I], _L),  # rows, d, h
    "wst_sae_topk_encode_fwd": (
        [_P, _I, _I, _I, _I, _I,          # x, x_bf16, rows, d, h, k
         _P, _P, _P, _P, _I, _P, _P],     # w_enc_t, b_enc, b_pre, out, out_f32, ws, stream
        _I,
    ),
    "wst_topk_mask_fwd": ([_P, _P, _I, _I, _I, _P], _I),
    "wst_max_wide_row_width": ([], _I),
    "wst_max_group_row_width": ([], _I),
    "wst_sae_select_launches": ([_I], _L),  # form: 0 group, 1 CTA a row
    "wst_coder_select_launches": ([_I], _L),
    "wst_topk_mask_wide_fwd": ([_P, _P, _I, _I, _I, _P], _I),
    "wst_max_blocked_row_width": ([], _I),
    "wst_max_mask_row_width": ([], _I),
    "wst_select_form": ([_I], _I),  # h
    "wst_cluster_ctas": ([_I], _I),  # h
    "wst_cluster_select_max_active": ([_I], _I),  # h
    "wst_encode_select_launches": ([_I], _L),  # form: SELECT_FORMS' index
    # form, pre, rows, h, k, out, out_f32, row0, stream
    "wst_encode_select_fwd": ([_I, _P, _I, _I, _I, _P, _I, _L, _P], _I),
    "wst_enc_head_dim": ([], _I),
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
    "wst_conv_stem_fwd": (
        [_P, _I, _I, _I, _I, _P, _P, _P, _P,       # mel, b, t_mel, n_mels, d, w1t, b1, w2t, b2
         _P, _P, _P, _P, _P],                      # pos, mel_pad, h_pad, out, stream
        _I,
    ),
    "wst_coder_fwd": (
        [_P, _I, _P, _I, _L, _I, _I, _I, _I, _I,   # x, x_bf16, y, y_bf16, off, rows, d, h, dout, k
         _I, _I, _P, _P, _P, _P, _P,               # use_skip, y_is_x, w_enc_t, b_enc, w_dec, b_out, w_skip_t
         _P, _P, _P, _P, _P, _P, _P, _P, _P, _P],  # hid, resid, xc, pre, sq/hsum partials, counts, sums, hsum, stream
        _I,
    ),
    "wst_coder_wide_fwd": (
        [_P, _I, _P, _I, _L, _I, _I, _I, _I, _I,   # x, x_bf16, y, y_bf16, off, rows, d, h, dout, k
         _I, _I, _P, _P, _P, _P, _P,               # use_skip, y_is_x, w_enc_t, b_enc, w_dec, b_out, w_skip_t
         _P, _P, _P, _P, _P, _P, _P, _P],          # hid, resid, xc, pre, sq partials, counts, sums, stream
        _I,
    ),
    "wst_coder_gemm_fwd": (
        [_I, _P, _P, _L, _I, _I, _P,               # epi, a, b, m, n, k, bias
         _P, _P, _P, _P, _I, _L, _P],              # out, partial, l0, x, x_bf16, row_offset, stream
        _I,
    ),
    "wst_gemm_tile": ([], _I),
    "wst_sae_topk_bwd_max_d": ([], _I),
    "wst_sae_topk_bwd_workspace_bytes": ([_I, _I, _I], _L),  # rows, d, h
    "wst_sae_topk_bwd": (
        [_I, _P, _P, _P, _P, _I, _I, _I,            # composed, hid, d_recon, xc, w_dec, rows, d, h
         _P, _P, _P, _P, _P],                       # dw_enc, db_enc, dw_dec, ws, stream
        _I,
    ),
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
