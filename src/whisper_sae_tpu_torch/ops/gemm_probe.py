"""The encoder GEMM's main loop timed without its epilogue, on the card.

Builds ``csrc/encoder_gemm.cu`` a second time with
``-DWST_GEMM_MAINLOOP_ONLY`` (the products alone: no epilogue, nothing
stored) and times it beside the library's build (the same kernel with its
epilogue) and ``torch.matmul`` on the same operands: the q/k/v product
(N = 3D) and the out-projection (N = D) at whisper-large-v3 (16 clips,
24,000 rows, D=1280) and whisper-tiny (64 clips, 96,000 rows, D=384).
Each is timed in the order kernel, main loop, matmul and then in the
reverse order; both readings are printed.  The last line of the output is
one JSON object.  Needs one H100; from the repository root:

    PYTHONPATH=src python -m whisper_sae_tpu_torch.ops.gemm_probe
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from . import _build

SHAPES = {"whisper_large_v3": (16 * 1500, 1280), "whisper_tiny": (64 * 1500, 384)}
PEAK_BF16 = 989e12  # dense bf16 operations a second, H100 SXM


def _mainloop_only():
    """``wst_enc_gemm_fwd`` of the main-loop-only build, built once."""
    out = _build.BUILD_DIR / f"libwst_gemm_mainloop_{_build.source_hash()}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DWST_GEMM_MAINLOOP_ONLY",
                        f"-I{_build._CSRC}", "-shared", "-o", str(out),
                        str(_build._CSRC / "encoder_gemm.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).wst_enc_gemm_fwd
    fn.argtypes, fn.restype = _build._SIGNATURES["wst_enc_gemm_fwd"]
    return fn


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _calls(gemm, m: int, d: int) -> dict:
    """The q/k/v product and the out-projection through ``gemm`` (a
    ``wst_enc_gemm_fwd``), each a function of no arguments."""
    g = torch.Generator(device="cuda").manual_seed(d)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    a, res, wqkv, wo = r(m, d), r(m, d), r(3 * d, d) * 0.05, r(d, d) * 0.05
    bqkv, bo = torch.zeros(3 * d, device="cuda"), torch.zeros(d, device="cuda")
    q, k, v, out = (torch.empty_like(a) for _ in range(4))
    st = torch.cuda.current_stream().cuda_stream

    def launch(*args):
        err = gemm(*args)
        if err:
            raise RuntimeError(f"wst_enc_gemm_fwd: CUDA error {err}")

    return {
        "qkv": (lambda: launch(0, a.data_ptr(), wqkv.data_ptr(), m, 3 * d, d, bqkv.data_ptr(),
                               0.125, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), None, st),
                lambda: torch.matmul(a, wqkv.t()), 3 * d),
        "out_proj": (lambda: launch(1, a.data_ptr(), wo.data_ptr(), m, d, d, bo.data_ptr(), 1.0,
                                    d, out.data_ptr(), None, None, res.data_ptr(), st),
                     lambda: torch.matmul(a, wo.t()), d),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_probe needs a CUDA card")
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "nvidia-smi: no card listed")
    full, mainloop = _build.load_library().wst_enc_gemm_fwd, _mainloop_only()
    res = {}
    for model, (m, d) in SHAPES.items():
        kernel_calls, mainloop_calls = _calls(full, m, d), _calls(mainloop, m, d)
        for prod, (kernel, matmul, n) in kernel_calls.items():
            fns = {"kernel_ms": kernel, "mainloop_only_ms": mainloop_calls[prod][0],
                   "matmul_ms": matmul}
            readings = {key: [] for key in fns}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    readings[key].append(_time_ms(fns[key]))
            row = {"rows": m, "k": d, "n": n,
                   "bound_ms": 2 * m * d * n / PEAK_BF16 * 1e3, **readings}
            res[f"{model}.{prod}"] = row
            print(f"{model} {prod}: " + ", ".join(f"{k} {v}" for k, v in row.items()))
        del kernel_calls, mainloop_calls
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
