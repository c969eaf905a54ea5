"""The encoder GEMM's main loop timed without its epilogue, on the card.

Builds ``csrc/encoder_gemm.cu`` a second time with
``-DWST_GEMM_MAINLOOP_ONLY`` (the products alone: no epilogue, nothing
stored) and times it beside the library's build (the same kernel with
its epilogue) and ``torch.matmul`` on the same operands: the q/k/v
product (N = 3D, K = D), the out-projection (N = D, K = D), the MLP
block's fc1 with its GELU epilogue (N = 4D, K = D) and fc2 with its
residual epilogue (N = D, K = 4D), also with the ``mlp_out`` capture, at
whisper-large-v3 (16 clips, 24,000 rows, D=1280) and whisper-tiny (64
clips, 96,000 rows, D=384).  Each is timed in one order and then in the
reverse order; both readings are printed.  The last line of the output
is one JSON object.  Needs one H100; from the repository root:

    PYTHONPATH=src python -m whisper_sae_tpu_torch.ops.gemm_probe

``--mlp-widths`` instead times ``cuda_encoder.mlp_block_fwd`` in the
extraction's mode (the final-LN capture in bf16) at every width the MLP
route takes, F = 4D, on 96,000 rows (64 clips) up to D = 512 and 24,000
(16 clips) above.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from . import _build, _probe, cuda_encoder
from ._probe import time_ms

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


def _calls(gemm, m: int, d: int) -> dict:
    """Each product through ``gemm`` (a ``wst_enc_gemm_fwd``): name ->
    (launch, the ``torch.matmul`` of the same operands, N, K), the first
    two functions of no arguments."""
    g = torch.Generator(device="cuda").manual_seed(d)

    def r(*shape):
        return torch.randn(*shape, generator=g, device="cuda").bfloat16()

    f = 4 * d
    a, res, hid = r(m, d), r(m, d), r(m, f)
    wqkv, wo, w1, w2 = r(3 * d, d) * 0.05, r(d, d) * 0.05, r(f, d) * 0.05, r(d, f) * 0.05
    b3, bd, bf = (torch.zeros(n, device="cuda") for n in (3 * d, d, f))
    q, k, v, out, y = (torch.empty_like(a) for _ in range(5))
    h = torch.empty_like(hid)
    st = torch.cuda.current_stream().cuda_stream

    def launch(*args):
        err = gemm(*args)
        if err:
            raise RuntimeError(f"wst_enc_gemm_fwd: CUDA error {err}")

    return {
        "qkv": (lambda: launch(0, a.data_ptr(), wqkv.data_ptr(), m, 3 * d, d, b3.data_ptr(),
                               0.125, d, q.data_ptr(), k.data_ptr(), v.data_ptr(), None, st),
                lambda: torch.matmul(a, wqkv.t()), 3 * d, d),
        "out_proj": (lambda: launch(1, a.data_ptr(), wo.data_ptr(), m, d, d, bd.data_ptr(), 1.0,
                                    d, out.data_ptr(), None, None, res.data_ptr(), st),
                     lambda: torch.matmul(a, wo.t()), d, d),
        "fc1": (lambda: launch(2, a.data_ptr(), w1.data_ptr(), m, f, d, bf.data_ptr(), 1.0, d,
                               h.data_ptr(), None, None, None, st),
                lambda: torch.matmul(a, w1.t()), f, d),
        "fc2": (lambda: launch(1, hid.data_ptr(), w2.data_ptr(), m, d, f, bd.data_ptr(), 1.0, d,
                               out.data_ptr(), None, None, res.data_ptr(), st),
                lambda: torch.matmul(hid, w2.t()), d, f),
        "fc2_capture": (lambda: launch(1, hid.data_ptr(), w2.data_ptr(), m, d, f, bd.data_ptr(),
                                       1.0, d, out.data_ptr(), y.data_ptr(), None,
                                       res.data_ptr(), st),
                        lambda: torch.matmul(hid, w2.t()), d, f),
    }


MLP_WIDTHS = (128, 256, 384, 512, 768, 1024, 1280, 1536)


def mlp_widths() -> dict:
    """ms of ``mlp_block_fwd`` at each width (two readings), weights
    prepared by a first call."""
    res = {}
    for d in MLP_WIDTHS:
        g = torch.Generator(device="cuda").manual_seed(d)

        def r(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

        n, f = (64 if d <= 512 else 16) * 1500, 4 * d
        x = r(n, d)
        p = {"w1": r(d, f, scale=d ** -0.5), "b1": r(f, scale=0.1),
             "w2": r(f, d, scale=f ** -0.5), "b2": r(d, scale=0.1)}
        ln_g, ln_b = 1 + r(d, scale=0.1), r(d, scale=0.1)
        fl = (1 + r(d, scale=0.1).float(), r(d, scale=0.1).float())
        fn = lambda: cuda_encoder.mlp_block_fwd(x, ln_g, ln_b, p, False, fl)  # noqa: E731
        res[d] = {"rows": n, "ms": [time_ms(fn), time_ms(fn)]}
        print(f"mlp_block_fwd D={d} F={f} rows={n}: {res[d]['ms']}")
        del x, p
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--mlp-widths", action="store_true",
                        help="time mlp_block_fwd at every width instead of the GEMM's products")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gemm_probe needs a CUDA card")
        return 1
    print(_probe.card())
    if args.mlp_widths:
        print(json.dumps(mlp_widths()))
        return 0
    gemms = {"kernel": _build.load_library().wst_enc_gemm_fwd, "mainloop_only": _mainloop_only()}
    res = {}
    for model, (m, d) in SHAPES.items():
        calls = {name: _calls(fn, m, d) for name, fn in gemms.items()}
        for prod, (kernel, matmul, n, k) in calls["kernel"].items():
            fns = {"kernel_ms": kernel, "mainloop_only_ms": calls["mainloop_only"][prod][0],
                   "matmul_ms": matmul}
            readings = {key: [] for key in fns}
            for order in (list(fns), list(fns)[::-1]):
                for key in order:
                    readings[key].append(time_ms(fns[key]))
            row = {"rows": m, "k": k, "n": n, "bound_ms": 2 * m * k * n / PEAK_BF16 * 1e3,
                   **readings}
            res[f"{model}.{prod}"] = row
            print(f"{model} {prod}: " + ", ".join(f"{k_} {v}" for k_, v in row.items()))
        del calls
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
