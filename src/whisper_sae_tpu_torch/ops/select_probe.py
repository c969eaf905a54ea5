"""The wide routes' group-form select-and-decode in variants of its
constants, timed on the card.

Each variant is a copy of this package's ``csrc/`` with one or more
edits of ``select_decode.cuh`` (``VARIANTS``: a constant changed, a step
cut out to time what it costs, or ``cycles_<phase>``: clock64 stamps at
the phase boundaries and the phase's mean cycles a row, from thread 0 of
each group, read back through the loss), built apart
under ``build/select_probe/<variant>/`` (all variants' builds started
together), and timed in a process of its own.  In each,
kernel A's wide route (``cuda_sae._fused_loss_launch``) and the Skip
transcoder's (``cuda_coder._coder_launch``) at whisper-small 8x (D = dout
= 768, H = 6144, k = 32) on 4096 seeded gaussian rows: a call's ms between
CUDA events (20 launches after 3 warm ones) and each launch's device ms
under ``torch.profiler`` (``select_decode``: the group kernel's).  The
variants run in the order given, then again in reverse, in one process
tree on one card.  Prints the card's name and power limit, then one JSON
line.  Needs one H100; from the repository root:

    PYTHONPATH=src python -m whisper_sae_tpu_torch.ops.select_probe [VARIANT ...]
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

# variant: (text, replacement) edits of csrc/select_decode.cuh.  The
# constants' variants change a design choice; the "no_*" variants cut a
# step out (their outputs are wrong: they time what the step costs).
_SIG = "unsigned int* list, int* sc, int bar_id) {"
VARIANTS = {
    "as_built": (),
    "no_compaction": (("kGroupCand = 2 * kGroupThreads;", "kGroupCand = 0;"),),
    "dec_rows_4": (("kGroupDecRows = 8;", "kGroupDecRows = 4;"),),
    "dec_rows_16": (("kGroupDecRows = 8;", "kGroupDecRows = 16;"),),
    # one group a CTA, four or five CTAs an SM
    "rows_cta_1": (("kGroupRowsCta = 4;", "kGroupRowsCta = 1;"),),
    "rows_cta_1_sm_5": (("kGroupRowsCta = 4;", "kGroupRowsCta = 1;"),
                        ("kGroupRowsSm = 4;", "kGroupRowsSm = 5;")),
    # two groups a CTA, three CTAs an SM
    "rows_cta_2_sm_6": (("kGroupRowsCta = 4;", "kGroupRowsCta = 2;"),
                        ("kGroupRowsSm = 4;", "kGroupRowsSm = 6;")),
    # a group of eight warps a row, half the values a thread, three an SM
    "threads_256": (("kGroupThreads = 128;", "kGroupThreads = 256;"),
                    ("kGroupMaxPerThread = 64;", "kGroupMaxPerThread = 32;"),
                    ("kGroupRowsCta = 4;", "kGroupRowsCta = 3;"),
                    ("kGroupRowsSm = 4;", "kGroupRowsSm = 3;")),
    # the threshold fixed at 2.5 (about 38 of 6144 unit-gaussian values)
    "no_select": (("                                                 int bar_id) {\n",
                   "                                                 int bar_id) {\n"
                   "  if (k > 0) return 0x40200000;\n"),),
    "no_list": ((_SIG, _SIG + "\n  if (h > 0) return 0;"),),
    "no_decode": (("  const int npairs = a.dout / 2;\n  int pc[NP];",
                   "  if (nsel >= 0) return;\n  const int npairs = a.dout / 2;\n  int pc[NP];"),),
    "no_target_loads": (("      base[i][j] = SKIP ? rrow[c] : a.b_out[c];", "      base[i][j] = 0.0f;"),
                        ("      yv[i][j] = Y_IS_X ? row_val(a.x, a.x_bf16, src * a.d + c)\n"
                         "                        : row_val(a.y, a.y_bf16, src * a.dout + c);",
                         "      yv[i][j] = 0.0f;")),
    "no_latent_store": (("    if (in)\n      *reinterpret_cast<uint2*>(hidden_row + c) =",
                         "    if (false)\n      *reinterpret_cast<uint2*>(hidden_row + c) ="),),
    "no_active": (("atomicOr(&active[c + i], 1);", ";"),),
    # a quarter of each row's pre brought in (the rest of the buffer stale)
    "short_copy": (("const uint32_t bytes = static_cast<uint32_t>(a.h) * 4u;",
                    "const uint32_t bytes = static_cast<uint32_t>(a.h) * 1u;"),),
}
# the select's warp sums by ballots (its second phase) and shuffles (its
# first) in place of the warp reduction
_BALLOT = ("    for (int i = 0; i < CT; ++i) c += cv[i] >= mid ? 1 : 0;\n"
           "    c = __reduce_add_sync(0xffffffffu, c);",
           "    for (int i = 0; i < CT; ++i) c += __popc(__ballot_sync(0xffffffffu, cv[i] >= mid));")
_SHFL = ("    for (int j = 0; j < N; ++j) c += xi[j] >= mid ? 1 : 0;\n"
         "    c = __reduce_add_sync(0xffffffffu, c);",
         "    for (int j = 0; j < N; ++j) c += xi[j] >= mid ? 1 : 0;\n"
         "    for (int off = kWarp / 2; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);")
VARIANTS["ballot_phase2"] = (_BALLOT,)
VARIANTS["no_redux"] = (_BALLOT, _SHFL)
# clock64 stamps at the group form's phase boundaries (thread 0 of a group)
_STAMPS = (
    ("    wst_hopper::mbar_wait(&full[grp], phase);",
     "    const long long c0 = clock64();\n    wst_hopper::mbar_wait(&full[grp], phase);\n"
     "    const long long c1 = clock64();"),
    ("    const int th = group_kth_largest(xi, a.k, sel[grp], bar_id);",
     "    const long long c2 = clock64();\n"
     "    const int th = group_kth_largest(xi, a.k, sel[grp], bar_id);\n"
     "    const long long c3 = clock64();"),
    ("    const size_t src = (size_t)(a.row_offset + (long long)g);",
     "    const long long c4 = clock64();\n    const size_t src = (size_t)(a.row_offset + (long long)g);"),
    ("    if (lane == 0) warp_sq[grp][warp] = sq;",
     "    const long long c5 = clock64();\n    if (lane == 0) warp_sq[grp][warp] = sq;"),
)
# phase: the stamps it lies between (c6: the row's partial written)
PHASES = {"wait": ("c1", "c0"), "load": ("c2", "c1"), "select": ("c3", "c2"),
          "list": ("c4", "c3"), "decode": ("c5", "c4"), "tail": ("c6", "c5"), "row": ("c6", "c0")}
for _phase, (_b, _a) in PHASES.items():
    # the phase's cycles a row in place of the row's loss partial: the
    # finalize's mean then reads cycles a row (times d for kernel A)
    VARIANTS[f"cycles_{_phase}"] = _STAMPS + (
        ("      a.sq_partial[g] = total;",
         f"      const long long c6 = clock64();\n      a.sq_partial[g] = total * 0.0f + "
         f"static_cast<float>({_b} - {_a});"),)
VARIANTS["cycles_select_no_redux"] = VARIANTS["cycles_select"] + (_BALLOT, _SHFL)
D, H, K, ROWS = 768, 6144, 32, 4096


def _variant_csrc(name: str, root: Path) -> Path:
    """A copy of csrc/ with the variant's constants replaced."""
    from . import _build

    out = root / name / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build._CSRC, out)
    path = out / "select_decode.cuh"
    text = path.read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"select_probe: variant {name}: {old!r} not in select_decode.cuh")
        text = text.replace(old, new, 1)
    path.write_text(text)
    return out


def _use(name: str, root: Path) -> None:
    """Point this process's build at the variant's sources and directory."""
    from . import _build

    _build._CSRC = root / name / "csrc"
    _build.BUILD_DIR = root / name


def _one(name: str, root: Path) -> dict:
    """Time both routes with the variant's kernels (in this process)."""
    import torch

    from . import _build, _probe, cuda_coder, cuda_sae

    _use(name, root)
    _build.load_library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x, y = randn(ROWS, D), randn(ROWS, D)
    w_enc, b_enc, w_dec = randn(D, H, scale=D ** -0.5), randn(H, scale=0.05), randn(H, D, scale=0.05)
    b_pre, b_dec, w_skip = randn(D, scale=0.05), randn(D, scale=0.05), randn(D, D, scale=0.02)
    we_t, wd = cuda_sae._bf16_t(w_enc), w_dec.bfloat16()
    ops = cuda_coder.operands(w_enc, b_enc, w_dec, b_dec, w_skip, topk=True)
    calls = {
        "kernel_a": lambda: cuda_sae._fused_loss_launch(x, 0, ROWS, we_t, b_enc, b_pre, wd,
                                                        b_dec + b_pre, K, True),
        "skip_transcoder": lambda: cuda_coder._coder_launch(x, y, 0, ROWS, ops, K, True),
    }
    res = {}
    for what, fn in calls.items():
        split = _probe.device_split(fn)
        res[what] = {"ms": _probe.time_ms(fn),
                     "select_decode": sum(v for k, v in split.items() if "select_decode" in k),
                     "split_ms": split}
        if name.startswith("cycles_"):  # the mean cycles a row of the phase
            out = fn()
            res[what]["cycles_a_row"] = (float(out[0]) * D if what == "kernel_a"
                                         else float(out.sq) / ROWS)
    return res


def main() -> None:
    from . import _build, _probe

    if len(sys.argv) > 2 and sys.argv[1] == "--build":
        _use(sys.argv[2], Path(sys.argv[3]))
        _build.build()
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(_one(sys.argv[2], Path(sys.argv[3]))), flush=True)
        return
    names = sys.argv[1:] or list(VARIANTS)
    card = _probe.card()
    print(card, flush=True)
    root = _build.BUILD_DIR / "select_probe"
    for name in names:
        _variant_csrc(name, root)
    builds = [subprocess.Popen([sys.executable, "-m", __spec__.name, "--build", name, str(root)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for name in names]  # all variants' nvcc runs together
    for name, b in zip(names, builds):
        log = b.communicate()[0]
        if b.returncode:
            raise SystemExit(f"select_probe: variant {name} did not build:\n{log}")
    res: dict = {"card": card, "rows": ROWS, "geometry": {"d": D, "h": H, "k": K}}
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            out = subprocess.run([sys.executable, "-m", __spec__.name, "--one", name, str(root)],
                                 capture_output=True, text=True)
            if out.returncode:
                raise SystemExit(f"select_probe: variant {name} failed:\n{out.stdout}{out.stderr}")
            got = json.loads(out.stdout.strip().splitlines()[-1])
            res.setdefault(name, []).append(got)
            print(name, turn, {w: (round(v["ms"], 4), round(v["select_decode"], 4),
                                   *((round(v["cycles_a_row"]),) if "cycles_a_row" in v else ()))
                               for w, v in got.items()}, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
