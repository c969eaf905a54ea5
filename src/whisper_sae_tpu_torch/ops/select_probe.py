"""The wide routes' group-form select-and-decode, and the top-k encode's
cluster select, in variants of their constants, timed on the card.

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
tree on one card.

The ``cluster*`` variants (``CLUSTER_VARIANTS``: edits of
``topk_common.cuh`` and ``blocked_encode.cu``) time the cluster select
(``csrc/blocked_encode.cu:cluster_select_kernel``) instead: kernel C
(``cuda_topk.topk_mask_fwd``, f32) at phase 23's shapes, [4096, 49152],
[1024, 81920] and [64, 262144], and the select alone with a bf16 latent
(``wst_encode_select_fwd``) on a chunk of kernel B at whisper-tiny 128x
(1664 x 49152) and of the blocked encode at whisper-large 64x (1024 x
81920), seeded gaussian rows, k = 32, 10 launches after 2 warm ones;
``cluster_cycles`` also reads each phase's mean clock64 cycles a CTA at
[4096, 49152] (``CLUSTER_PHASES``), the as-built ``cluster`` holds kernel
C's mask equal to its plain version at each shape, and each build prints
the cluster kernels' registers and spills (``-Xptxas -v``).  Prints the card's name and power
limit, then one JSON line.  Needs one H100; from the repository root:

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

# variant: (file, text, replacement) edits of csrc/ for the cluster select;
# "cluster_no_select" fixes the threshold (its output is wrong: it times
# the loads and stores alone)
CLUSTER_VARIANTS = {
    "cluster": (),
    "cluster_no_compaction": (("topk_common.cuh", "c_lo - c_hi <= kClusterCand) break;",
                               "c_lo - c_hi <= 0) break;"),),
    # one CTA an SM: shared memory past half an SM's
    "cluster_one_cta_sm": (("blocked_encode.cu",
                            "cfg.dynamicSmemBytes = (size_t)*smem_ints * sizeof(int);",
                            "cfg.dynamicSmemBytes = 120 * 1024;"),),
    "cluster_no_select": (("blocked_encode.cu",
                           "const int th = cluster_kth_largest(",
                           "const int th = k > 0 ? 0x40200000 : cluster_kth_largest("),),
    # every pass counts, also those above the row's largest value
    "cluster_no_skip": (("topk_common.cuh", "    if (mid <= top) {", "    if (mid <= top || k > 0) {"),
                        ("topk_common.cuh", "      if (mid > top) {", "      if (mid > top && k < 0) {")),
    # the passes' exchange on the hardware cluster barrier, not the mbarriers
    "cluster_hw_barrier": (("topk_common.cuh",
                            "  if (lane < nc) wst_hopper::mbar_arrive_release_cluster("
                            "wst_hopper::cluster_map(&sc.bar[x & 1], lane));\n"
                            "  wst_hopper::mbar_wait_acquire_cluster(&sc.bar[x & 1], (x >> 1) & 1);",
                            "  if (lane < nc && x >= 0) {}\n  wst_hopper::cluster_arrive();\n"
                            "  wst_hopper::cluster_wait();"),),
    # 48 values a thread in registers, 16,384 a CTA on chip: 4 CTAs a row
    # at 49152 and 8 at 81920, three CTAs an SM
    "cluster_3_ctas_sm": (("topk_common.cuh", "constexpr int kClusterPerThread = 84;",
                           "constexpr int kClusterPerThread = 48;"),
                          ("topk_common.cuh", "constexpr int kClusterSlice = 40960;",
                           "constexpr int kClusterSlice = 16384;"),
                          ("blocked_encode.cu", "__launch_bounds__(kClusterThreads, 2)",
                           "__launch_bounds__(kClusterThreads, 3)")),
}
# the passes over the whole row count into a float (a predicated FADD on
# the FP32 pipe beside each integer compare), exact below 2^24
CLUSTER_VARIANTS["cluster_fadd_count"] = (
    ("topk_common.cuh",
     "  int c = 0;\n#pragma unroll\n"
     "  for (int j = 0; j < kClusterPerThread; ++j) c += xi[j] >= mid ? 1 : 0;\n  return c;",
     "  float c = 0.0f;\n#pragma unroll\n"
     "  for (int j = 0; j < kClusterPerThread; ++j)\n    if (xi[j] >= mid) c += 1.0f;\n"
     "  return (int)c;"),)
# 96, 88 or 80 values a thread in registers, not 84 (the rest of 40960 a CTA
# in shared memory)
for _n in (96, 88, 80):
    CLUSTER_VARIANTS[f"cluster_regs_{_n}"] = (
        ("topk_common.cuh", "constexpr int kClusterPerThread = 84;",
         f"constexpr int kClusterPerThread = {_n};"),)
# clock64 stamps of thread 0 of each CTA: the loads (to the cluster
# barrier's wait), the select's passes over the whole row, its compaction
# and its passes on the list (CTAs that compacted), the stores, the exit
# barrier; summed over the CTAs in g_cluster_cycles, with the CTAs and
# the compacting CTAs
CLUSTER_PHASES = ("load", "full_passes", "compaction", "list_passes", "select", "store", "exit",
                  "ctas", "compacted")
CLUSTER_VARIANTS["cluster_cycles"] = (
    ("topk_common.cuh", "  int th;           // the threshold the list's passes found",
     "  int th;           // the threshold the list's passes found\n  long long stamp[2];"),
    ("topk_common.cuh", "  if (pass == 32) return lo;",
     "  if (pass == 32) return lo;\n  if (t == 0) sc.stamp[0] = clock64();"),
    ("topk_common.cuh", "  __syncthreads();  // the list is in this CTA's shared memory, in whole chunks",
     "  __syncthreads();  // the list is in this CTA's shared memory, in whole chunks\n"
     "  if (t == 0) sc.stamp[1] = clock64();"),
    ("blocked_encode.cu", "template <typename OutT>\n__global__ void __launch_bounds__(kClusterThreads, 2)",
     "__device__ unsigned long long g_cluster_cycles[9];\n"
     "template <typename OutT>\n__global__ void __launch_bounds__(kClusterThreads, 2)"),
    ("blocked_encode.cu", "  const int t = threadIdx.x;\n  const int row = (int)wst_hopper::cluster_id_x();",
     "  const int t = threadIdx.x;\n  const long long c0 = clock64();\n"
     "  const int row = (int)wst_hopper::cluster_id_x();"),
    ("blocked_encode.cu", "    wst_hopper::mbar_init(&sc.bar[1], arrivals);\n",
     "    wst_hopper::mbar_init(&sc.bar[1], arrivals);\n    sc.stamp[0] = 0;\n"),
    ("blocked_encode.cu", "  wst_hopper::cluster_wait();  // every CTA's mbarriers are initialised",
     "  wst_hopper::cluster_wait();  // every CTA's mbarriers are initialised\n"
     "  const long long c1 = clock64();"),
    ("blocked_encode.cu", "  wst_hopper::cluster_arrive();\n  if (vec) {\n    store_slice",
     "  const long long c2 = clock64();\n  wst_hopper::cluster_arrive();\n  if (vec) {\n"
     "    store_slice"),
    ("blocked_encode.cu", "    store_latent(o + c, masked_relu(monotone_int(src[c]), th));\n"
     "  wst_hopper::cluster_wait();\n}",
     "    store_latent(o + c, masked_relu(monotone_int(src[c]), th));\n"
     "  const long long c3 = clock64();\n  wst_hopper::cluster_wait();\n"
     "  if (t == 0) {\n    unsigned long long* g = g_cluster_cycles;\n"
     "    atomicAdd(g + 0, (unsigned long long)(c1 - c0));\n"
     "    if (sc.stamp[0]) {\n"
     "      atomicAdd(g + 1, (unsigned long long)(sc.stamp[0] - c1));\n"
     "      atomicAdd(g + 2, (unsigned long long)(sc.stamp[1] - sc.stamp[0]));\n"
     "      atomicAdd(g + 3, (unsigned long long)(c2 - sc.stamp[1]));\n"
     "      atomicAdd(g + 8, 1ull);\n    }\n"
     "    atomicAdd(g + 4, (unsigned long long)(c2 - c1));\n"
     "    atomicAdd(g + 5, (unsigned long long)(c3 - c2));\n"
     "    atomicAdd(g + 6, (unsigned long long)(clock64() - c3));\n"
     "    atomicAdd(g + 7, 1ull);\n  }\n}"),
    ("blocked_encode.cu", "}  // extern \"C\"\n",
     "void wst_cluster_cycles(unsigned long long* out, int reset) {\n"
     "  cudaMemcpyFromSymbol(out, wst::blocked::g_cluster_cycles, sizeof(unsigned long long) * 9);\n"
     "  if (reset) {\n    unsigned long long z[9] = {0};\n"
     "    cudaMemcpyToSymbol(wst::blocked::g_cluster_cycles, z, sizeof(z));\n  }\n}\n"
     "}  // extern \"C\"\n"),
)
MASK_SHAPES = ((4096, 49152), (1024, 81920), (64, 262144))
SELECT_CHUNKS = ((1664, 49152), (1024, 81920))  # kernel B's at tiny 128x, the blocked encode's at large 64x


def _variant_csrc(name: str, root: Path) -> Path:
    """A copy of csrc/ with the variant's edits (``VARIANTS``: of
    select_decode.cuh; ``CLUSTER_VARIANTS``: of the file each names)."""
    from . import _build

    out = root / name / "csrc"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build._CSRC, out)
    edits = (CLUSTER_VARIANTS[name] if name in CLUSTER_VARIANTS
             else [("select_decode.cuh", *e) for e in VARIANTS[name]])
    for file, old, new in edits:
        path = out / file
        text = path.read_text()
        if old not in text:
            raise SystemExit(f"select_probe: variant {name}: {old!r} not in {file}")
        path.write_text(text.replace(old, new, 1))
    return out


def _use(name: str, root: Path) -> None:
    """Point this process's build at the variant's sources and directory."""
    from . import _build

    _build._CSRC = root / name / "csrc"
    _build.BUILD_DIR = root / name


def _one_cluster(name: str) -> dict:
    """Time the cluster select with the variant's kernels (in this process)."""
    import ctypes

    import torch

    from . import _build, _probe, cuda_topk

    lib = _build.load_library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for rows, h in MASK_SHAPES:
        pre = torch.randn(rows, h, generator=g, device=dev)
        res[f"mask_{rows}x{h}"] = _probe.time_ms(lambda: cuda_topk.topk_mask_fwd(pre, K), iters=10,
                                                 warmup=2)
        if name == "cluster":  # as built: exact against the plain version
            from .topk import topk_mask_plain

            res[f"exact_{rows}x{h}"] = torch.equal(cuda_topk.topk_mask_fwd(pre, K),
                                                   topk_mask_plain(pre, K))
        if name == "cluster_cycles" and h == 49152:
            fn = lib.wst_cluster_cycles
            fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], None
            buf = (ctypes.c_ulonglong * len(CLUSTER_PHASES))()
            fn(buf, 1)
            cuda_topk.topk_mask_fwd(pre, K)
            torch.cuda.synchronize()
            fn(buf, 1)
            ctas, compacted = buf[7], max(buf[8], 1)
            res["cycles_a_cta"] = {p: buf[i] / (compacted if p in CLUSTER_PHASES[1:4] else ctas)
                                   for i, p in enumerate(CLUSTER_PHASES[:7])}
            res["cycles_a_cta"].update(ctas=ctas, compacted=buf[8])
    for rows, h in SELECT_CHUNKS:
        pre = torch.randn(rows, h, generator=g, device=dev)
        out = torch.empty((rows, h), dtype=torch.bfloat16, device=dev)

        def call():
            err = lib.wst_encode_select_fwd(_build.SELECT_FORMS.index("cluster"), pre.data_ptr(),
                                            rows, h, K, out.data_ptr(), 0, 0, stream)
            if err:
                raise SystemExit(f"select_probe: the cluster select failed: CUDA error {err}")
        res[f"select_{rows}x{h}"] = _probe.time_ms(call, iters=10, warmup=2)
    return res


def _one(name: str, root: Path) -> dict:
    """Time both routes with the variant's kernels (in this process)."""
    import torch

    from . import _build, _probe, cuda_coder, cuda_sae

    _use(name, root)
    if name in CLUSTER_VARIANTS:
        return _one_cluster(name)
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
        if sys.argv[2] in CLUSTER_VARIANTS:  # the cluster kernels' registers and spills
            lines = _build.last_build_log.splitlines()
            for i, line in enumerate(lines):
                if "Compiling entry function" in line and "cluster_select_kernel" in line:
                    print(" ".join(x.strip() for x in lines[i + 1:i + 5] if "spill" in x
                                   or "registers" in x))
        return
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(_one(sys.argv[2], Path(sys.argv[3]))), flush=True)
        return
    names = sys.argv[1:] or list(VARIANTS) + list(CLUSTER_VARIANTS)
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
        if name in CLUSTER_VARIANTS:
            print(name, "built:", log.strip().replace("\n", "; "), flush=True)
    res: dict = {"card": card, "rows": ROWS, "geometry": {"d": D, "h": H, "k": K}}
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            out = subprocess.run([sys.executable, "-m", __spec__.name, "--one", name, str(root)],
                                 capture_output=True, text=True)
            if out.returncode:
                raise SystemExit(f"select_probe: variant {name} failed:\n{out.stdout}{out.stderr}")
            got = json.loads(out.stdout.strip().splitlines()[-1])
            res.setdefault(name, []).append(got)
            if name in CLUSTER_VARIANTS:
                print(name, turn, {w: v if isinstance(v, dict) else round(v, 4)
                                   for w, v in got.items()}, flush=True)
                continue
            print(name, turn, {w: (round(v["ms"], 4), round(v["select_decode"], 4),
                                   *((round(v["cycles_a_row"]),) if "cycles_a_row" in v else ()))
                               for w, v in got.items()}, flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
