"""The SASS of the port's kernels against another tree's, kernel by kernel.

Compiles each source of this package's ``csrc/`` and of another tree's
(``CSRC``: e.g. a parent commit unpacked with ``git archive``) with the
flags of the library's build (``_build.NVCC_FLAGS``, one ``nvcc -c`` per
source, started together), disassembles each object with ``cuobjdump
-sass`` and compares each kernel's instructions, with the addresses and
encodings dropped, between the two builds.  A kernel is named by its
demangled name without the argument list; ``--alias NEW=OLD`` compares a
kernel renamed between the trees (a kernel made a template, say).  Prints
one line a kernel (``same``, ``differs`` with the instruction counts, or
the build it is missing from), then one JSON object.  Needs nvcc and
cuobjdump (the CUDA toolkit), not a card; from the repository root:

    PYTHONPATH=src python -m whisper_sae_tpu_torch.ops.sass_probe CSRC \\
        [--alias 'wst::topk_mask_kernel<float>=wst::topk_mask_kernel']
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from . import _build

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")


def _tool(name: str) -> str:
    found = shutil.which(name) or str(Path(_build._nvcc()).parent / name)
    if not Path(found).exists():
        raise SystemExit(f"sass_probe: {name} not found")
    return found


def _objects(csrc: Path, out: Path) -> list[Path]:
    """Each ``.cu`` of ``csrc`` compiled to an object under ``out``."""
    out.mkdir(parents=True, exist_ok=True)
    srcs = sorted(csrc.glob("*.cu"))
    objs = [out / f"{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, f"-I{csrc}", "-c", "-o",
                               str(obj), str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for src, obj in zip(srcs, objs)]
    for src, p in zip(srcs, procs):
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"sass_probe: nvcc failed on {src}:\n{log}")
    return objs


def _label(demangled: str) -> str:
    """``void wst::f<(int)3>(int, ...)`` -> ``wst::f<(int)3>``: the name up
    to the argument list, the first ``(`` outside the template arguments."""
    depth = 0
    for i, ch in enumerate(demangled):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            demangled = demangled[:i]
            break
    return demangled.strip().removeprefix("void ")


def kernels(csrc: Path, out: Path) -> dict[str, list[str]]:
    """Kernel label -> its SASS instructions, for every kernel of ``csrc``."""
    sass: dict[str, list[str]] = {}
    for obj in _objects(csrc, out):
        text = subprocess.run([_tool("cuobjdump"), "-sass", str(obj)], check=True,
                              capture_output=True, text=True).stdout
        name = None
        for line in text.splitlines():
            m = _FUNC.match(line)
            if m:
                name = m.group(1)
                sass[name] = []
            elif name is not None:
                i = _INSN.search(line)
                if i:
                    sass[name].append(i.group(1))
    names = list(sass)
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(names), check=True,
                               capture_output=True, text=True).stdout.splitlines()
    return {_label(d): sass[n] for n, d in zip(names, demangled)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", type=Path, help="the other tree's ops/csrc")
    ap.add_argument("--alias", action="append", default=[], metavar="NEW=OLD")
    args = ap.parse_args()
    alias = dict(a.split("=", 1) for a in args.alias)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        new = kernels(_build._CSRC, Path(tmp) / "new")
        old = kernels(args.csrc.resolve(), Path(tmp) / "old")
    res = {}
    for label in sorted(set(new) | (set(old) - set(alias.values()))):
        ours, theirs = new.get(label), old.get(alias.get(label, label))
        if ours is None or theirs is None:
            res[label] = "only in " + ("the other tree" if ours is None else "this tree")
        elif ours == theirs:
            res[label] = f"same ({len(ours)} instructions)"
        else:
            res[label] = f"differs ({len(ours)} instructions here, {len(theirs)} there)"
        print(f"{label}: {res[label]}", flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
