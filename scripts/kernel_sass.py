"""Dump the SASS of the port's CUDA kernels and count their instructions.

    python3 scripts/kernel_sass.py --out DIR [--csrc DIR]

Builds ``csrc/<source>.cu`` (the port's, or those of ``--csrc``, e.g. an
older checkout's) with the port's nvcc flags, disassembles each library
with ``cuobjdump -sass`` and writes one text file per source under
``--out``; prints, per kernel, its instruction count and the counts of the
opcodes it issues most.  Needs the CUDA toolkit (no card).
"""

import argparse
import collections
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pylatticedso_tpu_torch.kernels import build  # noqa: E402

_FUNC = re.compile(r"Function : (.+?)\s*$")
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", default=str(build.CSRC))
    ap.add_argument("--out", required=True,
                    help="directory for the .sass files")
    ap.add_argument("--sources", default="stencil_matvec,mg_fused")
    args = ap.parse_args()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    cuobjdump = str(Path(nvcc).parent / "cuobjdump")
    cxxfilt = shutil.which("c++filt")
    tmp = Path(tempfile.mkdtemp())
    for name in args.sources.split(","):
        so = tmp / f"lib{name}.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(so),
                        str(Path(args.csrc) / f"{name}.cu")], check=True,
                       capture_output=True)
        sass = subprocess.run([cuobjdump, "-sass", str(so)], check=True,
                              capture_output=True, text=True).stdout
        if cxxfilt:
            sass = subprocess.run([cxxfilt], input=sass, check=True,
                                  capture_output=True, text=True).stdout
        (out / f"{name}.sass").write_text(sass)
        func, counts = None, {}
        for line in sass.splitlines():
            m = _FUNC.search(line)
            if m:
                func = m.group(1)
                counts[func] = collections.Counter()
                continue
            m = _INSN.search(line)
            if m and func:
                counts[func][m.group(1).split(".")[0]] += 1
        for func, c in counts.items():
            print(f"{name} {func[:150]}: {sum(c.values())} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in c.most_common(14)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
