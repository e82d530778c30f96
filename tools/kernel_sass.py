"""Dump the SASS of the package's CUDA sources, built as the library builds
them, and count the instructions of each function that a redesign reads.

    python tools/kernel_sass.py [--out DIR] [SOURCE.cu ...]

Each source (default: every ``wgpu_path_tracing_tpu_torch/csrc/*.cu``) is
compiled to a cubin with ``ops/cuda_lib.py``'s flags and disassembled with
``cuobjdump -sass`` into DIR/<name>.sass (default DIR: ``build/sass``).
Then, for each function, it prints how many MUFU.RCP (the reciprocal's
approximation), FCHK (the division's range check), CALL, LDG and local
memory (LDL, STL) instructions it holds. Needs the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from wgpu_path_tracing_tpu_torch.ops import cuda_lib  # noqa: E402

OPCODES = ("MUFU.RCP", "FCHK", "CALL", "LDG", "LDL", "STL", "LDS", "STS",
           "FFMA", "FMUL", "FADD", "FMNMX")


def sass_of(src: str, out_dir: str) -> str:
    nvcc = cuda_lib._nvcc()
    name = os.path.splitext(os.path.basename(src))[0]
    cubin = os.path.join(out_dir, name + ".cubin")
    flags = [f for f in cuda_lib.NVCC_FLAGS if f not in ("-Xcompiler",
                                                         "-fPIC")]
    subprocess.run([nvcc, *flags, "-cubin", "-o", cubin, src], check=True)
    dump = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([dump, "-sass", cubin], check=True,
                          capture_output=True, text=True).stdout
    with open(os.path.join(out_dir, name + ".sass"), "w") as f:
        f.write(text)
    return text


def counts(text: str) -> dict:
    funcs, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1)
            funcs[current] = dict.fromkeys(OPCODES, 0)
            funcs[current]["instructions"] = 0
            continue
        m = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                      line)
        if current and m:
            op = m.group(1)
            funcs[current]["instructions"] += 1
            for code in OPCODES:
                if op == code or op.startswith(code + "."):
                    funcs[current][code] += 1
    return funcs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/sass")
    parser.add_argument("sources", nargs="*")
    args = parser.parse_args()
    sources = args.sources or sorted(glob.glob(os.path.join(
        cuda_lib.CSRC_DIR, "*.cu")))
    os.makedirs(args.out, exist_ok=True)
    for src in sources:
        for func, c in counts(sass_of(src, args.out)).items():
            print(f"{os.path.basename(src)} {func}: "
                  + ", ".join(f"{k} {v}" for k, v in c.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
