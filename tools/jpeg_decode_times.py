"""Time the JPEG reader's two entropy decoders on the committed timing
files, in turns, in one process on the host it runs on.

    python tools/jpeg_decode_times.py [--reps 3]

For each ``tests/jpeg/timing_*.jpg`` (1024^2 and 2048^2, 4:2:0, sequential
and progressive, Huffman- and arithmetic-coded; 1024^2 lossless),
``decode_jpeg_rgba`` runs ``--reps`` times with the C++ entropy decoder
(``accel/cbvh/jpeg_scan.cpp``) and as often with its plain Python version
(``accel.native.native_available`` patched to False), alternating;
each decode's SHA-256 is held to Pillow's
(``tests/jpeg/pillow_sha256.json``). One line a decode: the file, the
decoder, the seconds. The first line names the card, as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives it,
where there is one.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from wgpu_path_tracing_tpu_torch.accel import native  # noqa: E402
from wgpu_path_tracing_tpu_torch.utils.jpeg import decode_jpeg_rgba  # noqa: E402

JPEG_DIR = os.path.join(REPO, "tests", "jpeg")


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip() or "no card"
    except (OSError, subprocess.SubprocessError):
        return "no card"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    print(f"{card()}; Python {sys.version.split()[0]}, {os.cpu_count()} "
          "CPUs", flush=True)
    with open(os.path.join(JPEG_DIR, "pillow_sha256.json")) as f:
        digests = json.load(f)
    real = native.native_available
    for name in sorted(digests):
        with open(os.path.join(JPEG_DIR, name), "rb") as f:
            data = f.read()
        for decoder in ("C++", "Python") * args.reps:
            native.native_available = (real if decoder == "C++"
                                       else (lambda: False))
            try:
                t0 = time.perf_counter()
                rgba = decode_jpeg_rgba(data, name)
                secs = time.perf_counter() - t0
            finally:
                native.native_available = real
            if hashlib.sha256(rgba.tobytes()).hexdigest() != digests[name]:
                raise AssertionError(f"{name}: the {decoder} decode differs "
                                     "from Pillow's")
            print(f"{name} {decoder} {secs:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
