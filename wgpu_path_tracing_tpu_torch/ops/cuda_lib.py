"""Build and load the package's CUDA kernels.

The sources are ``wgpu_path_tracing_tpu_torch/csrc/*.cu`` (and the header
``isect.cuh`` that the intersection kernels share). They expose a
plain C interface, so they are compiled with ``nvcc`` (one process per
source, all started together) and linked into one shared library bound with
``ctypes``; no PyTorch headers are involved, which keeps the build to
seconds. The build happens at first use, into ``build/kernels/`` beside the
package (git-ignored), under a name that hashes the sources and flags, so an
edit rebuilds and an unchanged tree reuses it.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``-O3``,
``-fmad=false`` and no ``--use_fast_math``. Without contraction and with
IEEE division, reciprocal and square root, each kernel rounds every
operation as the separate kernels of its plain PyTorch version do, so the
two agree bit for bit on the card.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# K7's stack entries a ray at most (csrc/bvh2.cu kMaxStack).
BVH_MAX_STACK = 64
# C signatures of the exported launchers; each returns cudaGetLastError().
SIGNATURES = {
    "wpt_dense_hit": [_P, _P, _P, _P, _P, _I, _I, _P],  # ro, rd, tris, t, idx
    "wpt_bounce": [
        _I, _P, _P, _P, _P, _P, _P, _P,  # bounce, rays, state, thr, res, alive, t, idx
        _P, _P, _I, _I,  # tri_full, light_full, num_lights, do_mis
        _I, _P, _I, _I,  # texture mode, atlas or fat canvas, its h, w
        _P, _I, _I,  # fat match table (or NULL), its sets, slots_used bits
        _P,  # bounce-0 LDS rows (3, N) (or NULL)
        _P, _I, _I, _P,  # environment map (or NULL), its h, w, its params
        _P, _P, _P, _P, _P,  # out rays, state, thr, res, alive
        _P, _P, _P, _P, _P,  # shadow rays, t_max, mask, direct, pdf
        _I, _P,  # n, stream
    ],
    "wpt_walk": [
        _P, _P, _P,  # walk_order, walk_boxes, the leaf records
        _P, _P, _P, _P,  # ro, rd, active (or NULL), t_max (or NULL)
        _P, _P,  # out t, idx
        _I, _I, _I,  # n, num_tris (-1: none), any_hit
        _I, _P,  # stack entries a thread, stream
    ],
    "wpt_walk16": [  # the same at width 16
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
    ],
    "wpt_block_entry": [
        _P, _P, _P, _P, _P, _P, _P, _P,  # aabb, ox, oy, oz, dx, dy, dz, limit
        _P, _I, _I, _I, _P,  # out, nb, bn, boxes, stream
    ],
    "wpt_pairs": [
        _P, _P, _P,  # pairs_tris, each block's super tiles in order, counts
        _P, _P, _P, _P,  # ro, rd, limit, active (or NULL)
        _P, _P,  # out t, idx
        _I, _I, _I, _P,  # n, supers, num_tris (-1: none), stream
    ],
    "wpt_phased": [
        _P, _P, _P, _P, _P,  # leaf records, ro, rd, limit, active (or NULL)
        _P, _P, _P,  # gate bytes (scratch), out t, idx
        _I, _I, _I, _I,  # n, bn, groups, num_tris (-1: none)
        _I, _P,  # slots in ascending index order (kOrdered), stream
    ],
    "wpt_cluster": [
        _P, _P, _P,  # cluster rows, each block's entries ascending, clusters
        _P, _P, _P, _P,  # ro, rd, limit, active (or NULL)
        _P, _P,  # out t, idx
        _I, _I, _I, _I, _I, _P,  # n, clusters, k, max_rounds, num_tris, stream
    ],
    "wpt_bvh_stack": [
        _P, _P,  # the 32-B node records, the 48-B triangle rows (or NULL)
        _P, _P, _P, _P,  # ro, rd, active (or NULL), t_max (or NULL)
        _P, _P,  # out t (or depth), idx
        _I, _I, _I, _I, _I,  # n, nodes, tris, leaf_size, stack_depth
        _I, _I, _I, _F, _P,  # any_hit, max_steps, depth mode, its norm, stream
    ],
    "wpt_bvh_linked": [
        _P, _P,  # the 48-B node records, the 48-B triangle rows
        _P, _P, _P, _P,  # ro, rd, active (or NULL), t_max (or NULL)
        _P, _P,  # out t, idx
        _I, _I, _I, _I, _I, _I, _P,  # n, nodes, tris, leaf_size, any_hit,
        # max_steps, stream
    ],
    "wpt_bvh_div": [_P, _P, _P, _P, _I, _P],  # a, d, out, a / d, n, stream
    "wpt_atrous_level": [
        _P, _P, _P, _P, _P,  # color, normal, depth, found, var
        _P, _P,  # out color, var
        _I, _I, _I,  # h, w, step
        _F, _F, _F, _P,  # sigma_normal, sigma_depth, sigma_lum, stream
    ],
}


class _Lib:
    handle = None
    # nvcc's report (ptxas registers, shared memory, spills), kept beside
    # the library and read back with it
    build_log = ""
    lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def build() -> str:
    """Compile csrc/*.cu into the build directory if needed; returns the
    library path. nvcc's report is kept in ``build_log()``."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        with open(src, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libwpt_kernels_{h.hexdigest()[:16]}.so")
    log_path = out[:-3] + ".log"
    if os.path.exists(out):
        if not _Lib.build_log and os.path.exists(log_path):
            with open(log_path) as f:
                _Lib.build_log = f.read()
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objects = [os.path.join(tmp_dir, os.path.basename(src) + ".o")
                   for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objects)]
        logs = [proc.communicate()[0] for proc in procs]
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} "
                                   f"({proc.returncode}):\n{log}")
        tmp = os.path.join(tmp_dir, "lib.so")
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", tmp,
                               *objects], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
        _Lib.build_log = "".join(logs)
        with open(log_path, "w") as f:
            f.write(_Lib.build_log)
        os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    with _Lib.lock:
        if _Lib.handle is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _Lib.handle = handle
        return _Lib.handle


def build_log() -> str:
    return _Lib.build_log


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_ptr(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
